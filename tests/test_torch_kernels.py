"""The plain PyTorch versions of the port's CUDA kernels against the JAX
package's kernels on the CPU.

K3 (`apex_tpu_torch.ops.pallas_linalg`, batched SPD inverse) is held
against the Pallas kernel in interpret mode and against the unrolled
Cholesky of `apex_tpu.ops.linalg`; K2 (`apex_tpu_torch.physics.fleet_fk`,
fleet forward kinematics) against the Pallas FK kernel in interpret mode
and the XLA batch-last FK. Inputs are drawn with numpy from fixed seeds
and handed to both sides. The CUDA kernels themselves are held against
these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.linalg import spd_inverse as jax_spd_inverse
from apex_tpu.ops.pallas_linalg import pallas_spd_inverse_bt
from apex_tpu.physics import fleet as jax_fleet
from apex_tpu.physics.cassie_sim import cassie_model as jax_cassie_model
from apex_tpu.physics.fleet_fk import pallas_fk
from apex_tpu_torch.ops import pallas_linalg
from apex_tpu_torch.physics import fleet, fleet_fk
from apex_tpu_torch.physics.cassie_sim import CASSIE_QPOS_INIT, cassie_model
from apex_tpu_torch.physics.engine import PhysParams
from chip_smoke import fk_tree_model

CPU = torch.device("cpu")
B_TEST = 8   # one batch size, so each jitted JAX function compiles once

_jax_spd_inverse = jax.jit(jax_spd_inverse)


@jax.jit
def _jax_fk(ipos, qpos):
    """(XLA batch-last FK, Pallas FK kernel in interpret mode)."""
    jm = jax_cassie_model()
    return (tuple(jax_fleet._fk_bt(jm, ipos, qpos)),
            pallas_fk(jm, ipos, qpos, block_b=ipos.shape[-1], interpret=True))


def _random_spd(B, n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, n, n))
    A = X @ np.swapaxes(X, 1, 2) / n + 0.1 * np.eye(n)
    return np.moveaxis(A, 0, -1).astype(np.float32)          # (n, n, B)


def _cassie_batch(B, seed, q_noise=0.01):
    """Dyn-rand Cassie fleet near the standing pose: batch-last qpos,
    qvel and per-env params (masses, damping, COM offsets), numpy."""
    m = cassie_model()
    rng = np.random.default_rng(seed)
    qpos = CASSIE_QPOS_INIT[:, None] + q_noise * rng.normal(size=(m.nq, B))
    for j in m.joints:
        if j.jtype.name == "BALL":
            q = qpos[j.qposadr:j.qposadr + 4]
            qpos[j.qposadr:j.qposadr + 4] = q / np.linalg.norm(q, axis=0)
    qvel = 0.1 * rng.normal(size=(m.nv, B))
    mass = m.body_mass[:, None] * rng.uniform(0.5, 1.5, size=(m.nbody, B))
    damp = m.dof_damping[:, None] * rng.uniform(0.3, 5.0, size=(m.nv, B))
    ipos = m.body_ipos[:, :, None] + 0.01 * rng.normal(size=(m.nbody, 3, B))
    f32 = lambda x: np.asarray(x, np.float32)
    return f32(qpos), f32(qvel), f32(mass), f32(damp), f32(ipos)


def _cassie_damped_mass_matrix(B, seed):
    """M + hD of a dyn-rand Cassie fleet, (32, 32, B), from the port's
    dynamics (held against the JAX fleet in test_torch_physics.py)."""
    m = cassie_model()
    qpos, qvel, mass, damp, ipos = _cassie_batch(B, seed)
    params = PhysParams.from_model(m, B, CPU)
    params.body_mass, params.dof_damping = torch.tensor(mass), torch.tensor(damp)
    params.body_ipos = torch.tensor(ipos)
    dyn = fleet._dynamics_bt(m, params, torch.tensor(qpos), torch.tensor(qvel))
    Md = dyn.M.clone()
    Md.diagonal(dim1=0, dim2=1).add_(m.timestep * params.dof_damping.T)
    return Md.numpy()


def _assert_inverse_close(got, ref, rel):
    """Entries compared relative to max|A^-1|: the inverse's small entries
    carry the absolute error of the large ones (tests/test_fleet_parity.py
    _assert_stepout_close)."""
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


def _jax_inverses(At):
    """(Pallas kernel in interpret mode, unrolled Cholesky) of (n, n, B)."""
    pal = pallas_spd_inverse_bt(jnp.asarray(At), block_b=At.shape[-1],
                                interpret=True)
    unrolled = _jax_spd_inverse(jnp.asarray(np.moveaxis(At, -1, 0)))
    return np.asarray(pal), np.moveaxis(np.asarray(unrolled), 0, -1)


def test_spd_inverse_plain_matches_jax_random():
    """Random well-conditioned SPD at n = 32. Tolerance 1e-5 of max|A^-1|:
    f32 rounding (~6e-8) times the condition number (~1e2)."""
    At = _random_spd(B_TEST, 32, seed=0)
    got = pallas_linalg.spd_inverse_bt(torch.tensor(At)).numpy()
    ref_pallas, ref_unrolled = _jax_inverses(At)
    _assert_inverse_close(got, ref_pallas, 1e-5)
    _assert_inverse_close(got, ref_unrolled, 1e-5)
    resid = np.einsum("ijb,jkb->ikb", At.astype(np.float64), got)
    np.testing.assert_allclose(resid, np.eye(32)[:, :, None] + 0 * resid,
                               atol=1e-4)


def test_spd_inverse_plain_matches_jax_cassie():
    """Cassie's damped mass matrix M + hD from a dyn-rand fleet.
    Its condition number is ~1e5 (60 kg pelvis rows against 1e-5 kg m^2
    rod inertias), so f32 rounding allows ~1e-2 relative error in the
    smallest-eigenvalue directions; entries are held to 2e-3 of max|A^-1|,
    the scale of the JAX package's own fleet-vs-per-env Minv noise."""
    At = _cassie_damped_mass_matrix(B_TEST, seed=1)
    got = pallas_linalg.spd_inverse_bt(torch.tensor(At)).numpy()
    ref_pallas, ref_unrolled = _jax_inverses(At)
    _assert_inverse_close(got, ref_pallas, 2e-3)
    _assert_inverse_close(got, ref_unrolled, 2e-3)


@pytest.mark.parametrize("q_noise", [0.01, 0.3])
def test_fk_plain_matches_jax(q_noise):
    """Cassie FK (slides, hinges, three ball joints) with per-env COM
    offsets, against the Pallas kernel in interpret mode and the XLA
    batch-last FK at the tolerances of tests/test_fleet_parity.py:
    kinematics match to f32 rounding."""
    qpos, _, _, _, ipos = _cassie_batch(B_TEST, seed=2, q_noise=q_noise)
    got = fleet_fk.fleet_fk(cassie_model(), torch.tensor(ipos),
                            torch.tensor(qpos))
    xla, pal = _jax_fk(jnp.asarray(ipos), jnp.asarray(qpos))
    for name, g, x, p in zip(("xpos", "ximat", "xipos", "cdof", "origin"),
                             got, xla, pal):
        for ref in (x, p):
            np.testing.assert_allclose(g.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_fk_plain_matches_jax_on_a_second_tree():
    """The FK of `chip_smoke.fk_tree_model`'s 26-body tree (slide and hinge
    root, a ball joint mid-chain, a body of three joints, depth 10), built
    with each package's own `physics/spec.py`, against the XLA batch-last
    FK and the Pallas FK kernel in interpret mode, on the same numpy-drawn
    qpos (ball quaternions unnormalised) and COM offsets: f32 rounding."""
    from apex_tpu.physics import spec as jax_spec

    m, jm = fk_tree_model(), fk_tree_model(jax_spec)
    rng = np.random.default_rng(7)
    qpos = (m.qpos0[:, None] + 0.7 * rng.normal(size=(m.nq, B_TEST))
            ).astype(np.float32)
    ipos = (m.body_ipos[:, :, None] + 0.01 * rng.normal(
        size=(m.nbody, 3, B_TEST))).astype(np.float32)
    got = fleet_fk.fleet_fk(m, torch.tensor(ipos), torch.tensor(qpos))
    xla = jax_fleet._fk_bt(jm, jnp.asarray(ipos), jnp.asarray(qpos))
    pal = pallas_fk(jm, jnp.asarray(ipos), jnp.asarray(qpos),
                    block_b=B_TEST, interpret=True)
    for name, g, x, p in zip(("xpos", "ximat", "xipos", "cdof", "origin"),
                             got, xla, pal):
        for ref in (x, p):
            np.testing.assert_allclose(g.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_wrappers_take_plain_version_on_cpu_only():
    """On CPU tensors the wrappers run the plain versions and count no
    launch; tensors on any other non-CUDA device are refused."""
    At = torch.tensor(_random_spd(2, 6, seed=3))
    before = (pallas_linalg.spd_inverse_bt.launches,
              fleet_fk.fleet_fk.launches)
    torch.testing.assert_close(pallas_linalg.spd_inverse_bt(At),
                               pallas_linalg.spd_inverse_bt_plain(At))
    m = cassie_model()
    qpos, _, _, _, ipos = _cassie_batch(2, seed=4)
    fleet_fk.fleet_fk(m, torch.tensor(ipos), torch.tensor(qpos))
    assert (pallas_linalg.spd_inverse_bt.launches,
            fleet_fk.fleet_fk.launches) == before
    with pytest.raises(ValueError):
        pallas_linalg.spd_inverse_bt(At.to("meta"))
    with pytest.raises(ValueError):
        fleet_fk.fleet_fk(m, torch.tensor(ipos).to("meta"),
                          torch.tensor(qpos).to("meta"))
