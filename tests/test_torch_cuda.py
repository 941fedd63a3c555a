"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests need a CUDA device and the CUDA toolkit (the kernels are
built with nvcc at first use) and skip elsewhere. They import no JAX, so
they run where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from apex_tpu_torch.ops import linalg, pallas_linalg
from apex_tpu_torch.physics import engine, fleet, fleet_fk, fleet_kernel
from apex_tpu_torch.physics.cassie_sim import CASSIE_QPOS_INIT, cassie_model
from apex_tpu_torch.physics.engine import PhysParams
from apex_tpu_torch.envs.walker2d import walker_model
from chip_smoke import (CELL_5K_ENVS, MR_FLEET, MR_WORLD, SIMRATE,
                        SUITE_TRIALS, fk_tree_inputs, fk_tree_model,
                        k1_5k_terrain_inputs, k1_at_scale, k1_inputs,
                        k1_ramp_inputs, k1_standing_inputs, random_spd,
                        run_ranks, walker_inputs, walker_step_vs_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _fleet(B, seed):
    m = cassie_model()
    gen = torch.Generator()
    gen.manual_seed(seed)
    qpos = torch.tensor(CASSIE_QPOS_INIT, dtype=torch.float32)[:, None] \
        + 0.05 * torch.randn(m.nq, B, generator=gen)
    for j in m.joints:
        if j.jtype.name == "BALL":
            q = qpos[j.qposadr:j.qposadr + 4]
            qpos[j.qposadr:j.qposadr + 4] = q / q.norm(dim=0)
    qvel = 0.1 * torch.randn(m.nv, B, generator=gen)
    params = PhysParams.from_model(m, B, torch.device("cpu"))
    params.body_mass = params.body_mass * (
        0.5 + torch.rand(m.nbody, B, generator=gen))
    params.body_ipos = params.body_ipos + 0.01 * torch.randn(
        m.nbody, 3, B, generator=gen)
    return qpos, qvel, params


def _fk_inputs(which, B, cuda):
    """(model, body_ipos, qpos) on the card: a dyn-rand Cassie fleet, or
    `chip_smoke.fk_tree_model`'s tree (slide and hinge root, a ball joint
    mid-chain, a body of three joints, depth 10, a level of 13 bodies)."""
    if which == "cassie":
        qpos, _, params = _fleet(B, seed=B)
        return cassie_model(), params.body_ipos.to(cuda), qpos.to(cuda)
    m = fk_tree_model()
    gen = torch.Generator()
    gen.manual_seed(B)
    qpos, ipos = fk_tree_inputs(m, B, gen)
    return m, ipos.to(cuda), qpos.to(cuda)


@pytest.mark.parametrize("which", ["cassie", "tree"])
@pytest.mark.parametrize("B", [1, 33, 64, 1000, 1024])
def test_fk_kernel_matches_plain(cuda, which, B):
    """K2 against fk_plain on the card: f32 rounding of a 25-body chain
    (FMA contraction, CUDA's sinf/cosf within 2 ulp), and of a second tree
    that Cassie's shape does not cover; B = 1 and 33 leave partial
    blocks."""
    m, ipos, qpos = _fk_inputs(which, B, cuda)
    before = fleet_fk.fleet_fk.launches
    got = fleet_fk.fleet_fk(m, ipos, qpos)
    assert fleet_fk.fleet_fk.launches == before + 1
    ref = fleet_fk.fk_plain(m, ipos, qpos)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B", [1, 64, 2048])
def test_fk_kernel_matches_plain_on_walker2d(cuda, B):
    """K2 against fk_plain on Walker2d's model (slide, slide and hinge
    root, seven bodies), on `chip_smoke.walker_inputs`' fleet: f32
    rounding, as on Cassie."""
    m = walker_model()
    gen = torch.Generator()
    gen.manual_seed(B)
    qpos, _, _ = walker_inputs(B, gen)
    params = PhysParams.from_model(m, B, cuda)
    qpos = qpos.to(cuda)
    before = fleet_fk.fleet_fk.launches
    got = fleet_fk.fleet_fk(m, params.body_ipos, qpos)
    assert fleet_fk.fleet_fk.launches == before + 1
    ref = fleet_fk.fk_plain(m, params.body_ipos, qpos)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B", [64, 2048])
def test_walker2d_fleet_step_on_the_card_matches_plain(cuda, B):
    """One Walker2d fleet substep through K2 and K3 (one launch each)
    against the same step with their plain versions on the card, half the
    fleet in contact: the JAX package's per-step tolerances between its
    physics tiers (tests/test_fleet_parity.py), by
    `chip_smoke.walker_step_vs_plain`."""
    m = walker_model()
    gen = torch.Generator()
    gen.manual_seed(B + 1)
    qpos, qvel, ctrl = (x.to(cuda) for x in walker_inputs(B, gen))
    params = PhysParams.from_model(m, B, cuda)
    before = (fleet_fk.fleet_fk.launches,
              pallas_linalg.spd_inverse_bt.launches)
    fleet.fleet_step(m, params, qpos, qvel, ctrl)
    assert (fleet_fk.fleet_fk.launches,
            pallas_linalg.spd_inverse_bt.launches) == (before[0] + 1,
                                                       before[1] + 1)
    _, force = walker_step_vs_plain(m, params, qpos, qvel, ctrl)
    assert force > 0


@pytest.mark.parametrize("n,B", [(32, 1), (32, 64), (32, 1000), (9, 64),
                                 (1, 64), (16, 1000), (9, 2048), (32, 33)])
def test_spd_inverse_kernel_matches_plain(cuda, n, B):
    """K3 against the unrolled Cholesky on random SPD: 1e-5 of max|A^-1|
    (f32 rounding times a condition number ~1e2); B not a multiple of the
    block's 8 matrices and n below the kernel's width (8, 16 or 32)
    exercise the padding."""
    gen = torch.Generator()
    gen.manual_seed(n * B)
    X = torch.randn(B, n, n, generator=gen, dtype=torch.float64)
    A = (X @ X.transpose(1, 2) / n + 0.1 * torch.eye(n, dtype=torch.float64))
    At = A.permute(1, 2, 0).contiguous().float().to(cuda)
    before = pallas_linalg.spd_inverse_bt.launches
    got = pallas_linalg.spd_inverse_bt(At)
    assert pallas_linalg.spd_inverse_bt.launches == before + 1
    ref = pallas_linalg.spd_inverse_bt_plain(At)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("n,B", [(32, 1), (32, 64), (32, 1024), (9, 2048),
                                 (16, 33), (1, 5)])
def test_spd_inverse_bf_is_k3_and_matches_plain(cuda, n, B):
    """K3's batch-first route (K3-bf) on (B, n, n): within 1e-5 of
    max|A^-1| of the unrolled Cholesky (as K3), and bit for bit the
    batch-last K3 on the same matrices laid out (n, n, B) -- the same
    arithmetic, only the addresses differ; one count on its own counter."""
    gen = torch.Generator()
    gen.manual_seed(7 * n + B)
    At = random_spd(B, n, gen).to(cuda)              # (n, n, B)
    A = At.permute(2, 0, 1).contiguous()              # (B, n, n)
    before = (pallas_linalg.spd_inverse_bf.launches,
              pallas_linalg.spd_inverse_bt.launches)
    got = pallas_linalg.spd_inverse_bf(A)
    assert (pallas_linalg.spd_inverse_bf.launches,
            pallas_linalg.spd_inverse_bt.launches) == (before[0] + 1,
                                                       before[1])
    ref = linalg.spd_inverse(A)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-5 * scale
    assert torch.equal(got.permute(1, 2, 0),
                       pallas_linalg.spd_inverse_bt(At))
    torch.testing.assert_close(linalg.batched_spd_inverse(A), got, rtol=0,
                               atol=0)


def test_spd_inverse_bf_refuses_bad_inputs(cuda):
    """Wrong dtype, rank or width, or a non-contiguous tensor: an error,
    no launch and no fallback."""
    before = pallas_linalg.spd_inverse_bf.launches
    A = torch.eye(4, device=cuda)[None].expand(3, 4, 4)
    for bad in (A,                                      # not contiguous
                A.double().contiguous(),               # float64
                torch.eye(4, device=cuda),             # rank 2
                torch.zeros(2, 33, 33, device=cuda),   # n > 32
                torch.zeros(2, 4, 5, device=cuda)):    # not square
        with pytest.raises(ValueError):
            pallas_linalg.spd_inverse_bf(bad)
    assert pallas_linalg.spd_inverse_bf.launches == before


def _per_env_envelope(m, params_bf, qpos, qvel, ctrl, draws=4):
    """Per-dof spread of the CPU per-env substep's new qpos and qvel when
    its inputs change by random factors 1 +- 1e-7, i.e. by f32 rounding."""
    gen = torch.Generator()
    gen.manual_seed(0)
    out0 = engine.step(m, params_bf, qpos, qvel, ctrl)
    env_q = torch.zeros_like(out0.qpos[:1])
    env_v = torch.zeros_like(out0.qvel[:1])
    for _ in range(draws):
        jitter = lambda x: x * (1.0 + 1e-7 * (
            torch.randint(0, 2, x.shape, generator=gen) * 2.0 - 1.0))
        out = engine.step(m, params_bf, jitter(qpos), jitter(qvel), ctrl)
        env_q = torch.maximum(env_q, (out.qpos - out0.qpos).abs().amax(
            0, keepdim=True))
        env_v = torch.maximum(env_v, (out.qvel - out0.qvel).abs().amax(
            0, keepdim=True))
    return env_q, env_v


def test_per_env_substep_on_the_card_matches_the_cpu(cuda):
    """One per-env substep of a dyn-rand Cassie fleet on the card (K3-bf
    for (M + hD)^-1, one launch) against the same substep on the CPU,
    held per dof to four times the spread rounding-level input changes
    cause on the CPU (as the fleet tier's card test)."""
    m = cassie_model()
    qpos, qvel, params = _fleet(64, seed=9)
    gen = torch.Generator()
    gen.manual_seed(9)
    ctrl = 0.3 * torch.randn(m.nu, 64, generator=gen)
    pbf = engine.params_batch_first(params)
    q, v, u = qpos.T.contiguous(), qvel.T.contiguous(), ctrl.T.contiguous()
    before = pallas_linalg.spd_inverse_bf.launches
    out_g = engine.step(m, PhysParams(**{k: x.to(cuda) for k, x in
                                         vars(pbf).items()}),
                        q.to(cuda), v.to(cuda), u.to(cuda))
    assert pallas_linalg.spd_inverse_bf.launches == before + 1
    out_c = engine.step(m, pbf, q, v, u)
    env_q, env_v = _per_env_envelope(m, pbf, q, v, u)
    assert ((out_g.qvel.cpu() - out_c.qvel).abs() <= 4 * env_v + 1e-6).all()
    assert ((out_g.qpos.cpu() - out_c.qpos).abs() <= 4 * env_q + 1e-6).all()
    torch.testing.assert_close(out_g.kin.xpos.cpu(), out_c.kin.xpos,
                               rtol=1e-5, atol=1e-5)
    assert np.isfinite(out_g.qvel.cpu().numpy()).all()


def test_fk_and_spd_inverse_kernels_are_deterministic(cuda):
    """Five launches on the same inputs give the same bits: the lanes of a
    warp share their env's or matrix's rows in shared memory, and a missing
    __syncwarp() or __syncthreads() would make a lane read a value before
    or after another lane wrote it, depending on the card's schedule."""
    for which in ("cassie", "tree"):
        m, ipos, qpos = _fk_inputs(which, 1000, cuda)
        first = fleet_fk.fleet_fk(m, ipos, qpos)
        for _ in range(4):
            again = fleet_fk.fleet_fk(m, ipos, qpos)
            for a, b in zip(again, first):
                assert torch.equal(a, b), which
    gen = torch.Generator()
    gen.manual_seed(0)
    for n in (9, 32):
        A = random_spd(1000, n, gen).to(cuda)
        first = pallas_linalg.spd_inverse_bt(A)
        for _ in range(4):
            assert torch.equal(pallas_linalg.spd_inverse_bt(A), first), n


def test_kernel_wrappers_refuse_bad_inputs(cuda):
    A = torch.eye(4, device=cuda)[:, :, None].expand(4, 4, 3)
    with pytest.raises(ValueError):
        pallas_linalg.spd_inverse_bt(A)                  # not contiguous
    with pytest.raises(ValueError):
        pallas_linalg.spd_inverse_bt(A.double().contiguous())
    with pytest.raises(ValueError):
        pallas_linalg.spd_inverse_bt(torch.zeros(33, 33, 2, device=cuda))
    m = cassie_model()
    with pytest.raises(ValueError):
        fleet_fk.fleet_fk(m, torch.zeros(m.nbody, 3, 2, device=cuda),
                          torch.zeros(m.nq, 3, device=cuda))


def _rounding_envelope(m, params, qpos, qvel, ctrl, draws=4):
    """Per-row spread of the CPU substep's new qpos and qvel when its
    inputs change by random factors 1 +- 1e-7, i.e. by f32 rounding."""
    gen = torch.Generator()
    gen.manual_seed(0)
    _, _, q0, v0, _, _ = fleet.fleet_step(m, params, qpos, qvel, ctrl)
    env_q, env_v = torch.zeros_like(q0[:, :1]), torch.zeros_like(v0[:, :1])
    for _ in range(draws):
        jitter = lambda x: x * (1.0 + 1e-7 * (
            torch.randint(0, 2, x.shape, generator=gen) * 2.0 - 1.0))
        _, _, q, v, _, _ = fleet.fleet_step(m, params, jitter(qpos),
                                            jitter(qvel), ctrl)
        env_q = torch.maximum(env_q, (q - q0).abs().amax(1, keepdim=True))
        env_v = torch.maximum(env_v, (v - v0).abs().amax(1, keepdim=True))
    return env_q, env_v


@pytest.mark.parametrize("seed,ctrl_scale", [(7, 0.0), (8, 0.3)])
def test_fleet_step_on_the_card_matches_the_cpu(cuda, seed, ctrl_scale):
    """One substep of a dyn-rand fleet through both kernels against the
    CPU run of the plain versions. (M + hD)^-1 (condition ~1e5) amplifies
    f32 rounding unevenly across dofs (hip yaw and the achilles-rod ball
    joints most, the latter spinning at up to ~2.5e3 rad/s when the 5%
    qpos noise opens the loop closures); each device's result carries
    about the spread that rounding-level input changes cause, so the two
    are held to four times that spread, per row."""
    m = cassie_model()
    qpos, qvel, params = _fleet(64, seed=seed)
    gen = torch.Generator()
    gen.manual_seed(seed)
    ctrl = ctrl_scale * torch.randn(m.nu, 64, generator=gen)
    to = lambda p: PhysParams(**{k: v.to(cuda) for k, v in vars(p).items()})
    out_g = fleet.fleet_step(m, to(params), qpos.to(cuda), qvel.to(cuda),
                             ctrl.to(cuda))
    out_c = fleet.fleet_step(m, params, qpos, qvel, ctrl)
    (dyn_g, _, qpos_g, qvel_g, _, _), (dyn_c, _, qpos_c, qvel_c, _, _) = \
        out_g, out_c
    torch.testing.assert_close(dyn_g.M.cpu(), dyn_c.M, rtol=1e-4, atol=1e-4)
    env_q, env_v = _rounding_envelope(m, params, qpos, qvel, ctrl)
    assert ((qvel_g.cpu() - qvel_c).abs() <= 4 * env_v + 1e-6).all()
    assert ((qpos_g.cpu() - qpos_c).abs() <= 4 * env_q + 1e-6).all()
    assert np.isfinite(qvel_g.cpu().numpy()).all()


def _k1_inputs(B, seed, cuda):
    """`chip_smoke.k1_standing_inputs` with a dyn-rand fleet's parameters:
    near the standing pose, the even envs lowered 2 cm into contact; on the
    card."""
    _, _, params = _fleet(B, seed)
    gen = torch.Generator()
    gen.manual_seed(seed)
    return k1_standing_inputs(B, gen, cuda, params)


@pytest.mark.parametrize("B", [64, 1000])
def test_substep_kernel_matches_plain(cuda, B):
    """K1 against `pd_substep_plain` on the card, each output held
    elementwise to `fleet_kernel.kernel_bounds`: the kinematic diag rows
    to 1e-5, qvel, qacc and the contact-force rows to four times the
    row's spread under 1 +- 1e-7 input changes, qpos to the larger of the
    two. B = 1000 leaves a partial block of 32 threads."""
    m = cassie_model()
    params, qpos, qvel, rows = _k1_inputs(B, B, cuda)
    before = fleet_kernel.pd_substep.launches
    got = fleet_kernel.pd_substep(m, params, qpos, qvel, rows)
    assert fleet_kernel.pd_substep.launches == before + 1
    gen = torch.Generator()
    gen.manual_seed(0)
    ref, spread = fleet_kernel.plain_spread(m, params, qpos, qvel, rows, gen)
    bounds = fleet_kernel.kernel_bounds(ref, spread)
    torch.cuda.synchronize()
    for k, (a, r, bound) in enumerate(zip(got, ref, bounds)):
        assert torch.isfinite(a).all()
        d = (a - r).abs()
        assert (d <= bound).all(), (k, float((d / bound).max()))
    assert float(ref[3][0:2].abs().max()) > 0      # feet in contact


@pytest.mark.parametrize("B", [1, 33, 1000])
def test_substep_kernel_is_per_env(cuda, B):
    """Two warps per env and no reduction across envs: the first B envs
    of a 1024-env fleet, launched alone (fewer blocks; for B = 1 and 33
    the last block holds one env of its two), give the same bits as in
    the full launch."""
    m = cassie_model()
    params, qpos, qvel, rows = _k1_inputs(1024, 7, cuda)
    full = fleet_kernel.pd_substep(m, params, qpos, qvel, rows)
    cut = lambda x: x[..., :B].contiguous()
    part = fleet_kernel.pd_substep(
        m, PhysParams(**{k: cut(v) for k, v in vars(params).items()}),
        cut(qpos), cut(qvel), cut(rows))
    for a, b in zip(part, full):
        assert torch.equal(a, b[:, :B])
    assert float(part[3][0:2].abs().max()) > 0     # env 0 in contact


@pytest.mark.parametrize("hfield", [False, True])
def test_substep_kernel_is_deterministic(cuda, hfield):
    """Five launches on the same inputs give the same bits: the lanes of
    an env's two warps share its scratch in shared memory, and a missing
    __syncwarp() or barrier between two phases would make a lane read a
    value before or after another lane wrote it, depending on the card's
    schedule."""
    m = cassie_model(enable_hfield=hfield)
    if hfield:
        params, qpos, qvel, rows = _k1_terrain_inputs(1000, 11, cuda)
    else:
        params, qpos, qvel, rows = _k1_inputs(1000, 11, cuda)
    first = fleet_kernel.pd_substep(m, params, qpos, qvel, rows)
    for _ in range(4):
        again = fleet_kernel.pd_substep(m, params, qpos, qvel, rows)
        for a, b in zip(again, first):
            assert torch.equal(a, b)
    assert float(first[3][0:2].abs().max()) > 0    # feet in contact


def test_substep_kernel_refuses_bad_inputs(cuda):
    m = cassie_model()
    params, qpos, qvel, rows = _k1_inputs(4, 0, cuda)
    with pytest.raises(ValueError):                      # not contiguous
        fleet_kernel.pd_substep(m, params, qpos.T.contiguous().T, qvel, rows)
    with pytest.raises(ValueError):                      # float64
        fleet_kernel.pd_substep(m, params, qpos.double(), qvel, rows)
    with pytest.raises(ValueError):                      # wrong rows
        fleet_kernel.pd_substep(m, params, qpos, qvel, rows[:40])


def _k1_terrain_inputs(B, seed, cuda):
    """`chip_smoke.k1_inputs` on terrain: noise and steps tables at 0.06,
    envs beyond the table's edge, every fourth env on the plane."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    return k1_inputs(B, gen, cuda, terrain=0.06)


@pytest.mark.parametrize("B", [64, 1000])
def test_substep_kernel_hfield_matches_plain(cuda, B):
    """K1's heightfield branch against `pd_substep_plain` on the card, held
    to `fleet_kernel.kernel_bounds` as the flat branch is."""
    m = cassie_model(enable_hfield=True)
    params, qpos, qvel, rows = _k1_terrain_inputs(B, B, cuda)
    before = fleet_kernel.pd_substep.hfield_launches
    got = fleet_kernel.pd_substep(m, params, qpos, qvel, rows)
    assert fleet_kernel.pd_substep.hfield_launches == before + 1
    gen = torch.Generator()
    gen.manual_seed(0)
    ref, spread = fleet_kernel.plain_spread(m, params, qpos, qvel, rows, gen)
    bounds = fleet_kernel.kernel_bounds(ref, spread)
    torch.cuda.synchronize()
    for k, (a, r, bound) in enumerate(zip(got, ref, bounds)):
        assert torch.isfinite(a).all()
        d = (a - r).abs()
        assert (d <= bound).all(), (k, float((d / bound).max()))
    assert float(ref[3][0:2].abs().max()) > 0      # feet in contact


def test_substep_kernel_hfield_plane_envs_are_flat(cuda):
    """Envs with hfield_active 0 give the flat kernel's bits; the terrain
    envs do not."""
    params, qpos, qvel, rows = _k1_terrain_inputs(256, 3, cuda)
    got = fleet_kernel.pd_substep(cassie_model(enable_hfield=True), params,
                                  qpos, qvel, rows)
    flat = fleet_kernel.pd_substep(cassie_model(), params, qpos, qvel, rows)
    plane = params.hfield_active == 0
    assert 0 < int(plane.sum()) < 256
    for a, b in zip(got, flat):
        assert torch.equal(a[:, plane], b[:, plane])
    assert not torch.equal(got[1][:, ~plane], flat[1][:, ~plane])


def test_substep_kernel_hfield_refuses_a_bad_table(cuda):
    m = cassie_model(enable_hfield=True)
    params, qpos, qvel, rows = _k1_terrain_inputs(4, 0, cuda)
    static = fleet_kernel.static_rows(m, params)
    with pytest.raises(ValueError):                      # table rows
        fleet_kernel.pd_substep(m, params, qpos, qvel, rows,
                                (*static[:2], static[2][:512]))
    with pytest.raises(ValueError):                      # flat misc rows
        fleet_kernel.pd_substep(m, params, qpos, qvel, rows,
                                (static[0], static[1][:14], static[2]))


@pytest.mark.parametrize("case, B", [
    ("flat", SUITE_TRIALS), ("flat", CELL_5K_ENVS),
    ("terrain", SUITE_TRIALS), ("5k_tables", CELL_5K_ENVS)])
def test_substep_kernel_at_the_suite_fleets(cuda, case, B):
    """K1 at the eval suites' fleets (10,000 envs for the command suite,
    3,971 for a 5k cell): a sample of envs launched alone gives the full
    launch's bits, and holds against the plain version
    (`chip_smoke.k1_at_scale`). The flat kernel at both; the heightfield
    build with the lookup on at 10,000 on `add_terrain`'s terrain (the
    mk5c command suite) and at 3,971 on the 5k noise and hill tables
    (`chip_smoke.k1_5k_terrain_inputs`)."""
    gen = torch.Generator()
    gen.manual_seed(B)
    if case == "flat":
        m, inputs = cassie_model(), k1_standing_inputs(B, gen, cuda)
    elif case == "terrain":
        m = cassie_model(enable_hfield=True)
        inputs = k1_standing_inputs(B, gen, cuda, terrain=0.03)
    else:
        m = cassie_model(enable_hfield=True)
        inputs = k1_5k_terrain_inputs(B, gen, cuda)
    _, _, full = k1_at_scale(m, *inputs, gen, f"K1 {case} B={B}")
    assert all(torch.isfinite(x).all() for x in full)


def test_substep_kernel_hfield_ramps(cuda):
    """The 5k ramp cells through K1's heightfield build (a table in every
    env, hfield_active 0, floors tilted 3 degrees four ways): against the
    plain version on a sample, and bit for bit the flat kernel's."""
    gen = torch.Generator()
    gen.manual_seed(3)
    params, qpos, qvel, rows = k1_ramp_inputs(CELL_5K_ENVS, gen, cuda)
    _, _, got = k1_at_scale(cassie_model(enable_hfield=True), params, qpos,
                            qvel, rows, gen, "K1-hfield ramps")
    flat = fleet_kernel.pd_substep(cassie_model(), params, qpos, qvel, rows)
    for a, b in zip(got, flat):
        assert torch.equal(a, b)


def test_suite_step_on_the_card_matches_the_fleet_tier(cuda):
    """One step of the 5k suite (update_speed_state, the heading, then
    step_basic; the mk5c configuration: heightfield model, 60 substeps)
    on 64 envs over the 5k terrains, frictions and foot masses, through
    K1 against the same step on the fleet tier (K2 + K3), on the card.
    Sixty substeps amplify f32 rounding unevenly per row, so the two are
    held to four times the fleet tier's own spread when its input state
    changes by random factors 1 +- 1e-7, per row."""
    import dataclasses

    from apex_tpu_torch.envs.cassie import CassieEnv
    from apex_tpu_torch.runtime import eval_suites

    envs = {tier: CassieEnv(device="cuda", terrain="noise", simrate=60,
                            dynamics_randomization=False,
                            reward="5k_speed_reward", min_speed=0.0,
                            max_speed=3.0, pd_tier=tier)
            for tier in ("megakernel", "fleet")}
    B = 64
    gen = torch.Generator()
    gen.manual_seed(0)
    names = eval_suites.DEFAULT_5K_TERRAINS
    terr = [eval_suites._terrain_config(names[b % len(names)])
            for b in range(B)]
    state, obs = envs["fleet"].reset_for_test(B)
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=cuda)
    hf = f32(np.stack([t[1] if t[0] else np.zeros((32, 32)) for t in terr]))
    params = dataclasses.replace(
        state.params,
        friction=f32(0.8 + 0.4 * torch.rand(B, generator=gen).numpy()),
        floor_quat=euler2quat_rows([t[2] for t in terr], cuda),
        hfield=hf.permute(1, 2, 0).contiguous(),
        hfield_active=f32([float(t[0]) for t in terr]))
    state = dataclasses.replace(state, params=params)
    action = 0.1 * torch.randn(B, 10, generator=gen).to(cuda)

    def step(env, st):
        st = env.update_speed_state(st, torch.tensor(0.9, device=cuda))
        st = dataclasses.replace(st, orient_add=torch.full((B,), 0.3,
                                                           device=cuda))
        return env.step_basic(st, action)

    got, _ = step(envs["megakernel"], state)
    ref, _ = step(envs["fleet"], state)
    spread_q = torch.zeros_like(ref.phys.qpos[:, :1])
    spread_v = torch.zeros_like(ref.phys.qvel[:, :1])
    for _ in range(4):
        jitter = lambda x: x * (1.0 + 1e-7 * (torch.randint(
            0, 2, x.shape, generator=gen) * 2.0 - 1.0).to(cuda))
        st = dataclasses.replace(state, phys=dataclasses.replace(
            state.phys, qpos=jitter(state.phys.qpos),
            qvel=jitter(state.phys.qvel)))
        alt, _ = step(envs["fleet"], st)
        spread_q = torch.maximum(spread_q, (alt.phys.qpos - ref.phys.qpos)
                                 .abs().amax(1, keepdim=True))
        spread_v = torch.maximum(spread_v, (alt.phys.qvel - ref.phys.qvel)
                                 .abs().amax(1, keepdim=True))
    assert torch.isfinite(got.phys.qpos).all()
    assert ((got.phys.qpos - ref.phys.qpos).abs()
            <= 4 * spread_q + 1e-6).all()
    assert ((got.phys.qvel - ref.phys.qvel).abs()
            <= 4 * spread_v + 1e-6).all()
    assert torch.equal(got.phase, ref.phase)


def euler2quat_rows(tilts, device):
    """(4, B) floor quaternions from per-env (y_pitch, x_roll) tilts."""
    from apex_tpu_torch.utils.quaternion import euler2quat

    y = torch.tensor([t[0] for t in tilts], dtype=torch.float32)
    x = torch.tensor([t[1] for t in tilts], dtype=torch.float32)
    return euler2quat(z=torch.zeros_like(y), y=y, x=x).to(device)


def test_recurrent_ppo_walker_iteration_on_the_card_matches_the_cpu(cuda):
    """One recurrent PPO iteration on Walker2d from the committed
    `curves/recurrent_ppo_walker_seed0_ckpt` (its 256-env runner and
    carries), on the card and on the CPU with the same inputs: a
    deterministic rollout chunk of 4 steps (the same auto-reset draws on
    both; 4 K2 and 4 K3 launches per step on the card) whose observations
    agree row by row at the per-step tolerances of
    `chip_smoke.walker_step_vs_plain` (qpos rows 1e-4 / 2e-5, qvel rows
    5e-2 / 2e-2) and rewards at 1e-2 (the qpos tolerance over the step's
    0.008 s), then `_update` on the card's chunk on both devices with the
    same permutations: metrics within 1e-4 relative (1e-6 absolute), and
    parameters within 1e-5 relative plus 2e-3 of lr per optimiser step
    (Adam's amplification of near-zero gradient entries, as
    tests/test_torch_ppo.py bounds it)."""
    from apex_tpu_torch.agents.ppo import PPOConfig
    from apex_tpu_torch.agents.ppo_recurrent import (RecurrentPPO,
                                                     RecurrentRollout)
    from apex_tpu_torch.device import count_launches
    from apex_tpu_torch.envs.walker2d import Walker2dEnv
    from apex_tpu_torch.runtime import checkpoint

    T, cfg = 4, PPOConfig(num_envs=256, num_steps=256 * 4, max_traj_len=400)
    gen = torch.Generator()
    gen.manual_seed(0)
    resets = [Walker2dEnv(device="cpu").sample_reset_noise(gen, 256)
              for _ in range(T)]
    perms = [torch.randperm(256, generator=gen) for _ in range(cfg.epochs)]
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        env = Walker2dEnv(device=dev)
        agent = RecurrentPPO(env, cfg)
        state = checkpoint.load_recurrent_ppo(
            "curves/recurrent_ppo_walker_seed0_ckpt", agent)
        queue = list(resets)
        env.sample_reset_noise = lambda g, b, q=queue, d=dev: type(q[0])(
            *(x.to(d) for x in q.pop(0)))
        if dev.type == "cuda":
            (_, traj), _, n = count_launches(lambda: agent._rollout(
                state, state.runner, 1.0, deterministic=True))
            assert (n["K2"], n["K3"]) == (4 * T, 4 * T)
        else:
            _, traj = agent._rollout(state, state.runner, 1.0,
                                     deterministic=True)
        runs[dev.type] = agent, state, traj
    obs_g, obs_c = runs["cuda"][2].obs.cpu(), runs["cpu"][2].obs
    torch.testing.assert_close(obs_g[..., :8], obs_c[..., :8], rtol=1e-4,
                               atol=2e-5)
    torch.testing.assert_close(obs_g[..., 8:], obs_c[..., 8:], rtol=5e-2,
                               atol=2e-2)
    torch.testing.assert_close(runs["cuda"][2].reward.cpu(),
                               runs["cpu"][2].reward, rtol=1e-2, atol=1e-2)

    chunk = runs["cuda"][2]
    metrics, leaves = {}, {}
    for name, dev in (("cuda", cuda), ("cpu", torch.device("cpu"))):
        agent, state, _ = runs[name]
        traj = RecurrentRollout(*(x.to(dev) for x in chunk))
        r = state.runner
        before = state.actor_opt.count
        m = agent._update(state, traj, r.actor_carry, r.critic_carry, 1.0,
                          [p.to(dev) for p in perms])
        metrics[name] = {k: float(v) for k, v in m.items()}
        leaves[name] = checkpoint.to_jax_leaves(state, agent.env)[:20]
        steps = state.actor_opt.count - before
    for k, v in metrics["cpu"].items():
        np.testing.assert_allclose(metrics["cuda"][k], v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for a, b in zip(leaves["cuda"], leaves["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=2e-3 * cfg.lr * steps)


def test_k1_part_shards_are_the_whole_launch_bit_for_bit(cuda):
    """K1-part over 2 ranks of a gloo group on this card
    (`chip_smoke.k1_part_job`): each rank's launch is 512 envs wide and
    the gathered launches equal K1 on all 1024 envs bit for bit, on flat
    ground and on terrain."""
    for res in run_ranks("k1_part", MR_WORLD, timed=False):
        for tag in ("K1-part", "K1-part-hfield"):
            assert res[tag] == dict(local_width=MR_FLEET // MR_WORLD,
                                    bitwise=True), tag


def test_one_rank_nccl_spmd_iteration(cuda):
    """One SPMD PPO iteration on Cassie-v0 in a one-rank NCCL group
    (`chip_smoke.spmd_job`): counted (every K1 launch a K1-part one),
    finite metrics, the all-reduces through NCCL."""
    (res,) = run_ranks("spmd", 1, n_itr=1)
    assert res["backend"] == "nccl" and res["lockstep"]
    n = res["iterations"][0]["launches"]
    assert n["K1"] == n["K1-part"] > 0 and n["K1"] % SIMRATE == 0
    assert res["reduce_calls"] > 0
