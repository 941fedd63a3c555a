"""K1, the whole-substep kernel, and the megakernel tier of the PD scan:
the port's plain version against the JAX package on the CPU.

The JAX side runs the kernel generator's body on plain arrays
(`apex_tpu.physics.fleet_kernel.emulated_pd_substep`) eagerly under
`jax.disable_jit()`, as its own tests do (jitting the Cassie-sized graph is
impractical, tests/test_fleet_kernel.py:4-6); one substep takes seconds.
The inputs are a dyn-rand Cassie fleet of 4 envs made with numpy: env 0 in
flight, the others lowered into foot contact on a slightly tilted floor,
with an external wrench on the pelvis.
The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.physics import fleet_kernel as jax_fk
from apex_tpu.physics.cassie_sim import cassie_model as jax_cassie_model
from apex_tpu.physics.engine import PhysParams as JaxPhysParams
from apex_tpu_torch.envs.cassie import CassieEnv
from apex_tpu_torch.physics import fleet_kernel
from apex_tpu_torch.physics.cassie_sim import (
    CASSIE_QPOS_INIT,
    NEUTRAL_OFFSET,
    CassiePhysState,
    PDCommand,
    cassie_model,
    pd_scan,
)
from apex_tpu_torch.physics.engine import PhysParams

B = 4
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _fleet(seed, dyn_rand=True, qpos_noise=0.003):
    """numpy batch-last inputs: qpos, qvel, cmd rows, params dict."""
    m = cassie_model()
    rng = np.random.default_rng(seed)
    qpos = np.tile(CASSIE_QPOS_INIT[:, None], (1, B)) \
        + qpos_noise * rng.standard_normal((m.nq, B))
    qpos[2] += np.array([0.1, -0.01, -0.015, -0.02])     # env 0 in flight
    for j in m.joints:
        if j.jtype.name == "BALL":
            q = qpos[j.qposadr:j.qposadr + 4]
            qpos[j.qposadr:j.qposadr + 4] = q / np.linalg.norm(q, axis=0)
    qvel = 0.05 * rng.standard_normal((m.nv, B))
    target = NEUTRAL_OFFSET[:, None] + 0.05 * rng.standard_normal((m.nu, B))
    gains = lambda g: np.tile(np.asarray(g, float)[:, None], (1, B))
    cmd = np.concatenate([target, np.zeros((m.nu, B)),
                          gains([100.0, 100.0, 88.0, 96.0, 50.0] * 2),
                          gains([10.0, 10.0, 8.0, 9.6, 5.0] * 2),
                          np.zeros((m.nu, B))])
    p = PhysParams.from_model(m, B, torch.device("cpu"))
    params = {f.name: getattr(p, f.name).numpy().astype(np.float64)
              for f in dataclasses.fields(PhysParams)}
    if dyn_rand:
        params["body_mass"] = params["body_mass"] * rng.uniform(
            0.5, 1.5, (m.nbody, B))
        params["dof_damping"] = params["dof_damping"] * rng.uniform(
            0.3, 5.0, (m.nv, B))
        params["body_ipos"] = params["body_ipos"] + 0.005 * \
            rng.standard_normal((m.nbody, 3, B))
        params["friction"] = rng.uniform(0.4, 1.1, B)
        params["ext_force"] = 20.0 * rng.standard_normal((6, B))
        roll, pitch = rng.uniform(-0.03, 0.03, (2, B))
        params["floor_quat"] = np.stack([
            np.cos(roll / 2) * np.cos(pitch / 2),
            np.sin(roll / 2) * np.cos(pitch / 2),
            np.cos(roll / 2) * np.sin(pitch / 2),
            -np.sin(roll / 2) * np.sin(pitch / 2)])
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    return f32(qpos), f32(qvel), f32(cmd), {k: f32(v)
                                           for k, v in params.items()}


def _port_params(params):
    return PhysParams(**{k: torch.tensor(v) for k, v in params.items()})


def _port_substeps(params, qpos, qvel, cmd, n):
    """n chained plain substeps of the port; outputs after each."""
    m, p = cassie_model(), _port_params(params)
    q, v = torch.tensor(qpos), torch.tensor(qvel)
    outs = []
    for _ in range(n):
        o = fleet_kernel.pd_substep_plain(m, p, q, v, torch.tensor(cmd))
        q, v = o[0], o[1]
        outs.append([x.numpy() for x in o])
    return outs


def _envelope(params, qpos, qvel, cmd, n, draws=4, seed=0):
    """Per-row spread of the port's n-substep outputs when qpos and qvel
    change by random factors 1 +- 1e-7 (f32 rounding), max over draws."""
    rng = np.random.default_rng(seed)
    base = _port_substeps(params, qpos, qvel, cmd, n)
    env = [[np.zeros(x.shape[0]) for x in step] for step in base]
    for _ in range(draws):
        jit = lambda x: (x * (1 + 1e-7 * rng.choice([-1.0, 1.0], x.shape))
                         ).astype(np.float32)
        out = _port_substeps(params, jit(qpos), jit(qvel), cmd, n)
        for s in range(n):
            for k in range(4):
                env[s][k] = np.maximum(env[s][k], np.abs(
                    out[s][k] - base[s][k]).max(axis=1))
    return base, env


@pytest.fixture(scope="module")
def jax_and_port():
    """Three chained substeps of the JAX generator body and of the port's
    plain version from the same inputs, and the port's rounding
    envelope."""
    qpos, qvel, cmd, params = _fleet(seed=0)
    jm = jax_cassie_model()
    jp = JaxPhysParams(**{k: jnp.asarray(v) for k, v in params.items()})
    q, v = jnp.asarray(qpos), jnp.asarray(qvel)
    jax_outs = []
    with jax.disable_jit():
        for _ in range(3):
            o = jax_fk.emulated_pd_substep(jm, jp, q, v, jnp.asarray(cmd))
            q, v = o[0], o[1]
            jax_outs.append([np.asarray(x) for x in o])
    port, env = _envelope(params, qpos, qvel, cmd, 3)
    return jax_outs, port, env


@pytest.mark.parametrize("substeps", [1, 3])
def test_plain_substep_matches_the_jax_generator(jax_and_port, substeps):
    """`pd_substep_plain` against `emulated_pd_substep`, after 1 and after
    3 chained substeps: qpos, qvel, qacc and the 44 diag rows.

    The two run the same formulas in the same order, and differ by where
    PyTorch and XLA round (reciprocals of scalars, rsqrt, sin/cos). The
    velocity solve through M + hD and the connect impulses amplify that
    unevenly across dofs, so each row is held to four times the spread
    that rounding-level input changes cause in the port itself
    (`_envelope`: e.g. ~1e-4 in the hip-yaw velocities after 3
    substeps), plus 1e-6 of the row's magnitude. The kinematic diag rows
    (foot positions, orientations, velocities) and the motor torques of
    the first substep depend on the inputs only through FK and the PD
    law and are held to 1e-5; from the second substep on they inherit
    the state's spread, and are held to the larger of the two."""
    jax_outs, port, env = jax_and_port
    s = substeps - 1
    force_rows = [0, 1] + list(range(22, 34))
    for k, name in enumerate(("qpos", "qvel", "qacc", "diag")):
        got, ref, e = port[s][k], jax_outs[s][k], env[s][k]
        assert np.isfinite(got).all()
        err = np.abs(got - ref).max(axis=1)
        scale = np.abs(ref).max(axis=1)
        bound = 4 * e + 1e-6 * (1.0 + scale)
        if name == "diag":
            kin = np.setdiff1d(np.arange(len(err)), force_rows)
            strict = 1e-5 * (1.0 + scale[kin])
            bound[kin] = strict if substeps == 1 else np.maximum(
                bound[kin], strict)
        bad = np.nonzero(err > bound)[0]
        assert bad.size == 0, (
            f"{name} after {substeps} substeps: rows {bad.tolist()} err "
            f"{err[bad]} > bound {bound[bad]}")
    # the fleet starts in contact: nonzero foot forces in envs 1-3 at the
    # first substep, none in the env in flight
    frc = jax_outs[0][3][0:2]
    assert (frc[:, 1:].max(axis=0) > 1.0).all() and (frc[:, 0] == 0).all()


def test_kernel_meta_matches_jax():
    """`_KernelMeta` against the JAX package's: ancestor lists, body dofs,
    body ancestries, contact bodies and groups, actuator dofs."""
    ours = fleet_kernel.meta_of(cassie_model())
    ref = jax_fk._KernelMeta(jax_cassie_model())
    for name in ("anc", "body_dofs", "body_anc", "lcon", "rcon",
                 "con_bodies", "act_dof"):
        assert getattr(ours, name) == getattr(ref, name), name
    np.testing.assert_array_equal(ours.dof_body, ref.dof_body)
    # the structure the CUDA kernel's scratch is sized for
    assert sum(len(a) + 1 for a in ours.anc) == 307
    assert len(ours.con_bodies) == 9 and len(ours.eq_union) == 32


def _header(itab):
    return dict(zip(fleet_kernel._HEADER,
                    itab[:len(fleet_kernel._HEADER)].tolist()))


def _section(itab, hdr, name, n):
    return itab[hdr[name]:hdr[name] + n].tolist()


def _csr(itab, hdr, name, n):
    """A CSR section of the int table as a list of n lists."""
    ptr = _section(itab, hdr, f"O_{name}_PTR", n + 1)
    flat = itab[hdr[f"O_{name}"]:].tolist()
    return [flat[ptr[i]:ptr[i + 1]] for i in range(n)]


def _tri_entry(t):
    """(d, w) of offset t in the packed lower triangle."""
    d = int((np.sqrt(8 * t + 1) - 1) // 2)
    return d, t - d * (d + 1) // 2


def _ltdl_columns(itab, hdr, nv):
    """Per column k the LTDL updates (i, j), read back from their packed
    offsets, each checked to name row k."""
    cols = []
    for k, col in enumerate(_csr(itab, hdr, "LTDL", nv)):
        pairs = []
        for t in col:
            (i, j), (k1, i1), (k2, j2) = (_tri_entry(t & 1023),
                                          _tri_entry(t >> 10 & 1023),
                                          _tri_entry(t >> 20))
            assert (k1, k2, i1, j2) == (k, k, i, j), (k, t)
            pairs.append((i, j))
        cols.append(pairs)
    return cols


def test_kernel_tables_follow_the_cuda_header():
    """The int table's header order is the `Header` enum of the CUDA
    source, and every section offset lies inside its table, for the flat
    and the heightfield model; the schedule's scalars are Cassie's."""
    src = (ROOT / "apex_tpu_torch" / "csrc" / "fleet_kernel.cu").read_text()
    enum = re.search(r"enum Header \{([^}]*)\}", src).group(1)
    names = tuple(n.strip() for n in enum.split(",") if n.strip())
    assert names == fleet_kernel._HEADER
    for hfield in (False, True):
        m = cassie_model(enable_hfield=hfield)
        itab, ftab = fleet_kernel._k1_tables(m, torch.device("cpu"))
        hdr = dict(zip(names, itab[:len(names)].tolist()))
        assert (hdr["NB"], hdr["NV"], hdr["NQ"], hdr["NU"], hdr["NCON"],
                hdr["NEQ"], hdr["NLIM"]) == (25, 32, 35, 10, 17, 4, 16)
        # 9 body levels, 6 x 9 Lambda rows + 16 limits, dofs up to 13
        # ancestors deep
        assert (hdr["NLVL"], hdr["NTASK"], hdr["DOF_DEPTH"],
                hdr["HFIELD"]) == (9, 70, 14, int(hfield))
        for name, off in hdr.items():
            if name.startswith("O_"):
                assert len(names) <= off <= itab.numel(), name
            elif name.startswith("F_"):
                assert 0 <= off < ftab.numel(), name
        consts = ftab[hdr["F_CONST"]:hdr["F_CONST"] + 12].tolist()
        assert consts[0] == pytest.approx(m.timestep)
        assert consts[9:] == pytest.approx([0.0, 0.0, 9.81])
    # the capacities of the kernel's scratch are those of `_LIMITS`
    for name, key in (("kNb", "nbody"), ("kNv", "nv"), ("kNq", "nq"),
                      ("kNu", "nu"), ("kNcon", "ncon"), ("kNcb", "ncb"),
                      ("kNlim", "nlim"), ("kChain", "chain")):
        got = re.search(rf"constexpr int {name} = (\d+);", src).group(1)
        assert int(got) == fleet_kernel._LIMITS[key], name
    assert fleet_kernel._LIMITS["nv"] == 32      # one lane per dof


@pytest.mark.parametrize("hfield", [False, True])
def test_kernel_schedule_assigns_every_pair_once(hfield):
    """The lane schedule of the warp's phases, read back from the int
    table: CRBA (lane = dof d, its pairs anc[d] + [d]) and every LTDL
    column (its (i, j) list) each cover the ancestor pairs they must
    exactly once; the tree levels hold every body once, after its parent,
    and the dof depths every dof once, at its count of ancestors;
    the one-lane solve tasks are every Lambda row and limit once."""
    m = cassie_model(enable_hfield=hfield)
    meta = fleet_kernel.meta_of(m)
    itab, _ = fleet_kernel._k1_tables(m, torch.device("cpu"))
    hdr = _header(itab)
    nv, nb = m.nv, m.nbody
    anc = _csr(itab, hdr, "ANC", nv)
    assert anc == meta.anc
    mask = meta.st.crba_mask
    crba = [(d, w) for d in range(nv) for w in anc[d] + [d]]
    assert len(crba) == len(set(crba)) == 307
    assert set(crba) == {(d, w) for d in range(nv) for w in range(d + 1)
                         if mask[d, w] > 0}
    ltdl = _ltdl_columns(itab, hdr, nv)
    for k in range(nv):
        pairs = ltdl[k]
        want = {(i, j) for i in anc[k] for j in [i] + anc[i]}
        assert len(pairs) == len(set(pairs)) and set(pairs) == want, k
        assert all(j <= i < k and mask[i, j] > 0 for i, j in pairs)
    desc = _csr(itab, hdr, "DESC", nv)
    assert desc == [sorted((k for k in range(nv) if d in anc[k]),
                           reverse=True) for d in range(nv)]
    dlevels = _csr(itab, hdr, "DLVL", hdr["DOF_DEPTH"])
    assert sorted(d for lv in dlevels for d in lv) == list(range(nv))
    assert all(len(anc[d]) == n for n, lv in enumerate(dlevels) for d in lv)
    levels = _csr(itab, hdr, "LVL", hdr["NLVL"])
    assert sorted(b for lv in levels for b in lv) == list(range(nb))
    level_of = {b: n for n, lv in enumerate(levels) for b in lv}
    for b in range(nb):
        p = int(m.body_parent[b])
        assert level_of[b] == (0 if p < 0 else level_of[p] + 1)
    tasks = _section(itab, hdr, "O_TASK", 2 * hdr["NTASK"])
    tasks = [tuple(tasks[2 * t:2 * t + 2]) for t in range(hdr["NTASK"])]
    assert sorted(tasks) == sorted(
        [(fleet_kernel.TASK_LAMBDA, i) for i in range(6 * hdr["NCB"])]
        + [(fleet_kernel.TASK_LIMIT, i) for i in range(hdr["NLIM"])])
    bmask = [v & 0xFFFFFFFF for v in _section(itab, hdr, "O_BMASK", nb)]
    assert bmask == [sum(1 << d for d in meta.body_anc[b])
                     for b in range(nb)]


def _ltdl_serial(A, anc):
    """The one-thread LTDL of the kernel (and `pd_substep_plain`), in
    place on a dict of float32 entries; returns Dinv."""
    nv = len(anc)
    Dinv = [None] * nv
    for k in reversed(range(nv)):
        Dinv[k] = np.float32(1) / max(A[k, k], np.float32(1e-12))
        for i in reversed(anc[k]):
            a_ = A[k, i] * Dinv[k]
            for j in [i] + list(reversed(anc[i])):
                A[i, j] = A[i, j] - a_ * A[k, j]
            A[k, i] = a_
    return Dinv


def _ltdl_lanes(A, anc, ltdl):
    """The warp's LTDL: per column, every (i, j) update of the column's
    list reads the entries as they stood when the column began (the lanes
    run in any order), then row k is scaled."""
    nv = len(anc)
    Dinv = [None] * nv
    for k in reversed(range(nv)):
        dinv = np.float32(1) / max(A[k, k], np.float32(1e-12))
        new = {(i, j): A[i, j] - (A[k, i] * dinv) * A[k, j]
               for i, j in ltdl[k]}
        A.update(new)
        for i in anc[k]:
            A[k, i] = A[k, i] * dinv
        Dinv[k] = dinv
    return Dinv


@pytest.mark.parametrize("hfield", [False, True])
def test_ltdl_schedule_reads_what_the_serial_loop_reads(hfield):
    """Every LTDL update of the lane schedule comes after what it reads:
    no update of a column reads an entry that another update of the same
    column writes, and none reads row k after its scaling. Checked two
    ways: by the entries each column reads and writes, and by running both
    orders on M + hD of a dyn-rand Cassie fleet in float32, which must
    agree bit for bit."""
    m = cassie_model(enable_hfield=hfield)
    meta = fleet_kernel.meta_of(m)
    itab, _ = fleet_kernel._k1_tables(m, torch.device("cpu"))
    hdr = _header(itab)
    anc = meta.anc
    ltdl = _ltdl_columns(itab, hdr, m.nv)
    for k in range(m.nv):
        pairs = ltdl[k]
        writes = {(i, j) for i, j in pairs}
        reads = {(k, i) for i, _ in pairs} | {(k, j) for _, j in pairs}
        assert not writes & reads, k          # row k is only read
        assert len(writes) == len(pairs)      # one lane per entry
    qpos, qvel, cmd, params = _fleet(seed=3)
    from apex_tpu_torch.physics import fleet
    p = _port_params(params)
    dyn = fleet._dynamics_bt(cassie_model(), p, torch.tensor(qpos),
                             torch.tensor(qvel))
    for b in range(B):
        Mb = (dyn.M[:, :, b] + torch.diag(m.timestep * p.dof_damping[:, b])
              ).numpy().astype(np.float32)
        A1 = {(d, w): Mb[d, w] for d in range(m.nv) for w in anc[d] + [d]}
        A2 = dict(A1)
        D1, D2 = _ltdl_serial(A1, anc), _ltdl_lanes(A2, anc, ltdl)
        assert all(A1[key].tobytes() == A2[key].tobytes() for key in A1)
        assert [x.tobytes() for x in D1] == [x.tobytes() for x in D2]


@pytest.mark.parametrize("hfield", [False, True])
def test_solve_supports_are_ancestor_closed(hfield):
    """Every restricted solve runs over a support that holds the ancestors
    of each of its dofs, in ascending order (its L^T pass then stays inside
    it): the Lambda and limit supports of the task table are chains (each
    dof's ancestors are the entries before it), which their one-lane solve
    assumes; the connect rows' union is EQU_MASK; and the warp's passes by
    dof depth find every ancestor of a dof at a smaller depth."""
    m = cassie_model(enable_hfield=hfield)
    meta = fleet_kernel.meta_of(m)
    itab, _ = fleet_kernel._k1_tables(m, torch.device("cpu"))
    hdr = _header(itab)
    anc = meta.anc
    cbs = _section(itab, hdr, "O_CB", hdr["NCB"])
    banc = _csr(itab, hdr, "BANC", m.nbody)
    limsup = _csr(itab, hdr, "LIMSUP", hdr["NLIM"])
    equ = _section(itab, hdr, "O_EQU", hdr["NEQU"])
    tasks = _section(itab, hdr, "O_TASK", 2 * hdr["NTASK"])
    for t in range(hdr["NTASK"]):
        kind, idx = tasks[2 * t:2 * t + 2]
        sup = (banc[cbs[idx // 6]] if kind == fleet_kernel.TASK_LAMBDA
               else limsup[idx])
        assert sup == sorted(set(sup)), (kind, idx)
        assert all(anc[d] == sup[:e] for e, d in enumerate(sup)), (kind, idx)
    assert equ == sorted(set(equ))
    assert all(set(anc[d]) <= set(equ) for d in equ)
    assert hdr["EQU_MASK"] & 0xFFFFFFFF == sum(1 << d for d in equ)
    for d in range(m.nv):
        assert all(len(anc[i]) < len(anc[d]) for i in anc[d])
    assert max(len(a) for a in anc) + 1 == hdr["DOF_DEPTH"]


def test_megakernel_tier_matches_the_fleet_tier():
    """`pd_scan(tier="megakernel")` against `tier="fleet"` over 3 substeps
    on the dyn-rand fleet, at the tolerances the JAX package holds its
    megakernel to against its fleet path (tools/check_megakernel.py:80-91:
    qpos 2e-5, qvel 2e-2, qacc 60, left foot force 2.0). The two tiers
    solve with different factorizations (sparse LTDL against the dense
    SPD inverse), and diverge chaotically past a few stiff substeps."""
    qpos, qvel, cmd, params = _fleet(seed=1)
    m = cassie_model()
    phys = CassiePhysState(torch.tensor(qpos), torch.tensor(qvel),
                           torch.zeros(m.nv, B))
    pd = PDCommand(*(torch.tensor(cmd[i * m.nu:(i + 1) * m.nu])
                     for i in range(5)))
    p = _port_params(params)
    mk = pd_scan(m, p, phys, pd, 3, tier="megakernel")
    fl = pd_scan(m, p, phys, pd, 3, tier="fleet")
    assert (mk[0].qpos - fl[0].qpos).abs().max() < 2e-5
    assert (mk[2] - fl[2]).abs().max() < 2e-2          # qvel per substep
    assert (mk[3] - fl[3]).abs().max() < 60.0          # qacc per substep
    assert (mk[1].foot_frc_z[:, 0]
            - fl[1].foot_frc_z[:, 0]).abs().max() < 2.0
    assert fl[1].foot_frc_z.abs().max() > 50.0
    for a, b in zip(mk[1], fl[1]):
        assert a.shape == b.shape
    # the first substep's kinematic rows depend on the inputs only
    torch.testing.assert_close(mk[1].foot_pos[0], fl[1].foot_pos[0],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mk[1].foot_quat[0], fl[1].foot_quat[0],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mk[1].motor_torque[0], fl[1].motor_torque[0],
                               rtol=1e-5, atol=1e-4)


def test_tier_selection_and_unsupported_inputs():
    """The tier defaults by device; unknown tiers, models beyond the
    kernel's capacity and devices other than CPU and CUDA raise."""
    m = cassie_model()
    qpos, qvel, cmd, params = _fleet(seed=2)
    p = _port_params(params)
    phys = CassiePhysState(torch.tensor(qpos), torch.tensor(qvel),
                           torch.zeros(m.nv, B))
    pd = PDCommand(*(torch.tensor(cmd[i * m.nu:(i + 1) * m.nu])
                     for i in range(5)))
    default = pd_scan(m, p, phys, pd, 1)
    fleet = pd_scan(m, p, phys, pd, 1, tier="fleet")
    torch.testing.assert_close(default[0].qpos, fleet[0].qpos, rtol=0,
                               atol=0)
    with pytest.raises(ValueError):
        pd_scan(m, p, phys, pd, 1, tier="pallas")
    with pytest.raises(ValueError):
        CassieEnv(device="cpu", pd_tier="per-env")
    assert CassieEnv(device="cpu", pd_tier="megakernel").pd_tier \
        == "megakernel"
    with pytest.raises(ValueError, match="capacity"):
        fleet_kernel._k1_tables(
            dataclasses.replace(m, contacts=m.contacts * 2),
            torch.device("cpu"))
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        fleet_kernel.pd_substep(m, p, torch.empty(m.nq, B, device=meta),
                                torch.empty(m.nv, B, device=meta),
                                torch.empty(5 * m.nu, B, device=meta))
