"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Drives the port's main path -- the deterministic evaluation of the
JAX-trained Cassie policy `curves/cassie_mk4_hardened_ckpt` (64 envs, 300
policy steps of 50 PD substeps, dyn-rand, firmware estimator, early_clock
reward) -- through `apex_tpu_torch.runtime.evaluate.eval_checkpoint`, after
building the hand-written CUDA kernels from `apex_tpu_torch/csrc/` and
holding each against its plain PyTorch version on the card. Phases, each
printed with its seconds as it ends:

  device     require CUDA; card name, power limit, torch and CUDA versions
  build      nvcc build of the kernels (registers and spills printed)
  K3, K2     each kernel against its plain version at B = 64 and 1024:
             max error, kernel / plain / library ms, the roofline bound
  parity     a reset and one fleet substep on the GPU against the CPU;
             a GPU env step gives finite values of the right shapes
  eval       the 64-env, 300-step evaluation; launch counts of K2 and K3
             must equal what the code path implies
  step_1024  ms per policy step at the training fleet (1024 envs), and
             CUDA launches per substep from torch.profiler

The line before the last holds the kernels' JSON record, the card's name
and power limit precede it, and the last line is the JSON verdict. Any
failure raises: the script exits non-zero and prints no verdict.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from apex_tpu_torch.envs.cassie import CassieEnv
from apex_tpu_torch.ops import cuda_build, pallas_linalg
from apex_tpu_torch.physics import fleet, fleet_fk
from apex_tpu_torch.physics.cassie_sim import CASSIE_QPOS_INIT, cassie_model
from apex_tpu_torch.physics.engine import PhysParams
from apex_tpu_torch.runtime.evaluate import eval_checkpoint, load_experiment

CKPT = "curves/cassie_mk4_hardened_ckpt"
N_ENVS, TRAJ_LEN, FLEET = 64, 300, 1024
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores

_T0 = time.time()


def phase(name: str, t0: float, **info) -> None:
    fields = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{name}] {time.time() - t0:.2f} s {fields}".rstrip(), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls, by CUDA
    events around the whole run, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(nbytes: float, flops: float):
    """(bound ms, what bounds it, a printable breakdown): the larger of the
    bytes over HBM bandwidth and the fp32 operations over the fp32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    text = (f"{nbytes / 1e6:.3f} MB = {t_bytes * 1e6:.3f} us, "
            f"{flops / 1e6:.2f} MFLOP = {t_ops * 1e6:.3f} us")
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", text)


def fk_flops_per_env(model) -> int:
    """FP32 operations of one env's FK in csrc/fleet_fk.cu, counted from
    the model: 3x3 products 45, matrix-vector 15, cross product 9."""
    from apex_tpu_torch.physics.engine import _Structure
    from apex_tpu_torch.physics.spec import JointType

    st = _Structure.of(model)
    ops = 0
    for i in range(model.nbody):
        if model.body_parent[i] >= 0:
            ops += 6 * int(np.count_nonzero(model.body_pos[i]))
            ops += 0 if st.body_rot_identity[i] else 45
        for jidx in model.body_joints[i]:
            jt = model.joints[jidx].jtype
            if jt == JointType.SLIDE:
                ops += 15 + 1 + 6
            elif jt == JointType.HINGE:
                ops += 15 + 1 + 2 * 45 + 2 + 36 + 9
            else:
                ops += 7 + 4 + 24 + 45 + 3 * 9
        ops += 21                                      # xipos
    return ops


# ---------------------------------------------------------------------------

def random_spd(B: int, n: int, gen: torch.Generator) -> torch.Tensor:
    X = torch.randn(B, n, n, generator=gen, dtype=torch.float64)
    A = X @ X.transpose(1, 2) / n + 0.1 * torch.eye(n, dtype=torch.float64)
    return A.permute(1, 2, 0).contiguous().float()


def cassie_inputs(B: int, gen: torch.Generator):
    """A dyn-rand Cassie fleet near the standing pose: qpos, qvel, params."""
    m = cassie_model()
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
    params.dof_damping = params.dof_damping * (
        0.3 + 4.7 * torch.rand(m.nv, B, generator=gen))
    params.body_ipos = params.body_ipos + 0.01 * torch.randn(
        m.nbody, 3, B, generator=gen)
    return qpos, qvel, params


def check_k3(gen, dev):
    """K3 against its plain version on random SPD and on Cassie M + hD."""
    out = {}
    for B in (N_ENVS, FLEET):
        m = cassie_model()
        qpos, qvel, params = cassie_inputs(B, gen)
        to = lambda p: PhysParams(**{k: v.to(dev) for k, v in vars(p).items()})
        dyn = fleet._dynamics_bt(m, to(params), qpos.to(dev), qvel.to(dev))
        mhd = dyn.M.clone()
        mhd.diagonal(dim1=0, dim2=1).add_(
            m.timestep * to(params).dof_damping.T)
        cases = (("random", random_spd(B, 32, gen).to(dev), 1e-5),
                 ("cassie", mhd.contiguous(), 2e-3))
        for name, A, rel in cases:
            got = pallas_linalg.spd_inverse_bt(A)
            ref = pallas_linalg.spd_inverse_bt_plain(A)
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            err = (got - ref).abs().max().item()
            resid = (torch.einsum("ijb,jkb->ikb", A.double(), got.double())
                     - torch.eye(32, dtype=torch.float64, device=dev)[
                         :, :, None]).abs().max().item()
            if not (np.isfinite(err) and err <= rel * scale):
                raise AssertionError(
                    f"K3 {name} B={B}: max err {err:.3e} > {rel} x "
                    f"max|A^-1| {scale:.3e}")
            out[(name, B)] = dict(max_abs_err=err, rel_err=err / scale,
                                  resid=resid)
        A = cases[1][1]
        Abf = A.permute(2, 0, 1).contiguous()
        ms = cuda_ms(lambda: pallas_linalg.spd_inverse_bt(A), 50)
        plain = cuda_ms(lambda: pallas_linalg.spd_inverse_bt_plain(A), 3, 1)
        lib = cuda_ms(lambda: torch.linalg.inv(Abf), 50)
        # a Cholesky-based inverse: n^3/3 each for L, L^-1 and L^-T L^-1
        bnd, by, why = bound_ms(2 * A.numel() * 4, 32 ** 3 * B)
        out[("time", B)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                bound_ms=bnd, bound_by=by)
        print(f"  K3 B={B}: random err {out[('random', B)]['rel_err']:.2e} "
              f"of max, resid {out[('random', B)]['resid']:.2e}; cassie "
              f"M+hD err {out[('cassie', B)]['max_abs_err']:.3e} "
              f"({out[('cassie', B)]['rel_err']:.2e} of max), resid "
              f"{out[('cassie', B)]['resid']:.2e}; kernel {ms:.4f} ms, "
              f"plain {plain:.3f} ms, torch.linalg.inv {lib:.4f} ms, "
              f"bound {bnd * 1e3:.3f} us ({by}: {why})", flush=True)
    return out


def check_k2(gen, dev):
    """K2 against its plain version on a perturbed dyn-rand fleet."""
    m = cassie_model()
    out = {}
    for B in (N_ENVS, FLEET):
        qpos, _, params = cassie_inputs(B, gen)
        qpos, ipos = qpos.to(dev), params.body_ipos.to(dev)
        got = fleet_fk.fleet_fk(m, ipos, qpos)
        ref = fleet_fk.fk_plain(m, ipos, qpos)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        for name, a, b in zip(got._fields, got, ref):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5,
                                       msg=lambda s: f"K2 {name} B={B}: {s}")
        ms = cuda_ms(lambda: fleet_fk.fleet_fk(m, ipos, qpos), 100)
        plain = cuda_ms(lambda: fleet_fk.fk_plain(m, ipos, qpos), 3, 1)
        rows = m.nq + 3 * m.nbody + (3 + 9 + 3) * m.nbody + 6 * m.nv
        bnd, by, why = bound_ms(rows * B * 4, fk_flops_per_env(m) * B)
        out[B] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                      bound_by=by)
        print(f"  K2 B={B}: max err {err:.3e}; kernel {ms:.4f} ms, plain "
              f"{plain:.3f} ms, bound {bnd * 1e3:.3f} us ({by}: {why})",
              flush=True)
    return out


def rounding_envelope(m, params, qpos, qvel, ctrl, gen, draws=4):
    """Per-row spread of the CPU substep's new qpos and qvel when its
    inputs change by random factors 1 +- 1e-7, i.e. by f32 rounding."""
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


def check_parity(dev):
    """The GPU path against the CPU path of the port on the same inputs:
    a reset of 4 envs (f32 rounding), and one substep of a 64-env dyn-rand
    fleet. The substep goes through (M + hD)^-1, whose conditioning (~1e5)
    amplifies f32 rounding unevenly across dofs (hip yaw and the
    achilles-rod ball joints most); each device's result carries about the
    spread that rounding-level input changes cause (`rounding_envelope`),
    so their difference is held to four times that spread, per row. A full
    policy step on the GPU must give finite values of the right shapes."""
    envs = {d: CassieEnv(device=d) for d in ("cpu", "cuda")}
    gen = torch.Generator()
    gen.manual_seed(1)
    rnoise = envs["cpu"].sample_reset_noise(gen, 4)
    obs0 = {}
    for d, env in envs.items():
        mv = lambda x: x.to(env.device)
        obs0[d] = env.reset(type(rnoise)(*map(mv, rnoise)))[1].cpu()
    torch.testing.assert_close(obs0["cuda"], obs0["cpu"], rtol=1e-5,
                               atol=1e-5)
    reset_diff = float((obs0["cuda"] - obs0["cpu"]).abs().max())

    m = cassie_model()
    qpos, qvel, params = cassie_inputs(N_ENVS, gen)
    ctrl = 0.3 * torch.randn(m.nu, N_ENVS, generator=gen)
    to = lambda p: PhysParams(**{k: v.to(dev) for k, v in vars(p).items()})
    _, _, qpos_g, qvel_g, _, _ = fleet.fleet_step(
        m, to(params), qpos.to(dev), qvel.to(dev), ctrl.to(dev))
    _, _, qpos_c, qvel_c, _, _ = fleet.fleet_step(m, params, qpos, qvel, ctrl)
    env_q, env_v = rounding_envelope(m, params, qpos, qvel, ctrl, gen)
    dv = (qvel_g.cpu() - qvel_c).abs()
    dq = (qpos_g.cpu() - qpos_c).abs()
    ratio = max(float((dv / (4 * env_v + 1e-6)).max()),
                float((dq / (4 * env_q + 1e-6)).max()))
    if not ratio <= 1.0:
        raise AssertionError(
            f"GPU vs CPU substep: qvel {float(dv.max()):.3e}, qpos "
            f"{float(dq.max()):.3e}, {ratio:.2f} x the bound")

    env = envs["cuda"]
    state, _ = env.reset(env.sample_reset_noise(
        torch.Generator(device=dev), N_ENVS))
    _, obs, rew, term = env.step(
        state, torch.zeros(N_ENVS, env.action_size, device=dev),
        env.sample_step_noise(torch.Generator(device=dev), N_ENVS))
    if not (tuple(obs.shape) == (N_ENVS, env.observation_size)
            and bool(torch.isfinite(obs).all())
            and bool(torch.isfinite(rew).all())
            and tuple(term.shape) == (N_ENVS,)):
        raise AssertionError("GPU env step gave non-finite values or wrong "
                             "shapes")
    return reset_diff, float(dv.max()), float(dq.max()), ratio


def main() -> int:
    t0 = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    phase("device", t0, card=f"'{card}'", torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0],
          gpu=f"'{torch.cuda.get_device_name(0)}'",
          count=torch.cuda.device_count())

    t0 = time.time()
    so = cuda_build.build()
    cuda_build.library()
    print(so.with_suffix(".log").read_text().strip(), flush=True)
    phase("build", t0, library=so.name)

    gen = torch.Generator()
    gen.manual_seed(0)
    t0 = time.time()
    k3 = check_k3(gen, dev)
    phase("K3", t0)
    t0 = time.time()
    k2 = check_k2(gen, dev)
    phase("K2", t0)

    t0 = time.time()
    reset_diff, qvel_diff, qpos_diff, ratio = check_parity(dev)
    phase("parity", t0, reset_obs_max_diff=f"{reset_diff:.3e}",
          substep_qvel_max_diff=f"{qvel_diff:.3e}",
          substep_qpos_max_diff=f"{qpos_diff:.3e}",
          substep_diff_over_bound=f"{ratio:.3f}")

    # the main path, counted: counters at 0 just before, read just after
    t0 = time.time()
    fleet_fk.fleet_fk.launches = 0
    pallas_linalg.spd_inverse_bt.launches = 0
    torch.cuda.synchronize()
    t_eval = time.time()
    ep_ret, ep_len = eval_checkpoint(CKPT, n_episodes=N_ENVS,
                                     traj_len=TRAJ_LEN, device="cuda")
    torch.cuda.synchronize()
    eval_s = time.time() - t_eval
    n_fk = fleet_fk.fleet_fk.launches
    n_inv = pallas_linalg.spd_inverse_bt.launches
    simrate = 50
    # K3: once per substep; K2: once per substep, once per step for the
    # pre-step foot positions, once per step for the auto-reset fleet,
    # once for the initial reset
    want_inv = TRAJ_LEN * simrate
    want_fk = TRAJ_LEN * (simrate + 2) + 1
    if not (np.isfinite(ep_ret) and np.isfinite(ep_len) and ep_len > 0):
        raise AssertionError(f"eval gave return {ep_ret}, length {ep_len}")
    if (n_inv, n_fk) != (want_inv, want_fk):
        raise AssertionError(f"launch counts K3 {n_inv} (want {want_inv}), "
                             f"K2 {n_fk} (want {want_fk})")
    phase("eval", t0, mean_return=f"{ep_ret:.4f}",
          mean_length=f"{ep_len:.2f}",
          ms_per_policy_step=f"{eval_s / TRAJ_LEN * 1e3:.2f}",
          k3_launches=n_inv, k2_launches=n_fk)

    t0 = time.time()
    from apex_tpu_torch.agents.rollout import init_runner, rollout_scan

    exp = load_experiment(CKPT, device="cuda")
    env = exp.env
    gen_dev = torch.Generator(device=dev)
    gen_dev.manual_seed(0)

    def policy_fn(obs):
        return exp.actor.act(exp.norm, obs, deterministic=True)

    with torch.no_grad():
        runner = init_runner(env, gen_dev, FLEET)
        runner, _ = rollout_scan(env, policy_fn, runner, gen_dev, 1, TRAJ_LEN)
        torch.cuda.synchronize()
        t_steps = time.time()
        runner, traj = rollout_scan(env, policy_fn, runner, gen_dev, 3,
                                    TRAJ_LEN)
        torch.cuda.synchronize()
        step_ms = (time.time() - t_steps) / 3 * 1e3
        if not torch.isfinite(traj.reward).all() or \
                tuple(runner.obs.shape) != (FLEET, env.observation_size):
            raise AssertionError("fleet-1024 rollout gave non-finite rewards "
                                 "or a wrong observation shape")
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rollout_scan(env, policy_fn, runner, gen_dev, 1, TRAJ_LEN)
            torch.cuda.synchronize()
    events = prof.events()
    on_card = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = len(on_card)
    busy_ms = sum(e.time_range.elapsed_us() for e in on_card) / 1e3
    launch_calls = sum(1 for e in events if e.name in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
        "cuLaunchKernelEx"))
    phase("step_1024", t0, ms_per_policy_step=f"{step_ms:.2f}",
          device_kernels_per_policy_step=kernels,
          launch_calls_per_policy_step=launch_calls,
          launches_per_substep=f"{launch_calls / simrate:.1f}",
          device_busy_ms_per_policy_step=f"{busy_ms:.2f}",
          device_idle_share=f"{1.0 - busy_ms / step_ms:.4f}")

    record = {"kernels": [
        {"name": "K3 spd_inverse_bt", "route": "cuda",
         "source": "apex_tpu_torch/csrc/spd_inverse.cu",
         "replaces": "apex_tpu/ops/pallas_linalg.py:36",
         "launches": n_inv,
         "max_abs_err": k3[("cassie", N_ENVS)]["max_abs_err"],
         **k3[("time", N_ENVS)]},
        {"name": "K2 fleet_fk", "route": "cuda",
         "source": "apex_tpu_torch/csrc/fleet_fk.cu",
         "replaces": "apex_tpu/physics/fleet_fk.py:33",
         "launches": n_fk,
         "max_abs_err": k2[N_ENVS]["max_abs_err"],
         "ms": k2[N_ENVS]["ms"], "plain_ms": k2[N_ENVS]["plain_ms"],
         "bound_ms": k2[N_ENVS]["bound_ms"],
         "bound_by": k2[N_ENVS]["bound_by"], "library_ms": None},
    ]}
    at_fleet = {"K3": k3[("time", FLEET)], "K2": {
        k: v for k, v in k2[FLEET].items() if k != "max_abs_err"}}
    print(f"at B={FLEET}: {json.dumps(at_fleet)}", flush=True)
    print(f"total {time.time() - _T0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
