"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Drives the port's main paths -- the deterministic evaluations of the
JAX-trained Cassie policies (the switch checkpoints main, main2, mk3,
mk5a, mk5b and cassie_traj, see eval_switches) and of
`curves/cassie_mk4_hardened_ckpt` (64 envs, 300
policy steps of 50 PD substeps, dyn-rand, firmware estimator, early_clock
reward) through the whole-substep kernel K1, the same evaluation through
the fleet tier at reduced depth, the evaluations of the two terrain
checkpoints through K1's heightfield branch (`curves/cassie_mk5c_ckpt`:
noise terrain, 5k_speed_reward, dyn-rand off, 60 substeps;
`curves/cassie_mk4_terrain_ckpt`: mk4_hardened on noise terrain), a PPO
iteration of `python -m apex_tpu_torch ppo` at the training fleet and one
each on three new env configurations, and Walker2d through the
fleet tier (K2 + K3) under PPO, TD3, DDPG and ARS and TD3 on Cassie
through K1, and the recurrent learners (the committed recurrent PPO
checkpoint held to JAX, `ppo --recurrent` on Walker2d and Cassie, `rdpg`
and `ars --recurrent`), and the per-env engine tier (the mk4_hardened
evaluation and Walker2d through K3's batch-first route), the analysis
and profiling tools and the tools/ front ends -- after building the
hand-written CUDA kernels from `apex_tpu_torch/csrc/` and holding each
against its plain PyTorch version on the card. Phases, each printed with
its seconds as it ends:

  device     require CUDA; card name, power limit, torch and CUDA versions
  build      nvcc build of the kernels (seconds; registers and spills)
  analysis   (first, while the profiler keeps whole traces)
             `runtime/analysis.py` on mk4_hardened (megakernel tier):
             input_and_state_record (20 steps) and perturb_response (4
             angles x 2 phases, 16 steps), in the JAX package's shapes,
             counted; `runtime/profiling.py`'s trace of one policy step,
             holding the annotated region and its 50 K1 launches (a
             trace that lost launches is taken again, up to
             TRACE_ATTEMPTS: scripts/trace_window.py)
  K3-bf      K3's batch-first route (the per-env engine's inverse of
             M + hD) on (B, n, n) at (64 / 1024, 32, 32) on Cassie's M + hD
             and (2048, 9, 9): per row against its plain version, bit for
             bit the batch-last K3 on the transposed input; kernel, plain
             and torch.linalg.inv ms and its bound
  K3, K2     each kernel against its plain version at B = 64 and 1024:
             max error, kernel / plain / library ms (kernel and library:
             device time from torch.profiler), the roofline bound; K3 also
             at n = 9 for 2048 envs, K2 also on a second tree
             (`fk_tree_model`); registers, stack frame, shared memory per
             block and blocks resident per SM
  K1         the substep kernel (two warps per env, scratch and tables in
             shared memory) against its plain version at B = 64 and
             1024, on a perturbed fleet and near the standing pose
             (bounds from the plain version's rounding spread per row),
             five launches on the same inputs bit for bit, and against
             the fleet step at the JAX package's megakernel-vs-fleet
             tolerances; its registers, stack frame, shared memory per
             block and envs resident per SM
  K1-hfield  the same for the heightfield branch on terrain fleets (noise
             and steps tables, envs beyond the table's edge, a quarter of
             the envs on the plane), and its plane envs against the flat
             kernel bit for bit
  K1-suites  K1 at the eval suites' fleets: at B = 10,000 (the command
             suite) and 3,971 (a 5k cell), a sample of envs launched alone
             bit for bit as in the full launch and against the plain
             version; the same for the heightfield build with the lookup
             on, at 10,000 on terrain and at 3,971 on the 5k noise and
             hill tables; the 5k ramps (heightfield model, hfield_active
             0, floors tilted 3 degrees) against the plain version and bit
             for bit against the flat kernel; kernel ms for each (run
             before the long phases: later in a run the profiler's traces
             lost launches)
  K1-gains   K1 against its plain version with per-env PD gains (the
             defaults plus N(0, 40^2) and N(0, 8^2): negative d gains),
             as learned-gain policies hand them over, at B = 64
  parity     a reset and one fleet substep on the GPU against the CPU;
             a GPU env step gives finite values of the right shapes
  clock_5k   the gait clock every trial of a 5k cell follows (mk5c's env:
             update_speed_state with its phase floor, then step_basic's
             phase advance) for the 24 (mission, speed) schedules, one
             fleet on the card and one on the CPU: phase, cycle count and
             clock length after every step bit for bit (the CPU's
             sequences equal the JAX package's, tests/test_torch_clock_5k.py)
  eval       the 64-env, 300-step evaluation on the megakernel tier for
             seed 42; launch counts of K1, K2 and K3 must equal what the
             code path implies
  eval_fleet the same evaluation on the fleet tier, 5 steps, seed 42
  eval_mk5c, eval_mk4_terrain
             the terrain checkpoints' 64-env, 300-step evaluations on the
             megakernel tier (seed 42), every K1 launch a
             heightfield one; eval_fleet_mk5c: mk5c on the fleet tier,
             5 steps; the returns of eval, eval_mk5c and eval_mk4_terrain
             bit for bit those of earlier runs
  per_env    the per-env engine tier: a 64-env Cassie substep against the
             fleet tier at the JAX package's tier-to-tier tolerances; the
             mk4_hardened evaluation on it (64 envs, 5 steps, seed 42),
             counted (K3-bf once per substep, nothing else), ms per policy
             step and launches per substep; Walker2d on it at 2048 envs
             for 3 steps against its fleet tier, counted (4 K3-bf a step)
  tools      the nine `scripts/torch_<tool>.py` front ends of tools/ at a
             small size, each counted exactly: megakernel_divergence on
             mk5a at 8 envs x 2 steps on all three tiers (their returns
             within 1.8 % of each other), estimator_divergence (five rows
             of 8 envs x 2 steps, "exact" equal to "firmware tau=12ms"),
             mirror_policy_check (16 envs, 2 steps), vis_perturb (its 4 x
             1 grid of 208 steps) and vis_input_and_state (20 steps) on
             mk4_hardened; aslip_tests' grf, footplace and taskspace on a
             one-iteration aslip run of CassieTraj-v0; make_mission into a
             temporary directory read back through the mission loader;
             plot_policy and render_gait (one K2 launch) on the files of
             record_policy, eval --out and eval --gait; each output in the
             JAX tool's keys and shapes, finite (the figures are skipped
             where matplotlib does not import)
  eval_switches
             the 64-env, 300-step evaluation (seed 42, megakernel tier) of
             the checkpoints the CassieEnv switches unlock: main, main2 and
             mk3 (exact estimator), mk5a (heading curriculum,
             speed_phase_add), mk5b (5k_speed_reward, 60 substeps) and
             cassie_traj (CassieTraj-v0), and the port-trained
             torch_cassie_mk4_hardened_seed0 (scripts/torch_train_curve.py),
             counted, on JAX's draws (`jax_draws`), held to JAX's return
             on the CPU within 1.8 %, or within JAX's own seed spread
             where that is wider
  step_1024  ms per policy step at the training fleet (1024 envs), and
             CUDA launches per substep from torch.profiler
  train      `python -m apex_tpu_torch ppo` in-process, one iteration of
             8,192 env steps at 1024 envs and a 100-step evaluation; the
             run directory loads back
  train_new_envs
             one `ppo` iteration each through the CLI (256 envs, 2,048
             steps, a 50-step evaluation): Cassie-v0 with learned gains, a
             one-frame history, the min profile and the clock reward;
             CassieTraj-v0; CassieStanding-v0; counted, each run dir
             loading back
  curves     the learning-curve scripts in-process, counted:
             `scripts/torch_train_curve.py cassie --dyn-random` for one
             iteration at 1024 envs and its 100-step eval (the JAX tool's
             npz keys, finite returns, the checkpoint loading back), one
             `ars` and one `td3_sync` iteration of
             `torch_train_offpolicy_curve.py`, two of `td3_async` (the
             warm-up and one acting iteration; td3's episodes and evals
             100 steps), and one iteration of
             `torch_train_recurrent_curve.py walker` (a 100-step eval), on
             Walker2d
  walker_fleet
             Walker2d on the fleet tier at 2048 envs: K2 on its model and
             K3 on its M + hD against their plain versions (timed, with
             torch.linalg.inv beside K3), and the whole substep (K2 + K3)
             against the same step with the plain versions on the card
  walker2d_ppo
             bench.py's Walker2d PPO cell (2048 envs, 32 steps, minibatch
             4096), one iteration of rollout, update and 300-step eval,
             counted (a reset launches nothing; an env step 4 K2, 4 K3);
             then a learning check: 32 envs, 12 iterations, the eval
             return must rise by more than 50
  td3        bench.py's TD3 cell (async, 64 envs, Walker2d, the 1M ring):
             a warm-up and two policy iterations, counted; updates/s
  td3_cassie `python -m apex_tpu_torch td3_sync` on Cassie-v0 (K1), two
             iterations and an eval (100-step episodes), counted; run dir
             name and checkpoint
  ddpg, ars  `python -m apex_tpu_torch ddpg` and `ars` on Walker2d at the
             CLI's defaults but 100- and 200-step episodes, one iteration
             each, counted
  recurrent_ppo_walker
             `curves/recurrent_ppo_walker_seed0_ckpt` evaluated (256 envs,
             400 steps) on JAX's seed-42 reset draws, held within 1.8 % of
             JAX's return; one iteration of `ppo --recurrent` on Walker2d
             at 256 envs; each counted, the run dir loading back
  recurrent_ppo_cassie
             one `ppo --recurrent --mirror` iteration on Cassie-v0 (64
             envs, K1), counted
  rdpg, ars_recurrent
             `rdpg` (64 envs, 200-step episodes, 4 of the CLI's 80 BPTT
             updates, each timed; the recurrent evaluation) and `ars
             --recurrent` (200-step episodes) on Walker2d at the CLI's
             widths, one iteration each, counted
  suites_mk4 the eval battery's suites on mk4_hardened through the port's
             entry points (`runtime/eval_suites.py`): perturbation on the
             full 8 x 14 x 4 grid (448 envs, 88 steps; survivors at 25 N,
             not all at 350 N, the mean largest push within 75 N of
             JAX's), commands at 10,000 trials (800 steps), the five
             missions as one fleet; each counted, beside JAX's committed
             figures
  suites_mk5c
             perturbation and commands on mk5c (every K1 launch a
             heightfield one), and one full 5k cell, straight_1.4 (3,971
             envs: 11 terrains x 19 frictions x 19 foot masses, 959 steps
             of step_basic), its pass rate beside JAX's
  multi_rank the multi-GPU path as ranks of one process group sharing
             the card (`run_ranks`: subprocesses that load the library
             built above; two ranks on one card join with gloo, which
             stages CUDA tensors through the host, NCCL refusing a
             duplicate GPU): K1-part at 1024 envs over 2 ranks, flat and
             heightfield, each rank's 512-env launch gathered bit for bit
             the whole launch's, rank 0's shard against the plain version
             and timed beside K1 launched alone on it; two SPMD PPO
             iterations on Cassie-v0 (256 envs, 128 per rank), counted per
             rank (K1 and K1-part 50 per policy step), the ranks' nets and
             optimisers bit for bit equal after, the last iteration's
             all-reduce seconds; the same iterations in a one-rank NCCL
             group (the same total fleet); `python -m
             torch.distributed.run --standalone --nproc_per_node 2 -m
             apex_tpu_torch ppo` on Cassie-v0, its one run dir named by
             apex.py's hash, its checkpoint the whole 256-env fleet in
             JAX's leaf shapes, loading back and evaluating

The line before the last holds the kernels' JSON record, the card's name
and power limit precede it, and the last line is the JSON verdict. Any
failure raises: the script exits non-zero and prints no verdict.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from apex_tpu_torch.agents.ppo import PPO, PPOConfig
from apex_tpu_torch.agents.td3 import TD3, TD3Config, copy_params
from apex_tpu_torch.device import card_line, count_launches
from apex_tpu_torch.envs.cassie import CassieEnv
from apex_tpu_torch.envs.walker2d import Walker2dEnv, walker_model
from apex_tpu_torch.ops import cuda_build, pallas_linalg
from apex_tpu_torch.physics import fleet, fleet_fk, fleet_kernel
from apex_tpu_torch.physics.cassie_sim import (
    CASSIE_QPOS_INIT,
    DEFAULT_D_GAIN,
    DEFAULT_P_GAIN,
    MOTOR_QPOS_IDX,
    MOTOR_QVEL_IDX,
    PDCommand,
    cassie_model,
)
from apex_tpu_torch.physics.engine import PhysParams
from apex_tpu_torch.runtime import eval_suites
from apex_tpu_torch.runtime.evaluate import eval_checkpoint, load_experiment
from apex_tpu_torch.runtime.log import args_hash
from apex_tpu_torch.utils.quaternion import euler2quat
from apex_tpu_torch.utils.terrain import terrain_bank

CKPT = "curves/cassie_mk4_hardened_ckpt"
# the terrain checkpoints and their substeps per policy step
TERRAIN_CKPTS = {"mk5c": ("curves/cassie_mk5c_ckpt", 60),
                 "mk4_terrain": ("curves/cassie_mk4_terrain_ckpt", 50)}
N_ENVS, TRAJ_LEN, FLEET = 64, 300, 1024
# the megakernel-tier returns of the three checkpoints the port ran before
# the CassieEnv switches (chip runs on an H100 80GB HBM3 at 700 W, since a
# fresh fleet's reset builds its clocks as JAX's `init_runner` program
# does, `Env.reset_fresh`), at the seeds each is evaluated at; the
# switches must leave them bit for bit (the terrain checkpoints' seeds 0
# and 1, 273.6381530761719 / 264.85650634765625 on mk5c and
# 144.77532958984375 / 138.7381591796875 on mk4_terrain, are no longer
# run, to keep the script inside its time: PERF.md section 6; nor are
# mk4_hardened's seeds 0 and 1, 132.28341674804688 / 124.5030517578125)
EARLIER_RETURNS = {
    "eval": {42: 134.17620849609375},
    "eval_mk5c": {42: 265.31829833984375},
    "eval_mk4_terrain": {42: 149.14862060546875}}
# JAX's returns of the port-trained checkpoint's evaluation at seeds 42, 0
# and 1 (scripts/reference_eval_seeds.py on the CPU)
TORCH_MK4_SEED0_JAX = (60.9184, 59.7965, 59.8611)
# the checkpoints the switches unlock: (run dir, substeps per policy step,
# JAX's returns of the 64-env, 300-step evaluation at seeds 42, 0 and 1 on
# the CPU, scripts/reference_eval_seeds.py); curves/jax_eval_draws holds the
# draws of JAX's seed-42 run (scripts/export_eval_draws.py)
SWITCH_CKPTS = {
    "main": ("curves/cassie_main_ckpt", 50, (114.6508, 121.1239, 125.5392)),
    "main2": ("curves/cassie_main2_ckpt", 50, (112.9900, 123.6102, 117.0965)),
    "mk3": ("curves/cassie_mk3_ckpt", 50, (159.3735, 163.3571, 163.1609)),
    "mk5a": ("curves/cassie_mk5a_ckpt", 50, (145.8103, 152.2901, 150.7646)),
    "mk5b": ("curves/cassie_mk5b_ckpt", 60, (270.1442, 267.4449, 267.9929)),
    "cassie_traj": ("curves/cassie_traj_ckpt", 50,
                    (155.0116, 159.7726, 157.1118)),
    # trained by the port (scripts/torch_train_curve.py, seed 0's best
    # eval of 1,000 iterations), JAX's figures as the others'
    "torch_mk4_seed0": ("curves/torch_cassie_mk4_hardened_seed0_ckpt", 50,
                        TORCH_MK4_SEED0_JAX)}
# the draws files not named after their run dir (`draws_file`)
DRAWS_NAMES = {"torch_cassie_mk4_hardened_seed0_ckpt": "torch_mk4_seed0"}
EVAL_BOUND = 0.018     # the JAX package's bound between its physics tiers
FLEET_TRAJ_LEN = 5                 # depth of the fleet-tier evaluation
SIMRATE = 50
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores

_T0 = time.time()


def phase(name: str, t0: float, **info) -> None:
    fields = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{name}] {time.time() - t0:.2f} s {fields}".rstrip(), flush=True)


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


SLEEP_CYCLES = 50_000_000         # ~30 ms at the H100's boost clock
GAP_MS = 0.003                    # allowance per launch between kernels
TRACE_ATTEMPTS = 3                # traces taken before a reading fails
TRACE = {}                        # what the last device_ms call read


def queued_ms(fn, iters: int) -> tuple[float, bool]:
    """(mean ms per call of fn() by CUDA events, whether the calls ran
    back to back): the stream is held by a sleeping kernel while the host
    queues the calls, so where the host has queued them all before the
    sleep ends (the start event not yet reached), the events time the
    card's work alone, gaps between launches included; where fn() waits
    on the card, they time the host as well."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    queued = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, queued


def device_ms(fn, iters: int, kernel: str = "", warmup: int = 2) -> float:
    """Mean device time per call of fn() over `iters` calls, from
    torch.profiler's CUDA trace: for `kernel`, the mean duration of the
    traced launches whose name holds it (the trace may miss one of a
    burst); for "", the summed durations of every kernel over `iters`.
    Events around back-to-back calls would time the host instead, once a
    call's Python and launch work outlasts its kernel. Each trace is held
    to the same calls timed by `queued_ms`: its kernels' summed time per
    call must lie within 20 % of the events' time (less GAP_MS per launch
    when the calls ran back to back, no more than it otherwise), and the
    launches of `kernel`, the same work each time, within a factor 2 of
    their median duration. A trace that holds fewer than half the
    launches or fails those checks is taken again, up to TRACE_ATTEMPTS
    traces in all, and then the run fails. Each trace records the calls
    after a warm-up step of the same calls that the profiler traces and
    drops (its schedule): a window loses its first kernels (F7). `TRACE`
    keeps the last reading: its launches, names, durations and the
    events' time."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(warmup):
        fn()
    ev_ms, queued = queued_ms(fn, iters)
    for attempt in range(TRACE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for step in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                if not step:
                    prof.step()
        every = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        on_card = [e for e in every if kernel in e.name]
        us = sorted(e.time_range.elapsed_us() for e in on_card)
        med = us[len(us) // 2] if us else 0.0
        total_ms = sum(e.time_range.elapsed_us() for e in every) / iters / 1e3
        TRACE.clear()
        TRACE.update(
            kernel=kernel, iters=iters, launches=len(on_card),
            names=sorted({e.name[:60] for e in on_card}),
            us_min=us[0] if us else None, us_median=med,
            us_max=us[-1] if us else None, all_kernels=len(every),
            trace_ms_per_call=round(total_ms, 4),
            events_ms_per_call=round(ev_ms, 4), back_to_back=queued)
        low = 0.8 * ev_ms - GAP_MS * len(every) / iters if queued else 0.0
        even = not kernel or (bool(us) and us[-1] <= 2 * med
                              and med <= 2 * us[0])
        if (on_card and (not kernel or 2 * len(on_card) >= iters) and even
                and low <= total_ms <= 1.2 * ev_ms):
            break
        print(f"  device_ms: trace {attempt + 1} refused: {TRACE}",
              flush=True)
    else:
        raise AssertionError(f"device_ms: {TRACE_ATTEMPTS} traces refused: "
                             f"{TRACE}")
    per = len(on_card) if kernel else iters
    return sum(e.time_range.elapsed_us() for e in on_card) / per / 1e3


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


def k1_flops_per_env(model) -> int:
    """FP32 operations of one env's substep in csrc/fleet_kernel.cu,
    counted phase by phase from the loops over the model's tables (a
    product-sum of n terms is 2n - 1 operations; a cross product 9)."""
    meta = fleet_kernel.meta_of(model)
    st = meta.st
    nb, nv, nu = model.nbody, model.nv, model.nu
    anc = [len(a) for a in meta.anc]
    ops = 8 * nu                                       # PD law and clamp
    ops += fk_flops_per_env(model)                     # FK and com
    ops += nv * (27 + 3 + 12)                          # velocities, cdof_dot
    for i in range(nb):                                # spatial inertias
        nz = int(np.count_nonzero(model.body_inertia[i]))
        ops += 2 * nz + 45 + 5 + 9 * 4 + 18
    ops += nb * (2 * 6 * 11 + 27 + 9) + nv * 12        # RNEA forward
    ops += (nb - 1) * (6 + 36) + nv * 11               # RNEA back, Ic sum
    ops += nv * 66 + sum(11 * (a + 1) for a in anc) + 2 * nv   # CRBA
    ops += sum(1 + 2 * (1 + anc[i]) for k in range(nv)   # LTDL
               for i in meta.anc[k]) + nv

    def solve(sup):
        return 4 * sum(anc[k] for k in sup) + len(sup)

    for ub in meta.con_bodies:                         # contact-body Lambda
        sup = meta.body_anc[ub]
        ops += 6 * solve(sup) + 21 * 2 * len(sup)
    for c in model.contacts:                           # contact forces
        ops += 2 * int(np.count_nonzero(c.offset)) + 3 + 230
    ops += sum(12 * len(meta.body_anc[ub]) for ub in meta.con_bodies)
    ops += sum(solve(meta.anc[int(d)] + [int(d)]) + 15 for d in st.lim_dof)
    ops += 9 + 12 * len(meta.body_anc[0])              # root wrench
    ops += nv * 10 + solve(range(nv)) + 2 * nv         # free acceleration
    if model.equalities:                               # connect impulses
        ne = 3 * len(model.equalities)
        ops += sum(12 * len(s_) * 3 for s_ in meta.eq_sup) + 30 * len(
            model.equalities)
        ops += ne * solve(meta.eq_union)
        ops += sum(2 * len(meta.eq_sup[cl // 3]) for r in range(ne)
                   for cl in range(r, ne))
        ops += ne * ne * 3 + ne * (2 * 16 + 4)
        ops += ne ** 3 // 3 + 2 * ne * ne + ne * 2     # Cholesky, solves
        ops += ne * 2 * 16 + solve(range(nv)) + nv
    ops += 3 * nv + 2 * len(st.lin_dof) + 60 * len(st.balls)   # integrate
    ops += 2 * 40 + 30                                 # diagnostic rows
    return ops


def k1_hfield_flops_per_env(model) -> int:
    """FP32 operations the heightfield branch adds for an env on terrain:
    the cell size, and per contact its world point (3), the lookup (33:
    two clipped cell coordinates, their floors and fractions, the x then y
    contraction and both gradients), the normal (10) and the depth (3)."""
    return 2 + 49 * len(model.contacts)


def k1_flops(model, params) -> int:
    """FP32 operations of one substep of the fleet: the flat substep per
    env, and the heightfield branch for each env on terrain (the plane
    envs skip it)."""
    B = params.body_mass.shape[-1]
    ops = k1_flops_per_env(model) * B
    if model.enable_hfield:
        active = int((params.hfield_active > 0.5).sum())
        ops += k1_hfield_flops_per_env(model) * active
    return ops


def k1_bytes(model, params) -> int:
    """Bytes one substep of the fleet must move: per env, each input row
    read once and each output row written once, 4 bytes each (a heightfield
    model has two more misc rows); and for each env on terrain, the four
    table corners of each contact's cell, which is all the branch reads of
    the env's (1024,) table column. Contacts that share a cell need its
    corners once, so this count of the table is at most what is needed."""
    B = params.body_mass.shape[-1]
    misc = (fleet_kernel.HFIELD_MISC_ROWS if model.enable_hfield
            else fleet_kernel.MISC_ROWS)
    rows_in = (model.nq + model.nv + 5 * model.nu + model.nv + model.nbody
               + 3 * model.nbody + misc)
    rows_out = model.nq + 2 * model.nv + fleet_kernel.DIAG_ROWS
    nbytes = 4 * (rows_in + rows_out) * B
    if model.enable_hfield:
        active = int((params.hfield_active > 0.5).sum())
        nbytes += 4 * 4 * len(model.contacts) * active
    return nbytes


# ---------------------------------------------------------------------------

def fk_tree_model(spec=None):
    """A 26-body tree for K2 beside Cassie's, built with a `physics/spec.py`
    module (the port's by default): a root of two slides and a hinge (as
    Walker2d's), a ball joint mid-chain, a body with a hinge, a slide and a
    hinge, a branch of depth 10 (Cassie's deepest body is at 8) beside one
    of depth 3, a level of 13 bodies (two rounds of the kernel's walk), and
    bodies without joints, with zero offsets and with rotated frames."""
    if spec is None:
        from apex_tpu_torch.physics import spec
    J = spec.JointType
    rng = np.random.default_rng(5)
    # (parent, joint types); bodies in topological order
    bodies = [(-1, (J.SLIDE, J.SLIDE, J.HINGE)), (0, (J.HINGE,)),
              (1, (J.BALL,)), (2, (J.HINGE, J.SLIDE, J.HINGE))]
    bodies += [(3 + k, (J.HINGE,)) for k in range(6)]       # bodies 4-9
    bodies += [(0, (J.HINGE,)), (10, (J.BALL,)), (10, ())]  # bodies 10-12
    bodies += [(11, (J.HINGE,) if k % 3 else ()) for k in range(12)]
    bodies += [(9, (J.HINGE,))]                             # body 25
    nb = len(bodies)
    joints, body_joints, q, v = [], [], 0, 0
    for i, (_, types) in enumerate(bodies):
        body_joints.append(tuple(range(len(joints),
                                       len(joints) + len(types))))
        for jt in types:
            axis = rng.normal(size=3)
            if len(joints) < 3:
                axis = np.eye(3)[[0, 2, 1][len(joints)]]
            joints.append(spec.Joint(
                body=i, jtype=jt, axis=axis / np.linalg.norm(axis),
                pos=np.zeros(3), ref=float(rng.normal(0, 0.3)) * (
                    jt != J.BALL), qposadr=q, dofadr=v, range=(-1.0, 1.0),
                limited=False, stiffness=0.0, damping=0.1, armature=0.01))
            q += spec.QPOS_WIDTH[jt]
            v += spec.DOF_WIDTH[jt]
    pos = rng.normal(0, 0.2, size=(nb, 3))
    pos[rng.random((nb, 3)) < 0.3] = 0.0
    quat = rng.normal(size=(nb, 4))
    quat[::3] = [1.0, 0.0, 0.0, 0.0]
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    qpos0 = np.zeros(q)
    for j in joints:
        if j.jtype == J.BALL:
            qpos0[j.qposadr] = 1.0
    return spec.PhysModel(
        nbody=nb, nq=q, nv=v, nu=0,
        body_parent=np.array([p for p, _ in bodies], np.int32),
        body_pos=pos, body_quat=quat, body_mass=np.ones(nb),
        body_ipos=rng.normal(0, 0.05, size=(nb, 3)),
        body_inertia=np.tile(0.01 * np.eye(3), (nb, 1, 1)),
        joints=tuple(joints), body_joints=tuple(body_joints), actuators=(),
        contacts=(), equalities=(), dof_damping=np.full(v, 0.1),
        dof_armature=np.full(v, 0.01), qpos0=qpos0,
        body_names=tuple(f"body{i}" for i in range(nb)))


def fk_tree_inputs(m, B: int, gen: torch.Generator):
    """qpos (nq, B) and body_ipos (nb, 3, B) for `fk_tree_model`: angles and
    slides N(0, 0.7^2) around qpos0, ball quaternions drawn at random and
    left unnormalised (the kernel normalises them), COM offsets around the
    model's."""
    qpos = torch.tensor(m.qpos0, dtype=torch.float32)[:, None] \
        + 0.7 * torch.randn(m.nq, B, generator=gen)
    ipos = torch.tensor(m.body_ipos, dtype=torch.float32)[:, :, None] \
        + 0.01 * torch.randn(m.nbody, 3, B, generator=gen)
    return qpos.contiguous(), ipos.contiguous()


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


def build_report(build_log: str, source: str = "") -> str:
    """The compiler's register, stack and spill lines of a build log, of
    one source's section where `source` names it."""
    if source:
        build_log = build_log.split(f"== {source}", 1)[-1].split("\n==", 1)[0]
    return " | ".join(ln.strip() for ln in build_log.splitlines()
                      if "registers" in ln or "stack frame" in ln)


def cassie_mhd(B: int, gen: torch.Generator, dev) -> torch.Tensor:
    """M + hD of a dyn-rand Cassie fleet (`cassie_inputs`), as the fleet
    step inverts it: (32, 32, B) on `dev`."""
    m = cassie_model()
    qpos, qvel, params = cassie_inputs(B, gen)
    params = PhysParams(**{k: v.to(dev) for k, v in vars(params).items()})
    dyn = fleet._dynamics_bt(m, params, qpos.to(dev), qvel.to(dev))
    mhd = dyn.M.clone()
    mhd.diagonal(dim1=0, dim2=1).add_(m.timestep * params.dof_damping.T)
    return mhd.contiguous()


def check_k3(gen, dev, build_log: str):
    """K3 against its plain version on random SPD and on Cassie M + hD at
    n = 32, and on random SPD at Walker2d's n = 9 for 2048 envs (the
    kernel pads it to a width of 16)."""
    out = {}
    for B in (N_ENVS, FLEET):
        mhd = cassie_mhd(B, gen, dev)
        cases = (("random", random_spd(B, 32, gen).to(dev), 1e-5),
                 ("cassie", mhd, 2e-3))
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
        ms = device_ms(lambda: pallas_linalg.spd_inverse_bt(A), 50,
                       "spd_inverse_kernel")
        plain = cuda_ms(lambda: pallas_linalg.spd_inverse_bt_plain(A), 3, 1)
        lib = device_ms(lambda: torch.linalg.inv(Abf), 50)
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
    n, B = 9, 2048
    own = torch.Generator()      # leaves `gen`'s draws to the later phases
    own.manual_seed(n)
    A = random_spd(B, n, own).to(dev)
    got = pallas_linalg.spd_inverse_bt(A)
    ref = pallas_linalg.spd_inverse_bt_plain(A)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    if not (np.isfinite(err) and err <= 1e-5 * scale):
        raise AssertionError(f"K3 random n={n} B={B}: max err {err:.3e} > "
                             f"1e-05 x max|A^-1| {scale:.3e}")
    ms = device_ms(lambda: pallas_linalg.spd_inverse_bt(A), 50,
                   "spd_inverse_kernel")
    Abf = A.permute(2, 0, 1).contiguous()
    lib = device_ms(lambda: torch.linalg.inv(Abf), 50)
    bnd, by, why = bound_ms(2 * A.numel() * 4, n ** 3 * B)
    out[("time", (n, B))] = dict(ms=ms, library_ms=lib, bound_ms=bnd,
                                 bound_by=by)
    print(f"  K3 n={n} B={B}: random err {err / scale:.2e} of max; kernel "
          f"{ms:.4f} ms, torch.linalg.inv {lib:.4f} ms, bound "
          f"{bnd * 1e3:.3f} us ({by}: {why})", flush=True)
    print(f"  K3 {build_report(build_log, 'spd_inverse.cu')}; launch: a warp "
          f"per matrix, n = 32: {pallas_linalg.launch_info(32)}, n = 9: "
          f"{pallas_linalg.launch_info(9)}", flush=True)
    return out


def check_k3_bf(gen, dev, build_log: str):
    """K3's batch-first route (K3-bf, the per-env engine's inverse of
    M + hD) on (B, n, n): at B = 64 and 1024 on Cassie's M + hD
    (`cassie_mhd`) and at B = 2048 on random SPD of Walker2d's n = 9.
    Each against its plain version (`linalg.spd_inverse`), per row: the
    difference within `rel` of the row's largest entry of the inverse, as
    `check_k3` bounds K3 (2e-3 on M + hD, 1e-5 on random SPD); and bit for
    bit the batch-last K3 on the same matrices laid out (n, n, B). Timed
    beside its plain version and torch.linalg.inv."""
    from apex_tpu_torch.ops import linalg

    out = {}
    own = torch.Generator()      # leaves `gen`'s draws to the later phases
    own.manual_seed(2048)
    cases = [(B, 32, "cassie M+hD", cassie_mhd(B, gen, dev), 2e-3)
             for B in (N_ENVS, FLEET)]
    cases.append((2048, 9, "random SPD", random_spd(2048, 9, own).to(dev),
                  1e-5))
    for B, n, what, At, rel in cases:
        A = At.permute(2, 0, 1).contiguous()           # (B, n, n)
        before = pallas_linalg.spd_inverse_bf.launches
        got = pallas_linalg.spd_inverse_bf(A)
        if pallas_linalg.spd_inverse_bf.launches != before + 1:
            raise AssertionError("K3-bf: its wrapper did not count a launch")
        ref = linalg.spd_inverse(A)
        bt = pallas_linalg.spd_inverse_bt(At)
        torch.cuda.synchronize()
        row = ref.abs().amax(dim=-1, keepdim=True)
        err = (got - ref).abs()
        worst = float((err / row).max())
        if not (bool(torch.isfinite(got).all()) and worst <= rel):
            raise AssertionError(f"K3-bf {what} B={B}: max err per row "
                                 f"{worst:.3e} of the row's max > {rel}")
        if not torch.equal(got.permute(1, 2, 0), bt):
            raise AssertionError(f"K3-bf {what} B={B}: not bit for bit the "
                                 "batch-last K3 on the transposed input")
        ms = device_ms(lambda: pallas_linalg.spd_inverse_bf(A), 50,
                       "spd_inverse_kernel")
        plain = cuda_ms(lambda: linalg.spd_inverse(A), 3, 1)
        lib = device_ms(lambda: torch.linalg.inv(A), 50)
        # a Cholesky-based inverse: n^3/3 each for L, L^-1 and L^-T L^-1
        bnd, by, why = bound_ms(2 * A.numel() * 4, n ** 3 * B)
        out[(n, B)] = dict(max_abs_err=float(err.max()), ms=ms,
                           plain_ms=plain, bound_ms=bnd, bound_by=by,
                           library_ms=lib)
        print(f"  K3-bf {what} ({B}, {n}, {n}): max err {float(err.max()):.3e}"
              f" ({worst:.2e} of its row's max), bit for bit K3 on the "
              f"transposed input; kernel {ms:.4f} ms, plain {plain:.3f} ms, "
              f"torch.linalg.inv {lib:.4f} ms, bound {bnd * 1e3:.3f} us "
              f"({by}: {why})", flush=True)
    print("  spd_inverse.cu by instantiation (width, batch-first): "
          + "; ".join(f"<{w}, {bf}> {res}" for w, bf, res in
                      k3_resources(build_log)), flush=True)
    return out


def k3_resources(build_log: str):
    """[(width, batch_first, 'N registers, S bytes stack frame, spill
    stores / loads')] of each spd_inverse_kernel instantiation in the
    build log's spd_inverse.cu section (ptxas -v)."""
    import re

    sec = build_log.split("== spd_inverse.cu", 1)[-1].split("\n==", 1)[0]
    out = []
    for m in re.finditer(
            r"Function properties for \S*spd_inverse_kernelILi(\d+)ELb([01])"
            r"\S*\s+(\d+) bytes stack frame, (\d+) bytes spill stores, "
            r"(\d+) bytes spill loads\s+ptxas info\s+: Used (\d+) registers",
            sec):
        w, bf, stack, st, ld, regs = m.groups()
        out.append((int(w), bf == "1", f"{regs} registers, {stack} B stack, "
                    f"{st} / {ld} B spilled"))
    return out


def per_env_inputs(B: int, seed: int, dev):
    """A Cassie batch as tests/test_fleet_parity.py draws it for the JAX
    package's tier-to-tier checks (qpos N(0, 0.01^2) around the standing
    pose, ball quaternions renormalized, qvel N(0, 0.1^2), controls
    N(0, 0.3^2)), lowered 3 cm so that the feet press into the floor, with
    randomized masses, damping, friction and an external wrench:
    batch-last qpos, qvel, ctrl and params on `dev`."""
    m = cassie_model()
    rng = np.random.default_rng(seed)
    qpos = CASSIE_QPOS_INIT[:, None] + 0.01 * rng.normal(size=(m.nq, B))
    qpos[2] -= 0.03
    for j in m.joints:
        if j.jtype.name == "BALL":
            q = qpos[j.qposadr:j.qposadr + 4]
            qpos[j.qposadr:j.qposadr + 4] = q / np.linalg.norm(q, axis=0)
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    params = PhysParams.from_model(m, B, dev)
    params.body_mass = params.body_mass * f32(
        rng.uniform(0.5, 1.5, (m.nbody, B)))
    params.dof_damping = params.dof_damping * f32(
        rng.uniform(0.5, 2.0, (m.nv, B)))
    params.friction = f32(rng.uniform(0.4, 1.1, B))
    params.ext_force = f32(5.0 * rng.normal(size=(6, B)))
    return (f32(qpos), f32(0.1 * rng.normal(size=(m.nv, B))),
            f32(0.3 * rng.normal(size=(m.nu, B))), params)


# the JAX package's per-field tolerances between its physics tiers
# (tests/test_fleet_parity.py:39-68): (rtol, atol)
STEPOUT_TOL = dict(qpos=(1e-4, 2e-5), qvel=(5e-2, 2e-2), qacc=(1e-1, 50.0),
                   force=(5e-2, 1.0), depth=(1e-4, 1e-6), pos=(1e-4, 1e-5),
                   xpos=(1e-4, 1e-5), xquat=(1e-4, 1e-5),
                   torque=(1e-5, 1e-6))


def per_env_vs_fleet(m, params, qpos, qvel, ctrl):
    """One substep of the batch through the per-env engine (K3-bf) and the
    fleet step (K2 + K3), at STEPOUT_TOL. Returns the largest difference
    of each output, the largest contact force and the launch counts of
    the per-env substep."""
    from apex_tpu_torch.physics import engine

    pbf = engine.params_batch_first(params)
    q, v, u = qpos.T.contiguous(), qvel.T.contiguous(), ctrl.T.contiguous()
    got, _, n = count_launches(lambda: engine.step(m, pbf, q, v, u))
    dyn, con, q2, v2, a2, tau = fleet.fleet_step(m, params, qpos, qvel, ctrl)
    bf = lambda x: torch.movedim(x, -1, 0)
    pairs = dict(qpos=(got.qpos, bf(q2)), qvel=(got.qvel, bf(v2)),
                 qacc=(got.qacc, bf(a2)), force=(got.contact.force,
                                                 bf(con.force)),
                 depth=(got.contact.depth, bf(con.depth)),
                 pos=(got.contact.pos, bf(con.pos)),
                 xpos=(got.kin.xpos, bf(dyn.kin.xpos)),
                 xquat=(got.kin.xquat, bf(fleet._mat2quat_bt(dyn.kin.ximat))),
                 torque=(got.actuator_torque, bf(tau)))
    out = {}
    for name, (a, b) in pairs.items():
        rtol, atol = STEPOUT_TOL[name]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"per-env substep: non-finite {name}")
        torch.testing.assert_close(
            a, b, rtol=rtol, atol=atol,
            msg=lambda t: f"per-env vs fleet substep {name}: {t}")
        out[name] = float((a - b).abs().max())
    return out, float(con.force[:, 2].max()), n


def walker_per_env_vs_fleet(dev, steps: int = 3):
    """Walker2d at WALKER_FLEET envs, `steps` env steps on the per-env tier
    (K3-bf) against the fleet tier (K2 + K3) from the same state and
    actions, counted (4 K3-bf per step, nothing else). The states are held
    to the per-substep tolerances plus four times the fleet tier's own
    spread over the same steps when its start state changes by random
    factors 1 +- 1e-7 (four draws): contact onsets amplify rounding over
    the 4 x `steps` substeps."""
    from apex_tpu_torch.envs.walker2d import WalkerState

    B = WALKER_FLEET
    gen = torch.Generator()
    gen.manual_seed(13)
    qpos, qvel, _ = walker_inputs(B, gen)
    acts = [0.5 * torch.randn(B, 6, generator=gen).to(dev)
            for _ in range(steps)]
    envs = {t: Walker2dEnv(device=dev, pd_tier=t)
            for t in ("per_env", "fleet")}

    def run(tier, q, v):
        st = WalkerState(q.to(dev), v.to(dev))
        for a in acts:
            st, _, _, _ = envs[tier].step(st, a, None)
        return st

    got, secs, n = count_launches(lambda: run("per_env", qpos, qvel))
    check_counts("walker per_env steps", n, {
        "K1": 0, "K1-hfield": 0, "K2": 0, "K3": 0, "K3-bf": 4 * steps})
    ref = run("fleet", qpos, qvel)
    spread_q, spread_v = torch.zeros_like(ref.qpos), torch.zeros_like(
        ref.qvel)
    for _ in range(4):
        jitter = lambda x: x * (1.0 + 1e-7 * (
            torch.randint(0, 2, x.shape, generator=gen) * 2.0 - 1.0))
        alt = run("fleet", jitter(qpos), jitter(qvel))
        spread_q = torch.maximum(spread_q, (alt.qpos - ref.qpos).abs())
        spread_v = torch.maximum(spread_v, (alt.qvel - ref.qvel).abs())
    out = {}
    for name, a, b, sp, (rtol, atol) in (
            ("qpos", got.qpos, ref.qpos, spread_q, STEPOUT_TOL["qpos"]),
            ("qvel", got.qvel, ref.qvel, spread_v, STEPOUT_TOL["qvel"])):
        err = (a - b).abs()
        bound = atol + rtol * b.abs() + 4 * sp
        if not (bool(torch.isfinite(a).all()) and bool((err <= bound).all())):
            i = int(torch.argmax(err - bound))
            raise AssertionError(
                f"Walker2d per_env vs fleet {name}: err "
                f"{float(err.flatten()[i]):.3e} > bound "
                f"{float(bound.flatten()[i]):.3e}")
        out[name] = float(err.max())
    return dict(out, ms_per_step=secs / steps * 1e3, launches=n)


def check_per_env(dev, fleet_return: float):
    """The per-env engine tier on the card: one Cassie substep at N_ENVS
    envs against the fleet tier (STEPOUT_TOL); the mk4_hardened evaluation
    on the per-env tier (N_ENVS envs, FLEET_TRAJ_LEN steps, seed 42),
    counted (K3-bf once per substep, nothing else), its return within
    EVAL_BOUND of the fleet tier's on the same draws (`fleet_return`),
    with its launches per substep from torch.profiler; Walker2d on the
    per-env tier against its fleet tier (`walker_per_env_vs_fleet`)."""
    m = cassie_model()
    qpos, qvel, ctrl, params = per_env_inputs(N_ENVS, 21, dev)
    sub_err, force, n = per_env_vs_fleet(m, params, qpos, qvel, ctrl)
    check_counts("per-env substep", n, {"K1": 0, "K1-hfield": 0, "K2": 0,
                                        "K3": 0, "K3-bf": 1})
    if not force > 0:
        raise AssertionError("per-env substep: no contact force in the batch")
    print("  per-env substep vs fleet (B=64): " + ", ".join(
        f"{k} {v:.3e}" for k, v in sub_err.items())
        + f"; max contact force {force:.1f} N", flush=True)

    ep_ret, ep_len, secs, n = run_eval("per_env", FLEET_TRAJ_LEN, 42)
    check_counts("eval per_env", n, {
        "K1": 0, "K1-hfield": 0, "K2": 0, "K3": 0,
        "K3-bf": FLEET_TRAJ_LEN * SIMRATE})
    if not abs(ep_ret - fleet_return) <= EVAL_BOUND * abs(fleet_return):
        raise AssertionError(f"eval per_env: return {ep_ret:.4f}, the fleet "
                             f"tier's {fleet_return:.4f} on the same draws")
    # launches per substep: one policy step of the evaluation's fleet
    exp = load_experiment(CKPT, device="cuda", physics="per_env")
    env = exp.env
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with torch.no_grad():
        state, obs = env.reset(env.sample_reset_noise(gen, N_ENVS))
        act = exp.actor.act(exp.norm, obs, deterministic=True)
        noise = env.sample_step_noise(gen, N_ENVS)
        busy_ms, kernels, launch_calls = profile_launches(
            lambda: env.step(state, act, noise))
    step_ms = secs / FLEET_TRAJ_LEN * 1e3
    print(f"  eval per_env: return {ep_ret:.4f} (fleet tier "
          f"{fleet_return:.4f}), length {ep_len:.2f}, "
          f"{step_ms:.2f} ms per policy step; one step: {launch_calls} "
          f"launch calls ({launch_calls / SIMRATE:.1f} per substep), "
          f"{kernels} kernels, device busy {busy_ms:.2f} ms", flush=True)
    walker = walker_per_env_vs_fleet(dev)
    print(f"  Walker2d per_env vs fleet (B={WALKER_FLEET}, 3 steps): qpos "
          f"{walker['qpos']:.3e}, qvel {walker['qvel']:.3e}; "
          f"{walker['ms_per_step']:.2f} ms per env step; "
          f"{walker['launches']}", flush=True)
    return n, dict(
        substep_max_err=json.dumps({k: f"{v:.3e}" for k, v in
                                    sub_err.items()}),
        mean_return=f"{ep_ret:.4f}", mean_length=f"{ep_len:.2f}",
        ms_per_policy_step=f"{step_ms:.2f}",
        launch_calls_per_substep=f"{launch_calls / SIMRATE:.1f}",
        device_busy_ms_per_policy_step=f"{busy_ms:.2f}",
        k3_bf_launches=n["K3-bf"],
        walker_ms_per_step=f"{walker['ms_per_step']:.2f}")


ANALYSIS_STEPS = 20          # input_and_state_record's rollout
PERTURB_SCHEDULE = dict(wait_steps=4, perturb_steps=4, recover_steps=8,
                        phases=[0, 16])


def check_analysis(dev):
    """`runtime/analysis.py` and `runtime/profiling.py` on mk4_hardened on
    the megakernel tier at a small size: input_and_state_record
    (ANALYSIS_STEPS steps at 2 m/s) and perturb_response (4 angles x 2
    phases, PERTURB_SCHEDULE) finite and in the JAX package's shapes,
    counted (K1 once per substep; K2 at the reset, at the pinned state's
    observation and once per step for the pre-step foot positions); and
    profiling.trace around one policy step: its Chrome trace holds the
    annotated region and the step's SIMRATE K1 launches. The profiler
    drops the first kernels of a window, more the longer the process has
    run, and its padded window still does now and then
    (scripts/trace_window.py): a trace that misses launches is printed
    and taken again, up to TRACE_ATTEMPTS traces, and then the run fails."""
    from apex_tpu_torch.runtime import analysis, profiling

    exp = load_experiment(CKPT, device="cuda")
    env = exp.env

    def policy(obs):
        return exp.actor.act(exp.norm, obs, deterministic=True)

    counts = lambda steps: {"K1": SIMRATE * steps, "K1-hfield": 0,
                            "K2": steps + 2, "K3": 0}
    rec, secs_rec, n = count_launches(lambda: analysis.input_and_state_record(
        env, policy, n_steps=ANALYSIS_STEPS, speed=2.0))
    check_counts("input_and_state_record", n, counts(ANALYSIS_STEPS))
    T = ANALYSIS_STEPS
    shapes = dict(qpos=(T, 35), reward=(T,), fallen=(T,), est_lfoot=(T, 3),
                  est_rfoot=(T, 3), true_lfoot=(T, 3), true_rfoot=(T, 3))
    for k, shape in shapes.items():
        if rec[k].shape != shape or not np.isfinite(
                rec[k].astype(np.float64)).all():
            raise AssertionError(f"input_and_state_record {k}: shape "
                                 f"{rec[k].shape}, want {shape}, or "
                                 "non-finite")
    pr, secs_pr, n_pr = count_launches(lambda: analysis.perturb_response(
        env, policy, **PERTURB_SCHEDULE))
    total = sum(v for k, v in PERTURB_SCHEDULE.items() if k != "phases")
    check_counts("perturb_response", n_pr, counts(total))
    if (pr["pelvis"].shape != (4, 2, total, 7)
            or pr["fallen_seq"].shape != (4, 2, total)
            or pr["survived"].shape != (4, 2)
            or not np.isfinite(pr["pelvis"]).all()):
        raise AssertionError(f"perturb_response: shapes {pr['pelvis'].shape}"
                             f" {pr['fallen_seq'].shape} "
                             f"{pr['survived'].shape} or non-finite")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with torch.no_grad():
        state, obs = env.reset(env.sample_reset_noise(gen, N_ENVS))
        noise = env.sample_step_noise(gen, N_ENVS)
    for attempt in range(TRACE_ATTEMPTS):
        with torch.no_grad(), tempfile.TemporaryDirectory() as d:
            with profiling.trace(d) as t:
                with profiling.annotate("policy_step"):
                    env.step(state, policy(obs), noise)
            with open(t.path) as f:
                events = json.load(f)["traceEvents"]
        k1_in_trace = sum(1 for e in events if e.get("cat") == "kernel"
                          and "pd_substep_kernel" in e.get("name", ""))
        annotated = any(e.get("name") == "policy_step" for e in events)
        held = (f"annotated region {annotated}, K1 launches in the trace "
                f"{k1_in_trace}, want {SIMRATE}")
        if annotated and k1_in_trace == SIMRATE:
            break
        print(f"  profiling.trace: trace {attempt + 1} refused: {held}",
              flush=True)
    else:
        raise AssertionError(f"profiling.trace: {TRACE_ATTEMPTS} traces "
                             f"refused, the last: {held}")
    print(f"  input_and_state_record: {T} steps in {secs_rec:.2f} s, "
          f"est_lfoot_err {float(rec['est_lfoot_err']):.3e}, falls "
          f"{int(rec['fallen'].sum())}; perturb_response: "
          f"{pr['pelvis'].shape}, survived {int(pr['survived'].sum())} of 8 "
          f"in {secs_pr:.2f} s; trace: {k1_in_trace} K1 launches, "
          f"{len(events)} events", flush=True)
    return dict(record_s=f"{secs_rec:.2f}", perturb_s=f"{secs_pr:.2f}",
                k1_launches=n["K1"] + n_pr["K1"],
                k2_launches=n["K2"] + n_pr["K2"],
                trace_k1_launches=k1_in_trace, traces=attempt + 1)


# the tools phase: the divergence run's checkpoint, fleet and depth; the
# other Cassie tools' fleet, depth and run
TOOLS_CKPT = "curves/cassie_mk5a_ckpt"
TOOL_ENVS, TOOL_STEPS, TOOL_RECORD_STEPS = 8, 2, 20
# the aslip run of the tools phase: one `ppo` iteration of CassieTraj-v0
ASLIP_PPO = ["ppo", "--traj", "aslip", "--num_procs", "16", "--num_steps",
             "64", "--max_traj_len", "4", "--n_itr", "1",
             "--input_norm_steps", "16", "--minibatch_size", "16", "--seed",
             "0"]
ASLIP_PPO_STEPS = 16 // 16 + 64 // 16 + 4
ASLIP_IDX = 10             # the aslip gait of footplace and taskspace


def run_tool(name: str, argv, counted: bool = True):
    """scripts/<name>.py's main(argv) in-process on the card, its printed
    lines shown and kept: (result, seconds, launches or None, lines)."""
    import io

    buf = io.StringIO()
    fn = lambda: load_script(name).main(argv)
    with contextlib.redirect_stdout(buf):
        if counted:
            result, secs, n = count_launches(fn)
        else:
            t0 = time.time()
            result, n = fn(), None
            secs = time.time() - t0
    text = buf.getvalue()
    print("".join(f"    {line}\n" for line in text.splitlines()), end="",
          flush=True)
    return result, secs, n, text.splitlines()


def job_counts(steps: int, simrate: int = SIMRATE):
    """Launches of an analysis job's rollout of `steps` steps on the
    megakernel tier: K1 every substep; K2 at the reset, at the pinned
    state's observation and once a step (the pre-step foot positions)."""
    return {"K1": simrate * steps, "K1-hfield": 0, "K2": steps + 2, "K3": 0}


def finite_npz(path: str, keys: set, what: str):
    with np.load(path) as f:
        if set(f.files) != keys or not all(
                np.isfinite(f[k].astype(np.float64)).all() for k in f.files):
            raise AssertionError(f"{what}: keys {sorted(f.files)}, want "
                                 f"{sorted(keys)}, or non-finite values")
        return {k: f[k].shape for k in f.files}


def plotted(lines, what: str) -> str:
    """The plot line a tool ends with: the figure written or, without
    matplotlib (the card's machine), skipped."""
    if not (lines and (lines[-1].startswith("wrote ")
                       or lines[-1].startswith("(plot skipped: "))):
        raise AssertionError(f"{what}: last line {lines[-1:]}")
    return "written" if lines[-1].startswith("wrote ") else "skipped"


def tool_divergence():
    """torch_megakernel_divergence.py on mk5a, TOOL_ENVS x TOOL_STEPS, all
    three tiers: each tier's launches exactly (the script counts each),
    the JAX tool's JSON keys, and the fleet and per-env returns within
    EVAL_BOUND of the megakernel tier's."""
    (res, launches), secs, _, _ = run_tool(
        "torch_megakernel_divergence", [TOOLS_CKPT, "--envs",
                                        str(TOOL_ENVS), "--steps",
                                        str(TOOL_STEPS)], counted=False)
    T, S = TOOL_STEPS, SIMRATE
    want = {"megakernel": {"K1": T * S, "K1-hfield": 0, "K2": 2 * T + 1,
                           "K3": 0},
            "fleet": {"K1": 0, "K1-hfield": 0, "K2": T * (S + 2) + 1,
                      "K3": T * S},
            "per-env": {"K1": 0, "K1-hfield": 0, "K2": 0, "K3": 0,
                        "K3-bf": T * S}}
    for mode, w in want.items():
        check_counts(f"tools megakernel_divergence {mode}", launches[mode], w)
    out = res["results"]
    if set(res) != {"ckpt", "envs", "steps", "results",
                    "return_rel_delta_vs_megakernel"} or any(
            not np.isfinite(r["return"]) or r["episodes"] != TOOL_ENVS
            for r in out.values()):
        raise AssertionError(f"tools megakernel_divergence: {res}")
    deltas = res["return_rel_delta_vs_megakernel"]
    if not all(d <= EVAL_BOUND for d in deltas.values()):
        raise AssertionError(f"tools megakernel_divergence: tiers {deltas} "
                             f"apart, beyond {EVAL_BOUND}")
    return dict(seconds=f"{secs:.1f}", deltas=deltas,
                returns={m: r["return"] for m, r in out.items()},
                launches={m: {k: v for k, v in n.items() if v}
                          for m, n in launches.items()})


def tool_estimator():
    """torch_estimator_divergence.py on mk4_hardened, TOOL_ENVS episodes x
    TOOL_STEPS steps, its five rows on the megakernel tier: K1 every
    substep, K2 at each row's reset and once a step; the rows "exact" and
    "firmware tau=12ms" one configuration, one return (limit (k))."""
    (rows, raw), secs, n, _ = run_tool(
        "torch_estimator_divergence", [CKPT, "--episodes", str(TOOL_ENVS),
                                       "--steps", str(TOOL_STEPS)])
    R = len(rows)
    check_counts("tools estimator_divergence", n, {
        "K1": R * TOOL_STEPS * SIMRATE, "K1-hfield": 0,
        "K2": R * (TOOL_STEPS + 1), "K3": 0})
    if R != 5 or not np.isfinite(raw).all() or raw[0] != raw[1]:
        raise AssertionError(f"tools estimator_divergence: rows {rows}")
    return dict(seconds=f"{secs:.1f}", returns=[f"{r:.4f}" for r in raw])


def tool_mirror():
    """torch_mirror_policy_check.py on mk4_hardened, TOOL_STEPS steps of 16
    envs: the evaluation's launches (K1 every substep, K2 twice a step and
    at the reset), a finite distance per state."""
    err, secs, n, lines = run_tool("torch_mirror_policy_check",
                                   [CKPT, "--steps", str(TOOL_STEPS)])
    check_counts("tools mirror_policy_check", n, {
        "K1": TOOL_STEPS * SIMRATE, "K1-hfield": 0, "K2": 2 * TOOL_STEPS + 1,
        "K3": 0})
    if err.shape != (16 * TOOL_STEPS,) or not np.isfinite(err).all() or \
            not lines[-1].startswith(f"mirror consistency over {err.size}"):
        raise AssertionError(f"tools mirror_policy_check: {err}, {lines}")
    return dict(seconds=f"{secs:.1f}", mean=f"{err.mean():.4f}",
                max=f"{err.max():.4f}")


def tool_vis(d: str):
    """torch_vis_perturb.py (its defaults: 4 angles, phase 0, 208 steps) and
    torch_vis_input_and_state.py (TOOL_RECORD_STEPS steps) on mk4_hardened:
    launches as the jobs' (`job_counts`), the npz files in the JAX tools'
    keys and shapes, finite."""
    out = {}
    res, secs, n, lines = run_tool("torch_vis_perturb", [
        CKPT, "--out", os.path.join(d, "vis_perturb.png")])
    total = res["pelvis"].shape[2]
    check_counts("tools vis_perturb", n, job_counts(total))
    shapes = finite_npz(os.path.join(d, "vis_perturb.npz"), {
        "angles", "phases", "force", "pelvis", "fallen_seq", "survived",
        "push_window"}, "tools vis_perturb")
    if shapes["pelvis"] != (4, 1, total, 7) or total != 208:
        raise AssertionError(f"tools vis_perturb: shapes {shapes}")
    out["vis_perturb"] = dict(seconds=f"{secs:.1f}", plot=plotted(
        lines, "vis_perturb"), survived=int(res["survived"].sum()))
    T = TOOL_RECORD_STEPS
    rec, secs, n, lines = run_tool("torch_vis_input_and_state", [
        CKPT, "--steps", str(T), "--out", os.path.join(d, "vis_state.png")])
    check_counts("tools vis_input_and_state", n, job_counts(T))
    shapes = finite_npz(os.path.join(d, "vis_state.npz"), {
        "qpos", "reward", "fallen", "est_lfoot", "est_rfoot", "true_lfoot",
        "true_rfoot", "est_lfoot_err", "est_rfoot_err"},
        "tools vis_input_and_state")
    if shapes["qpos"] != (T, 35):
        raise AssertionError(f"tools vis_input_and_state: shapes {shapes}")
    out["vis_input_and_state"] = dict(seconds=f"{secs:.1f}", plot=plotted(
        lines, "vis_input_and_state"))
    return out


def tool_aslip(d: str):
    """torch_aslip_tests.py on an aslip run of one `ppo` iteration of
    CassieTraj-v0 (`--traj aslip`, counted as train_new_envs counts): grf
    (one cycle after three, on the run as the JAX tool loads it: the
    walking gait library, 33-step cycles), and footplace and taskspace
    with --keep-traj (gait ASLIP_IDX, 32-step cycles; without it they stop
    at "requires an aslip run" as in JAX, limit (l)); each counted as the
    jobs' rollouts (`job_counts`, three, two and one envs)."""
    out = {}

    def subcommands(run_dir):
        prof, secs, n, lines = run_tool("torch_aslip_tests", [
            "grf", run_dir, "--cycles", "1", "--out",
            os.path.join(d, "grf.png")])
        check_counts("tools aslip grf", n, job_counts(4 * 33))
        shapes = finite_npz(os.path.join(d, "grf.npz"), {
            "mean", "std", "cycles_used", "cycle_steps"}, "tools aslip grf")
        if shapes["mean"] != (33 * SIMRATE, 2):
            raise AssertionError(f"tools aslip grf: shapes {shapes}")
        out["grf"] = dict(seconds=f"{secs:.1f}", plot=plotted(lines, "grf"),
                          cycles_used=int(prof["cycles_used"]))
        try:
            run_tool("torch_aslip_tests", ["footplace", run_dir])
        except AssertionError as e:
            if "requires an aslip run" not in str(e):
                raise
        else:
            raise AssertionError("tools aslip footplace ran on the walking "
                                 "gait library")
        rows, secs, n, _ = run_tool("torch_aslip_tests", [
            "footplace", run_dir, "--keep-traj", "--traj-idx",
            str(ASLIP_IDX), "--steps", "1", "--trials", "2"])
        check_counts("tools aslip footplace", n, job_counts(5 * 32))
        out["footplace"] = dict(seconds=f"{secs:.1f}",
                                footsteps=rows[0]["n_footsteps"])
        rows, secs, n, _ = run_tool("torch_aslip_tests", [
            "taskspace", run_dir, "--keep-traj", "--speeds", str(ASLIP_IDX),
            "--out", os.path.join(d, "taskspace.npz")])
        check_counts("tools aslip taskspace", n, job_counts(8 * 32))
        with np.load(os.path.join(d, "taskspace.npz")) as f:
            if f.files != ["rows"] or f["rows"].shape != (1, 4):
                raise AssertionError(f"tools aslip taskspace: {dict(f)}")
        out["taskspace"] = dict(seconds=f"{secs:.1f}",
                                survived=rows[0]["survived"])

    steps = ASLIP_PPO_STEPS
    run_cli(ASLIP_PPO, "CassieTraj-v0", {
        "K1": SIMRATE * steps, "K1-hfield": 0, "K2": 2 * steps + 3,
        "K3": 0}, then=subcommands)
    return out


def tool_mission(d: str):
    """torch_make_mission.py into `d`, read back through the port's mission
    loader (`envs/trajectory.CommandTrajectory`) as its build_mission
    made it."""
    from apex_tpu_torch.envs import trajectory

    waypoints = "0,0 5,0 5,5 10,5"
    path, secs, _, _ = run_tool("torch_make_mission", [
        "--name", "smoke", "--speed", "1.4", "--waypoints", waypoints,
        "--out", d], counted=False)
    pts = np.array([[float(v) for v in w.split(",")]
                    for w in waypoints.split()])
    want = load_script("torch_make_mission").build_mission(pts, 1.4)
    own = trajectory.DATA_DIR
    trajectory.DATA_DIR = pathlib.Path(d)
    try:
        got = trajectory.CommandTrajectory("smoke")
    finally:
        trajectory.DATA_DIR = own
    if not all(np.array_equal(a, b) for a, b in zip(
            (got.global_pos, got.speed_cmd, got.orient), want)):
        raise AssertionError("tools make_mission: the loader read other "
                             "values than build_mission's")
    return dict(steps=got.trajlen, path=os.path.basename(path))


def tool_plots(d: str):
    """torch_plot_policy.py on a record of `evaluate.record_policy` and a
    fleet dump of `eval_checkpoint(out=...)` (eval --out), and
    torch_render_gait.py on `evaluate.dump_gait`'s qpos (eval --gait):
    its frames' body origins from one K2 launch, finite."""
    from apex_tpu_torch.runtime import evaluate

    rec, dump, gait = (os.path.join(d, f) for f in (
        "record.npz", "traj.npz", "gait.npz"))
    evaluate.record_policy(CKPT, out=rec, n_steps=10, device="cuda")
    eval_checkpoint(CKPT, n_episodes=TOOL_ENVS, traj_len=TOOL_STEPS,
                    device="cuda", out=dump)
    evaluate.dump_gait(CKPT, out=gait, n_steps=10, device="cuda")
    out = {}
    for name, src in (("record", rec), ("dump", dump)):
        _, _, _, lines = run_tool("torch_plot_policy", [
            src, "--out", os.path.join(d, f"{name}.png")], counted=False)
        out[f"plot_policy_{name}"] = plotted(lines, f"plot_policy {name}")
    (idx, xpos), secs, n, lines = run_tool("torch_render_gait", [
        gait, "--out", os.path.join(d, "gait.png")])
    check_counts("tools render_gait", n, {"K1": 0, "K1-hfield": 0, "K2": 1,
                                          "K3": 0})
    if xpos.shape != (8, 25, 3) or not np.isfinite(xpos).all():
        raise AssertionError(f"tools render_gait: {xpos.shape}")
    out["render_gait"] = dict(plot=plotted(lines, "render_gait"),
                              k2_launches=n["K2"])
    return out


def check_tools():
    """The nine `scripts/torch_<tool>.py` front ends in-process on the card
    at a small size, each counted exactly and its output checked in the
    JAX tool's keys and shapes."""
    out = {}
    os.makedirs("chiprun_out", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="chiprun_out") as d:
        for name, fn in (("megakernel_divergence", tool_divergence),
                         ("estimator_divergence", tool_estimator),
                         ("mirror_policy_check", tool_mirror),
                         ("vis", lambda: tool_vis(d)),
                         ("aslip_tests", lambda: tool_aslip(d)),
                         ("make_mission", lambda: tool_mission(d)),
                         ("plots", lambda: tool_plots(d))):
            out[name] = fn()
            print(f"  tools {name}: {out[name]}", flush=True)
    return out


def check_k2(gen, dev, build_log: str):
    """K2 against its plain version on a perturbed dyn-rand fleet, and on
    `fk_tree_model`'s tree."""
    m = cassie_model()
    tree = fk_tree_model()
    tree_gen = torch.Generator()  # leaves `gen`'s draws to later phases
    tree_gen.manual_seed(1)
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
        ms = device_ms(lambda: fleet_fk.fleet_fk(m, ipos, qpos), 100,
                       "fleet_fk_kernel")
        plain = cuda_ms(lambda: fleet_fk.fk_plain(m, ipos, qpos), 3, 1)
        rows = m.nq + 3 * m.nbody + (3 + 9 + 3) * m.nbody + 6 * m.nv
        bnd, by, why = bound_ms(rows * B * 4, fk_flops_per_env(m) * B)
        out[B] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                      bound_by=by)
        tq, tip = fk_tree_inputs(tree, B, tree_gen)
        tq, tip = tq.to(dev), tip.to(dev)
        got = fleet_fk.fleet_fk(tree, tip, tq)
        ref = fleet_fk.fk_plain(tree, tip, tq)
        torch.cuda.synchronize()
        for name, a, b in zip(got._fields, got, ref):
            torch.testing.assert_close(
                a, b, rtol=1e-5, atol=1e-5,
                msg=lambda s: f"K2 tree {name} B={B}: {s}")
        tree_err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        print(f"  K2 B={B}: max err {err:.3e} (tree {tree_err:.3e}); kernel "
              f"{ms:.4f} ms, plain {plain:.3f} ms, bound {bnd * 1e3:.3f} us "
              f"({by}: {why})", flush=True)
    print(f"  K2 {build_report(build_log, 'fleet_fk.cu')}; launch: a warp per "
          f"env, {fleet_fk.launch_info(m)}", flush=True)
    return out


def add_terrain(qpos, params, gen: torch.Generator, amplitude: float):
    """Heightfield terrain for a CPU fleet, in place: tables of the env's
    bank at `amplitude`, noise for the even envs and steps for the odd,
    hfield_active 0 for every fourth env (the plane), and every eighth env
    moved to within 0.6 m of the table's edge at +-10 m, or past it (the
    lookup's clip)."""
    B = qpos.shape[-1]
    env = torch.arange(B)
    idx = torch.randint(0, 64, (B,), generator=gen)
    tables = torch.where((env % 2 == 0)[:, None, None],
                         terrain_bank("noise", amplitude)[idx],
                         terrain_bank("steps", amplitude)[idx])
    params.hfield = tables.permute(1, 2, 0).contiguous()
    params.hfield_active = (env % 4 != 3).float()
    edge = env % 8 == 5
    sign = torch.where(torch.rand(2, int(edge.sum()), generator=gen) < 0.5,
                       -1.0, 1.0)
    qpos[0:2, edge] = sign * (9.4 + 1.2 * torch.rand(
        2, int(edge.sum()), generator=gen))


def k1_inputs(B: int, gen: torch.Generator, dev, terrain: float = 0.0):
    """`cassie_inputs`, with every other env lowered 2 cm into the floor so
    that contact forces are nonzero, friction U(0.4, 1.1), the floor tilted
    by up to 0.03 rad, an external wrench on the pelvis, and PD targets
    0.1 rad around the motor positions at the default gains; with
    `terrain`, on `add_terrain`'s terrain of that amplitude."""
    m = cassie_model()
    qpos, qvel, params = cassie_inputs(B, gen)
    qpos[2, 1::2] -= 0.02
    params.friction = 0.4 + 0.7 * torch.rand(B, generator=gen)
    half = 0.015 * (2 * torch.rand(2, B, generator=gen) - 1)
    params.floor_quat = torch.stack([
        torch.cos(half[0]) * torch.cos(half[1]),
        torch.sin(half[0]) * torch.cos(half[1]),
        torch.cos(half[0]) * torch.sin(half[1]),
        -torch.sin(half[0]) * torch.sin(half[1])])
    params.ext_force = 20.0 * torch.randn(6, B, generator=gen)
    target = qpos[torch.as_tensor(MOTOR_QPOS_IDX)] + 0.1 * torch.randn(
        m.nu, B, generator=gen)
    if terrain:
        add_terrain(qpos, params, gen, terrain)
    return k1_to(dev, qpos, qvel, params, target)


def k1_to(dev, qpos, qvel, params, target):
    cmd = PDCommand.from_targets(target)
    rows = torch.cat([cmd.p_target, cmd.d_target, cmd.p_gain, cmd.d_gain,
                      cmd.ff_torque])
    to = lambda p: PhysParams(**{k: v.to(dev).contiguous()
                                 for k, v in vars(p).items()})
    return (to(params), qpos.to(dev).contiguous(),
            qvel.to(dev).contiguous(), rows.to(dev).contiguous())


def k1_standing_inputs(B: int, gen: torch.Generator, dev, params=None,
                       terrain: float = 0.0):
    """The inputs of tools/check_megakernel.py: the standing pose with
    0.005 qpos and 0.05 qvel noise, PD targets N(0, 0.05^2), default
    parameters unless `params` (CPU) are given; the even envs (env 0 too,
    so B = 1 is in contact) lowered 2 cm into contact; with `terrain`, on
    `add_terrain`'s terrain of that amplitude."""
    m = cassie_model()
    qpos = torch.tensor(CASSIE_QPOS_INIT, dtype=torch.float32)[:, None] \
        + 0.005 * torch.randn(m.nq, B, generator=gen)
    qpos[2, 0::2] -= 0.02
    for j in m.joints:
        if j.jtype.name == "BALL":
            q = qpos[j.qposadr:j.qposadr + 4]
            qpos[j.qposadr:j.qposadr + 4] = q / q.norm(dim=0)
    qvel = 0.05 * torch.randn(m.nv, B, generator=gen)
    if params is None:
        params = PhysParams.from_model(m, B, torch.device("cpu"))
    target = 0.05 * torch.randn(m.nu, B, generator=gen)
    if terrain:
        add_terrain(qpos, params, gen, terrain)
    return k1_to(dev, qpos, qvel, params, target)


def k1_vs_plain(m, params, qpos, qvel, rows, gen, what: str, got=None):
    """K1 against `pd_substep_plain` on the same inputs, each output held
    elementwise to `fleet_kernel.kernel_bounds`. Returns, per output, (max
    abs error, largest error over its bound), the plain version's ms (one
    unjittered call, host clock) and the largest contact force. `got` is
    the kernel's output where the caller launched it (K1-part)."""
    if got is None:
        got = fleet_kernel.pd_substep(m, params, qpos, qvel, rows)
    torch.cuda.synchronize()
    t0 = time.time()
    fleet_kernel.pd_substep_plain(m, params, qpos, qvel, rows)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    ref, spread = fleet_kernel.plain_spread(m, params, qpos, qvel, rows,
                                            gen)
    bounds = fleet_kernel.kernel_bounds(ref, spread)
    worst = {}
    for name, a, b, bound in zip(("qpos", "qvel", "qacc", "diag"), got,
                                 ref, bounds):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"K1 {what}: non-finite {name}")
        ratio = (a - b).abs() / bound
        worst[name] = (float((a - b).abs().max()), float(ratio.max()))
        if not worst[name][1] <= 1.0:
            r, c = np.unravel_index(int(ratio.argmax()), ratio.shape)
            raise AssertionError(
                f"K1 {what} {name}[{r}, {c}]: err "
                f"{float((a - b).abs()[r, c]):.3e}, {worst[name][1]:.2f} x "
                f"its bound")
    force = float(ref[3][0:2].abs().max())
    if not force > 0:
        raise AssertionError(f"K1 {what}: no contact force in the fleet")
    return worst, plain_ms, force


def k1_vs_fleet(m, params, qpos, qvel, rows, what: str):
    """K1 against the fleet step at the JAX package's tolerances
    (tools/check_megakernel.py:80-91) on the same inputs."""
    dev = qpos.device
    k1 = fleet_kernel.pd_substep(m, params, qpos, qvel, rows)
    gear = torch.tensor([a.gear for a in m.actuators], device=dev)[:, None]
    mq = torch.as_tensor(MOTOR_QPOS_IDX, device=dev)
    mv = torch.as_tensor(MOTOR_QVEL_IDX, device=dev)
    nu = m.nu
    tau = (rows[2 * nu:3 * nu] * (rows[:nu] - qpos[mq])
           + rows[3 * nu:4 * nu] * (rows[nu:2 * nu] - qvel[mv])
           + rows[4 * nu:])
    _, con, fq, fv, fa, _ = fleet.fleet_step(m, params, qpos, qvel,
                                             tau / gear)
    lcon = [i for i, c in enumerate(m.contacts) if c.group == 0]
    l_frc = sum(con.force[i, 2] for i in lcon)
    vs_fleet = {
        "qpos": (float((k1[0] - fq).abs().max()), 2e-5),
        "qvel": (float((k1[1] - fv).abs().max()), 2e-2),
        "qacc": (float((k1[2] - fa).abs().max()), 60.0),
        "l_frc": (float((k1[3][0] - l_frc).abs().max()), 2.0)}
    for name, (d, tol) in vs_fleet.items():
        if not d < tol:
            raise AssertionError(f"{what} vs fleet {name}: {d:.3e} >= {tol}")
    return vs_fleet


def check_k1(gen, dev, build_log: str, terrain: float = 0.0):
    """K1 against its plain version and against the fleet step. The
    perturbed fleet reaches contact, tilt, friction and wrench branches,
    but its loose achilles rods (up to ~3e3 rad/s) widen each row's bound;
    near the standing pose every env is calm, so the same rule is tight.
    With `terrain`, the heightfield model on terrain of that amplitude
    (the standing fleet at half of it), and the plane envs of the
    heightfield launch against the flat kernel's, bit for bit."""
    m = cassie_model(enable_hfield=bool(terrain))
    tag = "K1-hfield" if terrain else "K1"
    out = {}
    for B in (N_ENVS, FLEET):
        params, qpos, qvel, rows = k1_inputs(B, gen, dev, terrain)
        worst, plain_ms, force = k1_vs_plain(m, params, qpos, qvel, rows,
                                             gen, f"{tag} B={B}")
        # the lanes of a warp share the env's scratch: a race between two
        # phases would make repeated launches differ
        first = fleet_kernel.pd_substep(m, params, qpos, qvel, rows)
        for _ in range(4):
            again = fleet_kernel.pd_substep(m, params, qpos, qvel, rows)
            if not all(torch.equal(a, b) for a, b in zip(again, first)):
                raise AssertionError(f"{tag} B={B}: five launches on the "
                                     "same inputs differ")
        params_s, qpos_s, qvel_s, rows_s = k1_standing_inputs(
            B, gen, dev, terrain=terrain / 2)
        worst_s, _, _ = k1_vs_plain(m, params_s, qpos_s, qvel_s, rows_s,
                                    gen, f"{tag} standing B={B}")
        vs_fleet = k1_vs_fleet(m, params_s, qpos_s, qvel_s, rows_s,
                               f"{tag} B={B}")
        extra = ""
        if terrain:
            got = fleet_kernel.pd_substep(m, params, qpos, qvel, rows)
            flat = fleet_kernel.pd_substep(cassie_model(), params, qpos,
                                           qvel, rows)
            plane = params.hfield_active == 0
            if not all(torch.equal(a[:, plane], b[:, plane])
                       for a, b in zip(got, flat)):
                raise AssertionError(f"{tag} B={B}: the plane envs differ "
                                     "from the flat kernel's")
            moved = float((got[1][:, ~plane] - flat[1][:, ~plane]).abs()
                          .max())
            extra = (f"; plane envs bitwise equal to the flat kernel, "
                     f"terrain envs' qvel moved up to {moved:.3e}")

        ms = device_ms(lambda: fleet_kernel.pd_substep(m, params, qpos, qvel,
                                                       rows), 20,
                       "pd_substep_kernel")
        bnd, by, why = bound_ms(k1_bytes(m, params), k1_flops(m, params))
        out[B] = dict(max_abs_err=max(v[0] for v in (*worst.values(),
                                                      *worst_s.values())),
                      ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                      library_ms=None)
        print(f"  {tag} B={B}: vs plain (max err, x bound) "
              + ", ".join(f"{k} {v[0]:.3e} {v[1]:.2f}"
                          for k, v in worst.items())
              + f"; max contact force {force:.1f} N; standing pose vs "
              "plain " + ", ".join(f"{k} {v[0]:.3e} {v[1]:.2f}"
                                   for k, v in worst_s.items())
              + "; vs fleet "
              + ", ".join(f"{k} {d:.3e} (tol {t})"
                          for k, (d, t) in vs_fleet.items())
              + f"{extra}; five launches bitwise equal; kernel {ms:.4f} "
              f"ms, plain {plain_ms:.1f} ms, "
              f"bound {bnd * 1e3:.3f} us ({by}: {why}), library none",
              flush=True)
    info = fleet_kernel.launch_info(m)
    print(f"  {tag} {build_report(build_log, 'fleet_kernel.cu')}; launch: "
          "two warps per env, "
          + ", ".join(f"{k} {v}" for k, v in info.items()), flush=True)
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


def check_k1_gains(dev):
    """K1 against its plain version with per-env PD gains, as a policy with
    learned gains (CassieEnv learn_gains) hands them to K1's gain rows: the
    defaults plus N(0, 40^2) on the p gains and N(0, 8^2) on the d gains,
    so that some p and about a quarter of the d gains are negative, on the
    perturbed fleet and near the standing pose, at B = 64 (the gain rows
    are per env: K1 at 1024 is held with the default gains); held per row
    to the plain version's rounding spread as `check_k1` holds the
    default gains. Its own generator: no other phase's draws move."""
    gen = torch.Generator()
    gen.manual_seed(11)
    m = cassie_model()
    nu = m.nu
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))[:, None]
    out = {}
    for B in (N_ENVS,):
        for tag, make in (("perturbed", k1_inputs),
                          ("standing", k1_standing_inputs)):
            params, qpos, qvel, rows0 = make(B, gen, dev)
            gains = torch.cat([
                f32(DEFAULT_P_GAIN) + 40.0 * torch.randn(nu, B,
                                                         generator=gen),
                f32(DEFAULT_D_GAIN) + 8.0 * torch.randn(nu, B,
                                                        generator=gen)])
            rows = torch.cat([rows0[:2 * nu], gains.to(dev),
                              rows0[4 * nu:]]).contiguous()
            worst, _, force = k1_vs_plain(m, params, qpos, qvel, rows, gen,
                                          f"K1-gains {tag} B={B}")
            default = fleet_kernel.pd_substep(m, params, qpos, qvel, rows0)
            moved = float((fleet_kernel.pd_substep(
                m, params, qpos, qvel, rows)[1] - default[1]).abs().max())
            if not moved > 0:
                raise AssertionError(f"K1-gains {tag} B={B}: the gains do "
                                     "not reach the kernel")
            out[f"{tag}_{B}"] = dict(
                max_err_over_bound=max(v[1] for v in worst.values()),
                negative_p=int((gains[:nu] < 0).sum()),
                negative_d=int((gains[nu:] < 0).sum()),
                qvel_moved_from_default_gains=f"{moved:.3e}")
            print(f"  K1-gains {tag} B={B}: vs plain (max err, x bound) "
                  + ", ".join(f"{k} {v[0]:.3e} {v[1]:.2f}"
                              for k, v in worst.items())
                  + f"; {out[f'{tag}_{B}']['negative_d']} of {nu * B} d "
                  f"gains negative; max contact force {force:.1f} N",
                  flush=True)
    return out


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
        mv = lambda x: None if x is None else x.to(env.device)
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


def check_clock_5k():
    """`eval_suites.gait_clock_5k` on mk5c's env on the card and on the
    CPU: every schedule's phase, cycle count and clock length bit for
    bit. Returns the counts compared and the steps where the floor held
    the clock still."""
    seqs = {d: eval_suites.gait_clock_5k(
        load_experiment(TERRAIN_CKPTS["mk5c"][0], device=d).env)
        for d in ("cuda", "cpu")}
    steps = frozen = 0
    for name, cpu in seqs["cpu"].items():
        for what, a, b in zip(("phase", "counter", "phaselen"),
                              seqs["cuda"][name], cpu):
            if a.shape != b.shape or not np.array_equal(
                    a.view(np.int32), b.view(np.int32)):
                bad = np.flatnonzero(a != b)
                raise AssertionError(
                    f"clock_5k {name} {what}: the card differs from the "
                    f"CPU at {bad.size} steps, first {bad[:5].tolist()}")
        steps += cpu[0].size
        frozen += int((np.diff(cpu[0]) == 0).sum())
    return dict(schedules=len(seqs["cpu"]), steps=steps,
                frozen_steps=frozen, equal="bit for bit")


def check_counts(name, got, want):
    """Launch counts against what the path implies; a count dict's K3-bf
    is 0 unless `want` names it (only the per-env tier launches it), and so
    is its K1-part (only a rank's shard of a partitioned fleet)."""
    if isinstance(got, dict):
        want = {"K3-bf": 0, "K1-part": 0, **want}
    if got != want:
        raise AssertionError(f"{name}: launch counts {got}, want {want}")


def run_eval(physics, traj_len, seed, ckpt=CKPT):
    """The deterministic evaluation of a checkpoint on one tier, counted."""
    (ep_ret, ep_len), secs, n = count_launches(lambda: eval_checkpoint(
        ckpt, n_episodes=N_ENVS, traj_len=traj_len, device="cuda",
        seed=seed, physics=physics))
    if not (np.isfinite(ep_ret) and np.isfinite(ep_len) and ep_len > 0):
        raise AssertionError(f"eval ({physics}, seed {seed}) gave return "
                             f"{ep_ret}, length {ep_len}")
    return ep_ret, ep_len, secs, n


def eval_seeds(name, ckpt, simrate, hfield):
    """The 64-env, 300-step megakernel-tier evaluation of `ckpt` for each
    seed of its EARLIER_RETURNS, counted: K1 once per substep (each a
    heightfield launch on terrain), K2 once per step for the pre-step foot
    positions, once per step for the auto-reset fleet and once for the
    initial reset, K3 never. The returns must be bit for bit those of
    earlier runs (EARLIER_RETURNS). Returns the first seed's counts and a
    printable summary."""
    want = {"K1": TRAJ_LEN * simrate,
            "K1-hfield": TRAJ_LEN * simrate if hfield else 0,
            "K2": TRAJ_LEN * 2 + 1, "K3": 0}
    rets, lens, ms, first = [], [], [], None
    for seed in EARLIER_RETURNS[name]:
        ep_ret, ep_len, secs, n = run_eval("megakernel", TRAJ_LEN, seed,
                                           ckpt)
        check_counts(f"{name} seed {seed}", n, want)
        first = first or n
        rets.append(ep_ret)
        lens.append(ep_len)
        ms.append(secs / TRAJ_LEN * 1e3)
        print(f"  {name} seed {seed}: return {ep_ret!r}, length "
              f"{ep_len:.2f}, {ms[-1]:.2f} ms per policy step", flush=True)
        if ep_ret != EARLIER_RETURNS[name][seed]:
            raise AssertionError(
                f"{name} seed {seed}: return {ep_ret!r}, earlier runs gave "
                f"{EARLIER_RETURNS[name][seed]!r}")
    return dict(first, summary=dict(
        mean_return=f"{np.mean(rets):.4f}", mean_length=f"{np.mean(lens):.2f}",
        returns=[f"{r:.4f}" for r in rets],
        ms_per_policy_step=[f"{x:.2f}" for x in ms],
        k1_launches=first["K1"], k1_hfield_launches=first["K1-hfield"],
        k2_launches=first["K2"], k3_launches=first["K3"]))


def step_1024(dev):
    """ms per policy step of the 1024-env fleet on the megakernel tier, and
    launches and device busy time of one profiled step."""
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
        busy_ms, kernels, launch_calls = profile_launches(
            lambda: rollout_scan(env, policy_fn, runner, gen_dev, 1,
                                 TRAJ_LEN))
    return dict(ms_per_policy_step=f"{step_ms:.2f}",
                device_kernels_per_policy_step=kernels,
                launch_calls_per_policy_step=launch_calls,
                launches_per_substep=f"{launch_calls / SIMRATE:.1f}",
                device_busy_ms_per_policy_step=f"{busy_ms:.2f}",
                device_idle_share=f"{1.0 - busy_ms / step_ms:.4f}")


def draws_file(ckpt: str, folder: str = "curves/jax_eval_draws") -> str:
    """The file of JAX's evaluation draws for a run dir: its name without
    "cassie_" and "_ckpt" (or its DRAWS_NAMES entry)."""
    name = os.path.basename(os.path.normpath(ckpt))
    name = DRAWS_NAMES.get(name, name.removeprefix("cassie_")
                           .removesuffix("_ckpt"))
    return os.path.join(folder, name + ".npz")


@contextlib.contextmanager
def jax_draws(path: str):
    """The port's evaluation on the draws of JAX's (a file of
    `scripts/export_eval_draws.py`, or of `scripts/export_td3_draws.py`
    for Walker2d): while it is open, the Cassie and Walker2d envs draw
    their own reset and step noise as always, and every value JAX's run
    used takes JAX's place: the first fleet reset's, each auto-reset's rows
    of the envs JAX reset at that step, and each step's command changes
    (JAX's hit masks; its values where they hit; Walker2d's step draws
    nothing). Draws JAX never used (resets of envs that end at other steps
    than JAX's) stay the port's."""
    from apex_tpu_torch.envs.cassie_traj import CassieTrajEnv

    with np.load(path) as f:
        d = {k: f[k] for k in f}
    B, T = int(d["batch"]), int(d["steps"])
    masks = {k[len("step_"):]: np.unpackbits(v, axis=-1, count=B)
             .astype(bool) for k, v in d.items() if k.endswith("_hit")}
    hit_of = {"orient_delta": "orient_hit", "new_speed": "speed_hit",
              "new_side": "side_hit", "jump_size": "jump_hit",
              "jump_sign": "jump_hit"}
    values = {}
    for k, h in hit_of.items():
        if f"step_{k}" in d:
            full = np.zeros((T, B), d[f"step_{k}"].dtype)
            full[masks[h]] = d[f"step_{k}"]
            values[k] = full
    calls = {"reset": 0, "step": 0}
    saved = {cls: (cls.sample_reset_noise, cls.sample_step_noise)
             for cls in (CassieEnv, CassieTrajEnv, Walker2dEnv)}

    def put(noise, name, rows, vals):
        x = getattr(noise, name)
        x = x.clone()
        x[..., rows] = torch.as_tensor(np.moveaxis(vals, 0, -1),
                                       dtype=x.dtype, device=x.device)
        return noise._replace(**{name: x})

    def reset(own):
        def sample(self, generator, batch):
            assert batch == B
            noise = own(self, generator, batch)
            k = calls["reset"]
            calls["reset"] += 1
            if k == 0:
                rows, pre = np.arange(B), "reset0_"
                idx = slice(None)
            else:
                idx = d["reset_step"] == k - 1
                rows, pre = d["reset_env"][idx], "reset_"
            for name in noise._fields:
                if f"{pre}{name}" in d and len(rows):
                    noise = put(noise, name, rows, d[f"{pre}{name}"][idx])
            return noise
        return sample

    def step(own):
        def sample(self, generator, batch):
            noise = own(self, generator, batch)
            t = calls["step"]
            calls["step"] += 1
            if noise is None:
                return noise
            dev = noise.orient_hit.device
            new = {h: torch.as_tensor(masks[h][t], device=dev)
                   for h in ("orient_hit", "speed_hit", "side_hit")
                   if h in noise._fields}
            for k, v in values.items():
                if k in noise._fields:
                    new[k] = torch.where(
                        torch.as_tensor(masks[hit_of[k]][t], device=dev),
                        torch.as_tensor(v[t], device=dev,
                                        dtype=getattr(noise, k).dtype),
                        getattr(noise, k))
            if "jump_hit" in masks:
                # a jump lands where U[0, 1) < orient_jump_prob
                new["jump_u"] = torch.where(
                    torch.as_tensor(masks["jump_hit"][t], device=dev),
                    0.0, 1.0)
            return noise._replace(**new)
        return sample

    for cls, (own_reset, own_step) in saved.items():
        cls.sample_reset_noise = reset(own_reset)
        cls.sample_step_noise = step(own_step)
    try:
        yield calls
    finally:
        for cls, (own_reset, own_step) in saved.items():
            cls.sample_reset_noise, cls.sample_step_noise = (own_reset,
                                                             own_step)


def file_draws(path: str, env):
    """The `draws` function of `runtime/analysis.py`'s jobs, and of
    `scripts/torch_estimator_divergence.py`'s evaluation, on JAX's draws (a
    file of `scripts/export_tool_draws.py`): a call (seed, n_trials,
    n_steps) that the file holds takes every field the file gives from it
    (JAX's key splits of PRNGKey(seed) for that call); the fields it lacks
    stay the env's own samplers' on a torch.Generator seeded with `seed`.
    A call the file does not hold raises."""
    from apex_tpu_torch.runtime.analysis import generator_draws

    with np.load(path) as f:
        d = {k: f[k] for k in f}
    calls = {tuple(int(x) for x in v): k[:-len("call")]
             for k, v in d.items() if k.endswith("_call")}
    own = generator_draws(env)

    def put(noise, arrays):
        new = {}
        for name in noise._fields:
            x = getattr(noise, name)
            if name in arrays and x is not None:
                new[name] = torch.as_tensor(
                    np.moveaxis(arrays[name], 0, -1), dtype=x.dtype,
                    device=x.device).contiguous()
        return noise._replace(**new)

    def draws(seed, n_trials, n_steps):
        call = (int(seed), int(n_trials), int(n_steps))
        if call not in calls:
            raise KeyError(f"{path} holds no draws for (seed, trials, steps)"
                           f" = {call}, only for {sorted(calls)}")
        pre = calls[call]
        part = lambda kind: {k[len(pre + kind):]: v for k, v in d.items()
                             if k.startswith(pre + kind)}
        reset, steps = own(*call)
        st = part("step_")
        return put(reset, part("reset_")), [
            put(s, {k: v[t] for k, v in st.items()})
            for t, s in enumerate(steps)]
    return draws


def eval_switch_ckpts():
    """The 64-env, 300-step megakernel-tier evaluation of each checkpoint
    the CassieEnv switches unlock (SWITCH_CKPTS), counted as `eval_seeds`
    counts (CassieTraj-v0's step reads the pre-step foot positions through
    K2 too): at seed 42 on the draws of JAX's seed-42 run (`jax_draws`),
    held to JAX's seed-42 return within
    EVAL_BOUND, or within JAX's own seed spread (how far its seeds 0 and 1
    land from seed 42) where that is wider: over 300 steps the two stacks'
    rounding parts their trajectories (ROADMAP limit (a)), and a policy
    that falls often turns that into falls at other steps, as other draws
    do."""
    out = {}
    for name, (ckpt, simrate, (jax_ret, *others)) in SWITCH_CKPTS.items():
        want = {"K1": TRAJ_LEN * simrate, "K1-hfield": 0,
                "K2": TRAJ_LEN * 2 + 1, "K3": 0}
        path = draws_file(ckpt)
        with np.load(path) as f:
            if abs(float(f["jax_return"]) - jax_ret) > 1e-3:
                raise AssertionError(f"{path} holds another run than JAX's "
                                     f"seed-42 {jax_ret}")
        with jax_draws(path):
            ep_ret, ep_len, secs, n = run_eval("megakernel", TRAJ_LEN, 42,
                                               ckpt)
        check_counts(f"eval_{name} on JAX's draws", n, want)
        rel = (ep_ret - jax_ret) / jax_ret
        spread = max(abs(r - jax_ret) for r in others) / jax_ret
        bound = max(EVAL_BOUND, spread)
        print(f"  eval_{name}: on JAX's seed-42 draws {ep_ret!r}, JAX "
              f"{jax_ret} ({100 * rel:+.2f} %, bound {100 * bound:.2f} %: "
              f"JAX's seeds 0 and 1 at {100 * spread:.2f} %), length "
              f"{ep_len:.2f}; {secs / TRAJ_LEN * 1e3:.2f} ms per policy "
              f"step, K1 "
              f"{n['K1']}, K2 {n['K2']}", flush=True)
        if not abs(rel) <= bound:
            raise AssertionError(
                f"eval_{name}: return {ep_ret:.4f} on JAX's draws is "
                f"{100 * rel:+.2f} % from JAX's {jax_ret}, beyond "
                f"{100 * bound:.2f} %")
        out[name] = (f"{ep_ret:.4f} vs JAX {jax_ret} ({100 * rel:+.2f} %, "
                     f"bound {100 * bound:.2f} %)")
    return out


# one PPO iteration of each new env through the CLI: the fleet, steps per
# iteration, evaluation length and obs-norm steps
NEW_ENV_PPO = ["--num_procs", "256", "--num_steps", "2048",
               "--max_traj_len", "50", "--n_itr", "1", "--input_norm_steps",
               "512", "--minibatch_size", "256", "--seed", "0"]
NEW_ENVS = {
    "gains_history_min_clock": ("Cassie-v0", [
        "--learn_gains", "--history", "1", "--reward", "clock",
        "--input_profile", "min"]),
    "traj": ("CassieTraj-v0", ["--mirror"]),
    "standing": ("CassieStanding-v0", []),
}


def train_new_envs():
    """`python -m apex_tpu_torch ppo` for one iteration on Cassie-v0 with
    learned gains, a history, the min profile and the clock reward, on
    CassieTraj-v0 and on CassieStanding-v0 (the CLI's 50 substeps, the
    megakernel tier), counted: K1 once per substep of the 2 obs-norm, 8
    rollout and 50 evaluation steps; K2 once per step for the auto-reset
    fleet, once more per step where the step reads the pre-step foot
    positions (not CassieStanding), and once per fresh fleet (PPO.init,
    after the obs-norm burn-in, the evaluation); K3 never. Each run dir
    loads back in the port's evaluation."""
    steps = 512 // 256 + 2048 // 256 + 50
    out = {}
    for name, (env_name, flags) in NEW_ENVS.items():
        per_step = 1 if env_name == "CassieStanding-v0" else 2
        (secs, _, scalars, _), ret = run_cli(
            ["ppo", *NEW_ENV_PPO, *flags], env_name,
            {"K1": SIMRATE * steps, "K1-hfield": 0,
             "K2": per_step * steps + 3, "K3": 0},
            then=lambda run_dir: eval_checkpoint(
                run_dir, n_episodes=8, traj_len=10, device="cuda"))
        for tag in ("Test/Return", "Train/Return", "Misc/Actor Loss"):
            if not np.all(np.isfinite(scalars[tag])):
                raise AssertionError(f"train_{name}: {tag} = {scalars[tag]}")
        if not (np.isfinite(ret[0]) and ret[1] > 0):
            raise AssertionError(f"train_{name}: reloaded run gave {ret}")
        out[name] = dict(seconds=f"{secs:.1f}", k1_launches=SIMRATE * steps,
                         k2_launches=per_step * steps + 3,
                         test_return=f"{scalars['Test/Return'][0]:.4f}",
                         reloaded_return=f"{ret[0]:.4f}")
        print(f"  train_{name}: {out[name]}", flush=True)
    return out


def profile_launches(fn):
    """One call of fn() under torch.profiler: (device busy ms, kernels on
    the card, launch calls from the host). The window is padded as
    profiling.trace pads it: the profiler drops fewer of its first kernels
    (scripts/trace_window.py)."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.runtime.profiling import PAD_S

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PAD_S)
    events = prof.events()
    on_card = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in on_card) / 1e3
    launch_calls = sum(1 for e in events if e.name in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
        "cuLaunchKernelEx"))
    return busy_ms, len(on_card), launch_calls


# the training run: the mk4_hardened settings (experiment.pkl), one
# iteration of 8 steps per env (the learning-curve phase, `curves`, trains
# at the curve tool's settings)
TRAIN_STEPS, TRAIN_ITR, TRAIN_NORM_STEPS = 8192, 1, 10000
TRAIN_TRAJ = 100       # the iteration's evaluation (the settings' 300 cut)


def train_args(logdir: str):
    return [
        "ppo", "--env_name", "Cassie-v0", "--dyn_random", "--mirror",
        "--simrate", str(SIMRATE), "--command_profile", "clock",
        "--input_profile", "full", "--reward", "early_clock", "--estimator",
        "firmware", "--std_dev", "-1.5", "--num_procs", str(FLEET),
        "--num_steps", str(TRAIN_STEPS), "--max_traj_len", str(TRAIN_TRAJ),
        "--n_itr", str(TRAIN_ITR), "--input_norm_steps",
        str(TRAIN_NORM_STEPS), "--seed", "0", "--logdir", logdir]


def train(dev):
    """A PPO iteration through the CLI at the training fleet, in-process,
    counted; then the run directory loads back in the port's
    evaluation."""
    import glob
    import os

    from apex_tpu_torch.__main__ import main as cli_main

    logdir = os.path.join("chiprun_out", f"smoke_train_{os.getpid()}")
    rc, secs, n = count_launches(lambda: cli_main(train_args(logdir)))
    if rc != 0:
        raise AssertionError(f"ppo exited with {rc}")
    # policy steps: the burn-in rollout, then per iteration the training
    # rollout and the max_traj_len-step evaluation
    steps = (TRAIN_NORM_STEPS // FLEET
             + TRAIN_ITR * (TRAIN_STEPS // FLEET + TRAIN_TRAJ))
    check_counts("train", n["K1"], SIMRATE * steps)
    (run_dir,) = glob.glob(os.path.join(logdir, "Cassie-v0", "*"))
    scalars = {}
    with open(os.path.join(run_dir, "scalars.csv")) as f:
        for line in f:
            tag, step, value = line.rsplit(",", 2)
            scalars.setdefault(tag, []).append(float(value))
    for tag in ("Misc/Actor Loss", "Misc/Critic Loss", "Misc/Mirror Loss",
                "Train/Mean KL Div", "Test/Return", "Train/Return"):
        if len(scalars[tag]) != TRAIN_ITR \
                or not np.all(np.isfinite(scalars[tag])):
            raise AssertionError(f"train: {tag} = {scalars.get(tag)}")
    sample_s = scalars["Misc/Sample Times"]
    eval_s = scalars["Misc/Evaluation Times"]
    ret, ln = eval_checkpoint(run_dir, n_episodes=8, traj_len=10,
                              device="cuda")
    if not (np.isfinite(ret) and ln > 0):
        raise AssertionError(f"reloaded run gave return {ret}, length {ln}")
    return dict(
        seconds=f"{secs:.1f}", k1_launches=n["K1"], k2_launches=n["K2"],
        k3_launches=n["K3"], policy_steps=steps,
        sample_update_s_per_itr=[f"{x:.2f}" for x in sample_s],
        eval_s_per_itr=[f"{x:.2f}" for x in eval_s],
        env_steps_per_s=[f"{TRAIN_STEPS / x:.0f}" for x in sample_s],
        test_return=[f"{x:.4f}" for x in scalars["Test/Return"]],
        kl=[f"{x:.5f}" for x in scalars["Train/Mean KL Div"]],
        actor_loss=[f"{x:.5f}" for x in scalars["Misc/Actor Loss"]],
        mirror_loss=[f"{x:.6f}" for x in scalars["Misc/Mirror Loss"]],
        reloaded_return=f"{ret:.4f}")


# scripts/torch_train_curve.py at the mk4_hardened settings: iterations,
# eval cadence, policy steps per env and iteration (its --steps-per-env),
# and the burn-in's policy steps (10,000 // 1024)
CURVE_ITR, CURVE_EVAL_EVERY, CURVE_STEPS, CURVE_NORM_STEPS = (
    1, 1, 32, 10000 // FLEET)
# the keys of tools/train_curve.py's npz (tests/test_torch_curves.py holds
# the scripts' files to the tools' source)
CURVE_NPZ_KEYS = {"iters", "wall_s", "env_steps", "train_return",
                  "eval_return", "eval_len", "ep_len", "num_envs",
                  "steps_per_iter"}
OFFPOLICY_NPZ_KEYS = {"iters", "wall_s", "env_steps", "eval_return", "algo",
                      "env", "seed"}
# td3_async's episodes and evals cut to 100 steps (the eval is 400 at the
# tool's default): its two iterations and two evals take ~10 s, not ~24
CURVE_TD3_EVAL = 100


def load_script(name: str):
    """A module of scripts/, imported from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join("scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def walker_curve(name: str, script: str, args, env_steps: int, keys: set,
                 d: str) -> dict:
    """One run of a curve script on Walker2d into `d`, counted: 4 K2 and 4
    K3 per env step, none at a reset; its npz has the keys and finite eval
    returns. td3_sync and td3_async run with their episodes and evals cut
    to CURVE_TD3_EVAL steps; td3_async holds its two iterations' updates,
    ring and eval points."""
    cut = (mock.patch("apex_tpu_torch.agents.td3.TD3Config",
                      functools.partial(TD3Config,
                                        max_traj_len=CURVE_TD3_EVAL))
           if name.startswith("td3") else contextlib.nullcontext())
    with cut:
        state, secs, n = count_launches(
            lambda: load_script(script).main([*args, "--out", d]))
    per = WALKER_SUBSTEPS * env_steps
    check_counts(f"curves {name}", n, {
        "K1": 0, "K1-hfield": 0, "K2": per, "K3": per})
    if name == "td3_async" and (
            state.update_count, state.replay.size) != (160, 10240):
        raise AssertionError(f"curves td3_async: {state.update_count} "
                             f"updates, ring {state.replay.size}")
    with np.load(os.path.join(d, f"{name}_walker_seed0.npz")) as f:
        if set(f.files) != keys or \
                not np.all(np.isfinite(f["eval_return"])) or (
                    name == "td3_async" and list(f["iters"]) != [0, 1]):
            raise AssertionError(f"curves {name}: {dict(f)}")
        return dict(seconds=f"{secs:.1f}", k2_launches=per,
                    eval_return=f"{f['eval_return'][-1]:.4f}")


def curves():
    """The learning-curve scripts in-process on the card, counted.
    `torch_train_curve.py cassie --dyn-random` (1024 envs, 32 steps each,
    minibatch 2,048), one iteration and its eval: K1 once per substep of the
    burn-in, of the iteration's rollout and of the TRAIN_TRAJ-step eval;
    K2 twice per policy step and once per fresh fleet (PPO.init, after the
    burn-in, each eval); K3 never. Its npz has the JAX tool's keys and
    finite returns, and its checkpoint loads back. Then on Walker2d (4 K2
    and 4 K3 per env step, none at a reset): `torch_train_offpolicy_curve.
    py ars` for one iteration (128 envs, 400 steps), `td3_sync` for one
    (80 steps of 64 envs, a 100-step eval), `td3_async` for two (the
    random warm-up and one acting iteration, each with a 100-step eval)
    and
    `torch_train_recurrent_curve.py walker` for one (the 39-step burn-in,
    a 64-step chunk, a 100-step eval)."""
    out = {}
    os.makedirs("chiprun_out", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="chiprun_out") as d:
        argv = ["cassie", "--dyn-random", "--n-itr", str(CURVE_ITR),
                "--eval-every", str(CURVE_EVAL_EVERY), "--max-traj-len",
                str(TRAIN_TRAJ), "--out", d]
        _, secs, n = count_launches(
            lambda: load_script("torch_train_curve").main(argv))
        evals = len(range(0, CURVE_ITR, CURVE_EVAL_EVERY)) + (
            (CURVE_ITR - 1) % CURVE_EVAL_EVERY != 0)
        steps = (CURVE_NORM_STEPS + CURVE_ITR * CURVE_STEPS
                 + evals * TRAIN_TRAJ)
        check_counts("curves cassie", n, {
            "K1": SIMRATE * steps, "K1-hfield": 0, "K2": 2 * steps + 2 + evals,
            "K3": 0})
        with np.load(os.path.join(d, "cassie_ppo_seed0.npz")) as f:
            if set(f.files) != CURVE_NPZ_KEYS:
                raise AssertionError(f"curves: npz keys {sorted(f.files)}")
            rets = f["eval_return"]
            if len(rets) != evals or not np.all(np.isfinite(rets)) or \
                    not np.all(np.isfinite(f["train_return"])):
                raise AssertionError(f"curves: eval returns {rets}, train "
                                     f"returns {f['train_return']}")
        ret, ln = eval_checkpoint(os.path.join(d, "cassie_ppo_seed0_ckpt"),
                                  n_episodes=8, traj_len=10, device="cuda")
        if not (np.isfinite(ret) and ln > 0):
            raise AssertionError(f"curves: reloaded run gave {ret}, {ln}")
        out["cassie"] = dict(
            seconds=f"{secs:.1f}", k1_launches=n["K1"], k2_launches=n["K2"],
            eval_return=[f"{r:.4f}" for r in rets],
            reloaded_return=f"{ret:.4f}")
        print(f"  curves cassie: {out['cassie']}", flush=True)

        runs = {"ars": ("torch_train_offpolicy_curve",
                        ["ars", "--n-itr", "1"], 400, OFFPOLICY_NPZ_KEYS),
                "td3_sync": ("torch_train_offpolicy_curve",
                             ["td3_sync", "--timesteps", str(80 * 64)],
                             80 + CURVE_TD3_EVAL, OFFPOLICY_NPZ_KEYS),
                # the warm-up iteration and one acting one, each with its
                # eval (iterations 0 and the last) of CURVE_TD3_EVAL steps
                "td3_async": ("torch_train_offpolicy_curve",
                              ["td3_async", "--timesteps", str(2 * 80 * 64)],
                              2 * (80 + CURVE_TD3_EVAL), OFFPOLICY_NPZ_KEYS),
                "recurrent_ppo": ("torch_train_recurrent_curve",
                                  ["walker", "--n-itr", "1",
                                   "--max-traj-len", str(CURVE_TD3_EVAL)],
                                  10000 // 256 + 64 + CURVE_TD3_EVAL,
                                  OFFPOLICY_NPZ_KEYS | {"train_return"})}
        for name, run in runs.items():
            out[name] = walker_curve(name, *run, d)
            print(f"  curves {name}: {out[name]}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Walker2d on the fleet tier (K2 + K3) and the learners beyond PPO
# ---------------------------------------------------------------------------

# bench.py's Walker2d PPO cell (bench.py:94-103) and the learning check of
# tests/test_learning_smoke.py:16-31
WALKER_FLEET, WALKER_STEPS, WALKER_TRAJ, WALKER_MB = 2048, 32, 300, 4096
WALKER_ITR = 1
WALKER_SUBSTEPS = Walker2dEnv.frame_skip
LEARN_ENVS, LEARN_ITR, LEARN_RISE = 32, 12, 50.0
# bench.py's TD3 cell (bench.py:106-121): async, 64 envs, the 1M ring
TD3_ITR = 2
# leaves of the JAX package's TD3TrainState on Cassie-v0 (pinned on the CPU
# against a JAX template by tests/test_torch_offpolicy.py)
TD3_CASSIE_LEAVES = 131
# apex.py's td3 namespace (apex.py:120-138 and _common_env_args)
TD3_KEYS = (
    "a_lr", "batch_size", "c_lr", "command_profile", "discount",
    "dyn_random", "env_name", "estimator", "eval_freq", "expl_noise",
    "history", "ik_baseline", "input_profile", "learn_gains", "logdir",
    "max_speed", "max_timesteps", "max_traj_len", "min_speed", "mirror",
    "no_delta", "noise_clip", "num_procs", "orient_jump_prob", "param_noise",
    "policy_freq", "policy_noise", "reward", "seed", "simrate",
    "speed_phase_add", "start_timesteps", "tau", "traj")


def walker_inputs(B: int, gen: torch.Generator):
    """A Walker2d fleet around qpos0 on the CPU: angles and slides
    N(0, 0.05^2), velocities N(0, 0.5^2), the odd envs lowered 6 cm so
    that their feet start in the floor, controls N(0, 0.5^2) (some beyond
    the actuators' clamp)."""
    m = walker_model()
    qpos = torch.tensor(m.qpos0, dtype=torch.float32)[:, None] \
        + 0.05 * torch.randn(m.nq, B, generator=gen)
    qpos[1, 1::2] -= 0.06
    qvel = 0.5 * torch.randn(m.nv, B, generator=gen)
    ctrl = 0.5 * torch.randn(m.nu, B, generator=gen)
    return qpos.contiguous(), qvel, ctrl


@contextlib.contextmanager
def plain_kernels():
    """The fleet step with K2's and K3's plain versions in place of the
    kernels, on any device."""
    saved = fleet.fleet_fk, fleet.spd_inverse_bt
    fleet.fleet_fk = fleet_fk.fk_plain
    fleet.spd_inverse_bt = pallas_linalg.spd_inverse_bt_plain
    try:
        yield
    finally:
        fleet.fleet_fk, fleet.spd_inverse_bt = saved


def walker_step_vs_plain(m, params, qpos, qvel, ctrl):
    """One Walker2d fleet substep through K2 and K3 against the same step
    with their plain versions, both on the card, at the JAX package's
    per-step tolerances between its physics tiers
    (tests/test_fleet_parity.py:39-69). Returns the largest difference
    of each output and the largest contact force."""
    got = fleet.fleet_step(m, params, qpos, qvel, ctrl)
    with plain_kernels():
        ref = fleet.fleet_step(m, params, qpos, qvel, ctrl)
    torch.cuda.synchronize()
    pairs = {"xpos": (got[0].kin.xpos, ref[0].kin.xpos, 1e-4, 1e-5),
             "qpos": (got[2], ref[2], 1e-4, 2e-5),
             "qvel": (got[3], ref[3], 5e-2, 2e-2),
             "qacc": (got[4], ref[4], 1e-1, 50.0),
             "force": (got[1].force, ref[1].force, 5e-2, 1.0),
             "depth": (got[1].depth, ref[1].depth, 1e-4, 1e-6),
             "torque": (got[5], ref[5], 1e-5, 1e-6)}
    out = {}
    for name, (a, b, rtol, atol) in pairs.items():
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"Walker2d step: non-finite {name}")
        torch.testing.assert_close(
            a, b, rtol=rtol, atol=atol,
            msg=lambda t: f"Walker2d step {name} vs plain: {t}")
        out[name] = float((a - b).abs().max())
    force = float(ref[1].force[:, 2].max())
    if not force > 0:
        raise AssertionError("Walker2d step: no contact force in the fleet")
    return out, force


def check_walker_fleet(dev):
    """K2 on Walker2d's model at B = 2048 against its plain version (the
    tolerance of `check_k2`), K3 on the fleet's own M + hD (n = 9) against
    its plain version, and the whole fleet substep (K2 + K3) against the
    same step with the plain versions, all on the card; timed."""
    m = walker_model()
    B = WALKER_FLEET
    gen = torch.Generator()
    gen.manual_seed(9)
    qpos, qvel, ctrl = walker_inputs(B, gen)
    qpos, qvel, ctrl = qpos.to(dev), qvel.to(dev), ctrl.to(dev)
    params = PhysParams.from_model(m, B, dev)
    ipos = params.body_ipos

    got = fleet_fk.fleet_fk(m, ipos, qpos)
    ref = fleet_fk.fk_plain(m, ipos, qpos)
    torch.cuda.synchronize()
    for name, a, b in zip(got._fields, got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5,
                                   msg=lambda t: f"K2 Walker2d {name}: {t}")
    k2_err = max((a - b).abs().max().item() for a, b in zip(got, ref))
    rows = m.nq + 3 * m.nbody + (3 + 9 + 3) * m.nbody + 6 * m.nv
    k2_bnd, k2_by, k2_why = bound_ms(rows * B * 4, fk_flops_per_env(m) * B)
    k2 = dict(max_abs_err=k2_err,
              ms=device_ms(lambda: fleet_fk.fleet_fk(m, ipos, qpos), 100,
                           "fleet_fk_kernel"),
              plain_ms=cuda_ms(lambda: fleet_fk.fk_plain(m, ipos, qpos), 3, 1),
              bound_ms=k2_bnd, bound_by=k2_by, library_ms=None)

    # K3 on the fleet's M + hD; the condition number (~1.3e3) times f32's
    # epsilon bounds the relative error of each inverse at ~1e-4
    dyn = fleet._dynamics_bt(m, params, qpos, qvel)
    A = dyn.M.clone()
    A.diagonal(dim1=0, dim2=1).add_(m.timestep * params.dof_damping.T)
    A = A.contiguous()
    inv = pallas_linalg.spd_inverse_bt(A)
    inv_plain = pallas_linalg.spd_inverse_bt_plain(A)
    torch.cuda.synchronize()
    scale = inv_plain.abs().max().item()
    k3_err = (inv - inv_plain).abs().max().item()
    if not (np.isfinite(k3_err) and k3_err <= 1e-4 * scale):
        raise AssertionError(f"K3 Walker2d M+hD: max err {k3_err:.3e} > "
                             f"1e-4 x max|A^-1| {scale:.3e}")
    Abf = A.permute(2, 0, 1).contiguous()
    k3_bnd, k3_by, k3_why = bound_ms(2 * A.numel() * 4, m.nv ** 3 * B)
    k3 = dict(max_abs_err=k3_err,
              ms=device_ms(lambda: pallas_linalg.spd_inverse_bt(A), 100,
                           "spd_inverse_kernel"),
              plain_ms=cuda_ms(
                  lambda: pallas_linalg.spd_inverse_bt_plain(A), 3, 1),
              bound_ms=k3_bnd, bound_by=k3_by,
              library_ms=device_ms(lambda: torch.linalg.inv(Abf), 50))

    step_err, force = walker_step_vs_plain(m, params, qpos, qvel, ctrl)
    _, _, n = count_launches(lambda: fleet.fleet_step(m, params, qpos, qvel,
                                                      ctrl))
    check_counts("Walker2d fleet step", n,
                 {"K1": 0, "K2": 1, "K3": 1, "K1-hfield": 0})
    step_ms = cuda_ms(lambda: fleet.fleet_step(m, params, qpos, qvel, ctrl),
                      10)
    with plain_kernels():
        plain_step_ms = cuda_ms(
            lambda: fleet.fleet_step(m, params, qpos, qvel, ctrl), 10)
    # one env step (4 substeps) of the 2048-env fleet, host clock and
    # profiled
    env = Walker2dEnv(device=dev)
    wstate, _ = env.reset(env.sample_reset_noise(
        torch.Generator(device=dev).manual_seed(0), B))
    act = 0.5 * torch.randn(B, env.action_size, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    env_step = lambda: env.step(wstate, act, None)
    env_step()
    env_step_ms = cuda_ms(env_step, 5, 0)
    busy_ms, kernels, launch_calls = profile_launches(env_step)
    print(f"  Walker2d env step B={B}: {env_step_ms:.2f} ms (host clock, "
          f"events), {launch_calls} launch calls "
          f"({launch_calls / WALKER_SUBSTEPS:.1f} per substep), {kernels} "
          f"kernels, device busy {busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / env_step_ms:.4f}", flush=True)

    print(f"  K2 Walker2d B={B}: max err {k2_err:.3e}; kernel "
          f"{k2['ms']:.4f} ms, plain {k2['plain_ms']:.3f} ms, bound "
          f"{k2_bnd * 1e3:.3f} us ({k2_by}: {k2_why}); "
          f"{fleet_fk.launch_info(m)}", flush=True)
    print(f"  K3 Walker2d M+hD n={m.nv} B={B}: err {k3_err:.3e} "
          f"({k3_err / scale:.2e} of max); kernel {k3['ms']:.4f} ms, plain "
          f"{k3['plain_ms']:.3f} ms, torch.linalg.inv "
          f"{k3['library_ms']:.4f} ms, bound {k3_bnd * 1e3:.3f} us ({k3_by}: "
          f"{k3_why})", flush=True)
    print("  Walker2d substep (K2 + K3) vs the plain versions on the card: "
          + ", ".join(f"{k} {v:.3e}" for k, v in step_err.items())
          + f"; max contact force {force:.1f} N; {step_ms:.3f} ms per "
          f"substep with the kernels, {plain_step_ms:.3f} ms with the plain "
          "versions (host clock, events)", flush=True)
    return dict(K2=k2, K3=k3, summary=dict(
        substep_ms=f"{step_ms:.3f}", plain_substep_ms=f"{plain_step_ms:.3f}",
        env_step_ms=f"{env_step_ms:.2f}", launch_calls_per_env_step=launch_calls,
        device_busy_ms_per_env_step=f"{busy_ms:.3f}",
        device_idle_share=f"{1.0 - busy_ms / env_step_ms:.4f}"))


def walker2d_ppo(dev):
    """bench.py's Walker2d PPO cell (2048 envs, 32 steps per env, minibatch
    4096, 3 epochs, traj 300) for WALKER_ITR iterations, each a rollout, the
    update and the 300-step evaluation, counted: a reset launches
    nothing, an env step 4 K2 and 4 K3. Then the learning check of
    tests/test_learning_smoke.py:16-31 (32 envs, 12 iterations, lr 3e-4,
    500 burn-in steps): the deterministic eval return must rise by more
    than 50."""
    env = Walker2dEnv(device=dev)
    cfg = PPOConfig(num_envs=WALKER_FLEET,
                    num_steps=WALKER_FLEET * WALKER_STEPS,
                    max_traj_len=WALKER_TRAJ, minibatch_size=WALKER_MB,
                    epochs=3)
    ppo = PPO(env, cfg)
    torch.cuda.reset_peak_memory_stats()
    state, _, n = count_launches(lambda: ppo.init(seed=0))
    check_counts("Walker2d reset", n,
                 {"K1": 0, "K2": 0, "K3": 0, "K1-hfield": 0})
    per_step = WALKER_SUBSTEPS
    want = {"K1": 0, "K1-hfield": 0,
            "K2": per_step * (WALKER_STEPS + WALKER_TRAJ),
            "K3": per_step * (WALKER_STEPS + WALKER_TRAJ)}
    out = dict(rollout_s=[], update_s=[], eval_s=[], env_steps_per_s=[],
               train_return=[], eval_return=[], kl=[])
    for itr in range(WALKER_ITR):
        def iteration():
            t0 = time.time()
            st, traj = ppo._rollout(state, 1.0)
            torch.cuda.synchronize()
            t1 = time.time()
            perms = [torch.randperm(traj.reward.numel(), generator=st.generator,
                                    device=dev) for _ in range(cfg.epochs)]
            metrics = {k: float(v) for k, v in
                       ppo._update(st, traj, 1.0, perms).items()}
            torch.cuda.synchronize()
            t2 = time.time()
            gen = torch.Generator(device=dev)
            gen.manual_seed(itr)
            ev = float(ppo._evaluate(st, gen)["ep_return"])
            torch.cuda.synchronize()
            return st, metrics, ev, (t1 - t0, t2 - t1, time.time() - t2)

        (state, metrics, ev, (t_roll, t_upd, t_ev)), _, n = count_launches(
            iteration)
        check_counts(f"walker2d_ppo iteration {itr}", n, want)
        for k, v in metrics.items():
            if not np.isfinite(v):
                raise AssertionError(f"walker2d_ppo: {k} = {v}")
        out["rollout_s"].append(f"{t_roll:.3f}")
        out["update_s"].append(f"{t_upd:.3f}")
        out["eval_s"].append(f"{t_ev:.3f}")
        out["env_steps_per_s"].append(
            f"{WALKER_FLEET * WALKER_STEPS / (t_roll + t_upd):.0f}")
        out["train_return"].append(f"{metrics['train_ep_return']:.3f}")
        out["eval_return"].append(f"{ev:.3f}")
        out["kl"].append(f"{metrics['kl']:.5f}")
    out["k2_launches_per_itr"] = n["K2"]
    out["k3_launches_per_itr"] = n["K3"]
    out["peak_mem_mb"] = f"{torch.cuda.max_memory_allocated() / 1e6:.1f}"
    out["launches"] = n

    # the learning check
    t0 = time.time()
    env = Walker2dEnv(device=dev)
    cfg = PPOConfig(num_envs=LEARN_ENVS, num_steps=LEARN_ENVS * 64,
                    max_traj_len=200, minibatch_size=512, epochs=3, lr=3e-4)
    ppo = PPO(env, cfg)
    state = ppo.prenormalize(ppo.init(seed=0), steps=500)

    def evaluate():
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        return float(ppo._evaluate(state, gen)["ep_return"])

    ev0 = evaluate()
    for _ in range(LEARN_ITR):
        state, _ = ppo._train_iteration(state, 1.0)
    ev1 = evaluate()
    print(f"  walker2d learning check: deterministic eval return "
          f"{ev0:.3f} -> {ev1:.3f} in {LEARN_ITR} iterations of "
          f"{LEARN_ENVS} envs ({time.time() - t0:.1f} s)", flush=True)
    if not ev1 > ev0 + LEARN_RISE:
        raise AssertionError(f"walker2d PPO did not learn: eval return "
                             f"{ev0:.3f} -> {ev1:.3f}")
    out["learning_eval_return"] = f"{ev0:.3f} -> {ev1:.3f}"
    return out


def td3_walker(dev):
    """bench.py's TD3 cell: `TD3Config(num_envs=64, async_mode=True)` on
    Walker2d with the 1M ring, one random warm-up iteration and TD3_ITR
    policy iterations, each counted (80 env steps: 320 K2 and 320 K3);
    learner updates/s as bench.py counts them (iterations x 80 over the
    seconds of the policy iterations, collection included), and 80 updates
    timed alone."""
    env = Walker2dEnv(device=dev)
    cfg = TD3Config(num_envs=64, async_mode=True)
    agent = TD3(env, cfg)
    torch.cuda.reset_peak_memory_stats()
    state = agent.init(seed=0)
    ring_mb = sum(getattr(state.replay, f).numel() * 4
                  for f in state.replay.FIELDS) / 1e6
    want = {"K1": 0, "K1-hfield": 0, "K2": WALKER_SUBSTEPS * cfg.collect_steps,
            "K3": WALKER_SUBSTEPS * cfg.collect_steps}
    secs = []
    for it in range(1 + TD3_ITR):
        copy_params(state.behavior, state.actor)   # load_freq 1
        (state, metrics), dt, n = count_launches(
            lambda: agent._train_iteration(state, random_actions=it == 0))
        check_counts(f"td3 iteration {it}", n, want)
        metrics = {k: float(v) for k, v in metrics.items()}
        for k in ("critic_loss", "actor_loss"):
            if not np.isfinite(metrics[k]):
                raise AssertionError(f"td3 iteration {it}: {k} = "
                                     f"{metrics[k]}")
        secs.append(dt)
    size = state.replay.size
    if size != (1 + TD3_ITR) * cfg.collect_steps * cfg.num_envs:
        raise AssertionError(f"td3: replay size {size}")

    def updates():
        for _ in range(cfg.updates_per_iter):
            batch = state.replay.sample(state.generator, cfg.batch_size)
            noise = torch.randn(batch[1].shape, generator=state.generator,
                                device=dev)
            agent._update(state, batch, noise)

    _, upd_s, n = count_launches(updates)
    check_counts("td3 updates", n, {"K1": 0, "K1-hfield": 0, "K2": 0,
                                    "K3": 0})
    return dict(
        iteration_s=[f"{x:.3f}" for x in secs],
        updates_per_s=f"{TD3_ITR * cfg.updates_per_iter / sum(secs[1:]):.1f}",
        learner_only_updates_per_s=f"{cfg.updates_per_iter / upd_s:.1f}",
        ms_per_update=f"{upd_s / cfg.updates_per_iter * 1e3:.2f}",
        replay_size=size, ring_mb=f"{ring_mb:.1f}",
        peak_mem_mb=f"{torch.cuda.max_memory_allocated() / 1e6:.1f}",
        critic_loss=f"{metrics['critic_loss']:.5f}",
        actor_loss=f"{metrics['actor_loss']:.5f}",
        k2_launches_per_itr=want["K2"], k3_launches_per_itr=want["K3"])


def read_scalars(run_dir: str):
    scalars = {}
    with open(os.path.join(run_dir, "scalars.csv")) as f:
        for line in f:
            tag, _, value = line.rsplit(",", 2)
            scalars.setdefault(tag, []).append(float(value))
    return scalars


def run_cli(argv, env_name: str, want, then=None):
    """`python -m apex_tpu_torch <argv>` in-process on the card, in a
    temporary run directory under chiprun_out/, counted against `want`;
    returns (seconds, the run dir's experiment args, scalars, checkpoint
    leaves), and with `then` also then(run dir)'s result."""
    from apex_tpu_torch.__main__ import main as cli_main

    os.makedirs("chiprun_out", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="chiprun_out") as logdir:
        rc, secs, n = count_launches(lambda: cli_main(
            [*argv, "--env_name", env_name, "--logdir", logdir]))
        if rc != 0:
            raise AssertionError(f"{argv[0]} exited with {rc}")
        check_counts(argv[0], n, want)
        (run_dir,) = os.listdir(os.path.join(logdir, env_name))
        run_dir = os.path.join(logdir, env_name, run_dir)
        with open(os.path.join(run_dir, "experiment.pkl"), "rb") as f:
            args = pickle.load(f)
        if os.path.basename(run_dir) != f"{args_hash(args)}-seed0":
            raise AssertionError(f"{argv[0]}: run dir {run_dir} is not "
                                 "named by the hash of its arguments")
        with open(os.path.join(run_dir, "checkpoint.pkl"), "rb") as f:
            leaves = pickle.load(f)
        out = secs, args, read_scalars(run_dir), leaves
        return out if then is None else (out, then(run_dir))


def td3_cassie():
    """`python -m apex_tpu_torch td3_sync` on Cassie-v0 (the CLI's
    defaults but CLI_TRAJ-step episodes: megakernel tier, 64 envs, the 1M
    ring), two iterations (the random warm-up and one policy iteration)
    and the evaluation at iteration 0: K1 once per substep of the 2 x 80 +
    CLI_TRAJ steps, K2 twice
    per step and once per fresh fleet (TD3.init, the evaluation), K3
    never; the run dir is named by the hash of apex.py's namespace, and
    the checkpoint holds the JAX TD3 train state's leaves."""
    steps = 2 * 80 + CLI_TRAJ
    secs, args, scalars, leaves = run_cli(
        ["td3_sync", "--max_timesteps", str(2 * 80 * 64),
         "--start_timesteps", "5120", "--max_traj_len", str(CLI_TRAJ)],
        "Cassie-v0",
        {"K1": SIMRATE * steps, "K1-hfield": 0, "K2": 2 * steps + 2,
         "K3": 0})
    if tuple(sorted(args)) != TD3_KEYS:
        raise AssertionError(f"td3_sync: experiment.pkl keys {sorted(args)}")
    if len(leaves) != TD3_CASSIE_LEAVES:
        raise AssertionError(f"td3_sync: checkpoint has {len(leaves)} "
                             f"leaves, JAX's TD3 state {TD3_CASSIE_LEAVES}")
    for tag in ("Test/Return", "Misc/Critic Loss", "Misc/Actor Loss"):
        if not np.all(np.isfinite(scalars[tag])):
            raise AssertionError(f"td3_sync: {tag} = {scalars[tag]}")
    return dict(seconds=f"{secs:.1f}", policy_steps=steps,
                k1_launches=SIMRATE * steps, k2_launches=2 * steps + 2,
                eval_return=f"{scalars['Test/Return'][0]:.4f}",
                critic_loss=f"{scalars['Misc/Critic Loss'][0]:.5f}",
                checkpoint_leaves=len(leaves))


def ddpg_walker():
    """`python -m apex_tpu_torch ddpg` on Walker2d at the CLI's defaults
    but CLI_TRAJ-step episodes, one iteration (the random warm-up: 80
    steps of 64 envs, 80 updates) and the evaluation: 4 K2 and 4 K3 per
    env step."""
    steps = 80 + CLI_TRAJ
    secs, _, scalars, _ = run_cli(
        ["ddpg", "--max_timesteps", str(80 * 64), "--max_traj_len",
         str(CLI_TRAJ)], "Walker2d-v0",
        {"K1": 0, "K1-hfield": 0, "K2": WALKER_SUBSTEPS * steps,
         "K3": WALKER_SUBSTEPS * steps})
    if not np.all(np.isfinite(scalars["Test/Return"])):
        raise AssertionError(f"ddpg: Test/Return {scalars['Test/Return']}")
    return dict(seconds=f"{secs:.1f}", env_steps=steps,
                k2_launches=WALKER_SUBSTEPS * steps,
                eval_return=f"{scalars['Test/Return'][0]:.4f}",
                critic_loss=f"{scalars['Misc/Critic Loss'][0]:.5f}")


def ars_walker():
    """`python -m apex_tpu_torch ars` on Walker2d at the CLI's defaults, 64
    directions, but ARS_TRAJ-step episodes: one iteration, a fleet of 128
    envs for ARS_TRAJ steps without auto-reset, 4 K2 and 4 K3 per step."""
    secs, _, scalars, leaves = run_cli(
        ["ars", "--n_itr", "1", "--max_traj_len", str(ARS_TRAJ)],
        "Walker2d-v0",
        {"K1": 0, "K1-hfield": 0, "K2": WALKER_SUBSTEPS * ARS_TRAJ,
         "K3": WALKER_SUBSTEPS * ARS_TRAJ})
    theta = np.asarray(leaves[0])
    if not (np.all(np.isfinite(theta)) and np.any(theta != 0)):
        raise AssertionError("ars: θ did not move or is not finite")
    return dict(seconds=f"{secs:.1f}", envs=128, env_steps=ARS_TRAJ,
                k2_launches=WALKER_SUBSTEPS * ARS_TRAJ,
                mean_return=f"{scalars['Test/Return'][0]:.4f}",
                total_steps=int(leaves[-1]))


# ---------------------------------------------------------------------------
# the recurrent learners: RecurrentPPO, RDPG and ARS with an LSTM policy
# ---------------------------------------------------------------------------

RECURRENT_CKPT = "curves/recurrent_ppo_walker_seed0_ckpt"
# JAX's seed-42 reset draws and returns (scripts/export_recurrent_draws.py)
RECURRENT_DRAWS = "curves/jax_eval_draws/recurrent_ppo_walker.npz"
RECURRENT_LEAVES = 80              # the JAX RecurrentPPOState of Walker2d
RPPO_STEPS, RPPO_ITR, RPPO_NORM_STEPS = 256 * 32, 1, 10000
# Cassie-v0: 64 envs, chunks of 16 steps, a 100-step evaluation
RPPO_CASSIE_ENVS, RPPO_CASSIE_T, RPPO_CASSIE_NORM, RPPO_CASSIE_TRAJ = (
    64, 16, 8, 100)
RDPG_UPDATES = 4                   # of the CLI's 80 (rdpg_updates)
# the episodes of the CLI's ARS and RDPG runs (the CLI's 400 cut) and of
# its td3_sync on Cassie and ddpg (their evaluations too)
ARS_TRAJ, CLI_TRAJ = 200, 100


def recurrent_ppo_walker(dev):
    """The committed recurrent PPO checkpoint (Walker2d, 256 envs) loaded
    into the port and evaluated as `RecurrentPPO._evaluate` does (a fresh
    fleet, 400 steps without resets, the first episode's return): on the
    reset draws of JAX's seed-42 evaluation, held within EVAL_BOUND of
    JAX's return, counted (a reset launches nothing, a step 4 K2 and 4
    K3). Then one iteration of `python -m apex_tpu_torch ppo --env_name
    Walker2d --recurrent --num_procs 256 --num_steps 8192 --max_traj_len
    CLI_TRAJ` (the 39-step burn-in, a 32-step chunk, the BPTT update and
    the evaluation), counted; its run dir loads back into the port's
    RecurrentPPOState."""
    from apex_tpu_torch.agents.ppo_recurrent import RecurrentPPO
    from apex_tpu_torch.envs.walker2d import WalkerResetNoise
    from apex_tpu_torch.runtime.checkpoint import (load_recurrent_ppo,
                                                   to_jax_leaves)

    with np.load(RECURRENT_DRAWS) as f:
        d = {k: f[k] for k in f}
    B, T = int(d["batch"]), int(d["steps"])
    env = Walker2dEnv(device=dev)
    agent = RecurrentPPO(env, PPOConfig(num_envs=B, max_traj_len=T))
    state = load_recurrent_ppo(RECURRENT_CKPT, agent)
    want = {"K1": 0, "K1-hfield": 0, "K2": WALKER_SUBSTEPS * T,
            "K3": WALKER_SUBSTEPS * T}
    own = env.sample_reset_noise
    env.sample_reset_noise = lambda gen, batch: WalkerResetNoise(
        *(torch.as_tensor(d[f"reset0_{k}"].T.copy(), device=dev)
          for k in ("qpos", "qvel")))
    ev, secs, n = count_launches(lambda: agent._evaluate(
        state, torch.Generator(device=dev)))
    env.sample_reset_noise = own
    check_counts("recurrent_ppo_walker eval", n, want)
    ret, jax_ret = float(ev["ep_return"]), float(d["jax_return"])
    rel = ret / jax_ret - 1.0
    print(f"  recurrent_ppo_walker on JAX's seed-42 draws: return {ret!r}, "
          f"length {float(ev['ep_len']):.2f}; JAX {jax_ret:.4f} ({rel:+.4%};"
          f" JAX's seeds {d['seeds'].tolist()}: "
          f"{[round(x, 4) for x in d['jax_seed_returns'].tolist()]}), "
          f"{secs / T * 1e3:.2f} ms per policy step", flush=True)
    if not abs(rel) <= EVAL_BOUND:
        raise AssertionError(f"recurrent_ppo_walker: return {ret} is "
                             f"{rel:+.4%} from JAX's {jax_ret}")
    steps = RPPO_NORM_STEPS // B + RPPO_ITR * (RPPO_STEPS // B + CLI_TRAJ)
    cli_want = {"K1": 0, "K1-hfield": 0, "K2": WALKER_SUBSTEPS * steps,
                "K3": WALKER_SUBSTEPS * steps}

    def reload(run_dir):
        back = load_recurrent_ppo(run_dir, RecurrentPPO(
            Walker2dEnv(device=dev), PPOConfig(num_envs=B)))
        return len(to_jax_leaves(back, env))

    (cli_s, args, scalars, leaves), n_back = run_cli(
        ["ppo", "--recurrent", "--num_procs", str(B), "--num_steps",
         str(RPPO_STEPS), "--n_itr", str(RPPO_ITR), "--max_traj_len",
         str(CLI_TRAJ), "--seed", "0"],
        "Walker2d", cli_want, then=reload)
    if not (args["recurrent"] and len(leaves) == n_back == RECURRENT_LEAVES):
        raise AssertionError(f"recurrent ppo: {len(leaves)} leaves, "
                             f"reloaded {n_back}")
    for tag in ("Test/Return", "Train/Return", "Train/Mean KL Div"):
        if len(scalars[tag]) != RPPO_ITR \
                or not np.all(np.isfinite(scalars[tag])):
            raise AssertionError(f"recurrent ppo: {tag} = {scalars[tag]}")
    return dict(
        jax_draws_return=f"{ret:.4f}", jax_return=f"{jax_ret:.4f}",
        diff=f"{rel:+.4%}", ep_len=f"{float(ev['ep_len']):.2f}",
        eval_ms_per_policy_step=f"{secs / T * 1e3:.2f}",
        eval_k2_launches=n["K2"], eval_k3_launches=n["K3"],
        cli_seconds=f"{cli_s:.1f}", cli_policy_steps=steps,
        cli_k2_launches=cli_want["K2"], cli_k3_launches=cli_want["K3"],
        test_return=[f"{x:.4f}" for x in scalars["Test/Return"]],
        kl=[f"{x:.5f}" for x in scalars["Train/Mean KL Div"]],
        checkpoint_leaves=len(leaves))


def recurrent_ppo_cassie():
    """One `ppo --recurrent --mirror` iteration on Cassie-v0 (the
    megakernel tier, 64 envs, an 8-step burn-in, a 16-step chunk, the
    BPTT update with the mirror loss through mirror_clock, a 100-step
    evaluation), counted: K1 once per substep; K2 once per env step, once
    per auto-reset step of the chunk and once per fresh fleet (the
    initial one, after the burn-in, the evaluation's); K3 never."""
    B, T, norm_t, traj = (RPPO_CASSIE_ENVS, RPPO_CASSIE_T,
                          RPPO_CASSIE_NORM, RPPO_CASSIE_TRAJ)
    steps = norm_t + T + traj
    want = {"K1": SIMRATE * steps, "K1-hfield": 0,
            "K2": norm_t + 2 * T + traj + 3, "K3": 0}
    secs, args, scalars, leaves = run_cli(
        ["ppo", "--recurrent", "--mirror", "--num_procs", str(B),
         "--num_steps", str(B * T), "--max_traj_len", str(traj), "--n_itr",
         "1", "--input_norm_steps", str(B * norm_t)], "Cassie-v0", want)
    for tag in ("Test/Return", "Train/Return", "Train/Mean KL Div"):
        if not np.all(np.isfinite(scalars[tag])):
            raise AssertionError(f"recurrent ppo cassie: {tag} = "
                                 f"{scalars[tag]}")
    return dict(seconds=f"{secs:.1f}", policy_steps=steps,
                k1_launches=want["K1"], k2_launches=want["K2"],
                test_return=f"{scalars['Test/Return'][0]:.4f}",
                kl=f"{scalars['Train/Mean KL Div'][0]:.5f}",
                checkpoint_leaves=len(leaves))


@contextlib.contextmanager
def rdpg_updates(n: int):
    """`rdpg` through the CLI with `n` BPTT updates per iteration in place
    of DPGConfig's 80 (apex.py has no flag for it), each update timed on
    the card: yields the list of their seconds."""
    from apex_tpu_torch.agents import dpg

    config, update = dpg.DPGConfig, dpg.DPG._update_rnn
    seconds = []

    @dataclasses.dataclass(frozen=True)
    class Config(config):
        updates_per_iter: int = n

    def timed(self, state, batch):
        torch.cuda.synchronize()
        t0 = time.time()
        out = update(self, state, batch)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        return out

    dpg.DPGConfig, dpg.DPG._update_rnn = Config, timed
    try:
        yield seconds
    finally:
        dpg.DPGConfig, dpg.DPG._update_rnn = config, update


def rdpg_walker():
    """`python -m apex_tpu_torch rdpg` on Walker2d at the CLI's widths (64
    envs, batches of 16 episodes, layers (128, 128)) with ARS_TRAJ-step
    episodes: one iteration (the random warm-up: one episode per env into
    the ring, then RDPG_UPDATES BPTT updates, each timed: the eager BPTT
    takes ~1-3 s per update, so the CLI's 80 would take minutes of the
    script) and the recurrent evaluation (ARS_TRAJ steps), counted: 4 K2
    and 4 K3 per env step."""
    steps = 2 * ARS_TRAJ
    with rdpg_updates(RDPG_UPDATES) as update_s:
        secs, _, scalars, leaves = run_cli(
            ["rdpg", "--max_timesteps", str(ARS_TRAJ * 64),
             "--max_traj_len", str(ARS_TRAJ)], "Walker2d-v0",
            {"K1": 0, "K1-hfield": 0, "K2": WALKER_SUBSTEPS * steps,
             "K3": WALKER_SUBSTEPS * steps})
    if len(update_s) != RDPG_UPDATES:
        raise AssertionError(f"rdpg: {len(update_s)} updates, want "
                             f"{RDPG_UPDATES}")
    for tag in ("Test/Return", "Misc/Critic Loss"):
        if not np.all(np.isfinite(scalars[tag])):
            raise AssertionError(f"rdpg: {tag} = {scalars[tag]}")
    print(f"  rdpg: {RDPG_UPDATES} BPTT updates of 16 episodes x "
          f"{ARS_TRAJ} steps "
          f"(the CLI's 80 cut), {np.mean(update_s) * 1e3:.1f} ms each",
          flush=True)
    return dict(seconds=f"{secs:.1f}", env_steps=steps,
                updates_per_iter=RDPG_UPDATES,
                ms_per_update=f"{np.mean(update_s) * 1e3:.1f}",
                k2_launches=WALKER_SUBSTEPS * steps,
                eval_return=f"{scalars['Test/Return'][0]:.4f}",
                critic_loss=f"{scalars['Misc/Critic Loss'][0]:.5f}",
                checkpoint_leaves=len(leaves))


def ars_recurrent_walker():
    """`python -m apex_tpu_torch ars --recurrent` on Walker2d at the CLI's
    defaults (64 directions, hidden 32: an LSTM policy of layers (32,
    32)) but ARS_TRAJ-step episodes: one iteration, 128 envs for ARS_TRAJ
    steps, 4 K2 and 4 K3 per step."""
    secs, _, scalars, leaves = run_cli(
        ["ars", "--recurrent", "--n_itr", "1", "--max_traj_len",
         str(ARS_TRAJ)], "Walker2d-v0",
        {"K1": 0, "K1-hfield": 0, "K2": WALKER_SUBSTEPS * ARS_TRAJ,
         "K3": WALKER_SUBSTEPS * ARS_TRAJ})
    theta = np.asarray(leaves[0])
    if not (np.all(np.isfinite(theta)) and np.any(theta != 0)):
        raise AssertionError("ars --recurrent: θ did not move or is not "
                             "finite")
    return dict(seconds=f"{secs:.1f}", envs=128, env_steps=ARS_TRAJ,
                theta_size=theta.size,
                k2_launches=WALKER_SUBSTEPS * ARS_TRAJ,
                mean_return=f"{scalars['Test/Return'][0]:.4f}")


# ---------------------------------------------------------------------------
# the eval battery's suites (runtime/eval_suites.py)
# ---------------------------------------------------------------------------

# JAX's committed battery results (tools/run_eval_battery.py)
JAX_BATTERY = {"mk4": "curves/cassie_mk4_hardened_eval_r5",
               "mk5c": "curves/cassie_mk5c_eval"}
SUITE_TRIALS = 10000              # the command suite's trials
CELL_5K = ("straight", 1.4)       # the 5k cell chip_smoke runs in full
CELL_5K_ENVS = 11 * 19 * 19       # terrains x frictions x foot masses
PERTURB_STEPS = 40 + 8 + 40       # settle, push, recover
PERTURB_MEAN_TOL = 75.0           # N, mean over angles against JAX's
COMMAND_STEPS = 4 * 200           # four commands of 200 steps


def sample_cols(B: int, every: int = 10):
    """Every `every`-th env of a fleet of B and its last eight (the last,
    partial block of a launch)."""
    return torch.unique(torch.cat([torch.arange(0, B, every),
                                   torch.arange(max(B - 8, 0), B)]))


def take_cols(cols, params, *rows):
    cut = lambda x: x[..., cols.to(x.device)].contiguous()
    return (PhysParams(**{k: cut(v) for k, v in vars(params).items()}),
            *(cut(x) for x in rows))


def k1_ramp_inputs(B: int, gen: torch.Generator, dev):
    """The 5k ramp cells through K1's heightfield build: the standing
    fleet of `k1_standing_inputs` on the heightfield model's parameters,
    a noise table in every env but hfield_active 0, and the floor tilted
    as up_3, down_3, left_3 and right_3 in turn (`_terrain_config`'s
    signs)."""
    m = cassie_model(enable_hfield=True)
    params = PhysParams.from_model(m, B, torch.device("cpu"))
    tilts = [eval_suites._terrain_config(t)[2]
             for t in ("up_3", "down_3", "left_3", "right_3")]
    pitch = torch.tensor([tilts[b % 4][0] for b in range(B)],
                         dtype=torch.float32)
    roll = torch.tensor([tilts[b % 4][1] for b in range(B)],
                        dtype=torch.float32)
    params.floor_quat = euler2quat(z=torch.zeros(B), y=pitch,
                                   x=roll).contiguous()
    table = torch.as_tensor(eval_suites._terrain_config("noise1")[1])
    params.hfield = table[:, :, None].expand(32, 32, B).contiguous()
    params.hfield_active = torch.zeros(B)
    return k1_standing_inputs(B, gen, dev, params=params)


TERRAINS_5K_HFIELD = ("noise1", "noise2", "noise3", "hill1", "hill2",
                      "hill3")


def k1_5k_terrain_inputs(B: int, gen: torch.Generator, dev):
    """The 5k noise and hill cells through K1's heightfield build: the
    standing fleet of `k1_standing_inputs` on the heightfield model's
    parameters, the six tables of `_terrain_config` in turn (none from
    the env's terrain bank), hfield_active 1, and each env moved to a
    uniform point within 9.5 m of the table's centre (every eighth to
    10.45 m, past its edge: the lookup's clip) and lifted by the table's
    height at the nearest cell, so that the feet meet the terrain there."""
    m = cassie_model(enable_hfield=True)
    params = PhysParams.from_model(m, B, torch.device("cpu"))
    tables = torch.stack([torch.as_tensor(eval_suites._terrain_config(n)[1])
                          for n in TERRAINS_5K_HFIELD])
    env = torch.arange(B)
    params.hfield = tables[env % len(tables)].permute(1, 2, 0).contiguous()
    params.hfield_active = torch.ones(B)
    xy = 19.0 * torch.rand(2, B, generator=gen) - 9.5
    xy[:, env % 8 == 5] *= 1.1
    res = params.hfield.shape[0]
    cell = ((xy + 10.0) / 20.0 * (res - 1)).round().clamp(0, res - 1).long()
    lift = params.hfield[cell[0], cell[1], env]
    params, qpos, qvel, rows = k1_standing_inputs(B, gen, dev, params=params)
    qpos[0:2] = xy.to(dev)
    qpos[2] += lift.to(dev)
    return params, qpos, qvel, rows


def k1_at_scale(m, params, qpos, qvel, rows, gen, what: str):
    """K1 on a whole large fleet, held on a sample of its envs
    (`sample_cols`): the sample launched alone gives the full launch's
    bits (no env reads another's rows, whatever the block count), and
    against the plain version under `kernel_bounds`. Returns (max abs
    error, kernel ms over the whole fleet, the full launch's outputs)."""
    full = fleet_kernel.pd_substep(m, params, qpos, qvel, rows)
    cols = sample_cols(qpos.shape[-1])
    sub = take_cols(cols, params, qpos, qvel, rows)
    alone = fleet_kernel.pd_substep(m, *sub)
    c = cols.to(qpos.device)
    if not all(torch.equal(a, f[:, c]) for a, f in zip(alone, full)):
        raise AssertionError(f"{what}: the sampled envs launched alone "
                             "differ from the full launch")
    worst, _, _ = k1_vs_plain(m, *sub, gen, what)
    ms = device_ms(lambda: fleet_kernel.pd_substep(m, params, qpos, qvel,
                                                   rows), 10,
                   "pd_substep_kernel")
    return max(v[0] for v in worst.values()), ms, full


def check_k1_suites(gen, dev):
    """K1 at the suites' fleets, each held on a sample against the plain
    version: the flat kernel at B = 10,000 and 3,971; the heightfield
    build at 10,000 on `add_terrain`'s terrain (the mk5c command suite),
    at 3,971 on the 5k noise and hill tables (`k1_5k_terrain_inputs`),
    and at 3,971 on the 5k ramps, there also bit for bit against the flat
    kernel on the same inputs (hfield_active 0 selects the plane)."""
    out = {}
    m = cassie_model()
    for B in (SUITE_TRIALS, CELL_5K_ENVS):
        err, ms, _ = k1_at_scale(m, *k1_standing_inputs(B, gen, dev), gen,
                                 f"K1 B={B}")
        out[f"k1_B{B}"] = dict(max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}")
    mh = cassie_model(enable_hfield=True)
    for name, B, inputs in (
            ("terrain", SUITE_TRIALS,
             k1_standing_inputs(SUITE_TRIALS, gen, dev, terrain=0.03)),
            ("5k_tables", CELL_5K_ENVS,
             k1_5k_terrain_inputs(CELL_5K_ENVS, gen, dev))):
        err, ms, _ = k1_at_scale(mh, *inputs, gen,
                                 f"K1-hfield {name} B={B}")
        out[f"k1_hfield_{name}_B{B}"] = dict(max_abs_err=f"{err:.3e}",
                                             ms=f"{ms:.4f}")
    params, qpos, qvel, rows = k1_ramp_inputs(CELL_5K_ENVS, gen, dev)
    err, ms, got = k1_at_scale(mh, params, qpos, qvel, rows, gen,
                               f"K1-hfield ramps B={CELL_5K_ENVS}")
    flat = fleet_kernel.pd_substep(m, params, qpos, qvel, rows)
    if not all(torch.equal(a, b) for a, b in zip(got, flat)):
        raise AssertionError("K1-hfield ramps: the heightfield build with "
                             "hfield_active 0 differs from the flat kernel")
    out[f"k1_hfield_ramps_B{CELL_5K_ENVS}"] = dict(
        max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}",
        bitwise_flat_kernel=True)
    for k, v in out.items():
        print(f"  {k}: " + ", ".join(f"{a} {b}" for a, b in v.items()),
              flush=True)
    return out


def suite_line(name, secs, n, **info):
    """Print one suite's figures, launches, seconds and peak memory on
    its own line, and start the next suite's peak from zero."""
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    fields = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"  {name}: {fields} launches={n} host_s={secs:.2f} "
          f"peak_MiB={peak:.1f}", flush=True)


def run_suites(tag: str, ckpt: str):
    """The eval battery's suites on `ckpt` through the port's entry
    points, each counted (K1 once per substep, a heightfield launch on a
    terrain checkpoint; K2 at every reset and once per `step` for the
    pre-step foot positions, none in step_basic or the playground's step;
    K3 never) and printed beside JAX's committed figures."""
    exp = load_experiment(ckpt, device="cuda")
    env, simrate = exp.env, exp.env.simrate
    hfield = env.model.enable_hfield
    with open(os.path.join(JAX_BATTERY[tag], "summary.json")) as f:
        jax_sum = json.load(f)

    def policy_fn(obs):
        return exp.actor.act(exp.norm, obs, deterministic=True)

    def want(steps, k2, hf=hfield):
        return {"K1": steps * simrate, "K1-hfield": steps * simrate * hf,
                "K2": k2, "K3": 0}

    out = {}
    torch.cuda.reset_peak_memory_stats()
    res, secs, n = count_launches(lambda: eval_suites.eval_perturbation(
        env, policy_fn, max_force=350.0))
    check_counts(f"{tag} perturb", n, want(PERTURB_STEPS,
                                           PERTURB_STEPS + 1))
    surv = res["survival"]
    if surv.shape != (8, 14, 4):
        raise AssertionError(f"{tag} perturb: survival {surv.shape}")
    got = [float(x) for x in res["max_force_per_angle"]]
    ref = jax_sum["perturb"]["max_force_per_angle"]
    mean_gap = abs(np.mean(got) - np.mean(ref))
    out["perturb"] = dict(max_force_per_angle=got, jax=ref,
                          within_25N=[abs(a - b) <= 25.0
                                      for a, b in zip(got, ref)],
                          mean_N=float(np.mean(got)),
                          jax_mean_N=float(np.mean(ref)),
                          survivors_25N=int(surv[:, 0].sum()),
                          survivors_350N=int(surv[:, -1].sum()),
                          n_nonfinite=res["n_nonfinite"])
    suite_line(f"{tag} perturb (448 envs)", secs, n, **out["perturb"])
    # a push that never reaches K1 survives everywhere (350 N at every
    # angle); one that knocks every env over survives nowhere. JAX's own
    # seeds move the mean over angles by up to 62.5 N (PERF.md section 6)
    if surv[:, -1].all() or not surv[:, 0].any():
        raise AssertionError(f"{tag} perturb: {int(surv[:, 0].sum())} of "
                             f"32 survive 25 N and {int(surv[:, -1].sum())}"
                             " of 32 survive 350 N")
    if not mean_gap <= PERTURB_MEAN_TOL:
        raise AssertionError(f"{tag} perturb: mean largest push "
                             f"{np.mean(got):.1f} N, JAX's "
                             f"{np.mean(ref):.1f} N")

    res, secs, n = count_launches(lambda: eval_suites.eval_commands(
        env, policy_fn, n_trials=SUITE_TRIALS))
    check_counts(f"{tag} commands", n, want(COMMAND_STEPS,
                                            COMMAND_STEPS + 1))
    p, pj = float(res["pass_rate"]), jax_sum["commands"]["pass_rate"]
    tol = 1.96 * (pj * (1 - pj) * 2 / SUITE_TRIALS) ** 0.5
    out["commands"] = dict(
        pass_rate=p, jax=pj, tol=round(tol, 4), within=abs(p - pj) <= tol,
        n_speed_fails=res["n_speed_fails"],
        n_orient_fails=res["n_orient_fails"],
        n_nonfinite=res["n_nonfinite"])
    suite_line(f"{tag} commands ({SUITE_TRIALS} envs)", secs, n,
               **out["commands"])
    if not out["commands"]["within"]:
        raise AssertionError(f"{tag} commands: pass rate {p} is not within "
                             f"{tol:.4f} of JAX's {pj}")

    if tag == "mk4":
        res, secs, n = count_launches(lambda: eval_suites.eval_missions(
            eval_suites.playground_policy(exp),
            eval_suites.BATTERY_MISSIONS, simrate=simrate))
        steps = max(r["total"] for r in res.values())
        check_counts(f"{tag} missions", n, want(steps, 1, hf=False))
        ref = jax_sum["missions"]
        out["missions"] = {m: dict(
            success=r["success"], progress=r["progress"],
            jax_success=bool(ref[m]["success"]),
            jax_progress=int(ref[m]["progress"])) for m, r in res.items()}
        left, right = res["90_left_1.4"], res["90_right_1.4"]
        same = all(left[k] == right[k] for k in (
            "success", "progress", "avg_pos_error", "avg_speed_error",
            "avg_orient_error"))
        suite_line(f"{tag} missions (5 envs, {steps} steps)", secs, n,
                   missions=out["missions"], left_equals_right=same)
        for m, r in out["missions"].items():
            if r["success"] != r["jax_success"] or abs(
                    r["progress"] - r["jax_progress"]) > 0.05 * max(
                        r["jax_progress"], 1):
                raise AssertionError(f"{tag} mission {m}: {r}")
        if not same:
            raise AssertionError("90_left_1.4 and 90_right_1.4 differ")

    if tag == "mk5c":
        mission, speed = CELL_5K
        res, secs, n = count_launches(lambda: eval_suites.eval_5k_matrix(
            policy_fn, env, missions=(mission,), mission_speeds=(speed,)))
        steps = res["policy_steps"]
        check_counts(f"{tag} 5k {mission}_{speed}", n,
                     want(steps, 1, hf=True))
        with open(os.path.join(JAX_BATTERY[tag], "eval_5k.pkl"), "rb") as f:
            jax_5k = pickle.load(f)
        mi = list(jax_5k["grid"]["missions"]).index(mission)
        si = list(jax_5k["grid"]["mission_speeds"]).index(speed)
        jax_cell = jax_5k["passed"][mi, si]
        agree = float((res["passed"][0, 0] == jax_cell).mean())
        out["5k_cell"] = dict(
            envs=CELL_5K_ENVS, steps=steps,
            pass_rate=float(res["pass_rate"]),
            jax_cell_pass_rate=float(jax_cell.mean()),
            jax_by_mission=jax_sum["5k"]["by_mission"][mission],
            trials_agreeing_with_jax=round(agree, 4),
            by_terrain={k: round(float(v), 3)
                        for k, v in res["by_terrain"].items()},
            n_nonfinite=res["n_nonfinite"])
        suite_line(f"{tag} 5k {mission}_{speed} ({CELL_5K_ENVS} envs)",
                   secs, n, **out["5k_cell"])
        if not abs(out["5k_cell"]["pass_rate"]
                   - out["5k_cell"]["jax_cell_pass_rate"]) <= 0.05:
            raise AssertionError(f"{tag} 5k cell: {out['5k_cell']}")
    return out



# ---------------------------------------------------------------------------
# several ranks: K1-part, the SPMD iteration, NCCL, the CLI under torchrun
# ---------------------------------------------------------------------------

# K1-part's fleet over MR_WORLD ranks sharing the card (gloo); the SPMD
# iteration's Cassie-v0 PPO (dyn-rand, mirror): 256 envs, 8 policy steps
# per env, local minibatch 512 // world, 3 epochs, two iterations
MR_WORLD, MR_FLEET = 2, 1024
SPMD_ENVS, SPMD_STEPS, SPMD_MB, SPMD_ITR, SPMD_NORM = 256, 2048, 512, 2, 1024
RANK_TIMEOUT_S = 600


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(job: str, world: int, **kw):
    """`rank_main(job)` in `world` processes, the ranks of one group on
    this host's first card (APEX_* variables; LOCAL_WORLD_SIZE = world, so
    more than one rank per card joins with gloo, one with NCCL). Each rank
    loads the library the parent built. Returns the ranks' JSON results in
    rank order; a rank that fails ends the others and raises."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as out:
        base = dict(os.environ, APEX_COORD_ADDR=f"127.0.0.1:{_free_port()}",
                    APEX_NUM_PROCS=str(world), LOCAL_WORLD_SIZE=str(world),
                    PYTHONPATH=root)
        code = ("import json, sys, chip_smoke; "
                "chip_smoke.rank_main(sys.argv[1], sys.argv[2], "
                "json.loads(sys.argv[3]))")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, job, out, json.dumps(kw)],
            cwd=root, env=dict(base, APEX_PROC_ID=str(r), LOCAL_RANK=str(r)))
            for r in range(world)]
        t_end = time.time() + RANK_TIMEOUT_S
        try:
            while True:
                rcs = [p.poll() for p in procs]
                if any(rc not in (None, 0) for rc in rcs) \
                        or all(rc == 0 for rc in rcs):
                    break
                if time.time() > t_end:
                    raise AssertionError(f"{job}: ranks still running after "
                                         f"{RANK_TIMEOUT_S} s")
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        if rcs != [0] * world:
            raise AssertionError(f"{job}: rank exit codes {rcs}")
        results = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                results.append(json.load(f))
        return results


def rank_main(job: str, out: str, kw: dict) -> None:
    """One rank of `run_ranks`: join the group, run the job, write its
    result."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import multihost
    from apex_tpu_torch.parallel.mesh import make_mesh

    multihost.initialize()
    mesh = make_mesh()
    try:
        res = RANK_JOBS[job](mesh, **kw)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(res, f)


def k1_part_job(mesh, timed: bool = True):
    """K1-part at MR_FLEET envs over the group, flat and heightfield: every
    rank draws the same whole fleet (k1_inputs), launches K1 on all of it,
    then K1-part on its block; the gathered blocks must equal the whole
    launch bit for bit, at a local width of MR_FLEET / world. With
    `timed`, rank 0 holds its block against the plain version and times
    K1-part and K1 launched alone on the same block while the other ranks
    wait."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel.mesh import env_block
    from apex_tpu_torch.utils.tree import tree_map

    gen = torch.Generator()           # the fleets: the same on every rank
    gen.manual_seed(14)
    spread_gen = torch.Generator()    # rank 0's rounding envelopes
    spread_gen.manual_seed(15)
    out = {}
    for terrain in (0.0, 0.06):
        m = cassie_model(enable_hfield=bool(terrain))
        tag = "K1-part-hfield" if terrain else "K1-part"
        params, qpos, qvel, rows = k1_inputs(MR_FLEET, gen, mesh.device,
                                             terrain)
        whole = fleet_kernel.pd_substep(m, params, qpos, qvel, rows)
        block = env_block(MR_FLEET, mesh.rank, mesh.world)
        take = lambda x: x[..., block].contiguous()
        p_s, q_s, v_s, r_s = (tree_map(take, params), take(qpos),
                              take(qvel), take(rows))
        fleet_kernel.LAST_KERNEL_BATCH = None
        with fleet_kernel.partitioned(mesh.world, MR_FLEET):
            shard = fleet_kernel.partitioned_pd_substep(m, p_s, q_s, v_s,
                                                        r_s)
            width = fleet_kernel.LAST_KERNEL_BATCH
            gathered = [mesh.all_gather(x, -1) for x in shard]
            if width != MR_FLEET // mesh.world:
                raise AssertionError(f"{tag}: a launch {width} envs wide, "
                                     f"want {MR_FLEET // mesh.world}")
            if not all(torch.equal(a, b) for a, b in zip(gathered, whole)):
                raise AssertionError(f"{tag}: the gathered shards differ "
                                     "from the whole launch")
            res = dict(local_width=width, bitwise=True)
            if timed and mesh.rank == 0:
                worst, plain_ms, _ = k1_vs_plain(
                    m, p_s, q_s, v_s, r_s, spread_gen, f"{tag} shard",
                    got=shard)
                ms = device_ms(lambda: fleet_kernel.partitioned_pd_substep(
                    m, p_s, q_s, v_s, r_s), 20, "pd_substep_kernel")
                alone_ms = device_ms(lambda: fleet_kernel.pd_substep(
                    m, p_s, q_s, v_s, r_s), 20, "pd_substep_kernel")
                bnd, by, _ = bound_ms(k1_bytes(m, p_s), k1_flops(m, p_s))
                res.update(
                    max_abs_err=max(v[0] for v in worst.values()),
                    worst_over_bound=max(v[1] for v in worst.values()),
                    ms=ms, k1_alone_ms=alone_ms, plain_ms=plain_ms,
                    bound_ms=bnd, bound_by=by, library_ms=None)
        dist.barrier()
        out[tag] = res
    return out


def lockstep(mesh, state) -> bool:
    """Whether every rank holds the same replicated tensors bit for bit
    (the nets, the normaliser, both optimisers' moments and counts)."""
    from apex_tpu_torch.parallel.mesh import replicated_tensors

    counts = torch.tensor([float(state.actor_opt.count),
                           float(state.critic_opt.count)], device=mesh.device)
    flat = torch.cat([x.detach().reshape(-1)
                      for x in replicated_tensors(state)] + [counts])
    rows = mesh.all_gather(flat[None], 0)
    return all(torch.equal(row, rows[0]) for row in rows)


def spmd_job(mesh, n_itr: int = SPMD_ITR):
    """`n_itr` SPMD iterations of PPO on Cassie-v0 (K1) over the group:
    rank 0 prenormalises, `shard_ppo_state` places the state, each
    iteration counted (K1 and K1-part 50 per policy step of the rank's
    block, K2 2 per step). The last iteration times the all-reduces
    (`Mesh.timing`). Returns per iteration the seconds, the counts and
    the metrics, the all-reduce seconds and calls of the timed one, and
    whether the ranks' replicated tensors agree bit for bit after."""
    from apex_tpu_torch.parallel.mesh import shard_ppo_state

    env = CassieEnv(dynamics_randomization=True, device=mesh.device)
    cfg = PPOConfig(num_envs=SPMD_ENVS, num_steps=SPMD_STEPS,
                    max_traj_len=TRAJ_LEN, minibatch_size=SPMD_MB)
    ppo = PPO(env, cfg)
    state = ppo.init(seed=0)
    if mesh.rank == 0:
        state = ppo.prenormalize(state, steps=SPMD_NORM)
    state = shard_ppo_state(state, mesh)
    if state.runner.obs.shape[0] != SPMD_ENVS // mesh.world:
        raise AssertionError(f"a rank's block of {state.runner.obs.shape}")
    want = {"K1": SIMRATE * cfg.rollout_len, "K1-hfield": 0,
            "K1-part": SIMRATE * cfg.rollout_len, "K2": 2 * cfg.rollout_len,
            "K3": 0}
    itrs = []
    for itr in range(n_itr):
        mesh.timing = itr == n_itr - 1
        mesh.reduce_calls, mesh.reduce_seconds = 0, 0.0
        (state, metrics), secs, n = count_launches(
            lambda: ppo._train_iteration(state, 1.0, mesh))
        check_counts(f"spmd iteration {itr} rank {mesh.rank}", n, want)
        metrics = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"spmd iteration {itr}: {metrics}")
        itrs.append(dict(seconds=secs, launches=n, metrics=metrics))
    same = lockstep(mesh, state)
    if not same:
        raise AssertionError(f"rank {mesh.rank}: the ranks' nets, "
                             "normaliser or optimisers differ")
    return dict(iterations=itrs, reduce_seconds=mesh.reduce_seconds,
                reduce_calls=mesh.reduce_calls, backend=mesh.backend,
                lockstep=same)


RANK_JOBS = {"k1_part": k1_part_job, "spmd": spmd_job}

# the CLI under torchrun: one iteration of 256 envs over two ranks
MR_CLI_ITR, MR_CLI_TRAJ, MR_CLI_NORM = 1, 20, 512


def torchrun_cli():
    """`python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    apex_tpu_torch ppo` on Cassie-v0: exit 0, one run directory named by
    apex.py's hash, its checkpoint the whole fleet in the leaf shapes and
    dtypes of a single-process state of the same configuration, loading
    back through the port's loader and evaluating."""
    import glob

    from apex_tpu_torch.runtime.checkpoint import to_jax_leaves

    logdir = os.path.join("chiprun_out", f"smoke_torchrun_{os.getpid()}")
    argv = ["ppo", "--env_name", "Cassie-v0", "--dyn_random", "--mirror",
            "--num_procs", str(SPMD_ENVS), "--num_steps", str(SPMD_STEPS),
            "--minibatch_size", str(SPMD_MB), "--max_traj_len",
            str(MR_CLI_TRAJ), "--n_itr", str(MR_CLI_ITR),
            "--input_norm_steps", str(MR_CLI_NORM), "--logdir", logdir]
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(MR_WORLD), "-m", "apex_tpu_torch", *argv],
        capture_output=True, text=True, timeout=RANK_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__))))
    secs = time.time() - t0
    if out.returncode != 0:
        raise AssertionError(f"torchrun exited with {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    line = f"env fleet sharded over {MR_WORLD} ranks (gloo"
    if line not in out.stdout:
        raise AssertionError(f"torchrun: no '{line}' in\n{out.stdout}")
    runs = glob.glob(os.path.join(logdir, "Cassie-v0", "*"))
    if len(runs) != 1:
        raise AssertionError(f"torchrun: run directories {runs}")
    (run_dir,) = runs
    with open(os.path.join(run_dir, "experiment.pkl"), "rb") as f:
        name = f"{args_hash(pickle.load(f))}-seed0"
    if os.path.basename(run_dir) != name:
        raise AssertionError(f"torchrun: run dir {run_dir}, want {name}")
    with open(os.path.join(run_dir, "checkpoint.pkl"), "rb") as f:
        leaves = pickle.load(f)
    env = CassieEnv(dynamics_randomization=True)
    ref = to_jax_leaves(PPO(env, PPOConfig(num_envs=SPMD_ENVS)).init(0), env)
    shapes = lambda xs: [(np.shape(x), np.asarray(x).dtype.str) for x in xs]
    if shapes(leaves) != shapes(ref):
        raise AssertionError("torchrun: the checkpoint's leaves are not a "
                             f"{SPMD_ENVS}-env state's")
    ret, ln = eval_checkpoint(run_dir, n_episodes=8, traj_len=10,
                              device="cuda")
    if not (np.isfinite(ret) and ln > 0):
        raise AssertionError(f"torchrun run dir gave return {ret}, length "
                             f"{ln}")
    return dict(seconds=secs, run_dir=run_dir, leaves=len(leaves),
                reloaded_return=ret)


def multi_rank():
    """The phase: K1-part over MR_WORLD gloo ranks sharing the card, the
    SPMD iteration over them and over a one-rank NCCL group (the same
    total fleet), and the CLI under torchrun. Returns (K1-part's figures,
    the per-rank K1-part count of the SPMD run, the phase's summary)."""
    t0 = time.time()
    k1p = run_ranks("k1_part", MR_WORLD)
    k1p_s = time.time() - t0
    for tag, res in k1p[0].items():
        print(f"  {tag} B={MR_FLEET} over {MR_WORLD} ranks: local width "
              f"{res['local_width']}, gathered bit for bit; shard vs plain "
              f"max err {res['max_abs_err']:.3e} "
              f"({res['worst_over_bound']:.2f} x bound); kernel "
              f"{res['ms']:.4f} ms, K1 alone at {res['local_width']} "
              f"{res['k1_alone_ms']:.4f} ms, plain {res['plain_ms']:.1f} "
              f"ms, bound {res['bound_ms'] * 1e3:.3f} us "
              f"({res['bound_by']})", flush=True)
    t0 = time.time()
    spmd = run_ranks("spmd", MR_WORLD)
    spmd_s = time.time() - t0
    t0 = time.time()
    (nccl,) = run_ranks("spmd", 1)
    nccl_s = time.time() - t0
    for tag, runs in (("gloo", spmd), ("nccl", [nccl])):
        for r, run in enumerate(runs):
            print(f"  spmd {tag} rank {r}: " + "; ".join(
                f"itr {i} {it['seconds']:.3f} s, kl "
                f"{it['metrics']['kl']:.5f}, episodes "
                f"{it['metrics']['num_episodes']:.0f}"
                for i, it in enumerate(run["iterations"]))
                + f"; all-reduces {run['reduce_calls']} in "
                f"{run['reduce_seconds']:.3f} s", flush=True)
    if spmd[0]["backend"] != "gloo" or nccl["backend"] != "nccl":
        raise AssertionError(f"backends {spmd[0]['backend']}, "
                             f"{nccl['backend']}")
    if spmd[0]["iterations"][-1]["metrics"] != \
            spmd[1]["iterations"][-1]["metrics"]:
        raise AssertionError("spmd: the ranks' metrics differ")
    t0 = time.time()
    cli = torchrun_cli()
    last = lambda run: run["iterations"][-1]["seconds"]
    part_launches = sum(it["launches"]["K1-part"]
                        for it in spmd[0]["iterations"])
    summary = dict(
        k1_part_s=f"{k1p_s:.1f}",
        k1_part_ms={t: f"{r['ms']:.4f}" for t, r in k1p[0].items()},
        k1_alone_ms={t: f"{r['k1_alone_ms']:.4f}"
                     for t, r in k1p[0].items()},
        spmd_s=f"{spmd_s:.1f}", nccl_s=f"{nccl_s:.1f}",
        spmd_itr_s_gloo_2_ranks=[
            f"{max(r['iterations'][i]['seconds'] for r in spmd):.3f}"
            for i in range(SPMD_ITR)],
        spmd_itr_s_nccl_1_rank=[f"{it['seconds']:.3f}"
                                for it in nccl["iterations"]],
        gloo_reduce_share=f"{spmd[0]['reduce_seconds'] / last(spmd[0]):.4f}",
        gloo_reduce_calls=spmd[0]["reduce_calls"],
        nccl_reduce_share=f"{nccl['reduce_seconds'] / last(nccl):.4f}",
        k1_part_launches_per_rank=part_launches,
        lockstep=all(r["lockstep"] for r in spmd),
        torchrun_s=f"{cli['seconds']:.1f}",
        torchrun_run_dir=cli["run_dir"],
        torchrun_reloaded_return=f"{cli['reloaded_return']:.4f}")
    return k1p[0], part_launches, summary


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
    build_s = time.time() - t0
    cuda_build.library()
    build_log = so.with_suffix(".log").read_text().strip()
    print(build_log, flush=True)
    phase("build", t0, library=so.name, build_seconds=f"{build_s:.2f}")
    # the analysis and profiling tools first: torch.profiler drops more of
    # a window's first kernels the longer the process has run, and this
    # phase's trace must hold every K1 launch of a policy step
    t0 = time.time()
    phase("analysis", t0, **check_analysis(dev))

    gen = torch.Generator()
    gen.manual_seed(0)
    t0 = time.time()
    k3 = check_k3(gen, dev, build_log)
    phase("K3", t0)
    t0 = time.time()
    k3_bf = check_k3_bf(gen, dev, build_log)
    phase("K3-bf", t0)
    t0 = time.time()
    k2 = check_k2(gen, dev, build_log)
    phase("K2", t0)
    t0 = time.time()
    k1 = check_k1(gen, dev, build_log)
    phase("K1", t0)
    t0 = time.time()
    k1h = check_k1(gen, dev, build_log, terrain=0.06)
    phase("K1-hfield", t0)
    # K1 at the eval suites' fleets, timed while the profiler's traces are
    # whole: later in the run, after the training and off-policy phases,
    # traces of 10 launches held 2 and then none (PERF.md section 6)
    t0 = time.time()
    phase("K1-suites", t0, **check_k1_suites(gen, dev))
    t0 = time.time()
    phase("K1-gains", t0, **check_k1_gains(dev))

    t0 = time.time()
    reset_diff, qvel_diff, qpos_diff, ratio = check_parity(dev)
    phase("parity", t0, reset_obs_max_diff=f"{reset_diff:.3e}",
          substep_qvel_max_diff=f"{qvel_diff:.3e}",
          substep_qpos_max_diff=f"{qpos_diff:.3e}",
          substep_diff_over_bound=f"{ratio:.3f}")
    t0 = time.time()
    phase("clock_5k", t0, **check_clock_5k())

    # the main path: the megakernel-tier evaluation, counted per seed.
    # K1: once per substep; K2: once per step for the pre-step foot
    # positions, once per step for the auto-reset fleet, once for the
    # initial reset; K3: never
    t0 = time.time()
    eval_n = eval_seeds("eval", CKPT, SIMRATE, hfield=False)
    phase("eval", t0, **eval_n.pop("summary"))

    # the fleet tier at reduced depth: K3 once per substep, K2 once per
    # substep, twice per step and once at the reset
    t0 = time.time()
    ep_ret, ep_len, secs, fleet_n = run_eval("fleet", FLEET_TRAJ_LEN, 42)
    fleet_ret = ep_ret
    check_counts("eval_fleet", fleet_n, {
        "K1": 0, "K1-hfield": 0, "K2": FLEET_TRAJ_LEN * (SIMRATE + 2) + 1,
        "K3": FLEET_TRAJ_LEN * SIMRATE})
    phase("eval_fleet", t0, mean_return=f"{ep_ret:.4f}",
          mean_length=f"{ep_len:.2f}",
          ms_per_policy_step=f"{secs / FLEET_TRAJ_LEN * 1e3:.2f}",
          k3_launches=fleet_n["K3"], k2_launches=fleet_n["K2"])

    # the terrain checkpoints through K1's heightfield branch
    terrain_n = {}
    for name, (ckpt, simrate) in TERRAIN_CKPTS.items():
        t0 = time.time()
        terrain_n[name] = eval_seeds(f"eval_{name}", ckpt, simrate,
                                     hfield=True)
        phase(f"eval_{name}", t0, **terrain_n[name].pop("summary"))
    ckpt, simrate = TERRAIN_CKPTS["mk5c"]
    t0 = time.time()
    ep_ret, ep_len, secs, n = run_eval("fleet", FLEET_TRAJ_LEN, 42, ckpt)
    check_counts("eval_fleet_mk5c", n, {
        "K1": 0, "K1-hfield": 0, "K2": FLEET_TRAJ_LEN * (simrate + 2) + 1,
        "K3": FLEET_TRAJ_LEN * simrate})
    phase("eval_fleet_mk5c", t0, mean_return=f"{ep_ret:.4f}",
          mean_length=f"{ep_len:.2f}",
          ms_per_policy_step=f"{secs / FLEET_TRAJ_LEN * 1e3:.2f}",
          k3_launches=n["K3"], k2_launches=n["K2"])

    # the per-env engine tier (K3-bf), and the analysis and profiling
    # tools on the megakernel tier
    t0 = time.time()
    per_env_n, per_env = check_per_env(dev, fleet_ret)
    phase("per_env", t0, **per_env)
    t0 = time.time()
    phase("tools", t0, **check_tools())

    # the checkpoints the CassieEnv switches unlock, and CassieTraj-v0
    t0 = time.time()
    phase("eval_switches", t0, **eval_switch_ckpts())

    t0 = time.time()
    phase("step_1024", t0, **step_1024(dev))

    t0 = time.time()
    phase("train", t0, **train(dev))
    t0 = time.time()
    phase("train_new_envs", t0, **train_new_envs())
    t0 = time.time()
    phase("curves", t0, **curves())

    # Walker2d on the fleet tier, and the learners beyond PPO
    t0 = time.time()
    walker = check_walker_fleet(dev)
    phase("walker_fleet", t0, **walker.pop("summary"))
    t0 = time.time()
    wppo = walker2d_ppo(dev)
    wppo_n = wppo.pop("launches")
    phase("walker2d_ppo", t0, **wppo)
    t0 = time.time()
    phase("td3", t0, **td3_walker(dev))
    t0 = time.time()
    phase("td3_cassie", t0, **td3_cassie())
    t0 = time.time()
    phase("ddpg", t0, **ddpg_walker())
    t0 = time.time()
    phase("ars", t0, **ars_walker())

    # the recurrent learners
    t0 = time.time()
    phase("recurrent_ppo_walker", t0, **recurrent_ppo_walker(dev))
    t0 = time.time()
    phase("recurrent_ppo_cassie", t0, **recurrent_ppo_cassie())
    t0 = time.time()
    phase("rdpg", t0, **rdpg_walker())
    t0 = time.time()
    phase("ars_recurrent", t0, **ars_recurrent_walker())

    # the eval battery's suites
    for tag, ckpt in (("mk4", CKPT), ("mk5c", TERRAIN_CKPTS["mk5c"][0])):
        t0 = time.time()
        suites = run_suites(tag, ckpt)
        phase(f"suites_{tag}", t0, suites=json.dumps(suites))

    # several ranks of one group, each loading the library built above
    t0 = time.time()
    k1_part, k1_part_n, mr = multi_rank()
    phase("multi_rank", t0, **mr)

    record = {"kernels": [
        {"name": "K1 pd_substep", "route": "cuda",
         "source": "apex_tpu_torch/csrc/fleet_kernel.cu",
         "replaces": "apex_tpu/physics/fleet_kernel.py:124",
         "launches": eval_n["K1"], **k1[N_ENVS]},
        {"name": "K1 pd_substep, heightfield branch", "route": "cuda",
         "source": "apex_tpu_torch/csrc/fleet_kernel.cu",
         "replaces": "apex_tpu/physics/fleet_kernel.py:455",
         "launches": terrain_n["mk5c"]["K1-hfield"], **k1h[N_ENVS]},
        {"name": "K3 spd_inverse_bt", "route": "cuda",
         "source": "apex_tpu_torch/csrc/spd_inverse.cu",
         "replaces": "apex_tpu/ops/pallas_linalg.py:36",
         "launches": fleet_n["K3"],
         "max_abs_err": k3[("cassie", N_ENVS)]["max_abs_err"],
         **k3[("time", N_ENVS)]},
        {"name": "K2 fleet_fk", "route": "cuda",
         "source": "apex_tpu_torch/csrc/fleet_fk.cu",
         "replaces": "apex_tpu/physics/fleet_fk.py:33",
         "launches": eval_n["K2"],
         "max_abs_err": k2[N_ENVS]["max_abs_err"],
         "ms": k2[N_ENVS]["ms"], "plain_ms": k2[N_ENVS]["plain_ms"],
         "bound_ms": k2[N_ENVS]["bound_ms"],
         "bound_by": k2[N_ENVS]["bound_by"], "library_ms": None},
        {"name": "K2 fleet_fk, Walker2d B=2048", "route": "cuda",
         "source": "apex_tpu_torch/csrc/fleet_fk.cu",
         "replaces": "apex_tpu/physics/fleet_fk.py:33",
         "launches": wppo_n["K2"], **walker["K2"]},
        {"name": "K3 spd_inverse_bt, Walker2d M+hD n=9 B=2048",
         "route": "cuda", "source": "apex_tpu_torch/csrc/spd_inverse.cu",
         "replaces": "apex_tpu/ops/pallas_linalg.py:36",
         "launches": wppo_n["K3"], **walker["K3"]},
        {"name": "K3-bf spd_inverse_bf, Cassie M+hD (64, 32, 32)",
         "route": "cuda", "source": "apex_tpu_torch/csrc/spd_inverse.cu",
         "replaces": "apex_tpu/ops/pallas_linalg.py:142",
         "launches": per_env_n["K3-bf"], **k3_bf[(32, N_ENVS)]},
        {"name": f"K1-part partitioned_pd_substep, a rank's "
                 f"{MR_FLEET // MR_WORLD} of {MR_FLEET} envs",
         "route": "cuda", "source": "apex_tpu_torch/csrc/fleet_kernel.cu",
         "replaces": "apex_tpu/physics/fleet_kernel.py:999",
         "launches": k1_part_n,
         **{k: k1_part["K1-part"][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}},
    ]}
    at_fleet = {"K1": {k: v for k, v in k1[FLEET].items()
                       if k != "max_abs_err"},
                "K1-hfield": {k: v for k, v in k1h[FLEET].items()
                              if k != "max_abs_err"},
                "K3": k3[("time", FLEET)],
                "K3-bf": k3_bf[(32, FLEET)],
                "K3-bf n=9 B=2048": k3_bf[(9, 2048)],
                "K3 n=9 B=2048": k3[("time", (9, 2048))],
                "K2": {k: v for k, v in k2[FLEET].items()
                       if k != "max_abs_err"},
                "K1-part heightfield, a rank's 512": {
                    k: v for k, v in k1_part["K1-part-hfield"].items()
                    if k != "max_abs_err"}}
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
