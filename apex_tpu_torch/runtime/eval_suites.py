"""Behavioral evaluation suites, each run as one fleet.

Port of `apex_tpu/runtime/eval_suites.py` (the reference's Ray-parallel
eval tools, SURVEY.md section 4): push robustness, command following,
missions, parameter sensitivity and the "5k" robustness matrix. The JAX
suites vmap a function of one trial; here every trial of a suite is an env
of one batch-last fleet, its per-trial commands (speed, phase_add,
orient_add, the pelvis wrench, friction, foot mass, floor tilt and terrain
table) are (B,)-wide tensors, and the steps are a Python loop over the
fleet. Randomness enters as explicit draws: the env's reset and step draws
(`sample_reset_noise`, `sample_step_noise`) and the command schedules'
(`sample_command_draws`), so a test can hand in JAX's.

Under the height criterion a fallen robot keeps stepping, as in the
reference; a state that goes non-finite fails no trial there (NaN never
compares below 0.4), in JAX and here alike, so each suite counts those
envs (`n_nonfinite`) and says which they are (`nonfinite_trials`).

A policy is a function obs (B, obs_dim) -> action (B, act_dim).
"""
from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from apex_tpu_torch.utils.quaternion import euler2quat, quat2euler

TERRAINS_5K = (Path(__file__).resolve().parent.parent / "data"
               / "terrains_5k.npz")


def _run_steps(env, policy_fn, state, obs, generator, n_steps: int,
               fail: str = "term"):
    """Step the fleet n_steps times; returns (state, obs, fallen (B,),
    non-finite (B,): the envs whose qpos left the finite numbers).

    fail="term" counts the env's own termination (the perturbation
    semantics, eval_perturb.py:59-81); fail="height" only qpos[2] < 0.4,
    the env's termination ignored and the envs stepping on
    (test_commands.py:113-115)."""
    B = obs.shape[0]
    fallen = torch.zeros((B,), dtype=torch.bool, device=obs.device)
    nonfinite = torch.zeros_like(fallen)
    for _ in range(n_steps):
        action = policy_fn(obs)
        state, obs, _, term = env.step(state, action,
                                       env.sample_step_noise(generator, B))
        fallen |= (state.phys.qpos[2] < 0.4) if fail == "height" else term
        nonfinite |= ~torch.isfinite(state.phys.qpos).all(dim=0)
    return state, obs, fallen, nonfinite


def _generator(env, seed: int) -> torch.Generator:
    generator = torch.Generator(device=env.device)
    generator.manual_seed(seed)
    return generator


@torch.no_grad()
def eval_perturbation(env, policy_fn: Callable, num_angles: int = 8,
                      max_force: float = 200.0, force_step: float = 25.0,
                      num_phases: int = 4, wait_steps: int = 40,
                      perturb_steps: int = 8, recover_steps: int = 40,
                      seed: int = 0):
    """Survival over (angle, force, gait phase) (reference compute_perturbs,
    eval_perturb.py:104-200): a reset fleet commanded to 0.5 m/s settles
    for wait_steps, a horizontal world-frame force pushes the pelvis for
    perturb_steps, and it must survive recover_steps more. Returns the
    survival matrix and the largest force survived at every phase, per
    angle."""
    angles = np.linspace(0, 2 * np.pi, num_angles, endpoint=False)
    forces = np.arange(force_step, max_force + 1e-6, force_step)
    A, F, P = np.meshgrid(angles, forces, np.arange(num_phases),
                          indexing="ij")
    dev, B = env.device, A.size
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32).ravel(),
                                    device=dev)
    angle, force, phase_idx = f32(A), f32(F), f32(P)
    gen = _generator(env, seed)

    state, obs = env.reset(env.sample_reset_noise(gen, B))
    # walk in place at 0.5 m/s from the trial's phase of the gait
    state = dataclasses.replace(
        state, speed=torch.full((B,), 0.5, device=dev),
        side_speed=torch.zeros((B,), device=dev),
        phase=state.clock.phaselen * phase_idx / num_phases)
    state, obs, fallen0, bad0 = _run_steps(env, policy_fn, state, obs, gen,
                                           wait_steps)
    # the push: [torque; force] wrench on the pelvis, in the world frame
    push = torch.zeros((6, B), device=dev)
    push[3] = force * torch.cos(angle)
    push[4] = force * torch.sin(angle)
    state = dataclasses.replace(
        state, params=dataclasses.replace(state.params, ext_force=push))
    state, obs, fallen1, bad1 = _run_steps(env, policy_fn, state, obs, gen,
                                           perturb_steps)
    state = dataclasses.replace(state, params=dataclasses.replace(
        state.params, ext_force=torch.zeros_like(push)))
    _, _, fallen2, bad2 = _run_steps(env, policy_fn, state, obs, gen,
                                     recover_steps)

    survived = (~(fallen0 | fallen1 | fallen2)).cpu().numpy().reshape(
        num_angles, len(forces), num_phases)
    # the largest force survived at every phase, per angle
    all_phases = survived.all(axis=2)
    max_per_angle = np.zeros(num_angles)
    for i in range(num_angles):
        ok = np.where(all_phases[i])[0]
        max_per_angle[i] = forces[ok.max()] if len(ok) else 0.0
    return {"angles": angles, "forces": forces, "survival": survived,
            "max_force_per_angle": max_per_angle,
            "n_nonfinite": int((bad0 | bad1 | bad2).sum())}


class CommandDraws(NamedTuple):
    """The random draws of the command schedules (eval_suites.py:140-156),
    each (n_trials, n_commands): speed-step magnitudes U(0.4, 1.3) and
    signs, heading increments U(pi/6, pi/3) and signs (+-1)."""
    delta: torch.Tensor
    delta_sign: torch.Tensor
    inc: torch.Tensor
    inc_sign: torch.Tensor


def sample_command_draws(generator: torch.Generator, n_trials: int,
                         n_commands: int, device=None) -> CommandDraws:
    shape = (n_trials, n_commands)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(
        shape, generator=generator, device=device)
    sign = lambda: torch.where(torch.rand(shape, generator=generator,
                                          device=device) < 0.5, -1.0, 1.0)
    return CommandDraws(delta=u(0.4, 1.3), delta_sign=sign(),
                        inc=u(np.pi / 6, np.pi / 3), inc_sign=sign())


def command_schedule(draws: CommandDraws, max_speed: float = 3.0):
    """(speeds, orients), each (n_trials, n_commands), from the draws
    (test_commands.py:132-140): the speeds a random walk from 0.5 m/s whose
    step flips its sign where it would leave [0, max_speed], each command
    taking the walk's value before its own step; the headings the running
    sum of the increments."""
    deltas = draws.delta * draws.delta_sign
    s = torch.full_like(deltas[:, 0], 0.5)
    walk = []
    for d in deltas.unbind(1):
        d = torch.where((s + d < 0.0) | (s + d > max_speed), -d, d)
        s = s + d
        walk.append(s)
    speeds = torch.stack([torch.full_like(s, 0.5), *walk[:-1]], dim=1)
    orients = torch.cumsum(draws.inc * draws.inc_sign, dim=1)
    return speeds, orients


@torch.no_grad()
def eval_commands(env, policy_fn: Callable, n_trials: int = 64,
                  n_commands: int = 4, steps_per_command: int = 200,
                  max_speed: float = 3.0, seed: int = 0,
                  draws: CommandDraws | None = None):
    """Random speed and heading schedules with the reference's command
    statistics (test_commands.py:66-140), from the deterministic eval
    reset: each command sets the speed at its block's start (and the gait
    frequency, phase_add 1.5 above 1.4 m/s) and adds its heading at the
    block's midpoint. A trial passes if qpos[2] never drops below 0.4.
    Failures are classified by whether the speed or the heading change
    into the failing command was the larger (report_stats,
    test_commands.py:187-223)."""
    dev = env.device
    gen = _generator(env, seed)
    if draws is None:
        draws = sample_command_draws(gen, n_trials, n_commands, dev)
    speeds, orients = command_schedule(draws, max_speed)
    state, obs = env.reset_for_test(n_trials)
    fallen = torch.zeros((n_trials,), dtype=torch.bool, device=dev)
    nonfinite = torch.zeros_like(fallen)
    fail_idx = torch.full((n_trials,), -1, dtype=torch.int32, device=dev)
    half = steps_per_command // 2
    for idx in range(n_commands):
        speed = speeds[:, idx]
        state = dataclasses.replace(
            state, speed=speed, phase_add=torch.where(speed > 1.4, 1.5, 1.0))
        state, obs, f1, b1 = _run_steps(env, policy_fn, state, obs, gen,
                                        half, fail="height")
        state = dataclasses.replace(state, orient_add=orients[:, idx])
        state, obs, f2, b2 = _run_steps(env, policy_fn, state, obs, gen,
                                        steps_per_command - half,
                                        fail="height")
        f = f1 | f2
        fail_idx = torch.where(fallen | ~f, fail_idx, idx)
        fallen |= f
        nonfinite |= b1 | b2
    passed = (~fallen).cpu().numpy()
    fail_idx = fail_idx.cpu().numpy()
    out = {"pass_rate": passed.mean(), "passed": passed,
           "fail_command_idx": fail_idx}
    out.update(_command_failures(passed, fail_idx, speeds.cpu().numpy(),
                                 orients.cpu().numpy(), max_speed))
    out["n_nonfinite"] = int(nonfinite.sum())
    out["nonfinite_trials"] = np.flatnonzero(nonfinite.cpu().numpy())
    return out


def _command_failures(passed, fail_idx, speeds, orients, max_speed):
    """report_stats' failure aggregation (tools/test_commands.py:187-223):
    each failure is a speed failure if the speed change into the failing
    command, over the speed range, is at least the heading change over
    pi/2; with the failing speeds and heading changes averaged."""
    fail_speed, fail_orient = [], []
    speed_fails = orient_fails = 0
    for t in range(len(passed)):
        i = fail_idx[t]
        if passed[t] or i < 0:
            continue
        ds = abs(speeds[t, i] - (speeds[t, i - 1] if i > 0 else 0.0))
        do = abs(orients[t, i] - (orients[t, i - 1] if i > 0 else 0.0))
        if ds / max_speed >= do / (np.pi / 2):
            speed_fails += 1
        else:
            orient_fails += 1
        fail_speed.append(speeds[t, i])
        fail_orient.append(do)
    return {
        "n_speed_fails": speed_fails, "n_orient_fails": orient_fails,
        "avg_failing_speed": float(np.mean(fail_speed)) if fail_speed
        else float("nan"),
        "avg_failing_orient_delta": float(np.mean(fail_orient))
        if fail_orient else float("nan")}


BATTERY_MISSIONS = ("default", "straight_1.4", "curvy_1.4", "90_left_1.4",
                    "90_right_1.4")


def playground_policy(exp):
    """The policy of a Cassie-v0 run (a loaded experiment) on
    CassiePlayground's observation: the playground's command appendix is
    [sin, cos, speed] (49 dims) and the clock policy expects a side speed
    after it (50); missions command none, so a zero is appended (apex.py:
    240-251)."""

    def policy_fn(obs):
        if obs.shape[-1] == exp.env.observation_size - 1:
            obs = torch.cat([obs, obs.new_zeros(obs.shape[:-1] + (1,))],
                            dim=-1)
        return exp.actor.act(exp.norm, obs, deterministic=True)

    return policy_fn


@torch.no_grad()
def eval_missions(policy_fn: Callable, missions=("default",),
                  simrate: int = 60, max_steps: int = 1200, device=None,
                  pd_tier: str | None = None):
    """Mission completion on CassiePlayground (reference
    tools/eval_mission.py:45-112), every mission an env of one fleet: each
    runs min(max_steps, its schedule's length - 1) steps; success is not
    falling (height or reward < 0.3) before its end, progress the steps
    survived, and the position, speed and heading errors are traced per
    step (eval_mission.py:69-82) and averaged over the steps alive.
    Returns {mission: result}."""
    from apex_tpu_torch.envs.cassie_playground import CassiePlayground

    env = CassiePlayground(mission=tuple(missions), simrate=simrate,
                           device=device, pd_tier=pd_tier)
    B = len(env.missions)
    dev = env.device
    steps = torch.as_tensor([min(max_steps, n - 1) for n in env.trajlens],
                            device=dev)
    state, obs = env.reset(B)
    fallen = torch.zeros((B,), dtype=torch.bool, device=dev)
    progress = torch.zeros((B,), dtype=torch.int64, device=dev)
    traces = []
    for t in range(int(steps.max())):
        state, obs, _, term = env.step(state, policy_fn(obs))
        active = t < steps
        alive = ~(fallen | term)
        progress += (alive & active).to(torch.int64)
        qpos, qvel = state.phys.qpos, state.phys.qvel
        pos, speed, orient = env.command(state)
        pos_err = torch.linalg.vector_norm(
            qpos[0:2] - (pos[0:2] + state.last_position[0:2]), dim=0)
        speed_err = torch.abs(torch.linalg.vector_norm(qvel[0:2], dim=0)
                              - speed)
        orient_err = torch.abs(quat2euler(qpos[3:7])[2] - orient)
        traces.append(torch.stack([pos_err, speed_err, orient_err,
                                   alive.float()]))
        fallen = torch.where(active, fallen | term, fallen)
    traces = torch.stack(traces).cpu().numpy().astype(np.float64)
    out = {}
    for b, name in enumerate(env.missions):
        n = int(steps[b])
        pos_e, spd_e, ori_e, alive = traces[:n, :, b].T
        alive = alive.astype(bool)
        n_alive = max(int(alive.sum()), 1)
        out[name] = {
            "success": bool(~fallen[b]), "progress": int(progress[b]),
            "total": n, "pos_error": pos_e.astype(np.float32),
            "speed_error": spd_e.astype(np.float32),
            "orient_error": ori_e.astype(np.float32), "alive": alive,
            "avg_pos_error": float((pos_e * alive).sum() / n_alive),
            "avg_speed_error": float((spd_e * alive).sum() / n_alive),
            "avg_orient_error": float((ori_e * alive).sum() / n_alive)}
    return out


def eval_mission(policy_fn: Callable, mission: str = "default",
                 simrate: int = 60, max_steps: int = 1200, device=None,
                 pd_tier: str | None = None):
    """One mission (`eval_missions` with a fleet of one)."""
    return eval_missions(policy_fn, (mission,), simrate, max_steps, device,
                         pd_tier)[mission]


SENSITIVITY_VALUES = {"friction": np.linspace(0.3, 1.3, 6),
                      "mass": np.linspace(0.5, 1.5, 6),
                      "damping": np.linspace(0.3, 4.0, 6)}


@torch.no_grad()
def eval_sensitivity(env, policy_fn: Callable, param: str = "friction",
                     values=None, n_trials: int = 16,
                     episode_steps: int = 200, seed: int = 0):
    """Dynamics-parameter sensitivity (reference
    tools/eval_sensitivity.py:9-98): n_trials reset envs per value, the
    parameter fixed to it (friction) or scaled by it (body masses, dof
    damping), commanded to 1 m/s; the survival rate per value."""
    if values is None:
        values = SENSITIVITY_VALUES[param]
    values = np.asarray(values)
    dev, B = env.device, len(values) * n_trials
    gen = _generator(env, seed)
    value = torch.as_tensor(np.repeat(values, n_trials).astype(np.float32),
                            device=dev)
    state, obs = env.reset(env.sample_reset_noise(gen, B))
    p = state.params
    if param == "friction":
        p = dataclasses.replace(p, friction=value)
    elif param == "mass":
        p = dataclasses.replace(p, body_mass=p.body_mass * value)
    elif param == "damping":
        p = dataclasses.replace(p, dof_damping=p.dof_damping * value)
    else:
        raise ValueError(f"unknown parameter {param!r}")
    state = dataclasses.replace(state, params=p,
                                speed=torch.ones((B,), device=dev))
    _, _, fallen, bad = _run_steps(env, policy_fn, state, obs, gen,
                                   episode_steps)
    survived = (~fallen).cpu().numpy().reshape(len(values), n_trials)
    return {"values": values, "survival_rate": survived.mean(axis=1),
            "n_nonfinite": int(bad.sum())}


DEFAULT_5K_TERRAINS = ("flat", "noise1", "noise2", "noise3", "hill1",
                       "hill2", "hill3", "left_3", "right_3", "up_3",
                       "down_3")


@functools.lru_cache(maxsize=None)
def _terrain_tables():
    with np.load(TERRAINS_5K) as f:
        return {k: f[k] for k in f}


def _terrain_config(name: str, seed: int = 0):
    """Terrain name -> (needs_hfield, (32, 32) float32 table or None,
    floor tilt (y_pitch, x_roll)), as the JAX suite's `_terrain_config`
    (eval_suites.py:318-360; reference 5k_test.py:35-47, 299-301): the
    flat plane, noise1-3 and hill1-3 heightfields (the JAX draws at seed
    0, from `terrains_5k.npz`, written by scripts/export_5k_terrains.py)
    and 3-degree ramps with JAX's sign mapping: left x = +3, right x = -3,
    up y = -3, and down y = +3 (the branch the reference meant; its own is
    dead code)."""
    tilt = np.deg2rad(3.0)
    if name == "flat":
        return False, None, (0.0, 0.0)
    if name.startswith(("noise", "hill")):
        if seed != 0:
            raise ValueError("the port holds the 5k terrain tables of seed "
                             f"0 only, not {seed}")
        tables = _terrain_tables()
        if name not in tables:
            raise ValueError(f"unknown terrain {name}")
        return True, tables[name], (0.0, 0.0)
    ramps = {"up_3": (-tilt, 0.0), "down_3": (tilt, 0.0),
             "left_3": (0.0, tilt), "right_3": (0.0, -tilt)}
    if name in ramps:
        return False, None, ramps[name]
    raise ValueError(f"unknown terrain {name}")


MISSIONS_5K = ("curvy", "straight", "90_left", "90_right")
SPEEDS_5K = (0.5, 0.9, 1.4, 1.9, 2.3, 2.8)


@torch.no_grad()
def eval_5k_matrix(policy_fn: Callable, env, missions=MISSIONS_5K,
                   mission_speeds=SPEEDS_5K,
                   terrains=DEFAULT_5K_TERRAINS, frictions=None,
                   foot_mass_scales=None, max_steps: int = 0, seed: int = 0,
                   on_cell: Callable | None = None):
    """The reference's "5k" robustness matrix (5k_test.py:19-74, 296-311)
    at its semantics: every trial drives the policy's own training env
    from the deterministic eval reset, with the cell's friction and
    foot-mass scales on the default dynamics, and per mission-schedule
    step applies update_speed (with its phase floor) and the heading, then
    step_basic; the only failure is qpos[2] < 0.4 before the schedule
    ends. max_steps > 0 truncates the schedules.

    The trials of one (mission, speed) are one fleet: terrains x frictions
    x foot masses (3,971 envs at the default grid), each terrain a
    heightfield table or a floor tilt per env. The JAX suite pads every
    schedule to the longest so that one program compiles; here each
    (mission, speed) runs for its own length, as a step past the end
    fails no trial. on_cell(mission, speed, passed, seconds), if given,
    is called after each cell. Returns the pass tensor and its rates per
    axis (report_stats, 5k_test.py:230-285)."""
    import time

    from apex_tpu_torch.envs.trajectory import CommandTrajectory

    if frictions is None:
        frictions = tuple(np.round(np.linspace(0.8, 1.2, 19), 6))
    if foot_mass_scales is None:
        foot_mass_scales = tuple(np.round(np.linspace(0.8, 1.2, 19), 6))
    if not env.model.enable_hfield and any(
            t.startswith(("noise", "hill")) for t in terrains):
        # heightfield terrains need the heightfield model; plane and ramp
        # cells run through it the same, with hfield_active 0
        env = dataclasses.replace(env, terrain="noise")
    dev = env.device
    shape = (len(missions), len(mission_speeds), len(terrains),
             len(frictions), len(foot_mass_scales))
    passed = np.zeros(shape, dtype=bool)

    # the trial batch: terrain-major, then friction, then foot mass
    n_t, n_fm = len(terrains), len(foot_mass_scales)
    B = n_t * len(frictions) * n_fm
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    fric = f32(np.tile(np.repeat(frictions, n_fm), n_t))
    fmass = f32(np.tile(np.tile(foot_mass_scales, len(frictions)), n_t))
    tables, active, ey, ex = [], [], [], []
    for terrain in terrains:
        needs_hf, table, (y, x) = _terrain_config(terrain, seed)
        tables.append(table if needs_hf else np.zeros((32, 32), np.float32))
        active.append(1.0 if needs_hf else 0.0)
        ey.append(y)
        ex.append(x)
    per = B // n_t
    rep = lambda x: torch.repeat_interleave(f32(x), per, dim=0)
    hfield = rep(np.stack(tables)).permute(1, 2, 0).contiguous()
    hf_active, pitch, roll = rep(active), rep(ey), rep(ex)
    foot_ids = [env.model.body_id("left-foot"),
                env.model.body_id("right-foot")]

    nonfinite = []        # (mission, speed, terrain, friction, foot mass)
    steps_run = 0
    for mi, mission in enumerate(missions):
        for si, speed in enumerate(mission_speeds):
            t0 = time.time()
            cmd = CommandTrajectory(f"{mission}_{speed}")
            n = cmd.trajlen - 1
            if max_steps:
                n = min(n, max_steps)
            state, obs = env.reset_for_test(B)
            p = state.params
            mass = p.body_mass.clone()
            mass[foot_ids] = mass[foot_ids] * fmass
            p = dataclasses.replace(
                p, friction=p.friction * fric, body_mass=mass,
                floor_quat=euler2quat(z=torch.zeros_like(pitch), y=pitch,
                                      x=roll).contiguous(),
                hfield=hfield, hfield_active=hf_active)
            state = dataclasses.replace(state, params=p)
            sp, orr = f32(cmd.speed_cmd[:n]), f32(cmd.orient[:n])
            fallen = torch.zeros((B,), dtype=torch.bool, device=dev)
            bad = torch.zeros_like(fallen)
            for i in range(n):
                state = env.update_speed_state(state, sp[i])
                state = dataclasses.replace(
                    state, orient_add=orr[i].expand(B))
                state, obs = env.step_basic(state, policy_fn(obs))
                fallen |= state.phys.qpos[2] < 0.4
                bad |= ~torch.isfinite(state.phys.qpos).all(dim=0)
            cell = (~fallen).cpu().numpy()
            passed[mi, si] = cell.reshape(n_t, len(frictions), n_fm)
            nonfinite += [(mission, speed, terrains[b // per],
                           frictions[b // n_fm % len(frictions)],
                           foot_mass_scales[b % n_fm])
                          for b in np.flatnonzero(bad.cpu().numpy())]
            steps_run += n
            if on_cell is not None:
                on_cell(mission, speed, passed[mi, si], time.time() - t0)

    def axis_rate(names, axis):
        keep = tuple(i for i in range(passed.ndim) if i != axis)
        return dict(zip(names, passed.mean(axis=keep)))

    out = {
        "grid": dict(missions=missions, mission_speeds=mission_speeds,
                     terrains=terrains, frictions=frictions,
                     foot_mass_scales=foot_mass_scales),
        "passed": passed,
        "pass_rate": passed.mean(),
        "by_mission": axis_rate(missions, 0),
        "by_speed": axis_rate(mission_speeds, 1),
        "by_terrain": axis_rate(terrains, 2),
        "by_friction": axis_rate(frictions, 3),
        "by_foot_mass": axis_rate(foot_mass_scales, 4),
        "n_nonfinite": len(nonfinite),
        "nonfinite_trials": nonfinite,
        "policy_steps": steps_run,
    }
    # the subset the reference artifact covers (flat + noise1)
    ref_terr = [t for t in ("flat", "noise1") if t in terrains]
    if ref_terr:
        idx = [list(terrains).index(t) for t in ref_terr]
        out["pass_rate_ref_subset"] = passed[:, :, idx].mean()
    return out


def gait_clock_5k(env):
    """The gait clock that every trial of a 5k cell follows: the phase,
    the count of wrapped cycles and the clock's length after each
    schedule step's update_speed_state (with its phase floor) and
    step_basic's phase advance, as eval_5k_matrix drives them. No physics
    enters it, so the grid's 24 (mission, speed) schedules run as one
    fleet of clocks, each held at its last speed past its end. Returns
    {"<mission>_<speed>": (phase, counter, phaselen)}, numpy arrays of
    the schedule's length."""
    from apex_tpu_torch.envs.trajectory import CommandTrajectory

    names = [f"{m}_{s}" for m in MISSIONS_5K for s in SPEEDS_5K]
    speeds = [np.float32(CommandTrajectory(n).speed_cmd[:-1]) for n in names]
    maxlen = max(len(sp) for sp in speeds)
    grid = np.stack([np.concatenate([sp, np.full(maxlen - len(sp), sp[-1])])
                     for sp in speeds], axis=1)
    state, _ = env.reset_for_test(len(names))
    rows = []
    for sp in torch.as_tensor(grid, device=env.device):
        state = env.update_speed_state(state, sp)
        time_, phase, counter = env._advance_phase(state)
        state = dataclasses.replace(state, time=time_, phase=phase,
                                    counter=counter)
        rows.append((phase, counter, state.clock.phaselen))
    seq = [torch.stack(x).cpu().numpy() for x in zip(*rows)]
    return {n: tuple(x[:len(sp), b] for x in seq)
            for b, (n, sp) in enumerate(zip(names, speeds))}


def compare_policies(path_a: str, path_b: str, n_episodes: int = 32,
                     traj_len: int = 300, device=None):
    """Two-policy comparison (reference tools/compare_pols.py:6-182, text
    instead of PDF)."""
    from apex_tpu_torch.runtime.evaluate import eval_checkpoint

    ra = eval_checkpoint(path_a, n_episodes=n_episodes, traj_len=traj_len,
                         device=device)
    rb = eval_checkpoint(path_b, n_episodes=n_episodes, traj_len=traj_len,
                         device=device)
    print(f"\n{'':>12} {'return':>10} {'ep_len':>8}")
    print(f"{'policy A':>12} {ra[0]:10.2f} {ra[1]:8.1f}")
    print(f"{'policy B':>12} {rb[0]:10.2f} {rb[1]:8.1f}")
    return {"a": ra, "b": rb}
