"""Offline policy-analysis jobs (the reference's misc analysis tools).

Port of `apex_tpu/runtime/analysis.py`, rebuilds of:
  * tools/aslip_tests/GRF_compare.py:16-103   -- per-substep ground-reaction
    force profiles phase-averaged over gait cycles;
  * tools/aslip_tests/parallelized.py:25-130  -- footstep-placement error
    (actual landing position vs the gait library's ideal stride deltas);
  * tools/aslip_tests/taskspace_tracking.py:48-180 -- task-space (foot)
    tracking error per commanded speed;
  * tools/vis_input_and_state.py:44-130       -- estimator-state vs true
    state recording over a rollout;
  * tools/vis_perturb.py:96-181               -- push-response trajectory
    recording.

The JAX jobs vmap a function of one trial; here the trials of a job are the
envs of one batch-last fleet (the seeds of `grf_profile`, the speeds of
`taskspace_tracking`, the (angle, phase) grid of `perturb_response`)
stepped in a Python loop. Randomness enters as explicit draws: a `draws`
function (seed, n_trials, n_steps) -> (the env's reset draws for n_trials
envs, a list of n_steps step draws), by default `generator_draws(env)`,
the env's own samplers on a `torch.Generator` seeded with `seed`; a test
hands in JAX's. Results come back as numpy in JAX's shapes and keys,
trial first.

A policy is a function obs (B, obs_dim) -> action (B, act_dim).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import numpy as np
import torch

from apex_tpu_torch.physics.cassie_sim import estimate_state, static_diag


def generator_draws(env) -> Callable:
    """The default draws: the env's reset and step samplers on a
    torch.Generator seeded with `seed`."""
    def draws(seed: int, n_trials: int, n_steps: int):
        gen = torch.Generator(device=env.device)
        gen.manual_seed(seed)
        reset = env.sample_reset_noise(gen, n_trials)
        return reset, [env.sample_step_noise(gen, n_trials)
                       for _ in range(n_steps)]
    return draws


def _cat_noise(noises: Sequence):
    """One fleet's draws from its members' (NamedTuples of batch-last
    tensors; a field a switch leaves off is None in all of them)."""
    return type(noises[0])(*(
        None if f[0] is None else torch.cat(f, dim=-1)
        for f in zip(*noises)))


def _fleet_draws(members: Sequence, n_steps: int):
    """Concatenate the members' (reset, steps) draws into one fleet's for
    n_steps steps; a member with fewer steps repeats its last step's draws
    (its record is cut to its own length)."""
    reset = _cat_noise([r for r, _ in members])
    steps = [_cat_noise([s[min(t, len(s) - 1)] for _, s in members])
             for t in range(n_steps)]
    return reset, steps


def _deterministic_state(env, state, speed=None, traj_idx=None):
    """Pin the command state for a deterministic eval (the reference's
    reset_for_test + update_speed, cassie.py:682-768): side speed, heading
    and phase 0, the commanded speed, and for a gait-library env the
    trajectory (one index, or one per env) with its speed and length."""
    B = state.phase.shape[-1]
    dev = state.phase.device
    upd = dict(side_speed=torch.zeros((B,), device=dev),
               orient_add=torch.zeros((B,), device=dev),
               phase=torch.zeros((B,), device=dev))
    if speed is not None:
        upd["speed"] = torch.full((B,), float(speed), device=dev)
    if traj_idx is not None and hasattr(state, "traj_idx"):
        ti = torch.as_tensor(traj_idx, dtype=torch.int64,
                             device=dev).expand(B).contiguous()
        upd["traj_idx"] = ti
        upd["speed"] = env._speeds[ti]
        upd["phaselen"] = (env._traj_len[ti] - 1).to(torch.float32)
    return dataclasses.replace(state, **upd)


def _rebuild_obs(env, state):
    """The observation after mutating the command state (phase and speed
    pinning); the state's history is left as it was, as in JAX."""
    est = estimate_state(env.model, state.phys,
                         static_diag(env.model, state.params, state.phys,
                                     env.pd_tier))
    return env._observe(state, est)[1]


@torch.no_grad()
def _record(env, policy_fn, n_steps: int, reset_noise, step_noise,
            speed=None, traj_idx=None, pre_state_fn=None):
    """The deterministic rollout of one fleet with the step diagnostics:
    {key: numpy (B, n_steps, ...)}."""
    state, _ = env.reset(reset_noise)
    state = _deterministic_state(env, state, speed, traj_idx)
    if pre_state_fn is not None:
        state = pre_state_fn(state)
    obs = _rebuild_obs(env, state)
    fallen = torch.zeros((obs.shape[0],), dtype=torch.bool,
                         device=obs.device)
    recs: List[dict] = []
    for t in range(n_steps):
        action = policy_fn(obs)
        st2, obs2, reward, term, info = env.step_info(state, action,
                                                      step_noise[t])
        fallen = fallen | term
        rec = dict(info, reward=reward, fallen=fallen, phase=state.phase,
                   speed=state.speed)
        recs.append({k: torch.movedim(v, -1, 0) for k, v in rec.items()})
        state, obs = st2, obs2
    return {k: torch.stack([r[k] for r in recs], dim=1).cpu().numpy()
            for k in recs[0]}


def rollout_record(env, policy_fn: Callable, n_steps: int, speed=None,
                   traj_idx=None, seed: int = 0, n_trials: int = 1,
                   pre_state_fn=None, draws: Callable | None = None):
    """Deterministic-policy rollout recording the full info stream of
    n_trials envs of one fleet.

    Returns a dict of numpy arrays shaped (n_trials, n_steps, ...): the env
    step's info diagnostics plus reward, fallen, phase and speed."""
    draws = draws or generator_draws(env)
    reset_noise, step_noise = draws(seed, n_trials, n_steps)
    return _record(env, policy_fn, n_steps, reset_noise, step_noise, speed,
                   traj_idx, pre_state_fn)


# ----------------------------------------------------------------------
# GRF profiles (GRF_compare.py:16-103)
# ----------------------------------------------------------------------
def grf_profile(env, policy_fn, speed=1.0, traj_idx=None,
                n_cycles: int = 10, wait_cycles: int = 3,
                seeds=(0, 10, 20), draws: Callable | None = None):
    """Phase-averaged per-substep ground-reaction-force profile.

    Runs (wait_cycles + n_cycles) gait cycles at a fixed commanded speed,
    one env per seed, and returns the per-substep vertical foot forces
    folded into gait cycles: mean/std over (trials x cycles), shape
    (cycle_steps * simrate, 2)."""
    if traj_idx is not None:
        plen = int(env._traj_len[traj_idx]) - 1
    else:
        plen = int(np.floor(float(
            getattr(env, "_agility_phaselen", 32))))
    cycle = plen + 1
    n_steps = (wait_cycles + n_cycles) * cycle
    draws = draws or generator_draws(env)
    reset_noise, step_noise = _fleet_draws(
        [draws(seed, 1, n_steps) for seed in seeds], n_steps)
    rec = _record(env, policy_fn, n_steps, reset_noise, step_noise,
                  speed=speed, traj_idx=traj_idx)

    profiles = []
    for k in range(len(seeds)):
        grf = rec["grf_seq"][k]          # (n_steps, simrate, 2)
        ok = ~rec["fallen"][k]
        grf = grf[wait_cycles * cycle:]
        ok = ok[wait_cycles * cycle:]
        grf = grf.reshape(n_cycles, cycle * env.simrate, 2)
        okc = ok.reshape(n_cycles, cycle).all(axis=1)
        if okc.any():
            profiles.append(grf[okc])
    if not profiles:
        z = np.zeros((cycle * env.simrate, 2))
        return {"mean": z, "std": z, "cycles_used": 0, "cycle_steps": cycle}
    allp = np.concatenate(profiles, axis=0)
    return {"mean": allp.mean(axis=0), "std": allp.std(axis=0),
            "cycles_used": int(allp.shape[0]), "cycle_steps": cycle}


# ----------------------------------------------------------------------
# Footstep placement error (parallelized.py:25-130)
# ----------------------------------------------------------------------
def foot_placement_error(env, policy_fn, traj_idx: int,
                         num_steps: int = 12, n_trials: int = 8,
                         seed: int = 0, frc_threshold: float = 20.0,
                         draws: Callable | None = None):
    """Landing-position error vs the gait library's ideal stride deltas:
    the ideal next landing is the previous actual landing of the other
    foot plus the reference's stance-to-stance stride vector
    (parallelized.py:63-78), measured at each touchdown, detected from the
    rising edge of the vertical GRF."""
    t = int(traj_idx)
    plen = int(env._traj_len[t]) - 1
    task = lambda k: env._task[k][t, :plen + 1].cpu().numpy()
    lpos, rpos, cpos = task("lpos"), task("rpos"), task("cpos")
    # world-frame reference foot positions; each foot's stance phase is
    # where it is lowest; stride deltas between opposite-foot stances
    lw, rw = lpos + cpos, rpos + cpos
    lp, rp = int(lw[:, 2].argmin()), int(rw[:, 2].argmin())
    right_to_left = lw[lp, :2] - rw[lp, :2]
    left_to_right = rw[rp, :2] - lw[rp, :2]

    n_env_steps = (num_steps + 4) * (plen + 1)
    rec = rollout_record(env, policy_fn, n_env_steps, traj_idx=t, seed=seed,
                         n_trials=n_trials, draws=draws)
    grf = rec["grf_seq"].mean(axis=2)        # (trials, T, 2) per-step mean
    foot_xy = rec["foot_pos"][..., :2]       # (trials, T, 2 feet, 2)
    fallen = rec["fallen"]

    errors = []
    for tr in range(n_trials):
        land = {0: None, 1: None}            # last actual landing per foot
        in_contact = [True, True]
        warmup = 2 * (plen + 1)
        for step in range(n_env_steps):
            if fallen[tr, step]:
                break
            for f in (0, 1):
                contact = grf[tr, step, f] > frc_threshold
                if contact and not in_contact[f]:
                    actual = foot_xy[tr, step, f]
                    other = land[1 - f]
                    if step > warmup and other is not None:
                        delta = (right_to_left if f == 0 else left_to_right)
                        ideal = other + delta
                        errors.append(float(np.linalg.norm(ideal - actual)))
                    land[f] = actual
                in_contact[f] = contact
    errors = np.asarray(errors)
    nan = float("nan")
    return {"errors": errors,
            "mean_error": float(errors.mean()) if errors.size else nan,
            "std_error": float(errors.std()) if errors.size else nan,
            "n_footsteps": int(errors.size),
            "stride_right_to_left": right_to_left,
            "stride_left_to_right": left_to_right}


# ----------------------------------------------------------------------
# Task-space tracking (taskspace_tracking.py:48-180)
# ----------------------------------------------------------------------
def taskspace_tracking(env, policy_fn, traj_indices=None,
                       n_cycles: int = 6, ramp_cycles: int = 2,
                       seed: int = 0, draws: Callable | None = None):
    """Per-speed task-space tracking error of an aslip policy: RMS error of
    the pelvis-relative foot positions against the gait library, one env
    per commanded speed (trajectory index), each run for its own
    (ramp_cycles + n_cycles) cycles."""
    if traj_indices is None:
        traj_indices = range(int(env.num_speeds))
    idx = [int(t) for t in traj_indices]
    plens = [int(env._traj_len[t]) - 1 for t in idx]
    lengths = [(ramp_cycles + n_cycles) * (p + 1) for p in plens]
    draws = draws or generator_draws(env)
    n_steps = max(lengths)
    reset_noise, step_noise = _fleet_draws(
        [draws(seed, 1, n) for n in lengths], n_steps)
    rec = _record(env, policy_fn, n_steps, reset_noise, step_noise,
                  traj_idx=idx)
    rows = []
    for k, (t, plen, n) in enumerate(zip(idx, plens, lengths)):
        sl = slice(ramp_cycles * (plen + 1), n)
        phase = rec["phase"][k, sl].astype(int) % (plen + 1)
        ok = ~rec["fallen"][k, sl]
        ref_l = env._task["lpos"][t].cpu().numpy()[phase]
        ref_r = env._task["rpos"][t].cpu().numpy()[phase]
        act_l = rec["est_lfoot_pos"][k, sl]
        act_r = rec["est_rfoot_pos"][k, sl]
        if ok.any():
            err_l = np.sqrt(((act_l - ref_l)[ok] ** 2).sum(-1)).mean()
            err_r = np.sqrt(((act_r - ref_r)[ok] ** 2).sum(-1)).mean()
        else:
            err_l = err_r = float("nan")
        rows.append({"traj_idx": t, "speed": round(0.1 * t, 2),
                     "survived": bool(ok.all()),
                     "lfoot_rms": float(err_l), "rfoot_rms": float(err_r)})
    return rows


# ----------------------------------------------------------------------
# Estimator-state vs true-state recording (vis_input_and_state.py:44-130)
# ----------------------------------------------------------------------
def input_and_state_record(env, policy_fn, n_steps: int = 300,
                           speed: float = 2.0, seed: int = 0,
                           draws: Callable | None = None):
    """Record the estimated state stream (what the policy sees) beside the
    true state over a rollout; returns arrays for offline plotting and the
    estimator-vs-truth deltas."""
    rec = rollout_record(env, policy_fn, n_steps, speed=speed, seed=seed,
                         draws=draws)
    qpos = rec["qpos"][0]                   # (T, 35) true state
    est_l = rec["est_lfoot_pos"][0]
    est_r = rec["est_rfoot_pos"][0]
    true_l = rec["foot_pos"][0, :, 0] - qpos[:, 0:3]
    true_r = rec["foot_pos"][0, :, 1] - qpos[:, 0:3]
    return {
        "qpos": qpos, "reward": rec["reward"][0], "fallen": rec["fallen"][0],
        "est_lfoot": est_l, "est_rfoot": est_r,
        "true_lfoot": true_l, "true_rfoot": true_r,
        "est_lfoot_err": np.abs(est_l - true_l).max(),
        "est_rfoot_err": np.abs(est_r - true_r).max(),
    }


# ----------------------------------------------------------------------
# Push-response recording (vis_perturb.py:96-181)
# ----------------------------------------------------------------------
@torch.no_grad()
def perturb_response(env, policy_fn, force: float = 170.0,
                     angles=None, phases=None, speed: float = 0.5,
                     wait_steps: int = 80, perturb_steps: int = 8,
                     recover_steps: int = 120, seed: int = 0,
                     draws: Callable | None = None):
    """A pelvis push of `force` N at each (angle, phase), one env each, and
    the pelvis trajectory through recovery (vis_perturb.py:96-181: 170 N,
    0.2 s pushes over 4 directions at phase-resolved starts)."""
    if angles is None:
        angles = np.linspace(0, 2 * np.pi, 4, endpoint=False)
    if phases is None:
        phases = [0]
    total = wait_steps + perturb_steps + recover_steps
    A, P = np.meshgrid(np.asarray(angles), np.asarray(phases, np.float64),
                       indexing="ij")
    n = A.size
    dev = env.device
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32).ravel(),
                                    device=dev)
    angle, phase0 = f32(A), f32(P)
    draws = draws or generator_draws(env)
    reset_noise, step_noise = draws(seed, n, total)

    state, _ = env.reset(reset_noise)
    state = _deterministic_state(env, state, speed=speed)
    state = dataclasses.replace(state, phase=phase0)
    obs = _rebuild_obs(env, state)
    push = torch.zeros((6, n), device=dev)
    push[3] = force * torch.cos(angle)
    push[4] = force * torch.sin(angle)
    fallen = torch.zeros((n,), dtype=torch.bool, device=dev)
    pelvis, fallen_seq = [], []
    for i in range(total):
        pushing = wait_steps <= i < wait_steps + perturb_steps
        state = dataclasses.replace(state, params=dataclasses.replace(
            state.params, ext_force=push if pushing
            else torch.zeros_like(push)))
        action = policy_fn(obs)
        state, obs, _, term = env.step(state, action, step_noise[i])
        fallen = fallen | term
        pelvis.append(state.phys.qpos[:7].T)
        fallen_seq.append(fallen)
    shape = (len(angles), len(phases))
    np_ = lambda x: torch.stack(x, dim=1).cpu().numpy()
    return {
        "angles": np.asarray(angles), "phases": np.asarray(phases),
        "force": force,
        "pelvis": np_(pelvis).reshape(shape + (total, 7)),
        "fallen_seq": np_(fallen_seq).reshape(shape + (total,)),
        "survived": (~fallen).cpu().numpy().reshape(shape),
        "push_window": (wait_steps, wait_steps + perturb_steps),
    }
