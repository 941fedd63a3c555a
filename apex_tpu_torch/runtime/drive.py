"""Scripted command driving: the reference's interactive keyboard eval
(util/eval.py:17-206) with the keyboard replaced by a timed script.

Port of `apex_tpu/runtime/drive.py`. A script is a list of [step, key]
pairs (or a JSON file of the same), e.g. [[10, "w"], [40, "k"], [80, "p"],
[120, "r"]]; each key is applied to the env state at its control step,
before the policy acts, with the bindings of util/eval.py:110-166:

  w/s  speed +/- 0.1           a/d  side speed -/+ 0.02 (a is dead)
  j/h  phase_add +/- 0.1       k/l  orient_add +/- 0.1
  x/z  swing duration +/- 0.01 v/c  stance duration +/- 0.01
  1/2/3 stance mode zero/grounded/aerial (rebuilds the gait clock)
  r    reset the environment   p    100 N upward push on the pelvis
  t    slowmo (no realtime rendering here: ignored)

The env is a fleet of one; its draws come from a generator seeded by
`seed`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Tuple

import numpy as np
import torch

from apex_tpu_torch.rewards.clock import (
    STANCE_AERIAL,
    STANCE_GROUNDED,
    STANCE_ZERO,
    build_clock,
)

KEY_DOC = "w s a d j h k l x z v c 1 2 3 r p t"


def load_script(path_or_list) -> List[Tuple[int, str]]:
    if isinstance(path_or_list, str):
        with open(path_or_list) as f:
            raw = json.load(f)
    else:
        raw = path_or_list
    script = [(int(t), str(k)) for t, k in raw]
    return sorted(script, key=lambda e: e[0])


def _apply_key(env, state, key: str):
    """One keyboard command on the env state (util/eval.py:110-166)."""
    add = {"w": ("speed", 0.1), "s": ("speed", -0.1),
           "d": ("side_speed", 0.02),
           # upstream quirk kept: 'a' subtracts 0.0 (util/eval.py:119)
           "a": ("side_speed", -0.0),
           "j": ("phase_add", 0.1), "h": ("phase_add", -0.1),
           "l": ("orient_add", -0.1), "k": ("orient_add", 0.1)}
    if key in add:
        name, delta = add[key]
        return dataclasses.replace(state,
                                   **{name: getattr(state, name) + delta})
    if key in "xzvc123":
        swing, stance = state.swing_duration, state.stance_duration
        mode = state.stance_mode
        if key in "xz":
            swing = swing + (0.01 if key == "x" else -0.01)
        elif key in "vc":
            stance = stance + (0.01 if key == "v" else -0.01)
        else:
            one_hot = {"1": STANCE_ZERO, "2": STANCE_GROUNDED,
                       "3": STANCE_AERIAL}[key]
            mode = torch.tensor(one_hot, device=mode.device)[:, None] \
                .expand_as(mode).contiguous()
        # JAX's _apply_key runs op by op: its phaselen is not contracted
        clock = build_clock(swing, stance, mode, env.strict_relaxer,
                            env.have_incentive, float(env._freq),
                            fused=False)
        return dataclasses.replace(state, swing_duration=swing,
                                   stance_duration=stance, stance_mode=mode,
                                   clock=clock)
    if key == "p":
        # 100 N upward push (util/eval.py:158-162: force_arr[2] = 100 in
        # the [force, torque] xfrc order; ext_force is [torque, force])
        ext = state.params.ext_force.clone()
        ext[5] = 100.0
        return dataclasses.replace(
            state, params=dataclasses.replace(state.params, ext_force=ext))
    if key == "t":
        return state
    raise ValueError(f"unknown drive key {key!r} (one of: {KEY_DOC})")


@torch.no_grad()
def drive_policy(actor, norm, env, script, n_steps: int = 300,
                 seed: int = 0, start_speed: float = 0.0) -> Dict:
    """Run the deterministic policy through a timed command script
    (util/eval.py:96-200): a reset commanded to `start_speed`, each
    scripted key applied at its control step, and per-step telemetry.
    Pushes persist until overwritten, as apply_force's do.

    Returns arrays: qpos (T, nq); speed, side_speed, orient_add, phase,
    phase_add, reward, done, l_foot_frc, r_foot_frc (T,); eval_reward."""
    by_step: Dict[int, List[str]] = {}
    for t, k in load_script(script):
        by_step.setdefault(t, []).append(k)
    generator = torch.Generator(device=env.device)
    generator.manual_seed(seed)
    # JAX resets here through `jax.jit(env.reset)` of one env, a program
    # that builds the clock as `init_runner`'s does (`reset_fresh`)
    state, obs = env.reset_fresh(env.sample_reset_noise(generator, 1))
    zero = torch.zeros_like(state.speed)
    state = dataclasses.replace(state, speed=zero + start_speed,
                                side_speed=zero, orient_add=zero)

    rec = {k: [] for k in ("qpos", "speed", "side_speed", "orient_add",
                           "phase", "phase_add", "reward", "done",
                           "l_foot_frc", "r_foot_frc")}
    eval_reward = 0.0
    for t in range(n_steps):
        for key in by_step.get(t, ()):
            if key == "r":
                state, obs = env.reset_fresh(
                    env.sample_reset_noise(generator, 1))
            else:
                state = _apply_key(env, state, key)
        action = actor.act(norm, obs, deterministic=True)
        state, obs, reward, done, info = env.step_info(
            state, action, env.sample_step_noise(generator, 1))
        eval_reward += float(reward[0])
        rec["qpos"].append(state.phys.qpos[:, 0].cpu().numpy())
        for name in ("speed", "side_speed", "orient_add", "phase",
                     "phase_add"):
            rec[name].append(float(getattr(state, name)[0]))
        rec["reward"].append(float(reward[0]))
        rec["done"].append(bool(done[0]))
        rec["l_foot_frc"].append(float(info["l_foot_frc"][0]))
        rec["r_foot_frc"].append(float(info["r_foot_frc"][0]))
    out = {k: np.asarray(v) for k, v in rec.items()}
    out["eval_reward"] = np.asarray(eval_reward)
    return out
