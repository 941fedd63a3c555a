"""Deterministic policy evaluation of a saved run, and rollout dumps.

Port of `apex_tpu/runtime/evaluate.py` (reference apex.py:257-280):
`load_experiment` rebuilds the env and the policy from a run directory
holding experiment.pkl and the JAX checkpoint.pkl; `eval_checkpoint` runs
a fleet of envs for one episode length with the deterministic policy and
reports the mean return and length of the episodes that finished;
`record_policy` and `dump_gait` record one env's rollout to .npz for
offline plotting and rendering.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from apex_tpu_torch.device import resolve_device
from apex_tpu_torch.envs.base import Env
from apex_tpu_torch.envs.registry import env_factory
from apex_tpu_torch.models.nets import FFV, GaussianFFActor, NormState
from apex_tpu_torch.runtime.checkpoint import load_checkpoint


class Experiment(NamedTuple):
    env: Env
    actor: GaussianFFActor
    critic: FFV
    norm: NormState
    args: SimpleNamespace


def load_experiment(path: str, device=None, physics=None,
                    keep_traj: bool = False) -> Experiment:
    """Rebuild (env, actor, critic, norm, args) from a run directory, with
    the JAX package's defaults for settings the run did not record.
    `physics` picks the PD scan's tier ("megakernel", "fleet" or
    "per_env"; None: the device's default). Like the JAX package's load,
    it does not pass the run's --traj on, so a CassieTraj-v0 run loads with
    the walking gait library; `keep_traj` builds the run's own."""
    device = resolve_device(device)
    with open(os.path.join(path, "experiment.pkl"), "rb") as f:
        args = SimpleNamespace(**pickle.load(f))
    env = env_factory(
        getattr(args, "env_name", "Cassie-v0"), device=device,
        simrate=getattr(args, "simrate", 50),
        command_profile=getattr(args, "command_profile", "clock"),
        input_profile=getattr(args, "input_profile", "full"),
        learn_gains=getattr(args, "learn_gains", False),
        dynamics_randomization=getattr(args, "dyn_random", False),
        reward=getattr(args, "reward", "early_clock"),
        history=getattr(args, "history", 0),
        estimator=getattr(args, "estimator", "exact"),
        terrain=getattr(args, "terrain", "flat"),
        min_speed=getattr(args, "min_speed", -0.3),
        max_speed=getattr(args, "max_speed", 4.0),
        orient_jump_prob=getattr(args, "orient_jump_prob", 0.0),
        speed_phase_add=getattr(args, "speed_phase_add", False),
        pd_tier=physics,
        **({"traj": getattr(args, "traj", "walking")} if keep_traj else {}))

    learn_stddev = getattr(args, "learn_stddev", False)
    ckpt = load_checkpoint(path, learn_stddev=learn_stddev)
    obs_dim, act_dim = env.observation_size, env.action_size
    actor = GaussianFFActor(
        obs_dim, act_dim,
        fixed_std=None if learn_stddev
        else float(np.exp(getattr(args, "std_dev", -1.5))),
        bounded=getattr(args, "bounded", False))
    critic = FFV(obs_dim)
    norm = NormState(obs_dim)
    actor.load_state_dict(ckpt.actor)
    critic.load_state_dict(ckpt.critic)
    norm.load_state_dict(ckpt.norm)
    return Experiment(env, actor.to(device).eval(), critic.to(device).eval(),
                      norm.to(device), args)


@torch.no_grad()
def eval_checkpoint(path: str, n_episodes: int = 16, traj_len: int = 400,
                    device=None, seed: int = 42, physics=None,
                    out: str | None = None):
    """Deterministic evaluation of a saved run: `n_episodes` envs step
    `traj_len` times (auto-resetting the ones that fall); prints and
    returns the mean return and length of the finished episodes, and
    with `out` dumps the (obs, action, reward, terminated) trajectories,
    (traj_len, n_episodes, ...), for offline replay."""
    from apex_tpu_torch.agents.rollout import init_runner, rollout_scan

    exp = load_experiment(path, device=device, physics=physics)
    env = exp.env
    generator = torch.Generator(device=env.device)
    generator.manual_seed(seed)

    def policy_fn(obs):
        return exp.actor.act(exp.norm, obs, deterministic=True)

    runner = init_runner(env, generator, n_episodes)
    runner, traj = rollout_scan(env, policy_fn, runner, generator,
                                traj_len, traj_len)

    n_done = int(torch.sum(traj.done_ep_len > 0))
    ep_ret = float(torch.sum(traj.done_ep_return) / max(n_done, 1))
    ep_len = float(torch.sum(traj.done_ep_len) / max(n_done, 1))
    print(f"episodes: {n_done}  mean return: {ep_ret:.2f}  "
          f"mean length: {ep_len:.1f}")
    if out:
        np.savez_compressed(
            out, **{k: getattr(traj, k).cpu().numpy()
                    for k in ("obs", "action", "reward", "terminated")})
        print(f"wrote trajectory dump: {out}")
    return ep_ret, ep_len


def _one_env_rollout(path: str, n_steps: int, speed: float, device,
                     physics, record, with_info: bool = False):
    """One env of the saved run, reset from seed 0 and commanded to
    `speed`, stepped n_steps times with the deterministic policy; record
    (state, obs, reward, terminated, info, action) -> {channel: value}
    gives each step's channels, stacked along a leading step axis (info is
    the step's diagnostics with `with_info`, else None)."""
    exp = load_experiment(path, device=device, physics=physics)
    env = exp.env
    generator = torch.Generator(device=env.device)
    generator.manual_seed(0)
    # JAX's `jax.jit(env.reset)` of one env builds the clock as its
    # `init_runner` program does (`reset_fresh`)
    state, obs = env.reset_fresh(env.sample_reset_noise(generator, 1))
    if hasattr(state, "speed"):
        state = dataclasses.replace(state,
                                    speed=torch.full_like(state.speed, speed))
    recs = []
    with torch.no_grad():
        for _ in range(n_steps):
            action = exp.actor.act(exp.norm, obs, deterministic=True)
            noise = env.sample_step_noise(generator, 1)
            if with_info:
                state, obs, reward, term, info = env.step_info(
                    state, action, noise)
            else:
                (state, obs, reward, term), info = env.step(
                    state, action, noise), None
            recs.append(record(state, obs, reward, term, info, action))
    return {k: np.stack([r[k] for r in recs]) for k in recs[0]}


def record_policy(path: str, out: str = "policy_record.npz",
                  n_steps: int = 300, speed: float = 1.0, device=None,
                  physics=None):
    """Record the control loop's channels over one deterministic rollout:
    commanded PD targets against measured motor positions, motor
    velocities, applied torques, ground-reaction forces, foot positions
    and pelvis states (the JAX `record_policy`, evaluate.py:94-138;
    reference plot_policy.py:1-326), from the env's step diagnostics."""
    one = lambda x: x[..., 0].detach().cpu().numpy()

    def record(state, obs, reward, term, info, action):
        return {"pd_target": one(info["pd_target"]),
                "motor_pos": one(info["motor_pos"]),
                "motor_vel": one(info["motor_vel"]),
                "torque": one(info["motor_torque"]),
                "grf": one(torch.stack([info["l_foot_frc"],
                                        info["r_foot_frc"]])),
                "foot_pos": one(info["foot_pos"]), "qpos": one(info["qpos"]),
                "reward": one(reward), "terminated": one(term),
                "action": action[0].cpu().numpy()}

    recs = _one_env_rollout(path, n_steps, speed, device, physics, record,
                            with_info=True)
    recs["speed"] = np.asarray(speed)
    np.savez_compressed(out, **recs)
    print(f"wrote {out}: " + ", ".join(
        f"{k} {v.shape}" for k, v in recs.items() if v.ndim))
    return recs


def dump_gait(path: str, out: str = "gait.npz", n_steps: int = 200,
              speed: float = 1.0, device=None, physics=None):
    """Record qpos of one deterministic rollout for offline rendering
    (tools/render_gait.py; the JAX `dump_gait`, evaluate.py:141-168)."""
    qpos = _one_env_rollout(
        path, n_steps, speed, device, physics,
        lambda state, *_: {"qpos": state.phys.qpos[:, 0].cpu().numpy()}
    )["qpos"]
    np.savez_compressed(out, qpos=qpos)
    print(f"wrote {out}: qpos {qpos.shape}")
    return qpos
