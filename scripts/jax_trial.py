"""The JAX package's side of `scripts/replay_nonfinite.py`: each trial that
went non-finite in the port's battery, run alone through the JAX env on
the CPU, stepping until its schedule ends, with the step at which its
qpos first left the finite numbers (None: it stayed finite) and whether
it passed (qpos[2] never below 0.4).

With --snapshot FILE (written by `scripts/replay_nonfinite.py
--snapshots`), the port's state a few steps before a blow-up is stepped
through the JAX env with the port's actions instead: the replayed step at
which JAX's qpos leaves the finite numbers, and its largest |qvel| per
step (the physics of a step does not depend on its draws: a command
change lands after it, and mk5c's estimator takes no noise).

A command trial takes the port's command draws from the replay's JSON
(its speed walk and heading increments, `eval_suites.command_schedule`'s
rules) and JAX's own step keys for the env's random command changes, as
JAX's eval_commands draws them per block. A 5k trial is deterministic:
the cell's mission schedule, terrain, friction and foot mass, as JAX's
eval_5k_matrix runs it, one env.

    JAX_PLATFORMS=cpu python scripts/jax_trial.py \\
        --ckpt curves/cassie_mk5c_ckpt --replay s1_mk5c.json
    JAX_PLATFORMS=cpu python scripts/jax_trial.py \\
        --ckpt curves/cassie_mk5c_ckpt --snapshot curves/s1_mk5c/5k_3692.pkl
"""
import argparse
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from apex_tpu.envs.trajectory import CommandTrajectory  # noqa: E402
from apex_tpu.runtime.eval_suites import _terrain_config  # noqa: E402
from apex_tpu.utils.quaternion import euler2quat  # noqa: E402


def _loader():
    spec = importlib.util.spec_from_file_location(
        "reference_eval_seeds", ROOT / "scripts" / "reference_eval_seeds.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load_experiment_lenient


def schedule(draws, max_speed=3.0):
    """(speeds, orients) of one trial from its command draws."""
    deltas = np.float32(draws["delta"]) * np.float32(draws["delta_sign"])
    s, walk = np.float32(0.5), []
    for d in deltas:
        d = -d if (s + d < 0.0) or (s + d > max_speed) else d
        s = np.float32(s + d)
        walk.append(s)
    speeds = np.float32([0.5, *walk[:-1]])
    orients = np.cumsum(np.float32(draws["inc"])
                        * np.float32(draws["inc_sign"]), dtype=np.float32)
    return speeds, orients


def run_command_trial(env, policy, draws, steps_per_command=200):
    speeds, orients = schedule(draws)
    step = jax.jit(lambda s, o, k: env.step(s, policy(o), k)[:2])
    state, obs = jax.jit(env.reset_for_test)()
    k_run = jax.random.PRNGKey(0)
    t, first_bad, fallen = 0, None, False
    half = steps_per_command // 2
    for idx, (sp, orr) in enumerate(zip(speeds, orients)):
        state = state.replace(speed=jnp.float32(sp),
                              phase_add=jnp.float32(1.5 if sp > 1.4 else 1.0))
        for j in range(steps_per_command):
            if j == half:
                state = state.replace(orient_add=jnp.float32(orr))
            key = jax.random.fold_in(jax.random.fold_in(
                k_run, 2 * idx + (j >= half)), j)
            state, obs = step(state, obs, key)
            q = np.asarray(state.phys.qpos)
            fallen |= bool(q[2] < 0.4)
            if first_bad is None and not np.isfinite(q).all():
                first_bad = t
            t += 1
    return {"steps": t, "first_nonfinite_step": first_bad,
            "passed": not fallen}


def run_5k_trial(env, policy, cell, seed=0):
    import dataclasses

    mission, speed, terrain, fric, fmass = cell
    if not env.model.enable_hfield:
        env = dataclasses.replace(env, terrain="noise")
    needs_hf, table, (ey, ex) = _terrain_config(terrain, seed)
    if table is None:
        table = np.zeros_like(_terrain_config("noise1", seed)[1])
    cmd = CommandTrajectory(f"{mission}_{speed}")
    state, obs = jax.jit(env.reset_for_test)()
    p = state.params
    mass = p.body_mass
    for fid in (env.model.body_id("left-foot"),
                env.model.body_id("right-foot")):
        mass = mass.at[fid].multiply(jnp.float32(fmass))
    state = state.replace(params=p.replace(
        friction=p.friction * jnp.float32(fric), body_mass=mass,
        floor_quat=euler2quat(z=jnp.zeros(()), y=jnp.float32(ey),
                              x=jnp.float32(ex)),
        hfield=jnp.asarray(table, jnp.float32),
        hfield_active=jnp.float32(1.0 if needs_hf else 0.0)))

    @jax.jit
    def step(st, ob, sp, orr):
        st = env.update_speed_state(st, sp).replace(orient_add=orr)
        return env.step_basic(st, policy(ob))

    first_bad, fallen = None, False
    n = cmd.trajlen - 1
    for i in range(n):
        state, obs = step(state, obs, jnp.float32(cmd.speed_cmd[i]),
                          jnp.float32(cmd.orient[i]))
        q = np.asarray(state.phys.qpos)
        fallen |= bool(q[2] < 0.4)
        if first_bad is None and not np.isfinite(q).all():
            first_bad = i
    return {"steps": n, "first_nonfinite_step": first_bad,
            "passed": not fallen}


def run_snapshot(env, path):
    """The port's snapshot stepped through the JAX env (see the module
    docstring)."""
    import pickle

    from apex_tpu.envs.cassie import CassieEnvState
    from apex_tpu.physics.cassie_sim import CassiePhysState
    from apex_tpu.physics.engine import PhysParams
    from apex_tpu.rewards.clock import GaitClock

    with open(path, "rb") as f:
        snap = pickle.load(f)
    nested = {"phys": CassiePhysState, "params": PhysParams,
              "clock": GaitClock}
    st = snap["state"]
    state = CassieEnvState(**{
        k: (nested[k](**{n: jnp.asarray(a[0]) for n, a in v.items()})
            if k in nested else jnp.asarray(v[0])) for k, v in st.items()})
    if snap["method"] == "step":
        key = jax.random.PRNGKey(0)
        step = jax.jit(lambda s, a: env.step(s, a, key)[0])
    else:
        step = jax.jit(lambda s, a: env.step_basic(s, a)[0])
    bad, vmax = None, []
    for i, a in enumerate(snap["actions"]):
        state = step(state, jnp.asarray(a[0]))
        q, v = np.asarray(state.phys.qpos), np.asarray(state.phys.qvel)
        vmax.append(float(np.abs(v).max()))
        if bad is None and not np.isfinite(q).all():
            bad = i
    return {"nonfinite_at_step": bad, "max_abs_qvel": vmax}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--replay", default=None)
    ap.add_argument("--snapshot", nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    ppo, state, _ = _loader()(args.ckpt)
    env = ppo.env

    def policy(obs):
        return state.actor.act(state.norm, obs, deterministic=True)

    out = {"ckpt": args.ckpt, "commands": [], "5k": [], "snapshots": {}}
    for path in args.snapshot:
        out["snapshots"][path] = run_snapshot(env, path)
        print("snapshot", path, json.dumps(out["snapshots"][path]),
              flush=True)
    replay = {}
    if args.replay:
        with open(args.replay) as f:
            replay = json.load(f)
    for rec in replay.get("commands", []):
        res = dict(trial=rec["trial"],
                   **run_command_trial(env, policy, rec["draws"]))
        out["commands"].append(res)
        print("commands trial", json.dumps(res), flush=True)
    for rec in replay.get("5k", []):
        res = dict(cell=rec["cell"], **run_5k_trial(env, policy,
                                                    rec["cell"]))
        out["5k"].append(res)
        print("5k trial", json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
