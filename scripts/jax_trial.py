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

With --clock NAME... (5k schedules such as straight_2.3), the gait clock
of one 5k trial with its physics (flat, friction and foot mass 1) is held
against the clock alone: the phase, cycle count and clock length after
every step, from `eval_5k_matrix`'s own program at one env (a host
callback after each step_basic records them), from this script's
per-step jitted 5k step, and from the physics-free scan of
`tests/test_torch_clock_5k.py`. Prints, for each of the first two, at
how many steps it parts from the physics-free sequence.

    JAX_PLATFORMS=cpu python scripts/jax_trial.py \\
        --ckpt curves/cassie_mk5c_ckpt --clock straight_2.3 90_left_0.5
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


def run_5k_trial(env, policy, cell, seed=0, clock=None):
    """One 5k trial stepped by a jitted step; clock, a list, gets the
    (phase, counter, phaselen) after every step."""
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
        if clock is not None:
            clock.append((float(state.phase), int(state.counter),
                          float(state.clock.phaselen)))
    return {"steps": n, "first_nonfinite_step": first_bad,
            "passed": not fallen}


def clock_alone(env, name):
    """(phase, counter, phaselen) per step of a 5k schedule with no
    physics: eval_5k_matrix's program (jit of vmap of a scan, the
    schedule unbatched) over update_speed_state, the heading and
    step_basic's phase advance (apex_tpu/envs/cassie.py:511-514)."""
    cmd = CommandTrajectory(name)
    n = cmd.trajlen - 1

    def single(speeds, orients, key):
        state, _ = env.reset_for_test(key)

        def body(st, c):
            st = env.update_speed_state(st, c[0]).replace(orient_add=c[1])
            phase = st.phase + st.phase_add
            wrapped = phase > st.clock.phaselen
            st = st.replace(phase=jnp.where(wrapped, 0.0, phase),
                            counter=st.counter + wrapped.astype(jnp.int32))
            return st, (st.phase, st.counter, st.clock.phaselen)

        return jax.lax.scan(body, state, (speeds, orients))[1]

    seq = jax.jit(jax.vmap(single, in_axes=(None, None, 0)))(
        jnp.asarray(cmd.speed_cmd[:n], jnp.float32),
        jnp.asarray(cmd.orient[:n], jnp.float32),
        jax.random.split(jax.random.PRNGKey(0), 1))
    return [np.asarray(x)[0] for x in seq]


class _ClockRecorder:
    """The env with a host callback after each step_basic that records
    (time, phase, counter, phaselen)."""

    def __init__(self, env):
        self._env, self.rows = env, []

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step_basic(self, state, action):
        st, obs = self._env.step_basic(state, action)
        jax.debug.callback(
            lambda *x: self.rows.append(tuple(np.asarray(v).item()
                                              for v in x)),
            st.time, st.phase, st.counter, st.clock.phaselen)
        return st, obs


def run_clock(env, policy, name):
    """The clock of one 5k trial with physics against the clock alone."""
    from apex_tpu.runtime.eval_suites import eval_5k_matrix

    mission, speed = name.rsplit("_", 1)
    alone = clock_alone(env, name)
    rec = _ClockRecorder(env)
    res = eval_5k_matrix(policy, rec, missions=(mission,),
                         mission_speeds=(float(speed),), terrains=("flat",),
                         frictions=(1.0,), foot_mass_scales=(1.0,))
    rows = sorted(rec.rows)
    matrix = [np.float32([r[1] for r in rows]), np.int32([r[2] for r in rows]),
              np.float32([r[3] for r in rows])]
    stepped = []
    trial = run_5k_trial(env, policy, (mission, float(speed), "flat", 1.0,
                                       1.0), clock=stepped)
    stepped = [np.float32([r[0] for r in stepped]),
               np.int32([r[1] for r in stepped]),
               np.float32([r[2] for r in stepped])]
    out = {"schedule": name, "steps": int(alone[0].size),
           "passed_matrix": bool(np.asarray(res["passed"]).all()),
           "passed_stepped": trial["passed"]}
    for label, seq in (("eval_5k_matrix", matrix), ("stepped", stepped)):
        out[label] = {
            f: (int(np.sum(a != b)) if a.shape == b.shape else "length")
            for f, a, b in zip(("phase", "counter", "phaselen"), seq, alone)}
    return out


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
    ap.add_argument("--clock", nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    ppo, state, _ = _loader()(args.ckpt)
    env = ppo.env

    def policy(obs):
        return state.actor.act(state.norm, obs, deterministic=True)

    out = {"ckpt": args.ckpt, "commands": [], "5k": [], "snapshots": {},
           "clock": []}
    for name in args.clock:
        out["clock"].append(run_clock(env, policy, name))
        print("clock", json.dumps(out["clock"][-1]), flush=True)
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
