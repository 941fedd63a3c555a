"""The gait clock's length P as each of the JAX package's other reset and
command programs computes it, on the CPU, at the reset speeds of
`curves/jax_eval_draws/`: the export `tests/test_torch_clock_resets.py`
holds the port to.

XLA contracts products into fused multiply-adds by the program around
them, so P can differ by an ulp between programs (ROADMAP limit (j)).
Each program here is the JAX package's own, run through its own entry
point at the configuration of a run directory, with two changes: the
reset's speed draw gives the speed listed for its key (a lookup, so the
speed stays a run-time input of the program), and the reset is followed
by a `jax.debug.callback` that reads the state's speed and P. Step counts
are cut to 1 where the entry point takes them; the clock is built before
any step.

  perturb           eval_suites.eval_perturbation's vmapped trial
                    (n / 16 angles x 4 forces x 4 phases)
  sensitivity       eval_suites.eval_sensitivity (n / 16 values x 16)
  rollout_record    analysis.rollout_record (n trials)
  perturb_response  analysis.perturb_response (n / 4 angles x 4 phases)
  ars               ARS's jitted iteration on the env (n / 2 directions,
                    the n candidates' rollouts)
  single_reset      `jax.jit(env.reset)` of one env: drive_policy's reset
                    and its "r" key, record_policy's and dump_gait's reset
  commands          eval_suites.eval_commands: its reset_for_test (its
                    clock does not depend on a speed)
  drive_keys        drive_policy's clock keys x, z, v and c (swing or
                    stance +- 0.01 s, the clock rebuilt by
                    `drive._apply_key`, which runs eagerly: op by op) on
                    the single_reset states; "<config>/drive_keys/swing"
                    and "/stance" hold the durations before the key,
                    "/phaselen_<key>" P after it

The configurations are `tests/test_torch_clock_resets.py`'s (main, mk5a,
mk5b, traj: the run directories' experiment.pkl). A program that cannot
run on a configuration's env is recorded with the exception's text. The
mission suite's CassiePlayground builds no clock from a speed (its
phaselen is the mission's) and is not a program of this export.

    JAX_PLATFORMS=cpu python scripts/export_clock_programs.py \\
        --configs main --out part_main.npz
    python scripts/export_clock_programs.py merge part_*.npz \\
        --out curves/jax_eval_draws/clock_programs.npz

Each file holds, per config and program, "<config>/<program>/speed" and
"<config>/<program>/phaselen" (float32, one per reset, in the order of
the callback's calls), or "<config>/<program>/error".
"""
import argparse
import pathlib
import pickle
import sys
import time
from types import SimpleNamespace

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

DRAWS = ROOT / "curves" / "jax_eval_draws"
CONFIGS = {"main": ("cassie_main_ckpt", ("main", "main2", "mk3")),
           "mk5a": ("cassie_mk5a_ckpt", ("mk5a",)),
           "mk5b": ("cassie_mk5b_ckpt", ("mk5b",)),
           "traj": ("cassie_traj_ckpt", ("traj",))}
PROGRAMS = ("perturb", "sensitivity", "rollout_record", "perturb_response",
            "ars", "single_reset", "commands", "drive_keys")
DRIVE_KEYS = "xzvc"          # drive_policy's keys that rebuild the clock


def file_speeds(name: str) -> np.ndarray:
    """A file's reset speeds (CassieTraj-v0: its speed indices)."""
    with np.load(DRAWS / f"{name}.npz") as f:
        key = "speed_idx" if "reset0_speed_idx" in f else "speed"
        return np.concatenate([f[f"reset0_{key}"], f[f"reset_{key}"]])


def config_speeds(config: str) -> np.ndarray:
    """The distinct speeds of a configuration's files, in file order."""
    speeds = np.concatenate([file_speeds(f) for f in CONFIGS[config][1]])
    _, first = np.unique(speeds, return_index=True)
    return speeds[np.sort(first)]


def jax_env(ckpt: str):
    """The JAX env of a run directory, as the JAX package's
    `load_experiment` builds it, and a fresh policy of its sizes."""
    import jax
    from apex_tpu.envs.registry import env_factory
    from apex_tpu.models.nets import GaussianFFActor, NormState

    with open(ROOT / "curves" / ckpt / "experiment.pkl", "rb") as f:
        args = SimpleNamespace(**pickle.load(f))
    env = env_factory(
        args.env_name, simrate=args.simrate,
        command_profile=args.command_profile,
        input_profile=args.input_profile, learn_gains=args.learn_gains,
        dynamics_randomization=args.dyn_random, reward=args.reward,
        history=args.history,
        estimator=getattr(args, "estimator", None) or "exact",
        terrain=getattr(args, "terrain", None) or "flat",
        speed_phase_add=getattr(args, "speed_phase_add", None) or False)
    actor = GaussianFFActor.init(jax.random.PRNGKey(0),
                                 env.observation_size, env.action_size,
                                 fixed_std=float(np.exp(-1.5)))
    return env, actor, NormState.create(env.observation_size)


class Probe:
    """While `run` runs a program: the reset's speed draw of `env` gives
    the table's speed for its key (CassieTraj-v0: its randint(0, 41)), and
    every reset reports (speed, P) through a debug callback."""

    def __init__(self, mp, env):
        import jax
        import jax.numpy as jnp

        self.table, self.got = None, []
        traj = type(env).__name__ == "CassieTrajEnv"
        uniform, randint = jax.random.uniform, jax.random.randint

        def lookup(key):
            t_keys, t_vals = self.table
            match = jnp.all(key == t_keys, axis=-1)
            return jnp.sum(jnp.where(match, t_vals, 0))

        def patched_uniform(key, shape=(), dtype=float, minval=0.0,
                            maxval=1.0):
            if (self.table is not None and not traj and shape == ()
                    and minval == env.min_speed
                    and maxval == env.max_speed):
                return lookup(key).astype(jnp.float32)
            return uniform(key, shape, dtype, minval, maxval)

        def patched_randint(key, shape, minval, maxval, dtype=int):
            if (self.table is not None and traj and shape == ()
                    and (minval, maxval) == (0, 41)):
                return lookup(key).astype(jnp.int32)
            return randint(key, shape, minval, maxval, dtype)

        def sink(speed, phaselen):
            self.got.append((np.float32(speed), np.float32(phaselen)))

        def report(reset):
            def wrapped(self_env, *a, **k):
                state, obs = reset(self_env, *a, **k)
                p = (state.phaselen if hasattr(state, "phaselen")
                     else state.clock.phaselen)
                jax.debug.callback(sink, state.speed, p)
                return state, obs
            return wrapped

        mp.setattr(jax.random, "uniform", patched_uniform)
        mp.setattr(jax.random, "randint", patched_randint)
        for name in ("reset", "reset_for_test"):
            if hasattr(type(env), name):
                mp.setattr(type(env), name, report(getattr(type(env),
                                                           name)))

    def run(self, reset_keys, speeds, fn):
        """fn() with the speed draw of each key of `reset_keys` giving
        `speeds`; returns the (speed, P) of each reset."""
        import jax
        import jax.numpy as jnp

        speed_keys = jax.vmap(lambda k: jax.random.split(k, 5)[0])(
            jnp.asarray(reset_keys))
        self.table, self.got = (speed_keys, jnp.asarray(speeds)), []
        try:
            fn()
            jax.effects_barrier()
        finally:
            self.table = None
        return self.got


def measure(config: str, program: str, log=print):
    """[(speed, P)] of every reset `program` makes at the configuration's
    speeds: one run of the program, its fleet the speeds padded (by
    repeating them) to a multiple of 16."""
    import jax
    import jax.numpy as jnp
    from jax.random import PRNGKey, split
    from pytest import MonkeyPatch

    from apex_tpu.runtime import analysis, eval_suites

    env, actor, norm = jax_env(CONFIGS[config][0])
    policy = lambda obs: actor.act(norm, obs, deterministic=True)
    speeds = config_speeds(config)
    n = -(-len(speeds) // 16) * 16
    first = lambda keys: [split(k)[0] for k in keys]
    mp = MonkeyPatch()
    try:
        probe = Probe(mp, env)
        if program == "perturb":
            keys = [split(k, 4)[0] for k in split(PRNGKey(0), n)]
            fn = lambda: eval_suites.eval_perturbation(
                env, policy, num_angles=n // 16, max_force=100.0,
                force_step=25.0, num_phases=4, wait_steps=1,
                perturb_steps=1, recover_steps=1)
        elif program == "sensitivity":
            keys = first(split(PRNGKey(0), n))
            fn = lambda: eval_suites.eval_sensitivity(
                env, policy, values=np.linspace(0.3, 1.3, n // 16),
                n_trials=16, episode_steps=1)
        elif program == "rollout_record":
            keys = first(split(PRNGKey(0), n))
            fn = lambda: analysis.rollout_record(env, policy, 1,
                                                 n_trials=n)
        elif program == "perturb_response":
            keys = first(split(PRNGKey(0), n))
            fn = lambda: analysis.perturb_response(
                env, policy, angles=np.linspace(0, 2 * np.pi, n // 4,
                                                endpoint=False),
                phases=[0, 8, 16, 24], wait_steps=1, perturb_steps=1,
                recover_steps=1)
        elif program == "ars":
            from apex_tpu.agents.ars import ARS, ARSConfig

            ars = ARS(env, ARSConfig(deltas=n // 2, deltas_used=n // 4,
                                     max_traj_len=1))
            keys = split(split(ars.init(seed=0).rng, 3)[2], n)
            fn = lambda: ars._step(ars.init(seed=0))
        elif program == "single_reset":
            keys = list(split(PRNGKey(0), n))
            reset = jax.jit(env.reset)
            fn = lambda: [reset(k) for k in keys]
        elif program == "commands":
            keys = first(split(PRNGKey(0), 16))
            fn = lambda: eval_suites.eval_commands(
                env, policy, n_trials=16, n_commands=1,
                steps_per_command=2)
        else:
            raise KeyError(program)
        t0 = time.time()
        got = probe.run(np.asarray(jnp.stack(list(keys))),
                        np.resize(speeds, len(keys)), fn)
        log(f"{config} {program}: {len(got)} resets, "
            f"{time.time() - t0:.1f}s")
    finally:
        mp.undo()
    return got


def measure_drive_keys(config: str, log=print) -> dict:
    """drive_policy's clock keys on the single-env reset of each speed:
    the durations before each key and P after it."""
    import jax
    from jax.random import PRNGKey, split
    from pytest import MonkeyPatch

    from apex_tpu.runtime.drive import _apply_key

    env, _, _ = jax_env(CONFIGS[config][0])
    speeds = config_speeds(config)
    keys = list(split(PRNGKey(0), len(speeds)))
    mp = MonkeyPatch()
    try:
        probe = Probe(mp, env)
        reset = jax.jit(env.reset)
        states = []
        probe.run(np.asarray(keys), speeds,
                  lambda: states.extend(reset(k)[0] for k in keys))
    finally:
        mp.undo()
    t0 = time.time()
    out = {"speed": [np.float32(s.speed) for s in states],
           "swing": [np.float32(s.swing_duration) for s in states],
           "stance": [np.float32(s.stance_duration) for s in states]}
    for key in DRIVE_KEYS:
        out[f"phaselen_{key}"] = [
            np.float32(_apply_key(env, s, key, PRNGKey(1)).clock.phaselen)
            for s in states]
    log(f"{config} drive_keys: {len(states)} states, "
        f"{time.time() - t0:.1f}s")
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def export(configs, programs, path, log=print):
    import jax

    jax.config.update("jax_platforms", "cpu")
    res = {}
    for config in configs:
        for program in programs:
            name = f"{config}/{program}"
            try:
                if program == "drive_keys":
                    for k, v in measure_drive_keys(config, log).items():
                        res[f"{name}/{k}"] = v
                    continue
                got = measure(config, program, log)
            except (AttributeError, TypeError, ValueError) as e:
                res[f"{name}/error"] = np.asarray(
                    f"{type(e).__name__}: {e}")
                log(f"{name}: {res[f'{name}/error']}")
                continue
            res[f"{name}/speed"] = np.asarray([s for s, _ in got],
                                              np.float32)
            res[f"{name}/phaselen"] = np.asarray([p for _, p in got],
                                                 np.float32)
    np.savez(path, **res)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", nargs="?", default="export",
                    choices=["export", "merge"])
    ap.add_argument("parts", nargs="*")
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS))
    ap.add_argument("--programs", nargs="+", default=list(PROGRAMS))
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.mode == "merge":
        res = {}
        for p in args.parts:
            with np.load(p) as f:
                res.update({k: f[k] for k in f.files})
        np.savez(args.out, **res)
        print(f"merged {len(args.parts)} parts into {args.out}")
        return
    export(args.configs, args.programs, args.out,
           log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
