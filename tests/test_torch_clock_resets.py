"""The gait clock's length at a reset in the port against the JAX package's,
bit for bit, as each of JAX's reset programs compiles it, on the CPU.

A reset builds the episode's clock from the drawn speed: its length is
P = 2 sw + 2 st with the swing and stance durations of
`speed_to_durations`. XLA contracts products into fused multiply-adds by
the program around them, so P can differ by an ulp between programs, and
the phase the observation reads is phase / P. JAX builds the clock in
three programs:

- `init_runner`'s `jax.jit(jax.vmap(env.reset))`
  (`apex_tpu/agents/rollout.py:53-59`), the first fleet of a training run
  and of an evaluation;
- the auto-reset inside `rollout_scan` (`:100-102`), in the training
  iteration's rollout (stochastic policy, `agents/ppo.py:300-305`);
- the same auto-reset in `runtime/evaluate.py:73-76`'s jitted rollout
  (deterministic policy).

The speeds are the reset speeds of JAX's evaluations saved in
`curves/jax_eval_draws/` (the first fleet's and the auto-resets', 128 per
file, 136 in traj's). JAX's programs are its own, with one change: the reset's speed draw
returns the file's speed for the env's key (a lookup, so the value stays
a run-time input of the program). The rollouts run one step with every
env truncated, so the whole fleet auto-resets. The port resets with the
same speeds and nothing else changed.

What this holds (S3): JAX's programs differ among themselves. Its
first-fleet program also contracts 0.30 + c |v| and 0.70 - c |v| into
fused multiply-adds, which moves P by an ulp from the auto-reset's for
9-17 % of the speeds (`EXPECTED_INIT_DIFFS`). The port's auto-reset is
JAX's auto-reset bit for bit in every configuration, and its fresh-fleet
reset (`reset_fresh`, through `init_runner`) is JAX's first-fleet
program's.
"""
import dataclasses
import pathlib
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.agents.rollout import init_runner, rollout_scan
from apex_tpu.envs.registry import env_factory as jax_env_factory
from apex_tpu.models.nets import GaussianFFActor as JaxActor
from apex_tpu.models.nets import NormState as JaxNorm
from apex_tpu_torch.runtime.evaluate import load_experiment

ROOT = pathlib.Path(__file__).resolve().parent.parent
DRAWS = ROOT / "curves" / "jax_eval_draws"
# one JAX and one port env per distinct configuration; main, main2 and
# mk3 were run with the same settings
CONFIGS = {"main": ("cassie_main_ckpt", ("main", "main2", "mk3")),
           "mk5a": ("cassie_mk5a_ckpt", ("mk5a",)),
           "mk5b": ("cassie_mk5b_ckpt", ("mk5b",)),
           "traj": ("cassie_traj_ckpt", ("traj",))}
FILES = [f for _, files in CONFIGS.values() for f in files]
# the training rollout's program (a stochastic policy) is compiled for
# mk5a's configuration only, the one with the dynamics randomisation and
# the firmware estimator of the curve's: each compile of a rollout takes
# ~25 s here, and it gave the evaluation rollout's clock bit for bit in
# all four configurations when compiled for each
TRAIN_PROGRAM = ("mk5a",)
# speeds of each file whose clock length JAX's first-fleet program gives
# one ulp away from its auto-reset's (of 128; traj's of 136)
EXPECTED_INIT_DIFFS = {"main": 22, "main2": 17, "mk3": 17, "mk5a": 13,
                       "mk5b": 13, "traj": 12}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run side by side in several worker processes: one torch
    thread each keeps them from oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _file_speeds(name: str) -> np.ndarray:
    """The file's 128 reset speeds (CassieTraj-v0: its speed indices,
    speed x 10)."""
    with np.load(DRAWS / f"{name}.npz") as f:
        key = "speed_idx" if "reset0_speed_idx" in f else "speed"
        return np.concatenate([f[f"reset0_{key}"], f[f"reset_{key}"]])


def _jax_env_and_policy(ckpt: str):
    """JAX's env of the run directory, built as its `load_experiment`
    builds it, and a freshly initialised policy of its sizes: the reset's
    arithmetic reads no weight, and skipping the checkpoint's train state
    skips compiling its 1,024-env fleet."""
    with open(ROOT / "curves" / ckpt / "experiment.pkl", "rb") as f:
        args = SimpleNamespace(**pickle.load(f))
    env = jax_env_factory(
        args.env_name, simrate=args.simrate,
        command_profile=args.command_profile,
        input_profile=args.input_profile, learn_gains=args.learn_gains,
        dynamics_randomization=args.dyn_random, reward=args.reward,
        history=args.history,
        estimator=getattr(args, "estimator", None) or "exact",
        terrain=getattr(args, "terrain", None) or "flat",
        speed_phase_add=getattr(args, "speed_phase_add", None) or False)
    actor = JaxActor.init(jax.random.PRNGKey(0), env.observation_size,
                          env.action_size, fixed_std=float(np.exp(-1.5)))
    return env, actor, JaxNorm.create(env.observation_size)


class _SpeedLookup:
    """While a table is set (`run`), the reset's speed draw of `env` (jax.random.uniform
    over [min_speed, max_speed), or CassieTraj-v0's randint(0, 41)) gives
    the speed listed for its key instead; every other draw is JAX's."""

    def __init__(self, monkeypatch, env):
        self.table = None
        self.traj = type(env).__name__ == "CassieTrajEnv"
        uniform, randint = jax.random.uniform, jax.random.randint

        def lookup(key):
            t_keys, t_vals = self.table
            match = jnp.all(key == t_keys, axis=-1)
            return jnp.sum(jnp.where(match, t_vals, 0))

        def patched_uniform(key, shape=(), dtype=float, minval=0.0,
                            maxval=1.0):
            if (self.table is not None and not self.traj and shape == ()
                    and minval == env.min_speed
                    and maxval == env.max_speed):
                return lookup(key).astype(jnp.float32)
            return uniform(key, shape, dtype, minval, maxval)

        def patched_randint(key, shape, minval, maxval, dtype=int):
            if (self.table is not None and self.traj and shape == ()
                    and (minval, maxval) == (0, 41)):
                return lookup(key).astype(jnp.int32)
            return randint(key, shape, minval, maxval, dtype)

        monkeypatch.setattr(jax.random, "uniform", patched_uniform)
        monkeypatch.setattr(jax.random, "randint", patched_randint)

    def run(self, reset_keys, speeds, fn):
        """fn() with the speed draw of each key of `reset_keys` (the keys
        the program's vmapped reset receives) giving `speeds`."""
        speed_keys = jax.vmap(lambda k: jax.random.split(k, 5)[0])(
            reset_keys)
        self.table = (speed_keys, jnp.asarray(speeds))
        try:
            return fn()
        finally:
            self.table = None


def _phaselen(env_state):
    """The clock's length (CassieTraj-v0 keeps it on the state)."""
    if hasattr(env_state, "phaselen"):
        return np.asarray(env_state.phaselen)
    return np.asarray(env_state.clock.phaselen)


_JAX = {}


def _jax_clocks(config: str):
    """{program: (speeds read back, clock lengths)} of JAX's three reset
    programs for every speed of the configuration's files, one fleet."""
    if config in _JAX:
        return _JAX[config]
    ckpt, files = CONFIGS[config]
    speeds = np.concatenate([_file_speeds(f) for f in files])
    B = len(speeds)
    env, actor, norm = _jax_env_and_policy(ckpt)
    mp = pytest.MonkeyPatch()
    try:
        lookup = _SpeedLookup(mp, env)
        rng = jax.random.PRNGKey(3)
        out = {}
        runner = lookup.run(
            jax.random.split(jax.random.split(rng)[1], B), speeds,
            lambda: init_runner(env, rng, B))
        out["init"] = runner.env_state
        policies = {"eval": lambda _, obs: actor.act(norm, obs,
                                                     deterministic=True)}
        if config in TRAIN_PROGRAM:
            policies["train"] = lambda k, obs: actor.act(
                norm, obs, rng=k, deterministic=False, anneal=1.0)
        reset_keys = jax.random.split(jax.random.split(runner.rng, 4)[3], B)
        for prog, policy in policies.items():
            # one step at max_traj_len 1: every env ends and auto-resets
            new, traj = lookup.run(reset_keys, speeds, lambda: jax.jit(
                lambda r: rollout_scan(env, policy, r, 1, 1))(runner))
            assert np.all(np.asarray(traj.done_ep_len) == 1)
            out[prog] = new.env_state
    finally:
        mp.undo()
    _JAX[config] = {k: (np.asarray(s.speed), _phaselen(s))
                    for k, s in out.items()}
    return _JAX[config]


def _port_clocks(config: str, speeds: np.ndarray,
                 fresh: bool = False) -> np.ndarray:
    """The port's clock lengths of a reset at `speeds` (with `fresh`, of a
    fresh fleet's, `reset_fresh`), the rest of its draws its own."""
    env = load_experiment(str(ROOT / "curves" / CONFIGS[config][0]),
                          device="cpu").env
    gen = torch.Generator()
    gen.manual_seed(0)
    noise = env.sample_reset_noise(gen, len(speeds))
    field = "speed_idx" if hasattr(noise, "speed_idx") else "speed"
    noise = noise._replace(**{field: torch.as_tensor(
        speeds, dtype=getattr(noise, field).dtype)})
    state, _ = (env.reset_fresh if fresh else env.reset)(noise)
    return _phaselen(state)


def _rows(file: str):
    """(config, slice of its fleet) holding the file's speeds."""
    for config, (_, files) in CONFIGS.items():
        if file in files:
            start = sum(len(_file_speeds(f))
                        for f in files[:files.index(file)])
            return config, slice(start, start + len(_file_speeds(file)))
    raise KeyError(file)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_jax_programs_reset_at_the_files_speeds(config):
    """The lookup reaches the reset's speed draw in every program: each
    state holds the files' speeds (CassieTraj-v0's randint / 10.0, which
    XLA computes as randint * 0.1f, as the port does)."""
    speeds = np.concatenate([_file_speeds(f) for f in CONFIGS[config][1]])
    want = (np.float32(speeds) * np.float32(0.1) if config == "traj"
            else speeds)
    for prog, (got, _) in _jax_clocks(config).items():
        np.testing.assert_array_equal(got, want, err_msg=prog)


def _assert_same(file, port, jax_p):
    diff = np.flatnonzero(port != jax_p)
    assert diff.size == 0, (
        f"{file}: {diff.size} of {port.size} clock lengths differ, first at "
        f"speed {_file_speeds(file)[diff[0]]}: port {port[diff[0]]!r}, "
        f"JAX {jax_p[diff[0]]!r}")


@pytest.mark.parametrize("file,program", [(f, "eval") for f in FILES]
                         + [("mk5a", "train")])
def test_port_reset_clock_is_jax_autoreset_bit_for_bit(file, program):
    """The port's reset clock length equals JAX's auto-reset's in the
    training and the evaluation rollout, for every speed of the file."""
    config, rows = _rows(file)
    speeds = np.concatenate([_file_speeds(f) for f in CONFIGS[config][1]])
    _assert_same(file, _port_clocks(config, speeds)[rows],
                 _jax_clocks(config)[program][1][rows])


@pytest.mark.parametrize("file", FILES)
def test_port_fresh_fleet_clock_is_jax_init_runner_bit_for_bit(file):
    """JAX's first-fleet program parts from its own auto-reset on
    EXPECTED_INIT_DIFFS[file] of the file's speeds (it also contracts
    0.30 + c |v| and 0.70 - c |v|); the port's fresh-fleet reset
    (`reset_fresh`, what `init_runner` calls) is that program's bit for
    bit."""
    config, rows = _rows(file)
    clocks = _jax_clocks(config)
    init, auto = clocks["init"][1][rows], clocks["eval"][1][rows]
    assert int(np.sum(init != auto)) == EXPECTED_INIT_DIFFS[file]
    speeds = np.concatenate([_file_speeds(f) for f in CONFIGS[config][1]])
    _assert_same(file, _port_clocks(config, speeds, fresh=True)[rows], init)


# ---------------------------------------------------------------------------
# JAX's other programs that build a clock: the suites, the analysis jobs,
# ARS's rollout, the single-env reset and drive_policy's clock keys, as
# `scripts/export_clock_programs.py` ran them (each program compiles its
# whole trial, ~1-5 min here, so their clock lengths are read from the
# committed export, made with the same speed lookup as above)
PROGRAMS_EXPORT = DRAWS / "clock_programs.npz"
# each program's reset in the port: JAX's batched programs build the clock
# as its auto-reset does; `jax.jit(env.reset)` of one env (drive_policy's
# reset and "r" key, record_policy's and dump_gait's reset) as its
# `init_runner` program does
PROGRAM_RESETS = {"perturb": "reset", "sensitivity": "reset",
                  "rollout_record": "reset", "perturb_response": "reset",
                  "ars": "reset", "single_reset": "reset_fresh"}
# programs that cannot run on a configuration's env in the JAX package:
# the perturbation suite reads `state.clock`, which CassieTrajEnv's state
# does not have (it keeps phaselen on the state)
NOT_RUN = {("traj", "perturb")}
# speeds of each file at which the program's clock length parts from
# JAX's auto-reset's (of 128; traj's of 136): the single-env reset's are
# init_runner's
EXPECTED_PROGRAM_DIFFS = {
    p: (EXPECTED_INIT_DIFFS if r == "reset_fresh"
        else dict.fromkeys(EXPECTED_INIT_DIFFS, 0))
    for p, r in PROGRAM_RESETS.items()}
# drive_policy's clock keys: the speeds of each configuration (its files'
# distinct speeds) at which JAX's key, computed op by op, parts from the
# contracted arithmetic of every compiled program's build_clock, per key
EXPECTED_KEY_DIFFS = {"main": {"x": 32, "z": 22, "v": 32, "c": 33},
                      "mk5a": {"x": 21, "z": 17, "v": 16, "c": 21},
                      "mk5b": {"x": 27, "z": 33, "v": 32, "c": 23},
                      "traj": {"x": 8, "z": 5, "v": 4, "c": 5}}


def _export():
    with np.load(PROGRAMS_EXPORT) as f:
        return {k: f[k] for k in f.files}


def _program_clocks(config: str, program: str, speeds) -> np.ndarray:
    """The export's clock length of `program` at each of `speeds` (the
    files' speeds; CassieTraj-v0's speed indices), looked up by the speed
    its reset stored."""
    ex = _export()
    table = {}
    for s, p in zip(ex[f"{config}/{program}/speed"],
                    ex[f"{config}/{program}/phaselen"]):
        assert table.setdefault(float(s), p) == p, (program, s)
    key = (np.float32(speeds) * np.float32(0.1) if config == "traj"
           else np.asarray(speeds))
    return np.array([table[float(k)] for k in key], np.float32)


def test_export_holds_every_program():
    """Every program ran on every configuration but the ones NOT_RUN
    names, with the files' speeds read back from its resets."""
    ex = _export()
    for config in CONFIGS:
        speeds = np.concatenate([_file_speeds(f)
                                 for f in CONFIGS[config][1]])
        want = (np.float32(speeds) * np.float32(0.1) if config == "traj"
                else np.float32(speeds))
        for program in PROGRAM_RESETS:
            name = f"{config}/{program}"
            if (config, program) in NOT_RUN:
                assert f"{name}/error" in ex, name
                continue
            assert set(ex[f"{name}/speed"]) == set(want), name


@pytest.mark.parametrize("file,program", [
    (f, p) for f in FILES for p in PROGRAM_RESETS
    if (_rows(f)[0], p) not in NOT_RUN])
def test_port_clock_is_each_jax_program_bit_for_bit(file, program):
    """The port's reset in each program (PROGRAM_RESETS) gives JAX's clock
    length bit for bit at every speed of the file; the program parts from
    JAX's auto-reset on EXPECTED_PROGRAM_DIFFS of them."""
    config, _ = _rows(file)
    speeds = _file_speeds(file)
    jax_p = _program_clocks(config, program, speeds)
    fresh = PROGRAM_RESETS[program] == "reset_fresh"
    _assert_same(file, _port_clocks(config, speeds, fresh=fresh), jax_p)
    auto = _port_clocks(config, speeds)
    assert int(np.sum(jax_p != auto)) == \
        EXPECTED_PROGRAM_DIFFS[program][file]


@pytest.mark.parametrize("config", [c for c in CONFIGS if c != "traj"])
def test_command_suite_clock_is_jax_reset_for_test(config):
    """The command suite's trials start from reset_for_test, whose clock is
    the fixed grounded 0.15 / 0.25 s one (no speed reaches it, and the
    suite's speed commands leave it, as JAX's do): its length is JAX's,
    which XLA folds from constants op by op (26.400002 at mk5b's simrate
    60, where the contracted sum gives 26.4)."""
    env = load_experiment(str(ROOT / "curves" / CONFIGS[config][0]),
                          device="cpu").env
    state, _ = env.reset_for_test(2)
    want = _export()[f"{config}/commands/phaselen"]
    np.testing.assert_array_equal(_phaselen(state),
                                  np.full(2, want[0], np.float32))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_drive_clock_keys_are_jax_op_by_op(config):
    """drive_policy's x, z, v and c keys rebuild the clock from the swing
    or stance duration +- 0.01 s; JAX's `_apply_key` runs op by op, so
    phaselen = 2 sw + 2 st is not contracted. On JAX's durations of each
    speed's single-env reset, the port's key gives JAX's length bit for
    bit, and the contracted arithmetic parts from it at
    EXPECTED_KEY_DIFFS of the speeds."""
    from apex_tpu_torch.rewards.clock import build_clock
    from apex_tpu_torch.runtime.drive import _apply_key

    ex = _export()
    env = load_experiment(str(ROOT / "curves" / CONFIGS[config][0]),
                          device="cpu").env
    swing = torch.as_tensor(ex[f"{config}/drive_keys/swing"])
    stance = torch.as_tensor(ex[f"{config}/drive_keys/stance"])
    B = len(swing)
    gen = torch.Generator()
    gen.manual_seed(0)
    state, _ = env.reset(env.sample_reset_noise(gen, B))
    state = dataclasses.replace(state, swing_duration=swing,
                                stance_duration=stance)
    for key in "xzvc":
        got = _apply_key(env, state, key).clock.phaselen.numpy()
        want = ex[f"{config}/drive_keys/phaselen_{key}"]
        diff = np.flatnonzero(got != want)
        assert diff.size == 0, (key, diff.size, got[diff[:3]],
                                want[diff[:3]])
        fused = build_clock(swing + (key == "x") * 0.01 - (key == "z") * 0.01,
                            stance + (key == "v") * 0.01
                            - (key == "c") * 0.01, state.stance_mode,
                            env.strict_relaxer, env.have_incentive,
                            float(env._freq)).phaselen.numpy()
        assert int(np.sum(fused != want)) == EXPECTED_KEY_DIFFS[config][key]


def test_single_env_programs_reset_as_init_runner(monkeypatch):
    """drive_policy (its start and its "r" key) and the one-env rollouts
    of record_policy and dump_gait reset through `reset_fresh`, the
    arithmetic of JAX's `jax.jit(env.reset)`, and never through `reset`."""
    from apex_tpu_torch.envs.cassie import CassieEnv
    from apex_tpu_torch.runtime import drive, evaluate

    calls = []
    for name in ("reset", "reset_fresh"):
        real = getattr(CassieEnv, name)
        monkeypatch.setattr(
            CassieEnv, name,
            lambda self, noise, _r=real, _n=name, **k: (
                calls.append(_n), _r(self, noise, **k))[1])
    exp = load_experiment(str(ROOT / "curves" / "cassie_mk5a_ckpt"),
                          device="cpu")
    drive.drive_policy(exp.actor, exp.norm, exp.env, [(0, "r")], n_steps=1)
    evaluate._one_env_rollout(str(ROOT / "curves" / "cassie_mk5a_ckpt"), 1,
                              1.0, "cpu", None,
                              lambda *a: {"x": torch.zeros(1)})
    assert calls.count("reset_fresh") == 3
    # `reset_fresh` runs `reset(noise, fresh_fleet=True)`
    assert calls.count("reset") == 3


@pytest.mark.parametrize("mission", ["default", "straight_1.4", "90_left_0.5"])
def test_mission_clock_is_jax_playgrounds(mission):
    """The mission suite's CassiePlayground builds no clock from a speed:
    its phaselen is the mission trajectory's, JAX's bit for bit."""
    from apex_tpu.envs.cassie_playground import CassiePlayground as JaxPG
    from apex_tpu_torch.envs.cassie_playground import CassiePlayground

    want = JaxPG(mission=mission).phaselen
    got = CassiePlayground(mission=mission, device="cpu").phaselen
    assert np.float32(got) == np.float32(want) and got == want
