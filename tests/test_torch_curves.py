"""The port's learning-curve scripts against the JAX package's tools, on the
CPU at a tiny size.

`scripts/torch_train_curve.py`, `torch_train_offpolicy_curve.py` and
`torch_train_recurrent_curve.py` are the counterparts of
`tools/train_curve.py`, `train_offpolicy_curve.py` and
`train_recurrent_curve.py`. Each runs here with `--device cpu --out
<tmp>`, and its files carry the keys the JAX tool writes: those are read
from the tools' source (the tools themselves write into curves/ and are
not run). The PPO curve's best-eval checkpoint loads in the JAX package's
`runtime.evaluate.load_experiment`, leaf for leaf the port's state, and
JAX's deterministic evaluation of it on JAX's own draws gives the port's
return on the same draws within the tolerance of
`tests/test_torch_ppo.py`'s iteration test (rtol 1e-4, atol 1e-6).
"""
import ast
import functools
import importlib.util
import json
import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.agents.rollout import init_runner as jax_init_runner
from apex_tpu.agents.rollout import rollout_scan as jax_rollout_scan
from apex_tpu.runtime.evaluate import load_experiment as jax_load_experiment
from apex_tpu_torch.agents import ars as ars_mod
from apex_tpu_torch.agents import td3 as td3_mod
from apex_tpu_torch.agents.rollout import evaluate_policy
from apex_tpu_torch.envs.walker2d import Walker2dEnv, WalkerResetNoise
from apex_tpu_torch.runtime import checkpoint
from apex_tpu_torch.runtime.evaluate import load_experiment

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run side by side in several worker processes: one torch
    thread each keeps them from oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dict_keys(node) -> set:
    return {k.value for k in node.keys}


def jax_tool_keys(tool: str) -> dict:
    """The keys a JAX tool writes, from its source: "npz" (np.savez's
    keywords), "pkl" (the dict it pickles as experiment.pkl) and
    "summary" (the dict of its closing JSON line)."""
    tree = ast.parse((ROOT / "tools" / f"{tool}.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = ast.unparse(node.func)
        if f == "np.savez":
            out["npz"] = {k.arg for k in node.keywords}
        elif f == "pickle.dump" and isinstance(node.args[0], ast.Dict):
            out["pkl"] = _dict_keys(node.args[0])
        elif f == "json.dumps" and isinstance(node.args[0], ast.Dict):
            out["summary"] = _dict_keys(node.args[0])
    for node in ast.walk(tree):     # train_curve.py: summary = {...}
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and ast.unparse(node.targets[0]) == "summary"):
            out["summary"] = _dict_keys(node.value)
    return out


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# scripts/torch_train_curve.py
# ---------------------------------------------------------------------------

CURVE_ARGS = ["walker", "--device", "cpu", "--num-envs", "64", "--n-itr",
              "2", "--eval-every", "1", "--max-traj-len", "20"]


@pytest.fixture(scope="module")
def ppo_run(tmp_path_factory):
    """A 2-iteration Walker2d curve at 64 envs (32 steps each, one
    minibatch of 2,048), an eval at each iteration; its output and
    stdout. (64 envs, not 8: the burn-in takes 10,000 // num_envs steps.)"""
    import contextlib
    import io

    out = tmp_path_factory.mktemp("curve")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = _script("torch_train_curve").main(
            CURVE_ARGS + ["--out", str(out)])
    return out, buf.getvalue(), state


def test_train_curve_writes_the_jax_tools_files(ppo_run):
    out, stdout, _ = ppo_run
    keys = jax_tool_keys("train_curve")
    with np.load(out / "walker_ppo_seed0.npz") as f:
        assert set(f.files) == keys["npz"]
        np.testing.assert_array_equal(f["iters"], [0, 1])
        for k in ("iters", "env_steps"):
            assert f[k].dtype == np.int64, k
        for k in ("wall_s", "train_return", "eval_return", "eval_len",
                  "ep_len"):
            assert f[k].dtype == np.float64, k
            assert np.all(np.isfinite(f[k])), k
        assert int(f["num_envs"]) == 64
        assert int(f["steps_per_iter"]) == 64 * 32
        np.testing.assert_array_equal(f["env_steps"], [2048, 4096])
    ckpt = out / "walker_ppo_seed0_ckpt"
    with open(ckpt / "experiment.pkl", "rb") as f:
        exp = pickle.load(f)
    assert set(exp) == keys["pkl"]
    assert (exp["env_name"], exp["num_procs"], exp["num_steps"]) == (
        "Walker2d", 64, 2048)
    summary = _last_json(stdout)
    assert set(summary) == keys["summary"] | {"card"}
    assert summary["card"] == "cpu"
    timing = json.loads(stdout.strip().splitlines()[-2])
    assert timing["timing"]["n_evals"] == 2


def test_curve_checkpoint_loads_in_jax_leaf_for_leaf(ppo_run):
    """JAX's load_experiment (through its load_checkpoint) restores the
    best-eval checkpoint over its template: every leaf is the saved one."""
    out, _, _ = ppo_run
    ckpt = out / "walker_ppo_seed0_ckpt"
    saved = checkpoint._read(str(ckpt))
    _, jstate, jargs = jax_load_experiment(str(ckpt))
    theirs = jax.tree_util.tree_leaves(jstate)
    assert len(theirs) == len(saved)
    for a, b in zip(saved, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jargs.env_name == "Walker2d"


def _jax_walker_draws(env, seed: int, B: int, T: int):
    """The reset draws of JAX's evaluation protocol with PRNGKey(seed)
    (`init_runner`, then `rollout_scan`'s auto-reset keys), as the port's
    WalkerResetNoise, one per fleet reset the port draws: the first
    fleet's, then one per step."""
    m = env.model

    def draws(key):
        keys = jax.random.split(key, B)
        u = [jax.vmap(lambda k, i=i, n=n: jax.random.uniform(
            jax.random.split(k)[i], (n,), minval=-1.0, maxval=1.0))(keys)
            for i, n in enumerate((m.nq, m.nv))]
        return WalkerResetNoise(*(torch.tensor(np.asarray(x).T) for x in u))

    rng, key = jax.random.split(jax.random.PRNGKey(seed))
    out = [draws(key)]
    for _ in range(T):
        rng, _, _, k_reset = jax.random.split(rng, 4)
        out.append(draws(k_reset))
    return out


def test_jax_eval_of_the_checkpoint_matches_the_ports(ppo_run, monkeypatch):
    """JAX's deterministic evaluation of the saved run (runtime/evaluate.
    py's program, 8 envs, 20 steps) and the port's on the same draws."""
    out, _, _ = ppo_run
    ckpt = str(out / "walker_ppo_seed0_ckpt")
    B, T, seed = 8, 20, 5
    ppo, jstate, _ = jax_load_experiment(ckpt)
    jenv = ppo.env

    def policy_fn(_, obs):
        return jstate.actor.act(jstate.norm, obs, deterministic=True)

    runner = jax_init_runner(jenv, jax.random.PRNGKey(seed), B)
    _, traj = jax.jit(lambda r: jax_rollout_scan(jenv, policy_fn, r, T, T))(
        runner)
    n_done = int(jnp.sum(traj.done_ep_len > 0))
    jax_ret = float(jnp.sum(traj.done_ep_return) / max(n_done, 1))

    exp = load_experiment(ckpt, device="cpu")
    draws = iter(_jax_walker_draws(exp.env, seed, B, T))
    monkeypatch.setattr(Walker2dEnv, "sample_reset_noise",
                        lambda self, gen, batch: next(draws))
    with torch.no_grad():
        stats = evaluate_policy(
            exp.env, lambda obs: exp.actor.act(exp.norm, obs,
                                               deterministic=True),
            torch.Generator(), B, T)
    assert int(stats["num_episodes"]) == n_done
    np.testing.assert_allclose(float(stats["ep_return"]), jax_ret,
                               rtol=1e-4, atol=1e-6)


def test_resume_reads_the_nets_normaliser_and_moments(ppo_run):
    """--resume: a fresh state takes the checkpoint's nets, normaliser and
    Adam moments and counts (the leaves before the runner), and the lr."""
    from apex_tpu_torch.agents.ppo import PPO, PPOConfig

    out, _, _ = ppo_run
    ckpt = out / "walker_ppo_seed0_ckpt"
    mod = _script("torch_train_curve")
    env = Walker2dEnv(device="cpu")
    ppo = PPO(env, PPOConfig(num_envs=64, num_steps=2048,
                             max_traj_len=20, minibatch_size=2048))
    state = mod.resume(ppo.init(seed=7), str(ckpt), 3e-4)
    saved = checkpoint._read(str(ckpt))
    ours = checkpoint.to_jax_leaves(state, env)
    n_runner = len(checkpoint._runner(state.runner, env, 7))
    for i, (a, b) in enumerate(zip(ours[:-n_runner - 1],
                                   saved[:-n_runner - 1])):
        if np.shape(a) == () and np.asarray(b).dtype == np.float32 \
                and float(b) == pytest.approx(1e-4):
            # the learning rate of inject_hyperparams, set anew
            assert float(a) == pytest.approx(3e-4), i
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(i))
    assert state.actor_opt.count in (3, 6)      # the best eval's iteration
    assert state.actor_opt.lr == state.critic_opt.lr == 3e-4


# ---------------------------------------------------------------------------
# scripts/torch_train_offpolicy_curve.py and torch_train_recurrent_curve.py
# ---------------------------------------------------------------------------

def _run(name, argv, capsys):
    state = _script(name).main(argv)
    return state, _last_json(capsys.readouterr().out)


def jax_tool_schedule(algo, argv, tmp_path, monkeypatch, **cfg):
    """tools/train_offpolicy_curve.py itself, run with `argv` and its TD3
    configured by `cfg`, writing into tmp_path/curves, with JAX's TD3
    iteration and eval replaced by recorders (no training): the order of
    its acting-snapshot refreshes ("refresh", `_tree_copy` of the actor)
    and iterations (("train", random_actions)), and its npz."""
    import sys

    from apex_tpu.agents import td3 as jax_td3
    from apex_tpu.models.nets import FFActor as JaxFFActor

    events = []
    copy = jax_td3._tree_copy

    def tree_copy(x):
        if isinstance(x, JaxFFActor):
            events.append("refresh")
        return copy(x)

    def train_iter(state, random_actions):
        events.append(("train", bool(random_actions)))
        return state, {"critic_loss": 0.0}

    post_init = jax_td3.TD3.__post_init__

    def recording(self):
        post_init(self)
        self._train_iter = train_iter
        self._eval_iter = lambda state, key: {"ep_return": 0.0}

    monkeypatch.setattr(jax_td3, "_tree_copy", tree_copy)
    monkeypatch.setattr(jax_td3.TD3, "__post_init__", recording)
    monkeypatch.setattr(jax_td3, "TD3Config", functools.partial(
        jax_td3.TD3Config, **cfg))
    monkeypatch.setattr(sys, "argv", ["train_offpolicy_curve.py", algo,
                                      *argv])
    spec = importlib.util.spec_from_file_location(
        "jax_train_offpolicy_curve", ROOT / "tools" /
        "train_offpolicy_curve.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tmp_path.mkdir(exist_ok=True)
    tool.__file__ = str(tmp_path / "tools" / "train_offpolicy_curve.py")
    tool.main()
    with np.load(tmp_path / "curves" / f"{algo}_walker_seed0.npz") as f:
        return events, {k: f[k] for k in f.files}


def port_schedule(monkeypatch):
    """Records the port script's acting-snapshot refreshes and its TD3
    iterations, as `jax_tool_schedule` records the JAX tool's."""
    events = []
    copy, train = td3_mod.copy_params, td3_mod.TD3._train_iteration

    def copy_params(target, source):
        events.append("refresh")
        return copy(target, source)

    def train_iteration(self, state, random_actions):
        events.append(("train", bool(random_actions)))
        return train(self, state, random_actions)

    monkeypatch.setattr(td3_mod, "copy_params", copy_params)
    monkeypatch.setattr(td3_mod.TD3, "_train_iteration", train_iteration)
    return events


# the off-policy runs: (iterations, TD3Config changes, extra argv). The
# async run has a one-iteration warm-up and refreshes its acting snapshot
# every 2nd iteration, so that the schedule shows both switches.
OFFPOLICY_RUNS = {
    "ars": (2, {}, ["--n-itr", "2"]),
    "td3_sync": (2, {}, ["--num-envs", "2", "--timesteps", "320"]),
    "td3_async": (3, dict(start_timesteps=160, load_freq=2),
                  ["--num-envs", "2", "--timesteps", "480"]),
}


@pytest.mark.parametrize("algo", sorted(OFFPOLICY_RUNS))
def test_offpolicy_curve_writes_the_jax_tools_files(algo, tmp_path, capsys,
                                                    monkeypatch):
    """ARS for 2 iterations, td3_sync over 320 steps (2 warm-up
    iterations of 2 envs x 80 steps, 80 updates each) and td3_async over
    480 (a warm-up iteration, then two acting ones, the snapshot refreshed
    every 2nd), on Walker2d, with short episodes, few ARS directions and a
    small replay ring. For TD3 the JAX tool runs with the same arguments
    and configuration (its iterations and evals recorded, not run): the
    port script refreshes its acting snapshot and switches from the
    random warm-up at the same iterations, and its npz has the JAX tool's
    iters and env_steps."""
    n_itr, td3_cfg, extra = OFFPOLICY_RUNS[algo]
    td3_cfg = dict(td3_cfg, max_traj_len=20, replay_size=4096)
    monkeypatch.setattr(ars_mod, "ARSConfig", functools.partial(
        ars_mod.ARSConfig, max_traj_len=20, deltas=8, deltas_used=4))
    monkeypatch.setattr(td3_mod, "TD3Config", functools.partial(
        td3_mod.TD3Config, **td3_cfg))
    argv = ["--eval-every", "1"] + extra
    tds = algo.startswith("td3")
    if tds:
        want, jax_npz = jax_tool_schedule(algo, argv, tmp_path / "jax",
                                          monkeypatch, **td3_cfg)
        capsys.readouterr()
        events = port_schedule(monkeypatch)
    state, summary = _run("torch_train_offpolicy_curve",
                          [algo, "--device", "cpu", "--out", str(tmp_path),
                           *argv], capsys)
    keys = jax_tool_keys("train_offpolicy_curve")
    assert set(summary) == keys["summary"] | {"card"}
    with np.load(tmp_path / f"{algo}_walker_seed0.npz") as f:
        assert set(f.files) == keys["npz"]
        np.testing.assert_array_equal(f["iters"], np.arange(n_itr))
        assert np.all(np.isfinite(f["eval_return"]))
        assert (str(f["algo"]), str(f["env"]), int(f["seed"])) == (
            algo, "Walker2d", 0)
        if tds:
            for k in ("iters", "env_steps"):
                np.testing.assert_array_equal(f[k], jax_npz[k])
    if tds:
        assert events == want
        assert summary["total_env_steps"] == 160 * n_itr
        assert (tmp_path / f"{algo}_walker_seed0_ckpt"
                / "checkpoint.pkl").is_file()
    if algo == "td3_async":
        assert want == ["refresh", ("train", True), ("train", False),
                        "refresh", ("train", False)]
        assert state.update_count == 80 * n_itr


def test_recurrent_curve_writes_the_jax_tools_files(tmp_path, capsys):
    """One iteration of recurrent PPO on Walker2d (64 envs, chunks of 8,
    episodes of 10 steps); its checkpoint reads back into the port's
    recurrent state."""
    from apex_tpu_torch.agents.ppo import PPOConfig
    from apex_tpu_torch.agents.ppo_recurrent import RecurrentPPO

    state, summary = _run("torch_train_recurrent_curve", [
        "walker", "--device", "cpu", "--out", str(tmp_path), "--n-itr",
        "1", "--num-envs", "64", "--chunk-len", "8", "--minibatch-envs",
        "16", "--max-traj-len", "10"], capsys)
    keys = jax_tool_keys("train_recurrent_curve")
    assert set(summary) == keys["summary"] | {"card"}
    with np.load(tmp_path / "recurrent_ppo_walker_seed0.npz") as f:
        assert set(f.files) == keys["npz"]
        np.testing.assert_array_equal(f["iters"], [0])
        assert np.all(np.isfinite(f["eval_return"]))
    ckpt = tmp_path / "recurrent_ppo_walker_seed0_ckpt"
    with open(ckpt / "experiment.pkl", "rb") as f:
        assert set(pickle.load(f)) == keys["pkl"]
    agent = RecurrentPPO(Walker2dEnv(device="cpu"),
                         PPOConfig(num_envs=64, num_steps=512,
                                   max_traj_len=10, minibatch_size=16))
    back = checkpoint.load_recurrent_ppo(str(ckpt), agent)
    for a, b in zip(back.actor.parameters(), state.actor.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the boundaries of the port hold for the scripts too
# ---------------------------------------------------------------------------

SCRIPTS = ("torch_train_curve", "torch_train_offpolicy_curve",
           "torch_train_recurrent_curve", "curve_band", "torch_eval_td3",
           "s4_bisect")


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_imports_nothing_of_jax(name):
    tree = ast.parse((ROOT / "scripts" / f"{name}.py").read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in mods if m.split(".")[0] in
           ("jax", "jaxlib", "flax", "optax", "apex_tpu")]
    assert not bad, bad


@pytest.mark.parametrize("name,argv", [
    ("torch_train_curve", ["walker"]),
    ("torch_train_offpolicy_curve", ["ars"]),
    ("torch_train_recurrent_curve", ["walker"])])
def test_script_runs_on_the_card_unless_told(name, argv, tmp_path,
                                             monkeypatch):
    """Without CUDA a script raises before it trains, unless --device cpu
    is given (the other tests)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _script(name).main([*argv, "--out", str(tmp_path)])
    assert not list(tmp_path.glob("*.npz"))


def test_curve_band_decides_by_the_rule():
    """scripts/curve_band.py: the centred 5-point mean (fewer at the ends),
    the band max(w, 0.25 mean) around the seeds, and the growth check."""
    cb = _script("curve_band")
    np.testing.assert_allclose(cb.smoothed([1, 2, 3, 4, 5, 6]),
                               [2, 2.5, 3, 4, 4.5, 5])
    iters = np.arange(0, 1001, 10)
    curve = lambda scale: {"iters": iters,
                           "eval_return": 10 + scale * iters / 100.0}
    ref = curve(3.0)
    held = cb.decide(ref, [curve(2.8), curve(3.1), curve(3.3)],
                     [300, 500, 750, 1000])
    assert held["held"] and held["first_point_outside"] is None
    low = cb.decide(ref, [curve(1.0), curve(1.1), curve(1.2)],
                    [300, 500, 750, 1000])
    assert not low["held"]
    assert low["first_point_outside"]["iter"] == 300
    # band at 300: seeds 13.0-13.6, h = 0.25 x 13.3, JAX's 19 above it
    np.testing.assert_allclose(low["first_point_outside"]["outside_by"],
                               19.0 - (13.6 + 0.25 * 13.3), rtol=1e-9)
