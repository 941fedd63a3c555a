"""The port's tool scripts (`scripts/torch_<tool>.py`) against the JAX
package's tools (`tools/<tool>.py`), on the CPU at a small size.

The JAX tools are imported from their files and run as they are, with the
run directory's loading replaced by small envs (3 substeps per policy
step) and a linear policy obs @ W (W drawn with numpy), the same in both
stacks; where a tool's logic sits inside its main() it is rebuilt from the
JAX package (`scripts/export_tool_draws.py estimator_eval` is the estimator
tool's evaluation). The port is handed JAX's draws (`chip_smoke.jax_draws`
for a rollout, `chip_smoke.file_draws` for the analysis jobs and the
estimator evaluation). What is compared:

  * megakernel_divergence: JAX's fleet mode and the port's three tiers on
    JAX's draws; returns within the reward bounds of
    tests/test_torch_analysis.py (TOL's (5e-2, 2e-2) per step over
    T_CLOSE = 3 steps), the port's tiers within the 1.8 % bound of each
    other, the closing JSON line with the JAX tool's keys;
  * estimator_divergence: the rows "exact" and "firmware tau=12ms"
    within the same bounds, and equal in both stacks (ROADMAP limit (k):
    they are one configuration); every row on JAX's draws, the estimator
    noise among them, replayed bit for bit (`file_draws`);
  * mirror_policy_check: mirror_err on the same observations within rtol
    1e-5 of the JAX tool's;
  * vis_perturb, vis_input_and_state and aslip_tests: the JAX tool and the
    port's script around the same stand-in job (the arguments each hands
    the job, the printed lines, the npz files); the jobs themselves are
    held to JAX's in tests/test_torch_analysis.py; and each script run for
    real on JAX's draws, its files in the JAX jobs' keys;
  * an aslip run loads without its gait library in the JAX tool and the
    port alike, and with it under the port's keep_traj (limit (l));
  * make_mission: build_mission bit for bit at three waypoint sets, the
    file read back through the port's mission loader;
  * plot_policy: the same figure as the JAX tool's from the same record;
  * render_gait: the frames' body origins within 1e-5 m of the JAX
    package's engine.forward_kinematics;
  * no script imports jax, apex_tpu or tools/, and each that computes on
    a device runs on the card unless --device cpu is given.
"""
import ast
import contextlib
import functools
import importlib.util
import io
import pathlib
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.envs.cassie import CassieEnv as JaxCassieEnv
from apex_tpu.envs.cassie_traj import CassieTrajEnv as JaxCassieTrajEnv
from apex_tpu_torch.envs import cassie as port_cassie
from apex_tpu_torch.envs import trajectory as port_trajectory
from apex_tpu_torch.envs.cassie_traj import CassieTrajEnv
from apex_tpu_torch.runtime import analysis
from apex_tpu_torch.runtime import evaluate
from apex_tpu_torch.runtime.evaluate import Experiment, load_experiment
from test_torch_switches import reset_draws, step_draws
from test_torch_traj import traj_reset_draws, traj_step_draws

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "curves" / "cassie_mk4_hardened_ckpt")
SIMRATE = 3
T_CLOSE = 3                  # policy steps of a rollout held to JAX's
RTOL, ATOL = 5e-2, 2e-2      # TOL's reward bound per step
EVAL_BOUND = 0.018           # the JAX package's bound between its tiers
# the seven scripts that compute on a device, and a minimal argv of each
DEVICE_SCRIPTS = {
    "torch_megakernel_divergence": ["x"],
    "torch_estimator_divergence": ["x"],
    "torch_mirror_policy_check": ["x"],
    "torch_vis_perturb": ["x"],
    "torch_vis_input_and_state": ["x"],
    "torch_aslip_tests": ["grf", "x"],
    "torch_render_gait": ["x.npz"],
}
# the two host jobs on numpy, which use no device
HOST_SCRIPTS = ("torch_make_mission", "torch_plot_policy")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run side by side in several worker processes: one
    torch thread each keeps them from oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = lambda name: _module(ROOT / "tools" / f"{name}.py", f"jax_{name}")
script = lambda name: _module(ROOT / "scripts" / f"{name}.py", name)


def run(main, argv=None, monkeypatch=None):
    """main(argv) (a JAX tool's main() reads sys.argv: pass monkeypatch),
    with its stdout: (result, lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if monkeypatch is None:
            result = main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["tool", *argv])
            result = main()
    return result, buf.getvalue().splitlines()


def linear_policy(obs_size: int, act_size: int, scale: float = 0.01):
    """obs @ W in both stacks: (JAX actor, port actor) with the checkpoint
    actor's act(norm, obs, deterministic) signature."""
    W = (scale * np.random.default_rng(3).normal(
        size=(obs_size, act_size))).astype(np.float32)
    Wj, Wt = jnp.asarray(W), torch.tensor(W)
    return (SimpleNamespace(act=lambda norm, obs, deterministic=True:
                            obs @ Wj),
            SimpleNamespace(act=lambda norm, obs, deterministic=True:
                            obs @ Wt))


def port_experiment(env, actor, **args):
    return Experiment(env=env, actor=actor, critic=None, norm=None,
                      args=SimpleNamespace(**args))


def close(a, b, steps=T_CLOSE):
    """|a - b| within TOL's reward bound summed over `steps` steps."""
    return abs(a - b) <= steps * ATOL + RTOL * abs(b)


def dict_keys_of(path: pathlib.Path, func: str = None, target: str = None):
    """The keys of the dict literals a function returns (func), or of the
    dict literal assigned to `target`, in a source file."""
    tree = ast.parse(path.read_text())
    keys = []
    for node in ast.walk(tree):
        if func and isinstance(node, ast.FunctionDef) and node.name == func:
            keys += [{k.value for k in r.value.keys}
                     for r in ast.walk(node) if isinstance(r, ast.Return)
                     and isinstance(r.value, ast.Dict)]
        if (target and isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Dict)
                and ast.unparse(node.targets[0]) == target):
            keys.append({k.value for k in node.value.keys})
    assert keys and all(k == keys[0] for k in keys), (func, target, keys)
    return keys[0]


# ---------------------------------------------------------------------------
# megakernel_divergence: the three tiers, and JAX's fleet mode
# ---------------------------------------------------------------------------

def test_megakernel_divergence_matches_jax(tmp_path, monkeypatch):
    """JAX's run_mode (fleet, its variables restored after) and the port's
    three tiers on JAX's draws (4 envs, 3 steps, seed 42, the main path's
    env at 3 substeps)."""
    B, T = 4, T_CLOSE
    jenv = JaxCassieEnv(simrate=SIMRATE)
    jact, pact = linear_policy(jenv.observation_size, jenv.action_size)
    for var in ("APEX_TPU_NO_MEGAKERNEL", "APEX_TPU_NO_FLEET",
                "APEX_TPU_FORCE_MEGAKERNEL"):
        monkeypatch.setenv(var, "0")
    monkeypatch.setattr(
        "apex_tpu.runtime.evaluate.load_experiment",
        lambda path: (SimpleNamespace(env=jenv),
                      SimpleNamespace(actor=jact, norm=None), None))
    jres = tool("megakernel_divergence").run_mode("x", "fleet", B, T)

    exporter = script("export_eval_draws")
    draws = exporter.eval_draws(jenv, np.ones((T, B), bool), 42)
    draws.update(jax_return=np.float64(jres["return"]))
    path = tmp_path / "draws.npz"
    np.savez(path, **draws)
    monkeypatch.setattr(evaluate, "load_experiment", lambda p, device=None,
                        physics=None: port_experiment(
                            port_cassie.CassieEnv(device=device,
                                                  simrate=SIMRATE,
                                                  pd_tier=physics), pact))
    (res, _), lines = run(script("torch_megakernel_divergence").main, [
        "x", "--envs", str(B), "--steps", str(T), "--device", "cpu",
        "--jax_draws", str(path)])

    assert set(res) == dict_keys_of(ROOT / "tools" /
                                    "megakernel_divergence.py",
                                    target="result")
    out = res["results"]
    for mode in ("megakernel", "fleet", "per-env"):
        assert f"{mode:11s}: {out[mode]}" in lines
        assert out[mode]["episodes"] == jres["episodes"] == B
        assert out[mode]["ep_len"] == jres["ep_len"] == T
        assert close(out[mode]["return"], jres["return"]), (mode, out, jres)
    base = out["megakernel"]["return"]
    for mode, delta in res["return_rel_delta_vs_megakernel"].items():
        assert delta == round(abs(out[mode]["return"] - base) / abs(base), 4)
        assert delta <= EVAL_BOUND, (mode, out)
    assert abs(out["fleet"]["return"] - out["per-env"]["return"]) <= \
        EVAL_BOUND * abs(out["fleet"]["return"])


# ---------------------------------------------------------------------------
# estimator_divergence
# ---------------------------------------------------------------------------

def test_estimator_divergence_matches_jax(tmp_path, monkeypatch):
    """The JAX tool's rows "exact" and "firmware tau=12ms" (its
    evaluation, rebuilt) and the port's script on JAX's draws (2 episodes,
    3 steps): "exact" is "firmware tau=12ms" in both stacks, one
    configuration (limit (k)) and one return; the other rows are other
    configurations, each run by the port on the same draws (the estimator
    noise's replay is held bit for bit in
    test_file_draws_replays_jax_key_splits)."""
    E, T = 2, T_CLOSE
    exporter = script("export_tool_draws")
    tree = ast.parse((ROOT / "tools" / "estimator_divergence.py")
                     .read_text())
    jax_rows = next(ast.literal_eval(n.iter) for n in ast.walk(tree)
                    if isinstance(n, ast.For)
                    and isinstance(n.iter, ast.List))
    port = script("torch_estimator_divergence")
    assert port.ROWS == jax_rows == exporter.ROWS

    base = dict(dynamics_randomization=False, reward="early_clock",
                simrate=SIMRATE)
    jenvs = [JaxCassieEnv(**base, **kw) for _, kw in jax_rows]
    penvs = [port_cassie.CassieEnv(device="cpu", **base, **kw)
             for _, kw in jax_rows]
    assert jenvs[0] == jenvs[1] and jenvs[0].estimator == "firmware"
    assert penvs[0] == penvs[1] and penvs[0].estimator == "firmware"
    for i in (2, 3, 4):
        assert jenvs[i] != jenvs[0] and penvs[i] != penvs[0]

    jact, pact = linear_policy(jenvs[0].observation_size,
                               jenvs[0].action_size, scale=0.1)
    jpol = lambda obs: jact.act(None, obs)
    jret = {i: exporter.estimator_eval(jenvs[i], jpol, E, T)
            for i in (0, 1)}
    path = tmp_path / "est.npz"
    np.savez(path, **exporter.call_draws(jenvs[0], exporter.EST_SEED, E, T,
                                         "c0_", est_noise=True))

    monkeypatch.setattr(port_cassie, "CassieEnv", functools.partial(
        port_cassie.CassieEnv, simrate=SIMRATE))
    monkeypatch.setattr(evaluate, "load_experiment",
                        lambda p, device=None: port_experiment(
                            None, pact, reward="early_clock"))
    (out, raw), lines = run(port.main, [
        "x", "--episodes", str(E), "--steps", str(T), "--device", "cpu",
        "--jax_draws", str(path)])

    assert [r["estimator"] for r in out] == [label for label, _ in jax_rows]
    row_keys = {"estimator", "eval_return", "eval_len"}
    for i, r in enumerate(out):
        assert set(r) == (row_keys if i == 0
                          else row_keys | {"return_delta_pct"})
        assert f"{r['estimator']:24s} return {raw[i]:8.2f}  len " \
               f"{r['eval_len']:6.1f}" in lines
    for i, (ret, length) in jret.items():
        assert close(raw[i], ret), (i, raw[i], ret)
        assert out[i]["eval_len"] == round(length, 1)
    assert raw[0] == raw[1] and jret[0] == jret[1]
    assert out[1]["return_delta_pct"] == 0.0


# ---------------------------------------------------------------------------
# mirror_policy_check
# ---------------------------------------------------------------------------

def test_mirror_err_matches_jax_on_the_same_observations():
    """mk4_hardened in both stacks; the port's rollout observations (16
    envs, 2 steps) through the port's mirror_err and the JAX tool's."""
    from apex_tpu.envs.base import mirror_clock as jax_mirror_clock
    from apex_tpu.envs.base import mirror_matrix as jax_mirror_matrix
    from apex_tpu.runtime.evaluate import load_experiment as jax_load

    port = script("torch_mirror_policy_check")
    exp = load_experiment(CKPT, device="cpu")
    obs = port.rollout_obs(exp, 2)
    assert tuple(obs.shape) == (2 * port.N_ENVS, exp.env.observation_size)
    err = port.mirror_err(exp, obs)

    ppo, state, _ = jax_load(CKPT)
    env = ppo.env
    M_obs = jnp.asarray(jax_mirror_matrix(env.mirrored_obs))
    M_act = jnp.asarray(jax_mirror_matrix(env.mirrored_acts))

    @jax.jit
    def mirror_err(obs):     # tools/mirror_policy_check.py:42-49
        a = state.actor.act(state.norm, obs, deterministic=True)
        mo = obs @ M_obs
        if env.clock_inds:
            mo = jax_mirror_clock(mo, env.clock_inds)
        am = state.actor.act(state.norm, mo, deterministic=True) @ M_act
        return jnp.linalg.norm(a - am, axis=-1)

    jerr = np.asarray(mirror_err(jnp.asarray(obs.numpy())))
    assert env.clock_inds == exp.env.clock_inds
    np.testing.assert_allclose(err, jerr, rtol=1e-5, atol=1e-7)
    assert err.max() > 0.01        # the policy is not symmetric by accident

    _, lines = run(port.main, [CKPT, "--steps", "1", "--device", "cpu"])
    assert lines[-1].startswith(
        f"mirror consistency over {port.N_ENVS} states: mean ")


# ---------------------------------------------------------------------------
# the analysis tools: the same stand-in job around both stacks' tools
# ---------------------------------------------------------------------------

def _stand_in(monkeypatch, name, result, calls=None):
    """Replace analysis job `name` in both stacks by one returning
    `result`; returns the list (`calls`, or a new one) it appends each
    call's (stack, positional arguments, keyword arguments) to."""
    calls = [] if calls is None else calls

    def make(stack):
        def job(env, policy_fn, *args, **kw):
            if stack == "port":
                assert kw.pop("draws") is None

            calls.append((stack, args, kw))
            return result() if callable(result) else result
        return job
    monkeypatch.setattr(f"apex_tpu.runtime.analysis.{name}", make("jax"))
    monkeypatch.setattr(analysis, name, make("port"))
    return calls


def _stand_in_load(monkeypatch):
    monkeypatch.setattr(
        "apex_tpu.runtime.evaluate.load_experiment",
        lambda path: (SimpleNamespace(env="env"),
                      SimpleNamespace(actor=None, norm=None), None))
    monkeypatch.setattr(evaluate, "load_experiment",
                        lambda path, device=None, keep_traj=False:
                        port_experiment("env", None))


def _same_calls(calls):
    """The JAX tool's calls of a job and the port's, in order: the same
    positional and keyword arguments."""
    jax_calls = [c[1:] for c in calls if c[0] == "jax"]
    port_calls = [c[1:] for c in calls if c[0] == "port"]
    assert jax_calls and len(jax_calls) == len(port_calls)
    for (a1, k1), (a2, k2) in zip(jax_calls, port_calls):
        assert len(a1) == len(a2) and sorted(k1) == sorted(k2)
        for x, y in zip((*a1, *k1.values()), (*a2, *(k2[k] for k in k1))):
            np.testing.assert_array_equal(x, y)


def _same_npz(a, b):
    with np.load(a) as f, np.load(b) as g:
        assert sorted(f.files) == sorted(g.files)
        for k in f.files:
            np.testing.assert_array_equal(f[k], g[k])


def _without_paths(lines, *paths):
    out = []
    for line in lines:
        for p in paths:
            line = line.replace(str(p), "<out>")
        out.append(line)
    return out


def test_vis_perturb_tool_logic_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    res = dict(angles=np.linspace(0, 2 * np.pi, 3, endpoint=False),
               phases=np.asarray([0, 8]), force=120.0,
               pelvis=rng.normal(size=(3, 2, 6, 7)),
               fallen_seq=rng.random((3, 2, 6)) < 0.3,
               survived=np.asarray([[True, False], [False, True],
                                    [True, True]]),
               push_window=(2, 4))
    calls = _stand_in(monkeypatch, "perturb_response", res)
    _stand_in_load(monkeypatch)
    argv = ["x", "--force", "120", "--angles", "3", "--phases", "0,8",
            "--speed", "0.7"]
    _, jl = run(tool("vis_perturb").main,
                argv + ["--out", str(tmp_path / "j.png")], monkeypatch)
    _, pl = run(script("torch_vis_perturb").main,
                argv + ["--out", str(tmp_path / "p.png"), "--device", "cpu"])
    _same_calls(calls)
    assert _without_paths(jl, tmp_path / "j.png") == \
        _without_paths(pl, tmp_path / "p.png")
    assert "FALL" in "".join(pl) and "pass" in "".join(pl)
    _same_npz(tmp_path / "j.npz", tmp_path / "p.npz")


def test_vis_input_and_state_tool_logic_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    T = 7
    fallen = np.zeros(T, bool)
    fallen[4:] = True
    rec = dict(qpos=rng.normal(size=(T, 35)), reward=rng.random(T),
               fallen=fallen, est_lfoot=rng.normal(size=(T, 3)),
               est_rfoot=rng.normal(size=(T, 3)),
               true_lfoot=rng.normal(size=(T, 3)),
               true_rfoot=rng.normal(size=(T, 3)),
               est_lfoot_err=np.float32(0.25), est_rfoot_err=np.float32(1e-3))
    calls = _stand_in(monkeypatch, "input_and_state_record", rec)
    _stand_in_load(monkeypatch)
    argv = ["x", "--speed", "1.5", "--steps", str(T)]
    _, jl = run(tool("vis_input_and_state").main,
                argv + ["--out", str(tmp_path / "j.png")], monkeypatch)
    _, pl = run(script("torch_vis_input_and_state").main,
                argv + ["--out", str(tmp_path / "p.png"), "--device", "cpu"])
    _same_calls(calls)
    assert _without_paths(jl, tmp_path / "j.png") == \
        _without_paths(pl, tmp_path / "p.png")
    assert "fell at step 4" in pl
    _same_npz(tmp_path / "j.npz", tmp_path / "p.npz")


@pytest.mark.parametrize("argv,aslip", [
    (["grf", "x", "--speed", "1.2", "--cycles", "2"], True),
    (["grf", "x", "--speed", "1.2"], False),
    (["footplace", "x", "--traj-idx", "7", "--steps", "3", "--trials", "2"],
     True),
    (["footplace", "x", "--steps", "3"], True),
    (["footplace", "x"], False),
    (["taskspace", "x", "--speeds", "0,5,20"], True),
    (["taskspace", "x"], False),
])
def test_aslip_tests_tool_logic_matches_jax(argv, aslip, tmp_path,
                                            monkeypatch):
    """Each subcommand around stand-in jobs; a run that is not aslip stops
    at footplace and taskspace in both (the JAX tool's load drops --traj:
    limit (l))."""
    rng = np.random.default_rng(7)
    calls = _stand_in(monkeypatch, "grf_profile", dict(
        mean=rng.random((12, 2)) * 300, std=rng.random((12, 2)),
        cycles_used=4, cycle_steps=2))
    _stand_in(monkeypatch, "foot_placement_error", lambda: dict(
        errors=np.asarray([0.1, 0.2]), mean_error=0.15, std_error=0.05,
        n_footsteps=2), calls)
    _stand_in(monkeypatch, "taskspace_tracking", [
        dict(traj_idx=t, speed=round(0.1 * t, 2), survived=t != 5,
             lfoot_rms=0.01 * t, rfoot_rms=0.02) for t in (0, 5, 20)], calls)
    env = SimpleNamespace(aslip=aslip, num_speeds=3)
    jtool, port = tool("aslip_tests"), script("torch_aslip_tests")
    monkeypatch.setattr(jtool, "_load", lambda run_dir: (env, None))
    monkeypatch.setattr(port, "_load", lambda args: (env, None, None))
    out = {"grf": ".png", "taskspace": ".npz"}.get(argv[0])
    outs = [[] if out is None else ["--out", str(tmp_path / f"{s}{out}")]
            for s in "jp"]
    if not aslip and argv[0] != "grf":
        for main, mp in ((jtool.main, monkeypatch), (port.main, None)):
            with pytest.raises(AssertionError, match="requires an aslip"):
                run(main, argv, mp)
        return
    _, jl = run(jtool.main, argv + outs[0], monkeypatch)
    _, pl = run(port.main, argv + outs[1] + ["--device", "cpu"])
    _same_calls(calls)
    assert _without_paths(jl, tmp_path / "j") == \
        _without_paths(pl, tmp_path / "p")
    if out:
        _same_npz(tmp_path / "j.npz", tmp_path / "p.npz")


def test_file_draws_replays_jax_key_splits(tmp_path):
    """`chip_smoke.file_draws` hands a job, call for call, JAX's draws of
    that call (trial i: split(split(PRNGKey(seed), n)[i]), steps from
    split(...[1], n_steps)), bit for bit: CassieEnv with the estimator
    noise and the heading curriculum, and the aslip CassieTrajEnv."""
    from chip_smoke import file_draws

    exporter = script("export_tool_draws")
    cfg = dict(simrate=SIMRATE, estimator_noise=0.02, orient_jump_prob=0.1)
    aslip = dict(simrate=SIMRATE, traj="aslip", dynamics_randomization=False)
    for jenv, penv, reset_fn, step_fn in (
            (JaxCassieEnv(**cfg), port_cassie.CassieEnv(device="cpu", **cfg),
             reset_draws, step_draws),
            (JaxCassieTrajEnv(**aslip), CassieTrajEnv(device="cpu", **aslip),
             traj_reset_draws, traj_step_draws)):
        seed, n, steps = 3, 2, 4
        path = tmp_path / "calls.npz"
        np.savez(path, **exporter.call_draws(jenv, seed, n, steps, "c0_"))
        draws = file_draws(str(path), penv)
        keys = jax.random.split(jax.random.PRNGKey(seed), n)
        pair = jax.vmap(jax.random.split)(keys)
        skeys = jax.vmap(lambda k: jax.random.split(k, steps))(pair[:, 1])
        reset, step_list = draws(seed, n, steps)
        want = [(reset, reset_fn(jenv, pair[:, 0]))] + [
            (s, step_fn(jenv, skeys[:, t])) for t, s in enumerate(step_list)]
        for got, ref in want:
            for name in ref._fields:
                r = getattr(ref, name)
                if r is not None:
                    g = getattr(got, name)
                    assert torch.equal(g, r.to(g.dtype)), name
        with pytest.raises(KeyError, match="holds no draws"):
            draws(1, 2, 4)


def _small_env_load(monkeypatch, env):
    """The port's run loading replaced by `env` and a linear policy."""
    _, pact = linear_policy(env.observation_size, env.action_size)
    monkeypatch.setattr(evaluate, "load_experiment",
                        lambda path, device=None, keep_traj=False:
                        port_experiment(env, pact))


def test_analysis_scripts_run_on_jax_draws(tmp_path, monkeypatch):
    """vis_perturb, vis_input_and_state and aslip_tests grf for real on the
    CPU at 3 substeps, each on a file of JAX's draws for its calls (a call
    the file lacks raises); their files carry the keys of the JAX jobs'
    results (read from apex_tpu/runtime/analysis.py) and finite values.
    The figures are left out (no matplotlib): the plot tests draw them."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    exporter = script("export_tool_draws")
    jax_src = ROOT / "apex_tpu" / "runtime" / "analysis.py"
    cfg = dict(simrate=SIMRATE, dynamics_randomization=False)
    jenv = JaxCassieEnv(**cfg)
    _small_env_load(monkeypatch, port_cassie.CassieEnv(device="cpu", **cfg))
    path = tmp_path / "cassie.npz"
    np.savez(path, **exporter.call_draws(jenv, 0, 2, 208, "c0_"),
             **exporter.call_draws(jenv, 0, 1, 4, "c1_"))

    _, lines = run(script("torch_vis_perturb").main, [
        "x", "--angles", "2", "--out", str(tmp_path / "vp.png"),
        "--device", "cpu", "--jax_draws", str(path)])
    assert lines[0] == "force 170 N, speed 0.5 m/s"
    assert lines[-1].startswith("(plot skipped: ")
    with np.load(tmp_path / "vp.npz") as f:
        assert set(f.files) == dict_keys_of(jax_src, "perturb_response")
        assert f["pelvis"].shape == (2, 1, 208, 7)
        assert np.isfinite(f["pelvis"]).all()
    vis_state = script("torch_vis_input_and_state").main
    run(vis_state, ["x", "--steps", "4", "--out", str(tmp_path / "vs.png"),
                    "--device", "cpu", "--jax_draws", str(path)])
    with np.load(tmp_path / "vs.npz") as f:
        assert set(f.files) == dict_keys_of(jax_src,
                                            "input_and_state_record")
        assert f["qpos"].shape == (4, 35) and np.isfinite(f["qpos"]).all()
    with pytest.raises(KeyError, match="holds no draws"):
        run(vis_state, ["x", "--steps", "5", "--out",
                        str(tmp_path / "vs.png"), "--device", "cpu",
                        "--jax_draws", str(path)])

    acfg = dict(simrate=SIMRATE, traj="aslip", dynamics_randomization=False)
    aenv = CassieTrajEnv(device="cpu", **acfg)
    _small_env_load(monkeypatch, aenv)
    cycle = int(aenv._traj_len[12])
    jaenv = JaxCassieTrajEnv(**acfg)
    apath = tmp_path / "aslip.npz"
    np.savez(apath, **{k: v for i, seed in enumerate((0, 10, 20))
                       for k, v in exporter.call_draws(
                           jaenv, seed, 1, (3 + 1) * cycle,
                           f"c{i}_").items()})
    _, lines = run(script("torch_aslip_tests").main, [
        "grf", "x", "--cycles", "1", "--speed", "1.2", "--out",
        str(tmp_path / "grf.png"), "--device", "cpu", "--jax_draws",
        str(apath)])
    assert lines[0].startswith("cycles used: ")
    with np.load(tmp_path / "grf.npz") as f:
        assert set(f.files) == dict_keys_of(jax_src, "grf_profile")
        assert f["mean"].shape == (cycle * SIMRATE, 2)
        assert np.isfinite(f["mean"]).all()


# ---------------------------------------------------------------------------
# make_mission, plot_policy, render_gait
# ---------------------------------------------------------------------------

WAYPOINTS = ["0,0 5,0 5,5 10,5", "0,0 0,0 3,4", "1,2 -2,-1 4,-3 4,-3 0,9"]


@pytest.mark.parametrize("waypoints", WAYPOINTS)
def test_build_mission_bit_for_bit(waypoints, tmp_path, monkeypatch):
    """build_mission bit for bit the JAX tool's, and the file read back
    through the port's mission loader."""
    jtool, port = tool("make_mission"), script("torch_make_mission")
    pts = np.array([[float(v) for v in w.split(",")]
                    for w in waypoints.split()])
    for speed, hz in ((1.4, 30.0), (0.55, 40.0)):
        for a, b in zip(jtool.build_mission(pts, speed, hz),
                        port.build_mission(pts, speed, hz)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    monkeypatch.setattr(jtool, "OUT_DIR", str(tmp_path / "jax"))
    (tmp_path / "jax").mkdir()
    argv = ["--name", "t", "--speed", "1.4", "--waypoints", waypoints]
    _, jl = run(jtool.main, argv, monkeypatch)
    out, pl = run(port.main, argv + ["--out", str(tmp_path)])
    assert _without_paths(jl, tmp_path / "jax") == \
        _without_paths(pl, tmp_path)
    _same_npz(tmp_path / "jax" / "mission_t.npz", out)
    assert pathlib.Path(port.OUT_DIR).resolve() == \
        port_trajectory.DATA_DIR == ROOT / "apex_tpu_torch" / "data"
    monkeypatch.setattr(port_trajectory, "DATA_DIR", tmp_path)
    mission = port_trajectory.CommandTrajectory("t")
    compos, speed, orient = port.build_mission(pts, 1.4)
    np.testing.assert_array_equal(mission.global_pos, compos)
    np.testing.assert_array_equal(mission.speed_cmd, speed)
    np.testing.assert_array_equal(mission.orient, orient)


def _record(T=12):
    rng = np.random.default_rng(0)
    return dict(pd_target=rng.normal(0, 0.1, (T, 10)),
                motor_pos=rng.normal(0, 0.1, (T, 10)),
                motor_vel=np.zeros((T, 10)),
                torque=rng.normal(0, 10, (T, 10)),
                grf=np.abs(rng.normal(0, 100, (T, 2))),
                foot_pos=rng.normal(0, 0.2, (T, 2, 3)),
                qpos=rng.normal(0, 0.2, (T, 35)), reward=rng.random(T),
                speed=np.asarray(1.0))


def _dump(T=12, B=3):
    rng = np.random.default_rng(1)
    term = np.zeros((T, B), bool)
    term[5, 1] = True
    return dict(obs=rng.normal(size=(T, B, 50)).astype(np.float32),
                action=rng.normal(size=(T, B, 10)).astype(np.float32),
                reward=rng.random((T, B)).astype(np.float32),
                terminated=term)


@pytest.mark.parametrize("kind", ["record", "dump"])
def test_plot_policy_draws_the_jax_tools_figure(kind, tmp_path, monkeypatch):
    """The same record (record_policy's schema) or fleet dump (eval --out)
    gives the JAX tool's figure, pixel for pixel; without matplotlib the
    script prints that it skipped the plot."""
    import matplotlib.image as mpimg

    data = _record() if kind == "record" else _dump()
    src = tmp_path / "in.npz"
    np.savez(src, **data)
    argv = [str(src), "--env", "1"]
    _, jl = run(tool("plot_policy").main,
                argv + ["--out", str(tmp_path / "j.png")], monkeypatch)
    port = script("torch_plot_policy")
    out, pl = run(port.main, argv + ["--out", str(tmp_path / "p.png")])
    assert _without_paths(jl, tmp_path / "j.png") == \
        _without_paths(pl, tmp_path / "p.png")
    np.testing.assert_array_equal(mpimg.imread(tmp_path / "j.png"),
                                  mpimg.imread(tmp_path / "p.png"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out, pl = run(port.main, argv + ["--out", str(tmp_path / "q.png")])
    assert out is None and pl[-1].startswith("(plot skipped: ")
    assert not (tmp_path / "q.png").exists()


def test_render_gait_positions_match_jax_forward_kinematics(tmp_path,
                                                             monkeypatch):
    """The frames' body origins (K2's plain version on the CPU) within 1e-5
    m of the JAX tool's vmapped engine.forward_kinematics plus origin, on
    the qpos of a perturbed standing gait; the figure with matplotlib, the
    skip line without."""
    from apex_tpu.physics.cassie_sim import cassie_model as jax_cassie_model
    from apex_tpu.physics.engine import PhysParams as JaxPhysParams
    from apex_tpu.physics.engine import forward_kinematics
    from apex_tpu_torch.physics.cassie_sim import CASSIE_QPOS_INIT

    rng = np.random.default_rng(2)
    T, F = 30, 8
    qpos = np.tile(np.asarray(CASSIE_QPOS_INIT, np.float32), (T, 1))
    qpos[:, :3] += rng.normal(0, 0.3, (T, 3)).astype(np.float32)
    qpos[:, 7:] += rng.normal(0, 0.2, (T, 28)).astype(np.float32)
    q = qpos[:, 3:7] + rng.normal(0, 0.1, (T, 4)).astype(np.float32)
    qpos[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    port = script("torch_render_gait")
    idx, xpos, edges = port.frame_positions(qpos, F, torch.device("cpu"))

    m = jax_cassie_model()
    params = JaxPhysParams.from_model(m)
    fk = jax.jit(jax.vmap(lambda q: forward_kinematics(m, params, q)))
    want_idx = np.linspace(0, len(qpos) - 1, F).astype(int)
    kin = fk(jnp.asarray(qpos[want_idx]))
    want = np.asarray(kin.xpos) + np.asarray(kin.origin)[:, None, :]
    np.testing.assert_array_equal(idx, want_idx)
    assert xpos.shape == want.shape == (F, m.nbody, 3)
    np.testing.assert_allclose(xpos, want, rtol=0, atol=1e-5)
    assert edges == [(i, int(p)) for i, p in enumerate(m.body_parent)
                     if p >= 0]

    gait = tmp_path / "gait.npz"
    np.savez(gait, qpos=qpos)
    _, lines = run(port.main, [str(gait), "--out", str(tmp_path / "g.png"),
                               "--frames", str(F), "--device", "cpu"])
    assert lines == [f"wrote {tmp_path / 'g.png'}"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    _, lines = run(port.main, [str(gait), "--out", str(tmp_path / "h.png"),
                               "--device", "cpu"])
    assert lines[-1].startswith("(plot skipped: ")


# ---------------------------------------------------------------------------
# the boundaries of the port hold for the scripts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [*DEVICE_SCRIPTS, *HOST_SCRIPTS])
def test_script_imports_nothing_of_jax_or_the_tools(name):
    tree = ast.parse((ROOT / "scripts" / f"{name}.py").read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in mods if m.split(".")[0] in
           ("jax", "jaxlib", "flax", "optax", "apex_tpu", "tools")]
    assert not bad, bad
    calls = {ast.unparse(n.func) for n in ast.walk(tree)
             if isinstance(n, ast.Call)}
    assert not calls & {"importlib.util.spec_from_file_location",
                        "importlib.import_module", "__import__"}


@pytest.mark.parametrize("name", sorted(DEVICE_SCRIPTS))
def test_script_runs_on_the_card_unless_told(name, tmp_path, monkeypatch):
    """Without CUDA a script raises before it loads or writes anything,
    unless --device cpu is given (the other tests)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        script(name).main(DEVICE_SCRIPTS[name])
    assert not list(tmp_path.iterdir())


def test_aslip_run_loads_without_its_gait_library(tmp_path):
    """Limit (l): an aslip CassieTraj-v0 run (the committed cassie_traj
    run with its --traj set to aslip) loads in the JAX tool's `_load` and
    in the port's `load_experiment` with the walking library; the port's
    keep_traj builds the run's own."""
    import pickle
    import shutil

    run = tmp_path / "aslip_run"
    shutil.copytree(ROOT / "curves" / "cassie_traj_ckpt", run)
    with open(run / "experiment.pkl", "rb") as f:
        args = pickle.load(f)
    with open(run / "experiment.pkl", "wb") as f:
        pickle.dump(dict(args, traj="aslip"), f)
    jenv, _ = tool("aslip_tests")._load(str(run))
    assert not jenv.aslip
    assert not load_experiment(str(run), device="cpu").env.aslip
    exp = load_experiment(str(run), device="cpu", keep_traj=True)
    assert exp.env.aslip and exp.env.num_speeds == 21
