"""`python -m apex_tpu_torch {ppo,td3_sync,td3_async,ddpg,ars,eval}`
against `apex.py`: the same flags give the same namespace, hence the same
run-directory name (the hash of the arguments) and the same
experiment.pkl; a run of the mk5c reward configuration without dyn-rand
writes a run directory that the JAX package loads; the learners beyond
PPO run on the CPU when asked and name their run directories as apex.py
does; the recurrent learners and the curriculum continuation write run
directories that the JAX package loads; and eval's suites, dumps, gait
recording and scripted drive run on the CPU at a tiny size."""
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

import apex
from apex_tpu.agents import ars as jax_ars
from apex_tpu.agents import dpg as jax_dpg
from apex_tpu.agents import ppo as jax_ppo
from apex_tpu.agents import td3 as jax_td3
from apex_tpu.runtime import log as jax_log
from apex_tpu.runtime.evaluate import load_experiment as jax_load_experiment
from apex_tpu_torch.__main__ import main as port_main
from apex_tpu_torch.agents import ars as port_ars
from apex_tpu_torch.agents import dpg as port_dpg
from apex_tpu_torch.agents import ppo as port_ppo
from apex_tpu_torch.agents import td3 as port_td3
from apex_tpu_torch.runtime import log
from apex_tpu_torch.runtime.evaluate import load_experiment
from chip_smoke import TD3_KEYS

CKPT = "curves/cassie_mk4_hardened_ckpt"

MK4_HARDENED = ["ppo", "--dyn_random", "--mirror", "--num_procs", "1024",
                "--num_steps", "32768", "--max_traj_len", "300",
                "--std_dev", "-1.5", "--estimator", "firmware"]
MK5C = ["ppo", "--reward", "5k_speed_reward", "--simrate", "60",
        "--min_speed", "0", "--max_speed", "3", "--mirror", "--num_procs",
        "1024"]
# the new envs' flags: CassieTraj-v0 on the aslip library with the IK
# baseline, CassieStanding-v0, and Cassie-v0 with learned gains and a
# history
TRAJ = ["ppo", "--env_name", "CassieTraj-v0", "--traj", "aslip",
        "--no_delta", "--ik_baseline", "--mirror"]
STANDING = ["ppo", "--env_name", "CassieStanding-v0", "--simrate", "60"]
GAINS = ["ppo", "--learn_gains", "--history", "1", "--reward", "clock",
         "--input_profile", "min"]
# the learners' flag sets: bench.py's TD3 cell (Walker2d, 64 envs), the
# CLI's defaults on Cassie, and a few flags changed
TD3_SYNC = ["td3_sync", "--max_timesteps", "10240", "--start_timesteps",
            "5120", "--param_noise", "--seed", "3"]
TD3_ASYNC = ["td3_async", "--env_name", "Walker2d-v0", "--num_procs", "64",
             "--tau", "0.01", "--dyn_random"]
DDPG = ["ddpg", "--env_name", "Walker2d-v0", "--c_lr", "3e-4",
        "--max_traj_len", "300"]
ARS = ["ars", "--env_name", "Walker2d-v0", "--deltas", "64", "--algo", "v2",
       "--n_itr", "1"]
# the recurrent learners and the curriculum continuation (from a committed
# run dir, with a new reward)
PPO_RECURRENT = ["ppo", "--env_name", "Walker2d", "--recurrent",
                 "--num_procs", "256"]
PREVIOUS = ["ppo", "--previous", CKPT, "--exchange_reward",
            "5k_speed_reward", "--num_procs", "256"]
RDPG = ["rdpg", "--env_name", "Walker2d-v0", "--c_lr", "3e-4"]
ARS_RECURRENT = ["ars", "--env_name", "Walker2d-v0", "--recurrent",
                 "--hidden_size", "16"]

# the run_experiment each CLI calls per subcommand: (JAX module, port
# module, the JAX call's keyword arguments besides the namespace)
ENTRY = {"ppo": (jax_ppo, port_ppo), "td3_sync": (jax_td3, port_td3),
         "td3_async": (jax_td3, port_td3), "ddpg": (jax_dpg, port_dpg),
         "rdpg": (jax_dpg, port_dpg), "ars": (jax_ars, port_ars)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run side by side in several worker processes: torch's
    default of one thread per core in each of them oversubscribes the
    CPU, and these many small tensors gain nothing from threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("argv", [MK4_HARDENED, MK5C, TRAJ, STANDING,
                                  GAINS, TD3_SYNC, TD3_ASYNC, DDPG, ARS,
                                  PPO_RECURRENT, PREVIOUS, RDPG,
                                  ARS_RECURRENT],
                         ids=["mk4_hardened", "mk5c", "traj", "standing",
                              "gains", "td3_sync", "td3_async", "ddpg",
                              "ars", "ppo_recurrent", "previous", "rdpg",
                              "ars_recurrent"])
def test_ppo_namespace_matches_apex_py(argv, monkeypatch):
    """The namespace each CLI hands to run_experiment (stubbed), for ppo
    (also `--recurrent`, and `--previous` with `--exchange_reward`, after
    parse_previous) and the learners beyond it: the same keys in the same
    order and the same values, so the same args_hash and pickled keys,
    and the same mode (async, recurrent); the port passes its device
    beside it."""
    got = {}
    jax_mod, port_mod = ENTRY[argv[0]]
    monkeypatch.setattr(jax_mod, "run_experiment",
                        lambda args, **kw: got.setdefault(
                            "jax", (vars(args), kw)))
    monkeypatch.setattr(
        port_mod, "run_experiment",
        lambda args, device=None, **kw: got.update(
            port=(vars(args), kw), device=device))
    monkeypatch.setattr(sys, "argv", ["apex.py", *argv])
    apex.main()
    assert port_main(argv) == 0
    (ours, our_kw), (theirs, their_kw) = got["port"], got["jax"]
    assert list(ours) == list(theirs)
    assert ours == theirs
    assert our_kw == their_kw
    assert log.args_hash(ours) == jax_log.args_hash(theirs)
    assert got["device"] == "cuda"
    if argv[0].startswith("td3"):     # what chip_smoke.py's td3_cassie reads
        assert tuple(sorted(theirs)) == TD3_KEYS
    if argv is PREVIOUS:              # the committed run's env, a new name
        assert (ours["env_name"], ours["reward"]) == ("Cassie-v0",
                                                      "5k_speed_reward")
        assert ours["run_name"].endswith("_NEW-5k_speed_reward")


def test_mk5c_reward_run_dir_loads_in_apex_py(tmp_path):
    """A tiny CPU run with mk5c's reward flags and no --dyn_random (2 envs,
    1 iteration of 60-substep steps) names its run directory by JAX's hash
    of its arguments, and the JAX package's load_experiment restores it."""
    rc = port_main([*MK5C[:-2], "--device", "cpu", "--num_procs", "2",
                    "--num_steps", "4", "--max_traj_len", "2", "--n_itr",
                    "1", "--input_norm_steps", "2", "--logdir",
                    str(tmp_path)])
    assert rc == 0
    (run_dir,) = (tmp_path / "Cassie-v0").iterdir()
    with open(run_dir / "experiment.pkl", "rb") as f:
        args = pickle.load(f)
    assert "cmd" not in args and "device" not in args
    assert (args["reward"], args["simrate"], args["dyn_random"]) == (
        "5k_speed_reward", 60, False)
    assert run_dir.name == f"{jax_log.args_hash(args)}-seed0"
    ppo, jstate, _ = jax_load_experiment(str(run_dir))
    assert (ppo.env.simrate, ppo.env.reward) == (60, "5k_speed_reward")
    exp = load_experiment(str(run_dir), device="cpu")
    np.testing.assert_array_equal(
        exp.actor.layers[0].weight.detach().numpy().T,
        np.asarray(jstate.actor.params["layers"][0]["w"]))
    assert jax.tree_util.tree_leaves(jstate)


@pytest.mark.parametrize("argv", [
    ["ppo", "--env_name", "CassieTraj-v0", "--mirror"],
    ["ppo", "--env_name", "CassieTraj-v0", "--learn_gains", "--reward",
     "no_speed_clock"],
    ["ppo", "--env_name", "CassieStanding-v0"],
    GAINS],
    ids=["traj", "traj_gains_clock", "standing", "gains"])
def test_new_env_run_dirs_load_in_apex_py(argv, tmp_path):
    """A tiny CPU PPO run of each new env (2 envs, 3 substeps, one
    iteration) names its run directory by JAX's hash of its arguments, and
    the JAX package's load_experiment restores its checkpoint: the env
    state's leaves are the JAX state's, leaf for leaf, or the template
    would refuse them; the port loads the same actor back. (Both stacks'
    load_experiment build CassieTraj-v0 without --traj, as JAX's does, so
    a run on the aslip library loads in neither.)"""
    rc = port_main([*argv, "--device", "cpu", "--simrate", "3",
                    "--num_procs", "2", "--num_steps", "4",
                    "--max_traj_len", "2", "--n_itr", "1",
                    "--input_norm_steps", "2", "--logdir", str(tmp_path)])
    assert rc == 0
    env_name = argv[argv.index("--env_name") + 1] \
        if "--env_name" in argv else "Cassie-v0"
    (run_dir,) = (tmp_path / env_name).iterdir()
    with open(run_dir / "experiment.pkl", "rb") as f:
        args = pickle.load(f)
    assert run_dir.name == f"{jax_log.args_hash(args)}-seed0"
    ppo, jstate, _ = jax_load_experiment(str(run_dir))
    exp = load_experiment(str(run_dir), device="cpu")
    assert (exp.env.observation_size, exp.env.action_size) == (
        ppo.env.observation_size, ppo.env.action_size)
    np.testing.assert_array_equal(
        exp.actor.layers[0].weight.detach().numpy().T,
        np.asarray(jstate.actor.params["layers"][0]["w"]))


@pytest.mark.parametrize("argv", [
    ["td3_sync", "--max_timesteps", "160"],
    ["td3_async", "--max_timesteps", "320", "--start_timesteps", "160"],
    ["ddpg", "--max_timesteps", "160"],
    ["ars", "--n_itr", "2", "--deltas", "4", "--deltas_used", "2"]],
    ids=["td3_sync", "td3_async", "ddpg", "ars"])
def test_learner_run_dirs_are_named_as_apex_py(argv, tmp_path):
    """Each learner runs on the CPU when asked (PointMass-v0, 2 envs, one or
    two iterations): the run directory is named by JAX's hash of the
    pickled arguments, which hold neither the subcommand nor the device,
    and holds a checkpoint and the scalars."""
    rc = port_main([*argv, "--device", "cpu", "--env_name", "PointMass-v0",
                    "--num_procs", "2", "--max_traj_len", "20", "--logdir",
                    str(tmp_path)])
    assert rc == 0
    (run_dir,) = (tmp_path / "PointMass-v0").iterdir()
    with open(run_dir / "experiment.pkl", "rb") as f:
        args = pickle.load(f)
    assert "cmd" not in args and "device" not in args
    assert run_dir.name == f"{jax_log.args_hash(args)}-seed0"
    assert (run_dir / "checkpoint.pkl").exists()
    assert "Test/Return" in (run_dir / "scalars.csv").read_text()


RECURRENT_RUNS = {
    "rdpg": ["rdpg", "--env_name", "PointMass-v0", "--num_procs", "2",
             "--max_traj_len", "8", "--max_timesteps", "16"],
    "ars_recurrent": ["ars", "--recurrent", "--env_name", "Walker2d-v0",
                      "--deltas", "2", "--deltas_used", "1", "--n_itr", "1",
                      "--max_traj_len", "4", "--hidden_size", "8"],
    "ppo_recurrent": ["ppo", "--recurrent", "--env_name", "PointMass-v0",
                      "--num_procs", "4", "--num_steps", "16",
                      "--max_traj_len", "6", "--minibatch_size", "2",
                      "--n_itr", "1", "--input_norm_steps", "8"],
    "ppo_previous": ["ppo", "--exchange_reward", "clock", "--num_procs",
                     "4", "--num_steps", "16", "--max_traj_len", "6",
                     "--n_itr", "1", "--input_norm_steps", "8"],
}


@pytest.mark.parametrize("case", list(RECURRENT_RUNS))
def test_recurrent_learners_run_dirs_load_in_apex_py(case, tmp_path):
    """The configurations the port refused until the recurrent learners
    came (`rdpg`, `ars --recurrent`, `ppo --recurrent`, `ppo --previous`)
    each run on the CPU (a few envs, one iteration) into a run directory
    named by JAX's hash of its arguments, whose checkpoint restores into
    the JAX package's template of the same configuration leaf for leaf
    (`ppo --previous`: a continuation of a feed-forward PointMass-v0 run
    dir named "walk", which inherits its env, is renamed by the new
    reward, and loads in JAX's load_experiment)."""
    from apex_tpu.agents import ppo_recurrent as jax_rppo
    from apex_tpu.envs.registry import env_factory as jax_env_factory
    from apex_tpu.runtime.checkpoint import load_checkpoint as jax_load

    argv = RECURRENT_RUNS[case]
    env_name = "Walker2d-v0" if case == "ars_recurrent" else "PointMass-v0"
    if case == "ppo_previous":
        prev = tmp_path / "prev"
        assert port_main(["ppo", "--device", "cpu", "--env_name",
                          "PointMass-v0", "--mirror", "--num_procs", "4",
                          "--num_steps", "16", "--max_traj_len", "6",
                          "--n_itr", "1", "--input_norm_steps", "8",
                          "--run_name", "walk", "--logdir", str(prev)]) == 0
        (prev_dir,) = (prev / "PointMass-v0").iterdir()
        argv = [*argv, "--previous", str(prev_dir)]
    rc = port_main([*argv, "--device", "cpu", "--logdir",
                    str(tmp_path / "runs")])
    assert rc == 0
    (run_dir,) = (tmp_path / "runs" / env_name).iterdir()
    with open(run_dir / "experiment.pkl", "rb") as f:
        args = pickle.load(f)
    assert "cmd" not in args and "device" not in args
    assert run_dir.name == f"{jax_log.args_hash(args)}-seed0"
    with open(run_dir / "checkpoint.pkl", "rb") as f:
        saved = pickle.load(f)
    jenv = jax_env_factory(args["env_name"])
    if case == "ppo_previous":
        assert (args["env_name"], args["mirror"], args["run_name"]) == (
            "PointMass-v0", True, "walk_NEW-clock")
        _, restored, _ = jax_load_experiment(str(run_dir))
    elif case == "ppo_recurrent":
        restored = jax_load(str(run_dir), jax_rppo.RecurrentPPO(
            jenv, jax_ppo.PPOConfig(num_envs=4)).init(0))
    elif case == "rdpg":
        restored = jax_load(str(run_dir), jax_dpg.DPG(
            jenv, jax_dpg.DPGConfig(num_envs=2, max_traj_len=8,
                                    recurrent=True)).init(0))
    else:
        restored = jax_load(str(run_dir), jax_ars.ARS(
            jenv, jax_ars.ARSConfig(hidden_size=8, recurrent=True)).init(0))
    for a, b in zip(jax.tree_util.tree_leaves(restored), saved):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert "Test/Return" in (run_dir / "scalars.csv").read_text()


# apex.py eval's flags, each suite and the dump, gait and drive options
EVAL_ARGVS = {
    "commands": ["--suite", "commands"],
    "perturb": ["--suite", "perturb", "--pdf", "perturb.pdf"],
    "mission": ["--suite", "mission", "--mission", "straight_1.4"],
    "sensitivity": ["--suite", "sensitivity"],
    "5k": ["--suite", "5k", "--pdf", "5k.pdf"],
    "compare": ["--suite", "compare", "--compare_to", "other_run",
                "--n_episodes", "8", "--traj_len", "100"],
    "out_gait": ["--out", "traj.npz", "--gait", "gait.npz", "--speed",
                 "0.5"],
    "drive": ["--drive", "script.json", "--drive_steps", "50"]}


@pytest.mark.parametrize("flags", list(EVAL_ARGVS.values()),
                         ids=list(EVAL_ARGVS))
def test_eval_namespace_matches_apex_py(flags, monkeypatch):
    """`python -m apex_tpu_torch eval` parses apex.py eval's flags to its
    namespace: the same keys in the same order and the same values, beside
    the port's own --seed, --physics and --device."""
    import argparse

    class Parsed(Exception):
        pass

    got = []
    parse = argparse.ArgumentParser.parse_args

    def capture(self, *args, **kwargs):
        got.append(vars(parse(self, *args, **kwargs)))
        raise Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    argv = ["eval", "--path", "run_dir", *flags]
    monkeypatch.setattr(sys, "argv", ["apex.py", *argv])
    with pytest.raises(Parsed):
        apex.main()
    with pytest.raises(Parsed):
        port_main(argv)
    theirs, ours = got
    port_only = {"cmd": "eval", "seed": 42, "physics": None,
                 "device": "cuda"}
    assert {k: ours.pop(k) for k in port_only} == port_only
    assert list(ours) == list(theirs)
    assert ours == theirs


@pytest.mark.parametrize("suite", ["commands", "mission"])
def test_eval_suites_run_from_the_cli(suite, monkeypatch, capsys):
    """`eval --suite commands` and `--suite mission` on the CPU at a tiny
    size (the suites' sizes cut: 2 trials of one 2-step command; 2 steps
    of the mission), printing the suite's figures."""
    import functools

    from apex_tpu_torch.runtime import eval_suites

    small = {"commands": dict(n_trials=2, n_commands=1,
                              steps_per_command=2),
             "mission": dict(max_steps=2)}[suite]
    name = {"commands": "eval_commands", "mission": "eval_mission"}[suite]
    monkeypatch.setattr(eval_suites, name, functools.partial(
        getattr(eval_suites, name), **small))
    assert port_main(["eval", "--path", CKPT, "--suite", suite,
                      "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert ("'pass_rate'" if suite == "commands" else "'progress': 2") \
        in printed, printed


def test_eval_out_gait_and_drive_from_the_cli(tmp_path, monkeypatch):
    """`eval --out --gait` writes the trajectory dump and the gait
    recording (dump_gait cut to 2 steps), and `eval --drive` runs a key
    script and writes its telemetry, on the CPU."""
    import functools
    import json

    from apex_tpu_torch.runtime import evaluate

    monkeypatch.setattr(evaluate, "dump_gait", functools.partial(
        evaluate.dump_gait, n_steps=2))
    out, gait = tmp_path / "traj.npz", tmp_path / "gait.npz"
    assert port_main(["eval", "--path", CKPT, "--n_episodes", "2",
                      "--traj_len", "2", "--out", str(out), "--gait",
                      str(gait), "--device", "cpu"]) == 0
    with np.load(out) as f:
        assert f["obs"].shape == (2, 2, 50) and f["action"].shape == (
            2, 2, 10)
    with np.load(gait) as f:
        assert f["qpos"].shape == (2, 35)
    script = tmp_path / "drive.json"
    script.write_text(json.dumps([[0, "w"], [1, "p"]]))
    tele = tmp_path / "drive.npz"
    assert port_main(["eval", "--path", CKPT, "--drive", str(script),
                      "--drive_steps", "2", "--out", str(tele),
                      "--device", "cpu"]) == 0
    with np.load(tele) as f:
        np.testing.assert_allclose(f["speed"], [0.1, 0.1], atol=1e-6)
        assert f["qpos"].shape == (2, 35)


def test_scripted_drive_keys():
    """tests/test_eval_suites.py::test_scripted_drive on the port (its env
    at 3 substeps per step): the keys land at their steps and the
    telemetry records them -- two 'w' at step 2 give 0.2 m/s, 'k' turns
    the heading by 0.1, 'j' raises phase_add to 1.1, 'r' resets it to 1;
    and '3' rebuilds the clock for the aerial stance mode."""
    import dataclasses

    from apex_tpu_torch.runtime import drive

    exp = load_experiment(CKPT, device="cpu")
    env = dataclasses.replace(exp.env, simrate=3)
    script = [[2, "w"], [2, "w"], [4, "k"], [5, "j"], [6, "p"], [8, "r"]]
    res = drive.drive_policy(exp.actor, exp.norm, env, script, n_steps=10,
                             seed=0, start_speed=0.0)
    assert res["qpos"].shape == (10, 35)
    np.testing.assert_allclose(res["speed"][0], 0.0, atol=1e-6)
    np.testing.assert_allclose(res["speed"][2:7], 0.2, atol=1e-6)
    assert res["orient_add"][4] > 0.09
    np.testing.assert_allclose(res["phase_add"][5:7], 1.1, atol=1e-6)
    np.testing.assert_allclose(res["phase_add"][8:], 1.0, atol=1e-6)
    state, _ = env.reset(env.sample_reset_noise(torch.Generator(), 1))
    aerial = drive._apply_key(env, state, "3")
    np.testing.assert_array_equal(aerial.stance_mode[:, 0].numpy(),
                                  [0.0, 1.0, 0.0])
    assert not torch.equal(aerial.clock.y, state.clock.y)
    pushed = drive._apply_key(env, state, "p")
    assert float(pushed.params.ext_force[5, 0]) == 100.0
    with pytest.raises(ValueError):
        drive._apply_key(env, state, "q")


def test_record_policy_channels(tmp_path):
    """record_policy writes the control loop's channels of one rollout
    (3 steps): the commanded targets, the measured motor positions (the
    qpos rows of the motors), torques, forces and foot positions."""
    from apex_tpu_torch.physics.cassie_sim import MOTOR_QPOS_IDX
    from apex_tpu_torch.runtime.evaluate import record_policy

    recs = record_policy(CKPT, out=str(tmp_path / "rec.npz"), n_steps=3,
                         device="cpu")
    for k, shape in (("pd_target", (3, 10)), ("motor_pos", (3, 10)),
                     ("torque", (3, 10)), ("grf", (3, 2)),
                     ("foot_pos", (3, 2, 3)), ("qpos", (3, 35)),
                     ("action", (3, 10)), ("reward", (3,))):
        assert recs[k].shape == shape, k
        assert np.isfinite(recs[k]).all(), k
    np.testing.assert_array_equal(recs["motor_pos"],
                                  recs["qpos"][:, MOTOR_QPOS_IDX])
    with np.load(tmp_path / "rec.npz") as f:
        assert set(f) == set(recs)
