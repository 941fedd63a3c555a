"""`python -m apex_tpu_torch {ppo,td3_sync,td3_async,ddpg,ars}` against
`apex.py`: the same flags give the same namespace, hence the same
run-directory name (the hash of the arguments) and the same
experiment.pkl; a run of the mk5c reward configuration without dyn-rand
writes a run directory that the JAX package loads; the learners beyond
PPO run on the CPU when asked and name their run directories as apex.py
does; the configurations not ported yet raise."""
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

MK4_HARDENED = ["ppo", "--dyn_random", "--mirror", "--num_procs", "1024",
                "--num_steps", "32768", "--max_traj_len", "300",
                "--std_dev", "-1.5", "--estimator", "firmware"]
MK5C = ["ppo", "--reward", "5k_speed_reward", "--simrate", "60",
        "--min_speed", "0", "--max_speed", "3", "--mirror", "--num_procs",
        "1024"]
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

# the run_experiment each CLI calls per subcommand: (JAX module, port
# module, the JAX call's keyword arguments besides the namespace)
ENTRY = {"ppo": (jax_ppo, port_ppo), "td3_sync": (jax_td3, port_td3),
         "td3_async": (jax_td3, port_td3), "ddpg": (jax_dpg, port_dpg),
         "ars": (jax_ars, port_ars)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run side by side in several worker processes: torch's
    default of one thread per core in each of them oversubscribes the
    CPU, and these many small tensors gain nothing from threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("argv", [MK4_HARDENED, MK5C, TD3_SYNC, TD3_ASYNC,
                                  DDPG, ARS],
                         ids=["mk4_hardened", "mk5c", "td3_sync",
                              "td3_async", "ddpg", "ars"])
def test_ppo_namespace_matches_apex_py(argv, monkeypatch):
    """The namespace each CLI hands to run_experiment (stubbed), for ppo
    and the learners beyond it: the same keys in the same order and the
    same values, so the same args_hash and pickled keys, and the same
    mode (async, recurrent); the port passes its device beside it."""
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


@pytest.mark.parametrize("argv", [["rdpg"], ["ars", "--recurrent"],
                                  ["ppo", "--recurrent"]],
                         ids=["rdpg", "ars_recurrent", "ppo_recurrent"])
def test_unported_learners_raise(argv, tmp_path):
    with pytest.raises(NotImplementedError):
        port_main([*argv, "--device", "cpu", "--logdir", str(tmp_path)])
