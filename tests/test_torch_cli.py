"""`python -m apex_tpu_torch ppo` against `apex.py ppo`: the same flags
give the same namespace, hence the same run-directory name (the hash of
the arguments) and the same experiment.pkl; and a run of the mk5c reward
configuration without dyn-rand writes a run directory that the JAX
package loads."""
import pickle
import sys

import jax
import numpy as np
import pytest

import apex
from apex_tpu.agents import ppo as jax_ppo
from apex_tpu.runtime import log as jax_log
from apex_tpu.runtime.evaluate import load_experiment as jax_load_experiment
from apex_tpu_torch.__main__ import main as port_main
from apex_tpu_torch.agents import ppo as port_ppo
from apex_tpu_torch.runtime import log
from apex_tpu_torch.runtime.evaluate import load_experiment

MK4_HARDENED = ["--dyn_random", "--mirror", "--num_procs", "1024",
                "--num_steps", "32768", "--max_traj_len", "300",
                "--std_dev", "-1.5", "--estimator", "firmware"]
MK5C = ["--reward", "5k_speed_reward", "--simrate", "60", "--min_speed",
        "0", "--max_speed", "3", "--mirror", "--num_procs", "1024"]


@pytest.mark.parametrize("flags", [MK4_HARDENED, MK5C],
                         ids=["mk4_hardened", "mk5c"])
def test_ppo_namespace_matches_apex_py(flags, monkeypatch):
    """The namespace each CLI hands to run_experiment (stubbed): the same
    keys in the same order and the same values, so the same args_hash and
    pickled keys; the port passes its device beside it."""
    got = {}
    monkeypatch.setattr(jax_ppo, "run_experiment",
                        lambda args: got.setdefault("jax", vars(args)))
    monkeypatch.setattr(
        port_ppo, "run_experiment",
        lambda args, device=None: got.update(port=vars(args), device=device))
    monkeypatch.setattr(sys, "argv", ["apex.py", "ppo", *flags])
    apex.main()
    assert port_main(["ppo", *flags]) == 0
    assert list(got["port"]) == list(got["jax"])
    assert got["port"] == got["jax"]
    assert log.args_hash(got["port"]) == jax_log.args_hash(got["jax"])
    assert got["device"] == "cuda"


def test_mk5c_reward_run_dir_loads_in_apex_py(tmp_path):
    """A tiny CPU run with mk5c's reward flags and no --dyn_random (2 envs,
    1 iteration of 60-substep steps) names its run directory by JAX's hash
    of its arguments, and the JAX package's load_experiment restores it."""
    rc = port_main(["ppo", "--device", "cpu", *MK5C[:-2], "--num_procs", "2",
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
