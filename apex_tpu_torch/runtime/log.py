"""Run directories and scalar logs.

Port of `apex_tpu/runtime/log.py` (reference util/log.py:11-91):
  * run dir = logdir/env_name/<md5(args but seed/logdir/previous)>-seed<seed>
  * `experiment.info`, the arguments in readable form, and `experiment.pkl`,
    the pickled argument dict, which `apex.py eval` and the port's
    `runtime/evaluate.py` read;
  * a writer with a `.dir` attribute. The JAX package writes TensorBoard
    events when tensorboard is installed; this writer appends
    `tag,step,value` lines to `scalars.csv` in the run dir and needs
    nothing beyond the standard library;
  * `parse_previous`, which continues a curriculum from a previous run.
"""
from __future__ import annotations

import hashlib
import os
import pickle
from collections import OrderedDict


class ScalarWriter:
    """`add_scalar(tag, value, step)` to <dir>/scalars.csv."""

    def __init__(self, run_dir: str):
        self.dir = run_dir
        self._f = open(os.path.join(run_dir, "scalars.csv"), "a")

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._f.write(f"{tag},{int(step)},{float(value)!r}\n")

    def close(self) -> None:
        self._f.close()


def args_hash(arg_dict: dict) -> str:
    """md5 over the sorted args minus seed/logdir/previous
    (util/log.py:23-49)."""
    arg_dict = OrderedDict(sorted(arg_dict.items(), key=lambda t: t[0]))
    for key in ("seed", "logdir", "previous"):
        arg_dict.pop(key, None)
    return hashlib.md5(str(arg_dict).encode("utf-8")).hexdigest()[:10]


def create_logger(args) -> ScalarWriter:
    """Create the run dir and its writer. `args` is an argparse.Namespace
    or a dict."""
    arg_dict = dict(vars(args)) if not isinstance(args, dict) else dict(args)
    seed = arg_dict.get("seed", 0)
    logdir = str(arg_dict.get("logdir", "./trained_models"))
    env_name = str(arg_dict.get("env_name", "env"))

    run_name = f"{args_hash(arg_dict)}-seed{seed}"
    output_dir = os.path.join(logdir, env_name, run_name)
    os.makedirs(output_dir, exist_ok=True)

    with open(os.path.join(output_dir, "experiment.info"), "w") as f:
        for key, val in sorted(arg_dict.items()):
            f.write(f"{key}: {val}\n")
    with open(os.path.join(output_dir, "experiment.pkl"), "wb") as f:
        pickle.dump(arg_dict, f)
    return ScalarWriter(output_dir)


# the env-defining keys a continuation inherits (util/log.py:74-91)
INHERITED = ("env_name", "traj", "simrate", "command_profile",
             "input_profile", "learn_gains", "history", "no_delta",
             "ik_baseline", "mirror")


def parse_previous(args):
    """Curriculum continuation (`parse_previous`, apex_tpu/runtime/log.py:
    75-95; reference util/log.py:74-91): with `args.previous` set, the
    env-defining keys of that run's experiment.pkl replace the arguments'
    own, so that the new run sees the same observation and action spaces;
    `exchange_reward` swaps the reward and renames the run to the previous
    run's name + "_NEW-" + the reward."""
    if getattr(args, "previous", None) is None:
        return args
    with open(os.path.join(args.previous, "experiment.pkl"), "rb") as f:
        prev = pickle.load(f)
    for key in INHERITED:
        if key in prev:
            setattr(args, key, prev[key])
    if getattr(args, "exchange_reward", None):
        args.reward = args.exchange_reward
        args.run_name = (prev.get("run_name", "run") + "_NEW-"
                         + str(args.reward))
    return args
