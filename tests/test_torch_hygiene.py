"""Boundaries of the port: apex_tpu_torch and chip_smoke.py never import
JAX or the JAX package, import on a machine without triton, nvcc or a GPU,
and run on the CPU only when asked to."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "apex_tpu")
CKPT = str(ROOT / "curves" / "cassie_mk4_hardened_ckpt")


def _port_files():
    return sorted((ROOT / "apex_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_imports_nothing_of_jax():
    offending = [
        f"{path.relative_to(ROOT)}: {mod}"
        for path in _port_files() for mod in _imported_modules(path)
        if mod.split(".")[0] in FORBIDDEN]
    assert len(_port_files()) > 20
    assert not offending, offending


def test_port_imports_without_triton_nvcc_or_gpu():
    """Importing every module of the port (and chip_smoke) loads no JAX,
    no triton and builds nothing, with nvcc out of reach."""
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import apex_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(apex_tpu_torch.__path__, "
        "'apex_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        f"bad = sorted(m for m in new if m.split('.')[0] in {FORBIDDEN!r} "
        "or m.split('.')[0] == 'triton')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent",
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """Without CUDA every entry point raises unless device='cpu' is asked
    for; with it, they run on the CPU."""
    from apex_tpu_torch.envs.cassie import CassieEnv
    from apex_tpu_torch.envs.registry import env_factory
    from apex_tpu_torch.envs.walker2d import Walker2dEnv
    from apex_tpu_torch.runtime.evaluate import load_experiment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: CassieEnv(), lambda: env_factory("Cassie-v0"),
                 lambda: load_experiment(CKPT),
                 lambda: CassieEnv(device="cuda"), lambda: Walker2dEnv(),
                 lambda: env_factory("Walker2d-v0")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert CassieEnv(device="cpu").device.type == "cpu"
    assert load_experiment(CKPT, device="cpu").env.device.type == "cpu"


def test_cli_without_cuda_fails(tmp_path):
    """`python -m apex_tpu_torch eval` defaults to the GPU: on a machine
    without one it exits non-zero instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch", "eval", "--path", CKPT,
         "--n_episodes", "1", "--traj_len", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "CUDA" in out.stderr


def test_unported_configurations_raise(tmp_path):
    """No configuration of the CLI is refused as not ported: the recurrent
    learners (`ppo --recurrent`, `rdpg`, `ars --recurrent`) and the
    curriculum continuation (`ppo --previous`) run (tests/test_torch_cli.py
    runs each), and the CLI and the learners hold no NotImplementedError.
    The CassieEnv switches that stood here build (the exact estimator,
    the min profile, the clock reward, a history), and an unknown terrain
    or env name is a ValueError, as in JAX."""
    import inspect

    import apex_tpu_torch.__main__ as cli
    from apex_tpu_torch.agents import ars, dpg, ppo
    from apex_tpu_torch.envs.cassie import CassieEnv
    from apex_tpu_torch.envs.registry import env_factory

    for mod in (cli, ars, dpg, ppo):
        assert "NotImplementedError" not in inspect.getsource(mod)
    for kwargs, size in (({"estimator": "exact"}, 50),
                         ({"input_profile": "min"}, 25),
                         ({"reward": "clock"}, 50), ({"history": 1}, 100)):
        assert CassieEnv(device="cpu", **kwargs).observation_size == size
    with pytest.raises(ValueError):
        CassieEnv(device="cpu", terrain="stairs")
    with pytest.raises(ValueError):
        env_factory("Humanoid-v9", device="cpu")
    assert env_factory("CassieStanding-v0",
                       device="cpu").observation_size == 46
