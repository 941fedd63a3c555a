"""Process-group initialisation for multi-GPU training.

Counterpart of `apex_tpu/parallel/multihost.py`. The JAX package runs one
program per host and lets `jax.distributed` form the global device mesh;
PyTorch runs one process per device, and `torch.distributed` joins them.
A rank stands for a mesh device: it steps its local share of the env
fleet on its own device, and the gradient and metric all-reduces of
`agents/ppo.py` keep the replicated nets in lockstep.

Usage: launch one process per GPU with torchrun

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m apex_tpu_torch ppo --num_procs 1024 ...

or set APEX_COORD_ADDR (host:port of rank 0), APEX_NUM_PROCS and
APEX_PROC_ID in each process, as for the JAX package. `initialize` reads
either set of variables; with neither, the run stays single-process.

The backend follows from how the ranks of a node map onto its GPUs: NCCL
when every rank has a GPU of its own, gloo when ranks share a device
(NCCL refuses two ranks on one GPU) or run on the CPU, as the tests do.
Gloo all-reduces CUDA tensors by staging them through the host.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def local_placement() -> tuple:
    """(local rank, ranks on this node): torchrun's LOCAL_RANK and
    LOCAL_WORLD_SIZE, else one rank per node, as the JAX package runs one
    process per host."""
    return (_env_int("LOCAL_RANK") or 0, _env_int("LOCAL_WORLD_SIZE") or 1)


def backend_for(device: torch.device, local_world: int) -> str:
    """NCCL when each of the node's `local_world` ranks has a GPU of its
    own, gloo when ranks share a device or run on the CPU."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device=None) -> torch.device:
    """The device of this rank: for CUDA, the node's GPU at the local rank
    (modulo the GPUs there, so that ranks beyond them share); "cpu" as
    asked. Sets the current CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank needs a CUDA device; pass "
                           "device='cpu' for a CPU group")
    local_rank, _ = local_placement()
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> bool:
    """Join the process group, if the run is one of several processes;
    returns whether it is.

    The arguments default to APEX_COORD_ADDR / APEX_NUM_PROCS /
    APEX_PROC_ID (the JAX package's variables), then to torchrun's
    MASTER_ADDR / WORLD_SIZE / RANK. `coordinator_address` is host:port,
    or an init-method URL (tcp://, file://). With nothing set the run
    stays single-process, as the JAX package's "single host, nothing to
    do"; with the variables set a failing init raises. `device` is where
    this rank runs (None: the GPU of its local rank)."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "APEX_COORD_ADDR")
    if num_processes is None:
        num_processes = _env_int("APEX_NUM_PROCS", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("APEX_PROC_ID", "RANK")
    if coordinator_address is None:
        if "MASTER_ADDR" not in os.environ:
            return False
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs its size and this process's rank: set "
            "APEX_NUM_PROCS and APEX_PROC_ID (or WORLD_SIZE and RANK)")
    dev = rank_device(device)
    backend = backend_for(dev, local_placement()[1])
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, device_id=dev if backend == "nccl" else None)
    return True


def global_env_count(per_process_envs: int) -> int:
    """Total fleet size across the job."""
    return per_process_envs * (dist.get_world_size()
                               if dist.is_initialized() else 1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(argv: Sequence[str], nproc: int) -> int:
    """`python -m apex_tpu_torch *argv` as `nproc` ranks of one group on
    this host, rank r on GPU r (torchrun's variables and a free localhost
    port): the JAX package's "same command, more machines" over the
    devices it sees. Returns 0 once every rank has, else the first
    non-zero exit code; a rank that fails ends the others."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]
    base = dict(os.environ, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(_free_port()), WORLD_SIZE=str(nproc),
                LOCAL_WORLD_SIZE=str(nproc), PYTHONPATH=os.pathsep.join(path))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "apex_tpu_torch", *argv],
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(nproc)]
    try:
        while True:
            rcs = [p.poll() for p in procs]
            failed = [rc for rc in rcs if rc not in (None, 0)]
            if failed or all(rc == 0 for rc in rcs):
                return failed[0] if failed else 0
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
