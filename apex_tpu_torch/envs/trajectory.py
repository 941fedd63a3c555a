"""Reference-trajectory and mission-schedule loaders, and the IK network.

Port of `apex_tpu/envs/trajectory.py` (reference trajectory/trajectory.py:
7-39, aslip_trajectory.py:42-98, missions/command_mission.py:5-23),
reading the port's own copies of the data files in `apex_tpu_torch/data/`
(`traj_walking.npz`, `traj_stepping.npz`, `aslip_trajs.npz`,
`iknet.npz`, `mission_*.npz`, the same bytes as `apex_tpu/data/`). Arrays
are float32 numpy on the host; envs turn them into device tensors at
construction.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

DATA_DIR = Path(__file__).resolve().parent.parent / "data"

ASLIP_SPEEDS = [round(0.1 * i, 1) for i in range(21)]  # 0.0 .. 2.0


class CassieTrajectory:
    """Agility 2 kHz trajectory (reference trajectory/trajectory.py:7-39)."""

    def __init__(self, name: str = "walking"):
        with np.load(DATA_DIR / f"traj_{name}.npz") as f:
            self.time = f["time"]
            self.qpos = f["qpos"]     # (N, 35)
            self.qvel = f["qvel"]     # (N, 32)
            self.torque = f["torque"]
            self.mpos = f["mpos"]
            self.mvel = f["mvel"]

    def __len__(self):
        return len(self.time)


class CassieAslipTrajectory:
    """One speed-indexed task-space gait cycle (reference
    aslip_trajectory.py:80-98), with its IK-net joint targets."""

    def __init__(self, data: Dict[str, np.ndarray]):
        self.qpos = data["qpos"]       # (T, 35)
        self.qvel = data["qvel"]       # (T, 10) motor velocities
        self.rpos, self.rvel = data["rpos"], data["rvel"]
        self.lpos, self.lvel = data["lpos"], data["lvel"]
        self.cpos, self.cvel = data["cpos"], data["cvel"]
        self.time = data["time"]
        self.ik_pos = data["ik_pos"]   # (T, 35) IKNet of the task targets
        self.length = self.qpos.shape[0]


def get_all_aslip_trajectories() -> List[CassieAslipTrajectory]:
    """All 21 speed cycles (reference getAllTrajectories,
    aslip_trajectory.py:42-66), with the IK network's qpos over each
    cycle's task-space targets (right foot, left foot, COM)."""
    iknet = IKNet()
    trajs = []
    with np.load(DATA_DIR / "aslip_trajs.npz") as f:
        for s in ASLIP_SPEEDS:
            data = {k: f[f"s{s}_{k}"] for k in
                    ("qpos", "qvel", "rpos", "rvel", "lpos", "lvel", "cpos",
                     "cvel", "time")}
            data["ik_pos"] = iknet(np.concatenate(
                [data["rpos"], data["lpos"], data["cpos"]], axis=1))
            trajs.append(CassieAslipTrajectory(data))
    return trajs


class IKNet:
    """9 -> 35 MLP mapping task space (right foot, left foot, COM) to qpos
    (the reference's offline-trained ikNet, state dict in iknet.npz): two
    relu hidden layers and a linear output, in numpy."""

    def __init__(self):
        with np.load(DATA_DIR / "iknet.npz") as f:
            self.w0, self.b0 = f["layers.0.weight"].T, f["layers.0.bias"]
            self.w1, self.b1 = f["layers.1.weight"].T, f["layers.1.bias"]
            self.w2, self.b2 = f["out.weight"].T, f["out.bias"]

    def __call__(self, x: np.ndarray) -> np.ndarray:
        h = np.maximum(x @ self.w0 + self.b0, 0.0)
        h = np.maximum(h @ self.w1 + self.b1, 0.0)
        return h @ self.w2 + self.b2


class CommandTrajectory:
    """Mission command schedule (reference missions/command_mission.py:
    5-23): per 30 Hz step, the commanded position, speed and heading."""

    def __init__(self, mission: str = "default"):
        with np.load(DATA_DIR / f"mission_{mission}.npz") as f:
            self.global_pos = f["compos"]     # (T, 3)
            self.speed_cmd = f["speed"]       # (T,)
            self.orient = f["orient"]         # (T,)
        self.trajlen = len(self.speed_cmd)
