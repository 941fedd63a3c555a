"""Reference-trajectory and mission-schedule loaders.

Port of `CassieTrajectory` and `CommandTrajectory` from
`apex_tpu/envs/trajectory.py` (reference trajectory/trajectory.py:7-39 and
missions/command_mission.py:5-23), reading the port's own copies of the
data files in `apex_tpu_torch/data/` (`traj_walking.npz`,
`mission_*.npz`, the same bytes as `apex_tpu/data/`). Arrays are float32
numpy on the host; envs turn them into device tensors at construction.
The aslip trajectories and the IK network are not ported yet.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

DATA_DIR = Path(__file__).resolve().parent.parent / "data"


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


class CommandTrajectory:
    """Mission command schedule (reference missions/command_mission.py:
    5-23): per 30 Hz step, the commanded position, speed and heading."""

    def __init__(self, mission: str = "default"):
        with np.load(DATA_DIR / f"mission_{mission}.npz") as f:
            self.global_pos = f["compos"]     # (T, 3)
            self.speed_cmd = f["speed"]       # (T,)
            self.orient = f["orient"]         # (T,)
        self.trajlen = len(self.speed_cmd)
