"""Environment factory (reference util/env.py:8-72), for the environments
the port has: Cassie-v0 in its default configuration, Walker2d-v0 and
PointMass-v0."""
from __future__ import annotations

from apex_tpu_torch.envs.base import Env


def env_factory(env_name: str, device=None, **kwargs) -> Env:
    """Build an environment by registered name on `device` (GPU unless
    "cpu" is asked for)."""
    if env_name.lower() in ("cassie-v0", "cassie"):
        from apex_tpu_torch.envs.cassie import CassieEnv

        keys = ("simrate", "command_profile", "input_profile",
                "dynamics_randomization", "learn_gains", "reward", "history",
                "estimator", "estimator_tau", "estimator_noise", "terrain",
                "min_speed", "max_speed", "orient_jump_prob",
                "speed_phase_add", "pd_tier")
        return CassieEnv(device=device,
                         **{k: v for k, v in kwargs.items() if k in keys})
    if env_name.lower() in ("walker2d-v0", "walker2d-v2", "walker2d"):
        # the Cassie settings of the CLI do not apply, as in the JAX
        # factory (apex_tpu/envs/registry.py:49-52)
        from apex_tpu_torch.envs.walker2d import Walker2dEnv

        return Walker2dEnv(device=device)
    if env_name.lower() in ("pointmass-v0", "pointmass"):
        from apex_tpu_torch.envs.base import PointMassEnv

        return PointMassEnv(device=device)
    raise NotImplementedError(
        f"environment {env_name!r} is not ported to apex_tpu_torch yet "
        "(available: Cassie-v0, Walker2d-v0, PointMass-v0)")
