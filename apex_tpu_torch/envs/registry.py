"""Environment factory (reference util/env.py:8-72), for every name the JAX
package registers (`apex_tpu/envs/registry.py`): Cassie-v0,
CassieStanding-v0, CassieTraj-v0, CassiePlayground-v0, Walker2d-v0 and
PointMass-v0. Each takes the keyword arguments JAX's factory passes on to
it, and the Cassie and Walker2d envs the port's `pd_tier`."""
from __future__ import annotations

from apex_tpu_torch.envs.base import Env


def env_factory(env_name: str, device=None, **kwargs) -> Env:
    """Build an environment by registered name on `device` (GPU unless
    "cpu" is asked for). An unknown name raises ValueError, as in the JAX
    factory: there is no gym fallback."""
    name = env_name.lower()
    pick = lambda *keys: {k: v for k, v in kwargs.items()
                          if k in keys + ("pd_tier",)}
    if name in ("cassie-v0", "cassie"):
        from apex_tpu_torch.envs.cassie import CassieEnv

        return CassieEnv(device=device, **pick(
            "simrate", "command_profile", "input_profile",
            "dynamics_randomization", "learn_gains", "reward", "history",
            "estimator", "estimator_tau", "estimator_noise", "terrain",
            "terrain_amplitude", "min_speed", "max_speed",
            "orient_jump_prob", "speed_phase_add"))
    if name in ("cassiestanding-v0", "cassiestanding"):
        from apex_tpu_torch.envs.cassie_standing import CassieStandingEnv

        return CassieStandingEnv(device=device, **pick("simrate"))
    if name in ("cassietraj-v0", "cassietraj"):
        from apex_tpu_torch.envs.cassie_traj import CassieTrajEnv

        return CassieTrajEnv(device=device, **pick(
            "simrate", "command_profile", "input_profile",
            "dynamics_randomization", "learn_gains", "reward", "history",
            "traj", "no_delta", "ik_baseline"))
    if name in ("cassieplayground-v0", "cassieplayground"):
        from apex_tpu_torch.envs.cassie_playground import CassiePlayground

        return CassiePlayground(device=device, **pick("simrate", "mission"))
    if name in ("walker2d-v0", "walker2d-v2", "walker2d"):
        # the Cassie settings of the CLI do not apply, as in the JAX
        # factory (apex_tpu/envs/registry.py:49-52)
        from apex_tpu_torch.envs.walker2d import Walker2dEnv

        return Walker2dEnv(device=device, **pick())
    if name in ("pointmass-v0", "pointmass"):
        from apex_tpu_torch.envs.base import PointMassEnv

        return PointMassEnv(device=device)
    raise ValueError(f"unknown environment: {env_name} (no gym fallback: "
                     "implement envs.base.Env instead)")
