"""The JAX package's PPO learning curve on PointMass-v0 at the verify
skill's size (128 envs, 4096 steps per iteration, max_traj_len 100,
minibatch 512, 25 iterations, seed 0): the deterministic eval return after
each iteration, the reference `tests/test_torch_ppo.py` holds the port's
curve against. Runs on the CPU:

    JAX_PLATFORMS=cpu python scripts/reference_pointmass_ppo.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from apex_tpu.agents.ppo import PPO, PPOConfig  # noqa: E402
from apex_tpu.envs.base import PointMassEnv  # noqa: E402


def main():
    ppo = PPO(PointMassEnv(), PPOConfig(num_envs=128, num_steps=4096,
                                        max_traj_len=100,
                                        minibatch_size=512))
    state = ppo.prenormalize(ppo.init(seed=0), steps=2000)
    rets = []
    for itr in range(25):
        state, _ = ppo._train_iter(state, jax.numpy.asarray(1.0))
        stats = ppo._eval_iter(
            state, jax.random.fold_in(jax.random.PRNGKey(0), itr))
        rets.append(float(stats["ep_return"]))
    print("eval return per iteration:", [f"{r:.2f}" for r in rets])
    print(f"first {rets[0]:.2f}, last {rets[-1]:.2f}, mean of the last 5 "
          f"{sum(rets[-5:]) / 5:.2f}")


if __name__ == "__main__":
    main()
