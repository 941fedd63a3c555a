"""Write the terrain banks of the JAX env to
`apex_tpu_torch/data/terrain_banks.npz`, which the port reads
(`apex_tpu_torch/utils/terrain.py` terrain_bank). Runs on the CPU:

    JAX_PLATFORMS=cpu python scripts/export_terrain_banks.py

`apex_tpu.envs.cassie.CassieEnv` draws 64 terrain tables per kind from
fixed keys (PRNGKey 11 noise, 22 hill, 33 steps; envs/cassie.py:209-229).
The file holds each kind's draws before the generators' amplitude scaling,
as (64, 32, 32) float32: for noise and hill the smoothed, centred noise
(`noise_hfield` up to its last line), for steps the resized coarse grid
(`steps_hfield` at step height 1). The script then checks that the port's
scaling of the file gives the JAX env's bank, bit for bit, at the default
amplitude and at one other.
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from apex_tpu.envs.cassie import CassieEnv  # noqa: E402
from apex_tpu.physics.engine import HFIELD_RES  # noqa: E402
from apex_tpu.utils.terrain import steps_hfield  # noqa: E402
from apex_tpu_torch.utils import terrain  # noqa: E402

SEEDS = {"noise": 11, "hill": 22, "steps": 33}


def centred_noise(rng, smoothness: int):
    """`apex_tpu.utils.terrain.noise_hfield` without its amplitude
    scaling: the same draws, smoothing and centring."""
    h = jax.random.uniform(rng, (HFIELD_RES, HFIELD_RES), minval=-1.0,
                           maxval=1.0)
    kernel = jnp.ones((smoothness, smoothness)) / (smoothness ** 2)
    for _ in range(2):
        h = jax.scipy.signal.convolve2d(h, kernel, mode="same")
    return h - h.mean()


def main():
    banks = {}
    for kind, seed in SEEDS.items():
        keys = jax.random.split(jax.random.PRNGKey(seed), 64)
        if kind == "steps":
            gen = lambda k: steps_hfield(k, step_height=1.0)
        else:
            gen = lambda k, s=terrain.SMOOTHNESS[kind]: centred_noise(k, s)
        banks[kind] = np.asarray(jax.jit(jax.vmap(gen))(keys), np.float32)
    out = ROOT / "apex_tpu_torch" / "data" / "terrain_banks.npz"
    np.savez_compressed(out, **banks)
    terrain._bank_rows.cache_clear()
    for kind in SEEDS:
        for amp in (0.05, 0.08):
            ref = np.asarray(CassieEnv(terrain=kind,
                                       terrain_amplitude=amp)._terrain_bank)
            got = terrain.terrain_bank(kind, amp).numpy()
            diff = float(np.abs(got - ref).max())
            print(f"{kind} amplitude {amp}: max |port - JAX| {diff:.3e}, "
                  f"bitwise equal {np.array_equal(got, ref)}")
    print(f"wrote {out} ({out.stat().st_size} bytes)")


if __name__ == "__main__":
    torch.set_num_threads(1)
    main()
