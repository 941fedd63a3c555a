"""Write the heightfield terrains of the JAX 5k robustness matrix to
`apex_tpu_torch/data/terrains_5k.npz`, which the port's 5k suite reads
(`apex_tpu_torch/runtime/eval_suites.py` _terrain_config). Runs on the
CPU:

    JAX_PLATFORMS=cpu python scripts/export_5k_terrains.py

`apex_tpu.runtime.eval_suites._terrain_config` draws noise1-3 (amplitude
0.04, smoothness 2) and hill1-3 (0.15, 8) with
`noise_hfield(fold_in(PRNGKey(seed), sha256(name)))`; torch cannot draw
jax.random's numbers, so the file holds the six seed-0 tables as
(32, 32) float32 arrays, keyed by name. The script then checks that the
port's `_terrain_config` gives the JAX one for all eleven terrain names,
bit for bit, with the same tilts.
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from apex_tpu.runtime import eval_suites as jax_suites  # noqa: E402
from apex_tpu_torch.runtime import eval_suites  # noqa: E402

TABLES = ("noise1", "noise2", "noise3", "hill1", "hill2", "hill3")


def main():
    tables = {}
    for name in TABLES:
        needs_hf, table, _ = jax_suites._terrain_config(name, seed=0)
        assert needs_hf
        tables[name] = np.asarray(table, np.float32)
    out = eval_suites.TERRAINS_5K
    np.savez_compressed(out, **tables)
    eval_suites._terrain_tables.cache_clear()
    for name in jax_suites.DEFAULT_5K_TERRAINS:
        ref = jax_suites._terrain_config(name, seed=0)
        got = eval_suites._terrain_config(name, seed=0)
        same = (ref[0] == got[0] and ref[2] == got[2]
                and (ref[1] is None) == (got[1] is None)
                and (ref[1] is None or np.array_equal(
                    np.asarray(ref[1], np.float32), got[1])))
        print(f"{name}: hfield {got[0]}, tilt (y, x) {got[2]}, equal to "
              f"the JAX terrain {same}")
        assert same, name
    print(f"wrote {out} ({out.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
