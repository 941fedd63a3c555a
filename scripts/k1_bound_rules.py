"""Which rounding bound holds K1 against its plain version, on the card.

K1 (`apex_tpu_torch/csrc/fleet_kernel.cu`) and `pd_substep_plain` round
differently (FMA contraction, CUDA's sinf/rsqrtf, the order of a few
products), and the solves through M + hD amplify that unevenly. Their
difference is held to 4x the plain version's spread under 1 +- 1e-7 input
changes (`fleet_kernel.plain_spread`). This script prints, for qpos, qvel,
qacc and the contact-force diag rows, the largest |K1 - plain| over that
bound when the spread is taken per row over the envs (the rule
`fleet_kernel.kernel_bounds` uses), per env over the rows, the smaller of
the two, or per element; with only qpos/qvel changed ("state") or every
input ("all"). A ratio above 1 means the rule does not bound the kernel.
Fleets: `chip_smoke.k1_inputs` (perturbed, with loose achilles rods) and
`chip_smoke.k1_standing_inputs` (calm), at B = 64 and 1024. Needs a CUDA
device:

    python3 scripts/k1_bound_rules.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from apex_tpu_torch.physics import fleet_kernel  # noqa: E402
from apex_tpu_torch.physics.cassie_sim import cassie_model  # noqa: E402
from apex_tpu_torch.physics.engine import PhysParams  # noqa: E402

RULES = {
    "row": lambda e: e.amax(1, keepdim=True),
    "env": lambda e: e.amax(0, keepdim=True),
    "min": lambda e: torch.minimum(e.amax(1, keepdim=True),
                                   e.amax(0, keepdim=True)),
    "element": lambda e: e,
}


def spread(m, params, qpos, qvel, rows, gen, every_input, draws=3):
    jit = lambda x: x * (1.0 + 1e-7 * (torch.randint(
        0, 2, x.shape, generator=gen) * 2.0 - 1.0).to(x.device))
    base = fleet_kernel.pd_substep_plain(m, params, qpos, qvel, rows)
    out = [torch.zeros_like(x) for x in base]
    for _ in range(draws):
        p, r = params, rows
        if every_input:
            p = PhysParams(**{k: jit(v) for k, v in vars(params).items()})
            r = jit(rows)
        new = fleet_kernel.pd_substep_plain(m, p, jit(qpos), jit(qvel), r)
        out = [torch.maximum(e, (n - b).abs())
               for e, n, b in zip(out, new, base)]
    return base, out


def ratios(got, ref, sp, rule):
    force = fleet_kernel.FORCE_DIAG_ROWS
    res = []
    for k, (a, r, e) in enumerate(zip(got, ref, sp)):
        if k == 3:
            a, r, e = a[force], r[force], e[force]
        bound = 4 * RULES[rule](e) + 1e-6 * (1.0 + r.abs())
        if k == 0:
            bound = torch.maximum(bound, 1e-5 + 1e-5 * r.abs())
        res.append(float(((a - r).abs() / bound).max()))
    return res


def main():
    if not torch.cuda.is_available():
        print("k1_bound_rules: no CUDA device", file=sys.stderr)
        return 2
    dev, m = torch.device("cuda"), cassie_model()
    gen = torch.Generator()
    gen.manual_seed(0)
    print("fleet B inputs rule: qpos qvel qacc force (max |K1 - plain| "
          "over the bound)")
    for B in (chip_smoke.N_ENVS, chip_smoke.FLEET):
        for name, make in (("perturbed", chip_smoke.k1_inputs),
                           ("standing", chip_smoke.k1_standing_inputs)):
            params, qpos, qvel, rows = make(B, gen, dev)
            got = fleet_kernel.pd_substep(m, params, qpos, qvel, rows)
            for every_input in (False, True):
                ref, sp = spread(m, params, qpos, qvel, rows, gen,
                                 every_input)
                for rule in RULES:
                    print(f"{name} {B} {'all' if every_input else 'state'} "
                          f"{rule}: " + " ".join(
                              f"{x:.3f}" for x in ratios(got, ref, sp, rule)),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
