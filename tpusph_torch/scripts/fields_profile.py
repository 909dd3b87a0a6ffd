"""Per-stage device time of the fields step (`step_kernels_fields`, what
`bench_torch.py` chains) at chosen steps of the trajectory, the
counterpart of `scripts/fields_profile.py`:

    python -m tpusph_torch.scripts.fields_profile [N] [steps ...]

N particles (262,144 by default; random init above the grid lattice's
capacity), at steps 0, 60 and 90 by default. Stages, each device ms by
`scripts.graph_ms` (10 calls in one CUDA graph, the median of 11 replays):
build (keys, sort, starts), density, press (pressure and masks), force
(and its masks), integ (integration and masks), and FULL, the whole step.
FULL minus the sum of the stages is the glue between them. The JAX
script's `supertile_columns` stage has no counterpart: the port's window
prep is the rank kernel's starts table, inside build. Prints one line a
step with the card's name and power limit.
"""

from __future__ import annotations

import sys

from tpusph_torch.core.config import tuned_config
from tpusph_torch.core.init import init_state, lattice_capacity
from tpusph_torch.engine.step import (
    fields_from_state,
    make_fields_chain,
    masked_force,
    masked_integrate,
    masked_pressure,
    step_kernels_fields,
)
from tpusph_torch.kernels.fused import density
from tpusph_torch.neighbors.cell_list import build_sorted_fields_1d
from tpusph_torch.scripts import card_line, cuda_device, graph_ms

STAGES = ("build", "density", "press", "force", "integ")


def stage_inputs(fs, cfg) -> dict:
    """Each stage's arguments at fields state `fs`, from one run of the
    stages in order: name → tuple. The last stage's output is the step's
    state."""
    fns = stages(cfg)
    sf = fns["build"](fs)
    raw = fns["density"](sf)
    rho_s, p_s = fns["press"](raw, sf.valid_sorted)
    fxyz = fns["force"](sf, rho_s, p_s)
    return {"build": (fs,), "density": (sf,), "press": (raw, sf.valid_sorted),
            "force": (sf, rho_s, p_s), "integ": (sf, fxyz, rho_s)}


def stages(cfg) -> dict:
    """name → the stage as a function of its arguments (`stage_inputs`)."""
    return {
        "build": lambda fs: build_sorted_fields_1d(*fs, cfg),
        "density": lambda sf: density(sf.x, sf.y, sf.z, sf.key_sorted, sf.starts, cfg),
        "press": lambda raw, valid_s: masked_pressure(raw, valid_s, cfg),
        "force": lambda sf, rho_s, p_s: masked_force(sf, rho_s, p_s, cfg),
        "integ": lambda sf, fxyz, rho_s: masked_integrate(sf, fxyz, rho_s, cfg),
    }


def profile_at(fs, cfg) -> dict:
    """Device ms of each stage and of the whole step at fields state `fs`."""
    args, fns = stage_inputs(fs, cfg), stages(cfg)
    ms = {name: graph_ms(lambda name=name: fns[name](*args[name])) for name in STAGES}
    ms["FULL"] = graph_ms(lambda: step_kernels_fields(fs, cfg))
    return ms


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 262_144
    steps = [int(s) for s in argv[1:]] or [0, 60, 90]
    dev = cuda_device()
    card = card_line()
    cfg = tuned_config(n)
    fs = fields_from_state(init_state(cfg, random_init=n > lattice_capacity(cfg), device=dev))
    out, done = {}, 0
    for target in steps:
        if target > done:
            fs, ovf = make_fields_chain(cfg, target - done, dev)(fs)
            if int(ovf):
                raise RuntimeError(f"overflow {int(ovf)} on the way to step {target}")
            done = target
        ms = profile_at(fs, cfg)
        named = sum(v for k, v in ms.items() if k != "FULL")
        print(f"fields step {target} (N={n}, device ms): "
              + "  ".join(f"{k}={v:.4f}" for k, v in ms.items())
              + f" | sum={named:.4f} glue={ms['FULL'] - named:.4f}; {card}", flush=True)
        out[target] = ms
    return out


if __name__ == "__main__":
    main()
