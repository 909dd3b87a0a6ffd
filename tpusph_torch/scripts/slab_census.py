"""Slab census of the dam-break trajectory, the counterpart of
`scripts/slab_census.py`:

    python -m tpusph_torch.scripts.slab_census [N] [steps] [chunk] [--device cpu]

The scaling model (`tpusph_torch/scripts/scaling_model.py`) needs three
quantities that are physics, the same on any rank count and any device,
so one card measures them: it runs the single-card trajectory and cuts
the box into D virtual z-slabs at every checkpoint, for D in 2, 4, 8:

  * imbalance, the largest slab's rows over N / D (the slowest rank sets
    the step time);
  * the largest halo send, rows within 2h of a cut on one side;
  * the next step's migration, rows on one side of a cut whose z + vz·dt
    lies on the other.

A "bal" sub-census does the same in cell space over the balanced
partition (`sharded.balanced_slab_planes`) fixed from the step-0
snapshot, the partition `DistSimulator.setup` ships.

The configuration is `tuned_config(N)` with grid init up to the
lattice's capacity and random init above it. On a card the trajectory is
the benchmarked physics, the fields chain (`engine/step.py::
make_fields_chain`): one replay of `chunk` steps between snapshots of z,
vz and valid. On the CPU it is `step_cell_list`, whose tile candidate
capacity doubles and the chunk replays when a window overflows. Neither
depends on the rank count, so the census must reproduce tpusph's
`scaling/census_n{N}.json` (`compare` states how closely).

Writes `census_n{N}.json` with tpusph's keys, plus the card and the
backend that ran, to `scaling_torch/` (TPUSPH_BENCH_ARTIFACT_DIR where
set). `scaling/` holds the JAX package's census and is never written.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from tpusph_torch.core.config import tuned_config
from tpusph_torch.core.init import init_state, lattice_capacity
from tpusph_torch.dist.sharded import balanced_slab_planes
from tpusph_torch.scripts import device_card

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT_DIR = os.path.join(REPO, "scaling_torch")
DS = (2, 4, 8)
GROWTH_TRIES = 6  # capacity doublings before a chunk is given up
# how closely a census must reproduce another of the same trajectory
IMBALANCE_ATOL = 0.002
HALO_RTOL = 0.01


def census(z: np.ndarray, vz: np.ndarray, cfg, bal_planes: dict | None = None) -> dict:
    """Per-D slab occupancy, halo-band and next-step-crosser counts of one
    snapshot of the live rows. With `bal_planes` (D → cell-plane
    partition) a "bal" census in cell space too, mirroring the engine's
    plane ownership (`sharded._migration_predicates`) and 2-cell bands
    (`sharded._band_thresholds`)."""
    out = {}
    band = 2.0 * cfg.h
    C = cfg.num_cells_per_dim
    zc = np.clip((z / np.float32(cfg.h)).astype(np.int32), 0, C - 1)
    z2 = z + vz * cfg.dt
    zc2 = np.clip((z2 / np.float32(cfg.h)).astype(np.int32), 0, C - 1)
    for d in DS:
        edges = cfg.box_dim * np.arange(1, d) / d
        slab = np.minimum((z / (cfg.box_dim / d)).astype(np.int64), d - 1)
        counts = np.bincount(slab, minlength=d)
        halo_up = halo_dn = mig = 0
        for e in edges:
            # the sender's rows within 2h of the cut, each side
            halo_up = max(halo_up, int(np.sum((z >= e - band) & (z < e))))
            halo_dn = max(halo_dn, int(np.sum((z >= e) & (z < e + band))))
            # the next step's one-hop crossers
            mig = max(mig, int(np.sum((z < e) & (z2 >= e))), int(np.sum((z >= e) & (z2 < e))))
        out[str(d)] = {
            "max_slab": int(counts.max()),
            "min_slab": int(counts.min()),
            "imbalance": round(float(counts.max()) / (len(z) / d), 4),
            "max_halo_send": int(max(halo_up, halo_dn)),
            "max_migration": int(mig),
        }
        if bal_planes is not None:
            interior = np.asarray(bal_planes[d][1:-1], np.int64)
            counts_b = np.bincount(np.searchsorted(interior, zc, side="right"), minlength=d)
            bh = bm = 0
            for e in interior:
                # the 2-cell send bands on either side of the plane
                bh = max(bh, int(np.sum((zc >= e - 2) & (zc < e))),
                         int(np.sum((zc >= e) & (zc < e + 2))))
                bm = max(bm, int(np.sum((zc < e) & (zc2 >= e))),
                         int(np.sum((zc >= e) & (zc2 < e))))
            out[str(d)]["bal"] = {
                "max_slab": int(counts_b.max()),
                "imbalance": round(float(counts_b.max()) / (len(z) / d), 4),
                "max_halo_send": int(bh),
                "max_migration": int(bm),
            }
    return out


def _paired(got: dict, want: dict):
    """(label, got's counts, want's counts) for every checkpoint, D and
    partition (equal-width "eq", balanced "bal") that both censuses hold."""
    want_rows = {r["step"]: r for r in want["rows"]}
    for row in got["rows"]:
        ref = want_rows.get(row["step"])
        for d in DS if ref is not None else ():
            for part in ("eq", "bal"):
                a = row[str(d)] if part == "eq" else row[str(d)].get("bal")
                b = ref[str(d)] if part == "eq" else ref[str(d)].get("bal")
                if a is not None and b is not None:
                    yield f"step {row['step']} D={d} {part}", a, b


def compare(got: dict, want: dict) -> list[str]:
    """The differences between two censuses of the same trajectory beyond
    the bars: the same checkpoints; at each, equal-width and balanced,
    imbalance within IMBALANCE_ATOL, the largest halo send within
    HALO_RTOL of `want`'s, the migration equal. Empty where they agree."""
    steps = [[r["step"] for r in c["rows"]] for c in (got, want)]
    if steps[0] != steps[1]:
        return [f"checkpoints {steps[0]} against {steps[1]}"]
    bad = []
    for where, a, b in _paired(got, want):
        if abs(a["imbalance"] - b["imbalance"]) > IMBALANCE_ATOL:
            bad.append(f"{where}: imbalance {a['imbalance']} against {b['imbalance']}")
        if abs(a["max_halo_send"] - b["max_halo_send"]) > HALO_RTOL * b["max_halo_send"]:
            bad.append(f"{where}: halo {a['max_halo_send']} against {b['max_halo_send']}")
        if a["max_migration"] != b["max_migration"]:
            bad.append(f"{where}: migration {a['max_migration']} against {b['max_migration']}")
    return bad


def differences(got: dict, want: dict) -> list[str]:
    """Every count that differs at all between two censuses, for the record
    (`compare` says which are beyond the bars)."""
    return [f"{where} {k}: {a[k]} against {b[k]}" for where, a, b in _paired(got, want)
            for k in sorted(set(a) & set(b)) if k != "bal" and a[k] != b[k]]


def _chain_chunks(cfg, state0, chunk: int, device):
    """(backend name, advance(carry) -> carry, snapshot(carry) -> (z, vz,
    valid) numpy, first carry): the fields chain on a card, the tile
    passes with grow-and-replay on the CPU."""
    from tpusph_torch.engine.step import fields_from_state, make_fields_chain, step_cell_list

    if device.type == "cuda":
        chain = make_fields_chain(cfg, chunk, device)

        def advance(fs):
            nxt, ovf = chain(fs)
            if int(ovf):
                raise RuntimeError(f"the fields chain overflowed ({int(ovf)})")
            return nxt

        def snapshot(fs):
            return tuple(a.cpu().numpy() for a in (fs.z, fs.vz, fs.valid))

        return "kernels", advance, snapshot, fields_from_state(state0)

    grown = [cfg]

    def advance(state):
        # a pile-up can overflow the candidate capacity mid-trajectory:
        # rewind to the chunk's start, double it, replay the same chunk
        for _ in range(GROWTH_TRIES):
            c, ovf, out = grown[0], 0, state
            for _ in range(chunk):
                out, aux = step_cell_list(out, c)
                ovf += int(aux.window_overflow)
            if ovf == 0:
                return out
            grown[0] = dataclasses.replace(c, tile_cand_capacity=c.tile_cand_capacity * 2)
            print(f"capacity overflow; growing tile_cand_capacity to "
                  f"{grown[0].tile_cand_capacity}", flush=True)
        raise RuntimeError("capacity growth did not converge")

    def snapshot(state):
        return tuple(a.numpy() for a in (state.position[:, 2], state.velocity[:, 2],
                                         state.valid))

    return "cell_list", advance, snapshot, state0


def run(n: int, steps: int, chunk: int, device) -> dict:
    """The census of `steps` steps of N = n, a checkpoint every `chunk`."""
    device = torch.device(device)
    cfg = tuned_config(n)
    random_init = n > lattice_capacity(cfg)
    state0 = init_state(cfg, random_init=random_init, device=device)
    backend, advance, snapshot, carry = _chain_chunks(cfg, state0, chunk, device)
    rows, bal_planes = [], None
    t0 = time.perf_counter()
    for done in range(0, steps + 1, chunk):
        z, vz, valid = snapshot(carry)
        alive = valid.astype(bool)
        if bal_planes is None:
            # the balanced partition of the initial snapshot, held fixed
            bal_planes = {d: balanced_slab_planes(z[alive], cfg, d) for d in DS}
        row = {"step": done, "n_alive": int(alive.sum())}
        row.update(census(z[alive], vz[alive], cfg, bal_planes))
        rows.append(row)
        print(f"step {done:4d}: " + "  ".join(
            f"D={d} imb={row[str(d)]['imbalance']:.3f}/bal={row[str(d)]['bal']['imbalance']:.3f} "
            f"halo={row[str(d)]['max_halo_send']} mig={row[str(d)]['max_migration']}"
            for d in DS), flush=True)
        if done < steps:
            carry = advance(carry)
    wall = time.perf_counter() - t0
    return {
        "n": n, "steps": steps, "chunk": chunk, "backend": backend,
        "init": "random" if random_init else "grid", "band_2h": 2.0 * cfg.h,
        "bal_planes": {str(d): list(p) for d, p in bal_planes.items()},
        "rows": rows, "wall_s": round(wall, 1),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": device_card(device),
    }


def main(argv=None, out_dir: str | None = None) -> dict:
    """Runs the census and writes `census_n{N}.json` to `out_dir`
    (default: TPUSPH_BENCH_ARTIFACT_DIR, else `scaling_torch/`)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    n = int(argv[0]) if argv else 262_144
    steps = int(argv[1]) if len(argv) > 1 else 100
    chunk = int(argv[2]) if len(argv) > 2 else 10
    out = run(n, steps, chunk, device)
    out_dir = out_dir or os.environ.get("TPUSPH_BENCH_ARTIFACT_DIR") or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"census_n{n}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path} ({out['wall_s']} s; {out['card']})", flush=True)
    return out


if __name__ == "__main__":
    main()
