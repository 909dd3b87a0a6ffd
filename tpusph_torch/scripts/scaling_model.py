"""Strong-scaling projection of the z-slab engine from one card, the
counterpart of `scripts/scaling_model.py`:

    python -m tpusph_torch.scripts.scaling_model

It reads files only (runs on the CPU) and keeps tpusph's model:

  t_step(N, D) = t_tier(N) · λ(N, D) / D                  a rank's own work
               + f_mig · tax_migsort(occ)
               + (1 − f_mig) · tax_skip(occ)              halo and migration machinery
               + t_link                                  the exchanges on the wire

  * t_tier(N): the one-rank ELIDED sharded bench
    (`TORCH_DIST_BENCH[_n{N}].json`, `bench_torch.py`'s sharded mode): the
    same engine as the machinery runs, with the machinery left out, its
    run one CUDA-graph replay as tpusph's tiers were scan-chained
    dispatches, so full − tier is the machinery alone. The chained
    single-card rate (`bench_torch.py`'s line at N, kept as
    `scaling_torch/TORCH_BENCH_n{N}.json`) is printed beside the tables as
    what one card gives today. Each rate's busy share is printed: where it
    is low the run is bound by the host, and t_tier · λ / D, which
    assumes that a rank's time shrinks with its rows, holds less.
  * λ(N, D), the halo and migration rows and f_mig (the share of
    checkpoints where some rank has slab-crossers): the port's census
    (`slab_census.py`, `scaling_torch/census_n{N}.json`), trajectory
    maxima at the balanced partition, and at equal widths for the second
    table.
  * tax_migsort, tax_skip: the whole machinery on one rank
    (TPUSPH_DIST_FULL_MACHINERY=1) minus t_tier, with the category sort
    always taken (`TORCH_DIST_BENCH_FULL_MIGSORT[_n{N}].json`) and with
    the migration-free sort skip live (`TORCH_DIST_BENCH_FULL[_n{N}].json`);
    each a power law through its two measured points, charged at the
    right-sized occupancy λ·N/D × the margin.
  * capacities: the census maxima × the margin 1.3, rounded up to
    multiples of 256 as `DistSimulator.right_size` rounds them; wire bytes
    a boundary and direction from `multislice.halo_bytes_per_boundary`.
  * t_link: an ASSUMPTION, nothing of it was run (one card): NCCL over
    NVLink 4 of an H100 SXM, 900 GB/s both directions together by the
    data sheet, so 450 GB/s a direction, with 10 µs a collective and 4
    collectives a step (the halo and the migration exchange, the two
    all-reduces of the counters), serial with the compute.

Every input is a parameter of the functions, with the port's default, so
that tpusph's v5e inputs run through the same code. Writes
`scaling_torch/PROJECTION.json` (`scaling/` is tpusph's) and prints the
tables with the card's name and power limit as the artifacts record them.
"""

from __future__ import annotations

import json
import math
import os
import sys

from tpusph_torch.dist.multislice import halo_bytes_per_boundary
from tpusph_torch.dist.simulator import round_capacity

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCALING = os.path.join(REPO, "scaling_torch")
TIERS = (262_144, 1_048_576)  # the two measured points of each tax
DS = (2, 4, 8)
MARGIN = 1.3  # DistSimulator.right_size's margin for D >= 2
# the link: an assumption (NVIDIA H100 SXM data sheet), not a measurement
LINK_BYTES_PER_S = 450e9  # NVLink 4, 900 GB/s both directions together
LINK_COLLECTIVE_LATENCY_S = 10e-6
COLLECTIVES_PER_STEP = 4  # halo and migration exchanges, two counter all-reduces


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_artifact(n: int, suffix: str = "", root: str = REPO) -> str:
    """`bench_torch.py`'s sharded artifact at tier n: TORCH_DIST_BENCH
    + suffix (``, `_FULL`, `_FULL_MIGSORT`), `_n{N}` off the headline N."""
    return os.path.join(root, f"TORCH_DIST_BENCH{suffix}{'' if n == 262_144 else f'_n{n}'}.json")


def tier_ms_from_artifacts(root: str = REPO, tiers=TIERS) -> dict:
    """{N: ms a step} of the one-rank elided sharded bench at each tier."""
    out = {}
    for n in tiers:
        art = load_json(bench_artifact(n, root=root))
        assert not art["full_machinery"] and art["ranks"] == 1 and art["parity"] == "pass", art
        out[n] = 1000.0 / art["value"]
    return out


def machinery_tax_fit(artifact, tier_ms: dict, tiers=TIERS):
    """A power law tax(n) through the measured machinery tax at the two
    tiers: `artifact(n)` is the path of the whole machinery's bench at n,
    the tax its ms a step less `tier_ms[n]`. Returns (tax, points, p)."""
    pts = []
    for n in tiers:
        full = load_json(artifact(n))
        assert full["full_machinery"] and full["parity"] == "pass", full
        pts.append((n, 1000.0 / full["value"] - tier_ms[n]))
    (n0, t0), (n1, t1) = pts
    p = math.log(t1 / t0) / math.log(n1 / n0)
    scale = t1 / (n1**p)
    return (lambda n: scale * (n**p)), pts, p


def census_stats(n: int, variant: str = "bal", census_dir: str = SCALING):
    """Trajectory maxima of imbalance, halo and migration rows per D from
    `census_n{n}.json`, and the share of checkpoints where some rank
    migrates rows (the weight of the always-sort tax). variant "bal": the
    balanced partition's sub-census; "eq": equal-width slabs."""
    c = load_json(os.path.join(census_dir, f"census_n{n}.json"))
    out = {}
    for d in DS:
        rows = [r[str(d)] for r in c["rows"]]
        if variant == "bal":
            rows = [r.get("bal", r) for r in rows]
        out[d] = {
            "lambda": max(r["imbalance"] for r in rows),
            "halo_rows": max(r["max_halo_send"] for r in rows),
            "mig_rows": max(r["max_migration"] for r in rows),
            "mig_frac": sum(r["max_migration"] > 0 for r in rows) / len(rows),
        }
    return out, c


def right_size_capacity(rows: int, margin: float = MARGIN) -> int:
    """`DistSimulator.right_size`'s rule: rows × margin, rounded up to a
    multiple of 256, at least 256."""
    return round_capacity(max(rows, 1) * margin)


def project(
    n: int, tax_force, tax_skip, variant: str = "bal", *, tier_ms: dict,
    census_dir: str = SCALING, link_bytes_per_s: float = LINK_BYTES_PER_S,
    link_latency_s: float = LINK_COLLECTIVE_LATENCY_S,
    collectives: int = COLLECTIVES_PER_STEP, capacity=right_size_capacity,
    wire_bytes=halo_bytes_per_boundary, margin: float = MARGIN,
) -> dict:
    """Strong-scaling rows for global N over D in {1, 2, 4, 8}. `capacity`
    maps census rows to a buffer's capacity, `wire_bytes(halo_cap,
    mig_cap)` gives the bytes a boundary and direction a step."""
    stats, census = census_stats(n, variant, census_dir)
    t1 = tier_ms[n]
    rows = [{
        "d": 1, "ms_per_step": round(t1, 2), "steps_per_sec": round(1000.0 / t1, 1),
        "speedup": 1.0, "efficiency": 1.0, "lambda": 1.0, "tax_ms": 0.0, "link_us": 0.0,
    }]
    for d in DS:
        s = stats[d]
        lam = s["lambda"]
        n_dev = lam * n / d
        halo_cap = capacity(s["halo_rows"])
        mig_cap = capacity(s["mig_rows"])
        wire = wire_bytes(halo_cap, mig_cap)
        t_link = (collectives * link_latency_s + wire / link_bytes_per_s) * 1000.0
        # the checkpoints with slab-crossers pay the category sort, the
        # rest take the skip; both at the right-sized occupancy
        f = s["mig_frac"]
        occ = n_dev * margin
        t_tax = f * tax_force(occ) + (1.0 - f) * tax_skip(occ)
        t = t1 * lam / d + t_tax + t_link
        rows.append({
            "d": d, "ms_per_step": round(t, 2), "steps_per_sec": round(1000.0 / t, 1),
            "speedup": round(t1 / t, 2), "efficiency": round(t1 / t / d, 3),
            "lambda": round(lam, 3), "tax_ms": round(t_tax, 2), "mig_frac": round(f, 2),
            "link_us": round(t_link * 1000.0, 1), "halo_cap": halo_cap, "mig_cap": mig_cap,
            "wire_bytes": wire,
        })
    return {
        "n": n, "census_init": census["init"],
        "partition": "balanced" if variant == "bal" else "equal_width", "rows": rows,
    }


def _print_table(tbl: dict) -> None:
    print(f"\nN = {tbl['n']:,} (strong scaling, census init={tbl['census_init']}, "
          f"{tbl['partition']} partition):")
    print("  D   ms/step  steps/s  speedup  eff    lambda  tax_ms  link_us (assumed)")
    for r in tbl["rows"]:
        print(f"  {r['d']}  {r['ms_per_step']:8.2f} {r['steps_per_sec']:8.1f}"
              f"  {r['speedup']:6.2f}  {r['efficiency']:5.3f}"
              f"  {r['lambda']:6.3f}  {r['tax_ms']:6.2f}  {r['link_us']:6.1f}")


def main(argv=None, root: str = REPO, census_dir: str = SCALING,
         out_dir: str | None = None) -> dict:
    """The projection from the artifacts under `root` and the census under
    `census_dir`; writes PROJECTION.json to `out_dir` (default
    `census_dir`) and returns it."""
    argv = sys.argv[1:] if argv is None else argv
    tier_ms = tier_ms_from_artifacts(root)
    elided = {n: load_json(bench_artifact(n, root=root)) for n in TIERS}
    tax_force, pts_f, p_f = machinery_tax_fit(
        lambda n: bench_artifact(n, "_FULL_MIGSORT", root), tier_ms)
    tax_skip, pts_s, p_s = machinery_tax_fit(lambda n: bench_artifact(n, "_FULL", root), tier_ms)
    cards = sorted({load_json(bench_artifact(n, s, root)).get("card", "not recorded")
                    for n in TIERS for s in ("", "_FULL", "_FULL_MIGSORT")})
    busy = {n: elided[n].get("device_busy") for n in TIERS}
    chained = {}
    for n in TIERS:  # bench_torch.py's last line at n, where it was kept
        path = os.path.join(census_dir, f"TORCH_BENCH_n{n}.json")
        if os.path.exists(path):
            chained[n] = load_json(path)["value"]
    print(f"inputs measured on {'; '.join(cards)}")
    print("one card today, the chained single-card bench (CUDA graph): "
          + (", ".join(f"{n}: {v:.3f} timesteps/s" for n, v in chained.items())
             or "not recorded"))
    print("t_tier: the one-rank elided sharded bench (one graph replay a run), "
          + ", ".join(f"{n}: {t:.3f} ms ({1000 / t:.3f} timesteps/s, device busy "
                      f"{'not measured' if busy[n] is None else busy[n]})"
                      for n, t in tier_ms.items()))
    print("machinery tax (whole machinery on one rank minus t_tier):\n  always-sort: "
          + ", ".join(f"{n}: {t:.3f} ms" for n, t in pts_f) + f"  -> ~ n^{p_f:.2f}"
          + "\n  sort skipped on steps without crossers: "
          + ", ".join(f"{n}: {t:.3f} ms" for n, t in pts_s) + f"  -> ~ n^{p_s:.2f}")
    print(f"link (ASSUMED, not measured): {LINK_BYTES_PER_S / 1e9:.0f} GB/s a direction, "
          f"{LINK_COLLECTIVE_LATENCY_S * 1e6:.0f} us a collective, {COLLECTIVES_PER_STEP} "
          "collectives a step (NVLink 4 of an H100 SXM by the data sheet)")
    tables, tables_eq = [], []
    for n in sorted(tier_ms):
        if not os.path.exists(os.path.join(census_dir, f"census_n{n}.json")):
            print(f"\nN = {n:,}: no census_n{n}.json, no table")
            continue
        for variant, into in (("bal", tables), ("eq", tables_eq)):
            tbl = project(n, tax_force, tax_skip, variant, tier_ms=tier_ms,
                          census_dir=census_dir)
            into.append(tbl)
            _print_table(tbl)
    out = {
        "model": "t = t_tier(N)*lambda/D + mig_frac-weighted tax(n_dev*margin) + t_link",
        "cards": cards,
        "tier": "one-rank elided sharded bench, one graph replay a run "
                "(TORCH_DIST_BENCH[_n{N}].json)",
        "tier_ms": {str(n): round(t, 4) for n, t in tier_ms.items()},
        "tier_device_busy": {str(n): b for n, b in busy.items()},
        "chained_single_card_timesteps_per_s": {str(n): v for n, v in chained.items()},
        "tax_points_ms": {str(n): round(t, 3) for n, t in pts_f},
        "tax_skip_points_ms": {str(n): round(t, 3) for n, t in pts_s},
        "tax_exponent": round(p_f, 3),
        "tax_skip_exponent": round(p_s, 3),
        "link_assumption": {
            "what": "assumed, not measured: NCCL over NVLink 4, H100 SXM data sheet",
            "bytes_per_s_per_direction": LINK_BYTES_PER_S,
            "collective_latency_s": LINK_COLLECTIVE_LATENCY_S,
            "collectives_per_step": COLLECTIVES_PER_STEP,
        },
        "tables": tables,
        "tables_equal_width": tables_eq,
    }
    path = os.path.join(out_dir or census_dir, "PROJECTION.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nwrote {path}")
    return out


if __name__ == "__main__":
    main()
