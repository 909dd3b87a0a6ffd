#!/usr/bin/env python3
"""Smoke run of tpusph_torch on one NVIDIA GPU (built for sm_90a: H100).

    python3 chip_smoke.py        # from the repository root

Phases, each of which raises on failure (exit code 1):
  1. device: needs torch.cuda; prints the card, CUDA version and the
     card's power limit as nvidia-smi reports it;
  2. build: compiles the CUDA kernels from tpusph_torch/csrc with nvcc;
  3. kernels against their plain PyTorch versions on the card, at the
     main path's shapes (262,144 particles, grid init, at step 0 and after
     20 steps): ranks exact, density rtol 1e-5, force rtol 1e-4 atol 1e-4;
     prints each kernel's time beside the plain version's;
  4. parity at N = 4096: one kernel step against the NumPy oracle
     (tests/oracle_numpy.py: density rtol 1e-4, positions atol 1e-5), and
     10 chained kernel steps against 10 plain steps on the CPU,
     multiset-compared (density rtol 1e-4, positions atol 1e-4);
  5. the main path through the user's entry points: Simulator at 262,144
     particles, 3 warm-up steps and 100 timed `simulate_and_time` steps;
     prints the Times table and timesteps/s, checks that each kernel was
     launched, that no particle left the grid and that the state is
     finite.
It then prints one JSON line of per-kernel results and, last, one JSON
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_MAIN = 262_144
N_PARITY = 4096
TIMED_STEPS = 100
WARMUP_STEPS = 3


def require(ok, msg: str) -> None:
    """Fail the run (an `assert` would vanish under `python -O`)."""
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Median over `reps` batches of 10 back-to-back calls, in ms per call,
    from CUDA events on the current stream (wrapper overhead included)."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / 10)
    return statistics.median(samples)


def canon(pos, *fields):
    """Order particle records by position (a multiset compare)."""
    order = np.lexsort(pos.T)
    return (pos[order],) + tuple(f[order] for f in fields)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this runs only on a GPU",
              file=sys.stderr)
        return 1

    from tpusph_torch.bench.times import Times, format_times
    from tpusph_torch.core.config import default_config, tuned_config
    from tpusph_torch.core.init import init_state
    from tpusph_torch.engine.simulator import Simulator
    from tpusph_torch.engine.step import build_phase, make_step
    from tpusph_torch.kernels import fused, qrank
    from tpusph_torch.physics.kernels import pressure_from_density
    from tpusph_torch.utils import cuda_build

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from oracle_numpy import oracle_step

    # ---------------------------------------------------------- 1. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    print(card)

    # ----------------------------------------------------------- 2. build
    path, build_s = cuda_build.build()
    cuda_build.library()
    print(f"build: {build_s:.2f} s -> {os.path.relpath(path, REPO)}")
    log = path.with_suffix(".log")
    for line in log.read_text().splitlines() if log.exists() else []:
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---------------------------------- 3. kernels against plain versions
    cfg = tuned_config(N_MAIN)
    nc = cfg.num_cells
    step = make_step(cfg, "kernels", dev)
    states = {0: init_state(cfg, device=dev)}
    st = states[0]
    for _ in range(20):
        st, _ = step(st)
    states[20] = st

    results = {
        "rank": dict(route="cuda", source="tpusph_torch/csrc/qrank.cu",
                     replaces="tpusph/pallas/qrank.py:234", fn=qrank.rank_queries),
        "density": dict(route="cuda", source="tpusph_torch/csrc/sph.cu",
                        replaces="tpusph/pallas/fused.py:1200", fn=fused.density),
        "force": dict(route="cuda", source="tpusph_torch/csrc/sph.cu",
                      replaces="tpusph/pallas/fused.py:1540", fn=fused.force),
    }
    for r in results.values():
        r["max_abs_err"] = 0.0
    for label, st in states.items():
        cl = build_phase(st, cfg)
        key, starts = cl.key_sorted, cl.starts
        cells = torch.arange(nc + 2, dtype=torch.int32, device=dev)
        rk, ovf = qrank.rank_queries(key, cells, nc)
        rp = qrank.rank_queries_plain(key, cells, nc)
        torch.testing.assert_close(rk, rp, rtol=0, atol=0)
        require(ovf == 0, f"rank overflow {ovf}")
        results["rank"]["max_abs_err"] = max(
            results["rank"]["max_abs_err"], float((rk - rp).abs().max()))

        xyz = st.position[cl.perm].T.contiguous()
        vxyz = st.velocity[cl.perm].T.contiguous()
        dk = fused.density(*xyz, key, starts, cfg)
        dp = fused.density_plain(*xyz, key, starts, cfg)
        torch.testing.assert_close(dk, dp, rtol=1e-5, atol=0)
        results["density"]["max_abs_err"] = max(
            results["density"]["max_abs_err"], float((dk - dp).abs().max()))

        rho, p = pressure_from_density(dk, cfg)
        rho = torch.where(cl.valid_sorted, rho, 1.0)
        p = torch.where(cl.valid_sorted, p, 0.0)
        fk = fused.force(*xyz, *vxyz, rho, p, key, starts, cfg)
        fp = fused.force_plain(*xyz, *vxyz, rho, p, key, starts, cfg)
        torch.testing.assert_close(fk, fp, rtol=1e-4, atol=1e-4)
        results["force"]["max_abs_err"] = max(
            results["force"]["max_abs_err"], float((fk - fp).abs().max()))
        _, count = fused.windows(key, starts, cfg)
        print(f"step {label}: ranks equal; density max|err| "
              f"{float((dk - dp).abs().max()):.3e} (max rho {float(dk.max()):.3f}); "
              f"force max|err| {float((fk - fp).abs().max()):.3e} "
              f"(max |f| {float(fk.abs().max()):.3f}); widest window {int(count.max())}; "
              f"max p {float(p.max()):.3f}")

        if label == 20:  # time at the pile-up state
            calls = {
                "rank": (lambda: qrank.rank_queries(key, cells, nc),
                         lambda: qrank.rank_queries_plain(key, cells, nc)),
                "density": (lambda: fused.density(*xyz, key, starts, cfg),
                            lambda: fused.density_plain(*xyz, key, starts, cfg)),
                "force": (lambda: fused.force(*xyz, *vxyz, rho, p, key, starts, cfg),
                          lambda: fused.force_plain(*xyz, *vxyz, rho, p, key, starts, cfg)),
            }
            for name, (kern, plain) in calls.items():
                results[name]["ms"] = time_ms(kern, 21)
                results[name]["plain_ms"] = time_ms(plain, 5)
                print(f"time {name}: kernel {results[name]['ms']:.4f} ms, plain "
                      f"{results[name]['plain_ms']:.4f} ms per call (N={N_MAIN}, "
                      f"step 20; {card})")

    # ------------------------------------------------- 4. parity at 4096
    cfg4 = default_config(N_PARITY)
    s0 = init_state(cfg4, device=dev)
    s1, aux = make_step(cfg4, "kernels", dev)(s0)
    v = s0.valid.cpu().numpy()
    ref = oracle_step(s0.position.cpu().numpy()[v], s0.velocity.cpu().numpy()[v], cfg4)
    np.testing.assert_allclose(s1.density.cpu().numpy()[v], ref["density"], rtol=1e-4, atol=0)
    np.testing.assert_allclose(s1.position.cpu().numpy()[v], ref["position"], rtol=0, atol=1e-5)
    require(int(aux.oob_count) == 0, "particles outside the grid at N=4096")
    print(f"parity N={N_PARITY}: 1 kernel step matches the NumPy oracle")

    sg, sc = s0, init_state(cfg4, device="cpu")
    step_gpu, step_cpu = make_step(cfg4, "kernels", dev), make_step(cfg4, "kernels", "cpu")
    for _ in range(10):
        sg, _ = step_gpu(sg)
        sc, _ = step_cpu(sc)
    vg, vc = sg.valid.cpu().numpy(), sc.valid.numpy()
    require(vg.sum() == vc.sum() == N_PARITY, "valid slots differ")
    pa, ra = canon(sg.position.cpu().numpy()[vg], sg.density.cpu().numpy()[vg])
    pb, rb = canon(sc.position.numpy()[vc], sc.density.numpy()[vc])
    np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ra, rb, rtol=1e-4, atol=0)
    print(f"parity N={N_PARITY}: 10 kernel steps match 10 plain steps on the CPU")

    # ------------------------------------------------------ 5. main path
    kernels = [qrank.rank_queries, fused.density, fused.force]
    for fn in kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    sim = Simulator(tuned_config(N_MAIN), device="cuda")
    sim.setup()
    warm = Times()
    for _ in range(WARMUP_STEPS):
        sim.simulate_and_time(warm)
    times = Times()
    worst_oob = worst_ovf = 0
    for _ in range(TIMED_STEPS):
        sim.simulate_and_time(times)
        worst_oob = max(worst_oob, int(sim.last_aux.oob_count))
        worst_ovf = max(worst_ovf, sim.last_aux.window_overflow)
    launches = {name: fn.launches for name, fn in zip(results, kernels)}
    print(format_times(times))
    phase_s = times.build_grid + times.sph_update + times.memcpy
    print(f"timesteps/s: {times.iters / phase_s:.3f} (N={N_MAIN} grid init, "
          f"{TIMED_STEPS} steps; {card})")
    print(f"peak device memory: {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    print(f"launches in the main path: {launches}")
    for name, n in launches.items():
        require(n > 0, f"{name} kernel was not launched by the main path")
    require(worst_oob == 0, f"{worst_oob} particles left the grid")
    require(worst_ovf == 0, f"window overflow {worst_ovf}")
    for f in ("position", "velocity", "force", "density", "pressure"):
        require(torch.isfinite(getattr(sim.state, f)).all(), f"non-finite {f}")
    pos = sim.get_position()
    require(pos.shape == (N_MAIN, 3) and np.isfinite(pos).all(), "bad host positions")
    lo, hi = cfg.h, cfg.box_dim - cfg.h
    require(pos.min() >= lo - 1e-6 and pos.max() <= hi + 1e-6, "particle outside the box")

    table = [
        {"name": name, "route": r["route"], "source": r["source"],
         "replaces": r["replaces"], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, r in results.items()
    ]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
