"""Free-mode frame time on one card, the counterpart of
`scripts/freemode_bench.py`: the double-buffered (async) frame loop
against the sequential one (TPUSPH_VIZ_SYNC=1), unchunked and chunked
(S steps a dispatch, packed pixels, raw positions and bitmaps):

    python -m tpusph_torch.scripts.freemode_bench [N] [frames] [mode-substring]

N = 65,536 and 60 frames by default; the third argument keeps the modes
whose name holds it (e.g. `bitmap`), and with `interactive` in it also
times the interactive window's ticks under matplotlib's Agg backend (tick
and a whole canvas draw: everything the live window pays but the blit).
Each mode: ms a frame of `run_free_mode` after a warm-up run of the same
mode (its CUDA graphs captured), printed with the card's name and power
limit.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time

from tpusph_torch.core.config import tuned_config
from tpusph_torch.engine.simulator import Simulator
from tpusph_torch.scripts import card_line, cuda_device
from tpusph_torch.viz.render import run_free_mode

# (name, sync, steps a dispatch (0: unchunked), TPUSPH_VIZ_PACK)
MODES = (
    [("sync", True, 0, "1"), ("async", False, 0, "1")]
    + [(f"chunk{s}", False, s, "1") for s in (4, 8, 16)]
    + [("chunk8 xyz", False, 8, "0")]
    + [(f"chunk{s} bitmap", False, s, "bitmap") for s in (8, 16)]
)
VIZ_VARS = ("TPUSPH_VIZ_SYNC", "TPUSPH_VIZ_CHUNK", "TPUSPH_VIZ_PACK")


@contextlib.contextmanager
def viz_env(sync: bool, chunk: int, pack: str | None):
    """TPUSPH_VIZ_SYNC / _CHUNK / _PACK set for one mode (unset where
    None), restored after."""
    saved = {var: os.environ.get(var) for var in VIZ_VARS}
    wanted = ("1" if sync else None, str(chunk) if chunk > 1 else None, pack)
    try:
        for var, val in zip(VIZ_VARS, wanted):
            os.environ.pop(var, None)
            if val is not None:
                os.environ[var] = val
        yield
    finally:
        for var, val in saved.items():
            os.environ.pop(var, None)
            if val is not None:
                os.environ[var] = val


def run(n: int, frames: int, sync: bool, chunk: int = 0, pack: str = "1",
        device="cuda") -> float:
    """Seconds a frame of headless free mode in one mode, after a warm-up
    run of at least 4 frames (a whole chunk at least)."""
    if chunk > 1:
        frames -= frames % chunk  # the steady state: no tail chunk of another size
    with viz_env(sync, chunk, pack), tempfile.TemporaryDirectory() as d:
        sim = Simulator(tuned_config(n), device=device)
        sim.setup()
        run_free_mode(sim, frames=max(4, chunk), out_dir=d)  # capture and warm
        t0 = time.perf_counter()
        run_free_mode(sim, frames=frames, out_dir=d)
        dt = time.perf_counter() - t0
    return dt / frames


def run_interactive(n: int, frames: int, sync: bool, device="cuda") -> float:
    """Seconds a tick of the interactive window (`_build_interactive`'s
    tick and a canvas draw under Agg), after 3 warm-up ticks."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    from tpusph_torch.viz.render import _build_interactive

    with viz_env(sync, 0, None):  # the frame stream's default for N
        sim = Simulator(tuned_config(n), device=device)
        sim.setup()
        fig, tick, _ = _build_interactive(sim)
        try:
            for k in range(3):
                tick(k)
                fig.canvas.draw()
            t0 = time.perf_counter()
            for k in range(frames):
                tick(k)
                fig.canvas.draw()
            dt = time.perf_counter() - t0
        finally:
            plt.close(fig)
    return dt / frames


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 65_536
    frames = int(argv[1]) if len(argv) > 1 else 60
    pick = argv[2] if len(argv) > 2 else None
    dev = cuda_device()
    card = card_line()
    out = {}
    for name, sync, chunk, pack in MODES:
        if pick is not None and pick not in name:
            continue
        per = run(n, frames, sync, chunk, pack, dev)
        out[name] = per * 1e3
        print(f"{name:<14} frame time: {per * 1e3:8.3f} ms ({1 / per:7.1f} fps) at N={n}; "
              f"{card}", flush=True)
    if pick is not None and "interactive" in pick:
        for name, sync in (("interactive sync", True), ("interactive pipe", False)):
            per = run_interactive(n, frames, sync, dev)
            out[name] = per * 1e3
            print(f"{name:<14} tick time: {per * 1e3:8.3f} ms ({1 / per:7.1f} fps) at N={n}; "
                  f"{card}", flush=True)
    return out


if __name__ == "__main__":
    main()
