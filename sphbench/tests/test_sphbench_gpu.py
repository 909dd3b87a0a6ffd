"""On the card (marked `gpu`; they skip without one): the port, the
control and a planted fault at a size a test run holds, each through the
path that decides `correct`, and one short run of a cell as the driver
runs it."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from sphbench import run
from sphbench.registry import Benchmark

from conftest import REPO, tiny_root
from test_sphbench_correct import _broken

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The 262k scene at 65,536 particles (~5.5 x-planes), 100 steps a run,
    with the 262k cells' limits."""
    return tiny_root(tmp_path_factory.mktemp("bench"), steps=100, n=65536)


@pytest.mark.parametrize("cell", ["tiny-chain", "tiny-timed"])
@pytest.mark.parametrize("seed", [31, 2**31 + 17])
def test_port_passes_and_control_fails_at_65536(root, cuda, cell, seed):
    got = run.execute(Benchmark(root), cell, seed, 0.0, False, device=cuda)
    assert got.line["correct"] and got.record.failed == 0, got.err
    low = run.execute(Benchmark(root), cell, seed, 0.0, False, device=cuda, control=True)
    assert low.line["correct"] is False, low.err


@pytest.mark.parametrize("cell", ["tiny-chain", "tiny-timed"])
def test_one_particle_moved_inside_the_fluid_fails_the_widest_gap(root, cuda, monkeypatch,
                                                                  cell):
    """One answer moved by 1.0 along z inside the falling column, where the
    fluid surrounds it: the widest gap alone fails it (the p99 cannot)."""
    bench = Benchmark(root)
    _broken(monkeypatch, bench, "altered")
    out = run.execute(bench, cell, 43, 0.0, False, device=cuda)
    compared = out.line["compared"]
    widest = "phase_gap_max" if cell == "tiny-chain" else "position_gap_max"
    assert out.line["correct"] is False
    assert compared[widest]["value"] > compared[widest]["limit"], out.err
    p99 = widest.replace("max", "p99")
    assert compared[p99]["value"] <= compared[p99]["limit"], out.err


def test_a_cell_runs_as_the_driver_runs_it(cuda):
    p = subprocess.run([sys.executable, "-m", "sphbench.run", "--workload", "grid262k-chain100",
                        "--seed", "2147483651", "--seconds", "2", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.splitlines()[-1])
    assert line["correct"] and line["failed"] == 0 and line["device"]["platform"] == "gpu"
    assert {"timesteps_per_s", "run_ms_p95", "setup_s"} == set(line["metrics"])
