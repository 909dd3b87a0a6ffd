"""The correctness check on the CPU at 4,096 particles: the reference
against the port's plain path, the control and the faults failing the
cells' limits, and a whole run with the timed path broken underneath."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from sphbench import compare, run
from sphbench.reference import sph
from sphbench.registry import Benchmark
from sphbench.window import Record

from conftest import REPO, TINY

STEPS = 20


@pytest.fixture(scope="module")
def config():
    c = json.loads((REPO / "sphbench" / "configs" / "dambreak-grid-262k.json").read_text())
    c["num_particles"] = TINY
    return c


@pytest.fixture(scope="module")
def grid():
    return Benchmark().init("grid")


@pytest.fixture(scope="module")
def start(config, grid):
    return grid.start(config, 2**31 + 5, "cpu")


@pytest.fixture(scope="module")
def reference(config, start):
    return sph.run(start["position"], config, STEPS, velocity=start["velocity"])


def test_initial_state_is_the_lattice_plus_a_small_jitter(config, grid, start):
    pos = start["position"]
    again = grid.start(config, 2**31 + 5, "cpu")["position"]
    other = grid.start(config, 7, "cpu")["position"]
    assert torch.equal(pos, again) and not torch.equal(pos, other)
    nx = grid.lattice_nx(config)
    assert nx == 109
    assert torch.allclose(pos[nx + 1], torch.tensor([0.1, 0.19, 0.19]), atol=1.001e-4)
    assert (pos - other).abs().max() <= 2e-4
    assert not start["velocity"].any()


@pytest.mark.parametrize("loop", ["chain", "timed"])
def test_reference_agrees_with_the_ports_plain_path(config, start, reference, loop):
    """Each loop of the port on the CPU (the kernels' plain versions)
    against the reference, after the same steps from the same state, by
    the loop's own numbers."""
    ref = {k: v.numpy() for k, v in reference.items() if k != "pairs"}
    module = Benchmark().loop(loop)
    ported = module.Loop(config, {"steps": STEPS}, start, "cpu")
    n = module.numbers(ported.result(ported.run(Record())), ref, config)
    assert n and all(v < 1e-4 for v in n.values()), n
    assert all(v < 1e-5 for k, v in n.items() if not k.startswith("density")), n


@pytest.mark.parametrize("cell", ["tiny-chain", "tiny-timed"])
def test_the_bfloat16_control_fails_the_cells_limits(tiny, cell):
    """The control judged in the port's place, through the path that
    decides `correct` in every run."""
    out = run.execute(Benchmark(tiny), cell, 11, 0.0, False, device="cpu", control=True)
    assert out.line["correct"] is False, out.err
    assert out.numbers.keys() == out.line["compared"].keys()


def _moved(x, y, z, where: str):
    """Move one particle by 1.0 (ten h) along z, toward the box's middle:
    `column`, the one at the 90th percentile of height, inside the column
    that still falls as a lattice; `pile`, the middle row, in the pile on
    the floor."""
    i = int(torch.argsort(y)[int(0.9 * y.shape[0])]) if where == "column" else y.shape[0] // 2
    z[i] += 1.0 if z[i] < 5.0 else -1.0


def _broken(monkeypatch, bench: Benchmark, fault: str, where: str = "column"):
    """Break the port underneath the harness: `unchanged` (a run returns
    its state as it came), `half` (half of the particles left where they
    were), `altered` (one particle's answer moved, `_moved`)."""
    chain_module = bench.loop("chain")
    real_chain = chain_module.make_fields_chain

    def make_chain(cfg, steps, device):
        chain = real_chain(cfg, steps, device)

        def broken(fs):
            out, ovf = chain(fs)
            if fault == "unchanged":
                return fs, ovf
            rows = [t.clone() for t in out]
            if fault == "half":
                half = rows[0].shape[0] // 2
                for dst, src in zip(rows[:6], fs[:6]):
                    dst[half:] = src[half:]
            else:
                v = out.valid
                x, y, z = (r[v] for r in rows[:3])
                _moved(x, y, z, where)
                rows[2][v] = z
            return type(out)(*rows), ovf

        return broken

    simulator = bench.loop("timed").Simulator
    real_step = simulator.simulate_and_time
    real_get = simulator.get_position

    def step(self, times):
        before = self.state
        real_step(self, times)
        if fault == "unchanged":
            self.state = before
        elif fault == "half":
            half = self.cfg.num_particles // 2
            for f in ("position", "velocity"):
                getattr(self.state, f)[half:] = getattr(before, f)[half:]

    def get_position(self):
        pos = real_get(self).copy()
        if fault == "altered":
            p = torch.from_numpy(pos)
            _moved(p[:, 0], p[:, 1], p[:, 2], where)
        return pos

    monkeypatch.setattr(chain_module, "make_fields_chain", make_chain)
    monkeypatch.setattr(simulator, "simulate_and_time", step)
    monkeypatch.setattr(simulator, "get_position", get_position)


@pytest.mark.parametrize("cell", ["tiny-chain", "tiny-timed"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_a_run_with_the_timed_path_broken_is_not_correct(tiny, monkeypatch, cell, fault):
    """The whole run but the look for a card, on the CPU: sound, it is
    correct; with each fault underneath, not."""
    bench = Benchmark(tiny)
    if fault:
        _broken(monkeypatch, bench, fault)
    out = run.execute(bench, cell, 11, 0.2, False, device="cpu")
    line, err = out.line, out.err
    assert line["correct"] is (fault is None), err
    assert line["attempted"] >= 1 and list(line)[-1] == "compared"
    assert err[-len(line["compared"]):] == [
        f"compared {k} {v['value']!r} limit {v['limit']!r}" for k, v in line["compared"].items()]


def test_a_traced_run_reports_the_layers_and_the_trace(tiny):
    line = run.execute(Benchmark(tiny), "tiny-timed", 12, 0.2, True, device="cpu").line
    assert line["correct"] and line["attempted"] == 2
    assert {"sim.copy_ms", "sim.compute_ms", "graph.capture_s"} <= set(line["metrics"])
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result_and_no_jax():
    """Run as the driver runs it, on a machine without a card: exit 2 and
    no line; the harness's pieces, run on the CPU, load neither JAX nor
    the JAX package."""
    p = subprocess.run([sys.executable, "-m", "sphbench.run", "--workload", "grid262k-chain100",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 2 and p.stdout == "", (p.returncode, p.stdout, p.stderr)
    code = ("import sys, json; from pathlib import Path; "
            "from conftest import tiny_root; import tempfile; "
            "from sphbench import run; from sphbench.registry import Benchmark; "
            "root = tiny_root(Path(tempfile.mkdtemp()), steps=3); "
            "run.execute(Benchmark(root), 'tiny-chain', 3, 0.1, True, device='cpu'); "
            "print(json.dumps(run.forbidden_modules()))")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300, env={**os.environ,
                                         "PYTHONPATH": f"{REPO}:{REPO / 'sphbench' / 'tests'}"})
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.splitlines()[-1]) == []


def test_no_result_from_the_benchmarks_files_alone(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run fails and prints nothing on standard output."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "sphbench", tmp_path / "sphbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "sphbench.run", "--workload", "grid262k-chain100",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout == "", (p.returncode, p.stdout)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    import ast

    banned = {"jax", "jaxlib", "flax", "tpusph", "bench", "bench_torch", "chip_smoke"}
    for path in (REPO / "sphbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, (path, name)
                if "reference" in path.parts:
                    assert top != "tpusph_torch", (path, name)


def test_compare_flags_non_finite_and_missing_particles():
    pos = np.random.default_rng(0).uniform(1, 2, (50, 3))
    vel = np.zeros_like(pos)
    assert compare.phase_numbers(pos, vel, pos, vel, 0.01)["phase_gap_max"] == 0.0
    bad = pos.copy()
    bad[3] = np.nan
    assert compare.phase_numbers(bad, vel, pos, vel, 0.01)["phase_gap_max"] == float("inf")
    doubled = pos.copy()
    doubled[4] = doubled[5]  # one particle lost, another doubled
    assert compare.phase_numbers(doubled, vel, pos, vel, 0.01)["phase_gap_max"] > 0.01
    assert compare.judge({"a": 1.0}, {}) == (False, {})
    assert compare.judge({"a": 1.0, "b": 5.0}, {"a": 2.0})[0]
