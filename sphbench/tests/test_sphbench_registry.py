"""BENCHMARK.json and the files it names: every piece loads by name, and
every name, unit and field keeps to the benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest

from sphbench.registry import NAME, ROOT, UNIT, Benchmark

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE = re.compile(r"^[^\n\t]{1,200}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(LINE.match(w) for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in SPEC["configs"]] + WORKLOADS + [m["name"] for m in METRICS]
    names += [w["traffic"] for w in SPEC["workloads"]] + [w["config"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    for kind in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[kind]}) == len(SPEC[kind])
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    texts = [c["why"] for c in SPEC["configs"]] + [c["source"] for c in SPEC["configs"]]
    texts += [w["why"] for w in SPEC["workloads"]] + [m["layer"] for m in SPEC["per_layer"]]
    assert all(LINE.match(t) for t in texts)


def test_entries_have_just_the_contract_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in WORKLOADS:
        own = [m for m in METRICS if w in m.get("workloads", WORKLOADS)]
        assert "setup_s" in {m["name"] for m in own}
        assert len([m for m in own if m["name"] in e2e]) >= 2
        assert [m for m in own if m["name"] not in e2e]
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", WORKLOADS):
            assert w in moved.get("workloads", WORKLOADS), (m["name"], w)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_cell_loads_its_files_by_name(workload):
    bench = Benchmark()
    cell = bench.cell(workload)
    assert cell.config["name"] == next(w for w in SPEC["workloads"]
                                       if w["name"] == workload)["config"]
    assert cell.traffic["steps"] > 0
    loop = bench.loop(cell.traffic["loop"])
    assert callable(loop.Loop) and callable(loop.numbers)
    assert callable(bench.init(cell.config["init"]).start)
    assert cell.limits, f"no limits/{workload}.json"
    for m in cell.end_to_end + cell.per_layer:
        assert callable(bench.reader(m.name))


def test_configuration_files_hold_what_is_run():
    for c in SPEC["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"] and config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(config["assumed"])
        assert config["precision"] == "float32" and config["init"] == "grid"
        assert c["file"].startswith(SPEC["paths"][0] + "/")


def test_stages_cover_the_kernels_and_do_not_overlap():
    stages = Benchmark().stages()
    assert {"build", "density", "force"} <= set(stages)
    # names as the profiler gave them on the H100 (torch 2.11), cut short
    names = {
        "tpusph::(anonymous namespace)::density_tile_kernel(tpusph::(anonymous": "density",
        "tpusph::(anonymous namespace)::force_tile_kernel(tpusph::(anonymous": "force",
        "tpusph::(anonymous namespace)::qrank_block_kernel(int const*, int": "build",
        "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_detail": "build",
        "void at::native::_scatter_gather_elementwise_kernel<128, 8, at::native::"
        "_cuda_scatter_gather_internal_kernel<false, at::native::OpaqueType<4>": "build",
        "void at::native::index_elementwise_kernel<128, 4, at::native::gpu_index_kernel"
        "<at::native::index_kernel_impl<at::native::OpaqueType<4> >": "build",
        "void at::native::index_elementwise_kernel<128, 4, at::native::"
        "index_copy_kernel_impl<at::native::OpaqueType<4> >": None,
        "void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous "
        "namespace)::where_kernel_impl": None,
    }
    for name, stage in names.items():
        hits = [s for s, pats in stages.items() if any(p.search(name) for p in pats)]
        assert hits == ([stage] if stage else []), name


def test_a_throwaway_configuration_and_cell_load_from_files_only(tiny):
    bench = Benchmark(tiny)
    for cell in ("tiny-chain", "tiny-timed"):
        c = bench.cell(cell)
        assert c.config["num_particles"] == 4096 and c.limits
        assert {m.name for m in c.end_to_end} >= {"timesteps_per_s", "setup_s"}
    assert bench.cell("grid262k-chain100").config["num_particles"] == 262144
    with pytest.raises(KeyError, match="loops/nothing.py"):
        bench.loop("nothing")


CUBE_INIT = """
import torch


def start(config, seed, device):
    n = int(config["num_particles"])
    side = round(n ** (1 / 3))
    i = torch.arange(n, device=device)
    cells = torch.stack([i // (side * side), (i // side) % side, i % side], 1).float()
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pos = 3.0 + 0.09 * cells + 1e-4 * torch.rand((n, 3), generator=gen, device=device)
    return {"position": pos, "velocity": torch.zeros_like(pos)}
"""


def test_a_loop_and_an_init_added_as_files_run_through_the_harness(tiny):
    """A start state and a loop that no code names, each a new file, and a
    configuration, a mix and a cell that name them: the harness runs the
    cell, judged by the new loop's own numbers."""
    from sphbench import run

    (tiny / "sphbench" / "inits" / "cube.py").write_text(CUBE_INIT)
    loops = tiny / "sphbench" / "loops"
    (loops / "chain_again.py").write_text((loops / "chain.py").read_text())
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    config = json.loads((tiny / "sphbench" / "configs" / "tiny.json").read_text())
    config.update(name="cube", init="cube")
    (tiny / "sphbench" / "configs" / "cube.json").write_text(json.dumps(config))
    spec["configs"].append({**spec["configs"][-1], "name": "cube",
                            "file": "sphbench/configs/cube.json"})
    (tiny / "sphbench" / "traffic" / "again10.json").write_text(
        json.dumps({"loop": "chain_again", "steps": 10, "trace_runs": 1}))
    spec["workloads"].append({"name": "cube-again", "config": "cube", "traffic": "again10",
                              "chips": 1, "why": "a test's throwaway"})
    (tiny / "sphbench" / "limits" / "cube-again.json").write_text(
        (tiny / "sphbench" / "limits" / "tiny-chain.json").read_text())
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run.execute(Benchmark(tiny), "cube-again", 5, 0.0, False, device="cpu")
    assert out.line["correct"], out.err
    assert set(out.line["compared"]) == {"phase_gap_max", "phase_gap_p99"}
    assert out.record.runs >= 1 and out.record.steps == 10 * out.record.runs
