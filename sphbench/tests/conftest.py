"""Fixtures of the benchmark's tests: a throwaway benchmark root made of
files only, and the card for the tests marked `gpu`."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
TINY = 4096


def tiny_root(tmp: Path, steps: int = 20, n: int = TINY) -> Path:
    """A benchmark root beside the real one: the real BENCHMARK.json and the
    sphbench data folders, plus a configuration `tiny` (the 262k scene at
    `n` particles), mixes `chain<steps>` and `timed<steps>`, and cells
    `tiny-chain` and `tiny-timed` with the limits of the 262k cells, each
    added as a file of its own and an entry."""
    src = REPO / "sphbench"
    dst = tmp / "sphbench"
    for sub in ("configs", "inits", "traffic", "loops", "metrics", "stages", "limits"):
        shutil.copytree(src / sub, dst / sub)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    config = json.loads((src / "configs" / "dambreak-grid-262k.json").read_text())
    config.update(name="tiny", num_particles=n)
    (dst / "configs" / "tiny.json").write_text(json.dumps(config))
    spec["configs"].append({"name": "tiny", "source": config["source"],
                            "file": "sphbench/configs/tiny.json", "reduced": ["num_particles"],
                            "why": "a test's throwaway"})
    for loop, real in (("chain", "grid262k-chain100"), ("timed", "grid262k-timed100")):
        (dst / "traffic" / f"{loop}{steps}.json").write_text(
            json.dumps({"loop": loop, "steps": steps, "trace_runs": 2}))
        cell = f"tiny-{loop}"
        spec["workloads"].append({"name": cell, "config": "tiny", "traffic": f"{loop}{steps}",
                                  "chips": 1, "why": "a test's throwaway"})
        shutil.copy(src / "limits" / f"{real}.json", dst / "limits" / f"{cell}.json")
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and real in m["workloads"]:
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture
def tiny(tmp_path) -> Path:
    return tiny_root(tmp_path)


@pytest.fixture
def cuda():
    """The card; skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
