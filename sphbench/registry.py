"""The benchmark's data, found by name.

`BENCHMARK.json` at the root names the cells (`workloads`), the
configurations and the metrics. Every other piece is a file of its own:

    configs/<config>.json     the scene as it is run (the entry's `file`)
    inits/<init>.py           a start state: `start(config, seed, device)`;
                              the configuration's `init` names it
    traffic/<traffic>.json    a traffic mix: the loop and its parameters
    loops/<loop>.py           a loop: `Loop(config, traffic, start, device)`
                              and `numbers(got, reference, config)`, the
                              numbers its output is judged by; the
                              traffic's `loop` names it
    metrics/<metric>.py       a reader: `read(run) -> float | None`
    stages/*.json             {"stage": name, "patterns": [regex, ...]}:
                              which profiler kernel names are that stage
    limits/<workload>.json    {number: limit} of the cell's correctness check

A later cell, mix, metric or stage is a new file; no file is edited.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    kind: str  # "end_to_end" or "per_layer"
    workloads: tuple[str, ...] | None  # None: every cell

    def applies_to(self, workload: str) -> bool:
        return self.workloads is None or workload in self.workloads


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents, with its "name"
    chips: int
    limits: dict  # number → limit
    end_to_end: tuple[Metric, ...]
    per_layer: tuple[Metric, ...]


class Benchmark:
    """`BENCHMARK.json` under `root` and the files it names (`root/sphbench`
    unless the command's `paths` say otherwise)."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.spec["paths"][0]
        self.configs = {c["name"]: c for c in self.spec["configs"]}
        self.workloads = {w["name"]: w for w in self.spec["workloads"]}
        self.metrics = [
            *(_metric(m, "end_to_end") for m in self.spec["end_to_end"]),
            *(_metric(m, "per_layer") for m in self.spec["per_layer"]),
        ]
        self._modules: dict[tuple[str, str], object] = {}

    def cell(self, name: str) -> Cell:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(self.workloads)}")
        w = self.workloads[name]
        entry = self.configs[w["config"]]
        config = _load_json(self.root / entry["file"])
        traffic = {"name": w["traffic"], **_load_json(self.dir / "traffic" / f"{w['traffic']}.json")}
        limits_file = self.dir / "limits" / f"{name}.json"
        limits = _load_json(limits_file) if limits_file.exists() else {}
        return Cell(
            name=name,
            config=config,
            traffic=traffic,
            chips=int(w["chips"]),
            limits=limits,
            end_to_end=tuple(m for m in self.metrics
                             if m.kind == "end_to_end" and m.applies_to(name)),
            per_layer=tuple(m for m in self.metrics
                            if m.kind == "per_layer" and m.applies_to(name)),
        )

    def reader(self, metric: str):
        """The `read` function of `metrics/<metric>.py`."""
        return self.module("metrics", metric).read

    def loop(self, name: str):
        """The module `loops/<name>.py`."""
        return self.module("loops", name)

    def init(self, name: str):
        """The module `inits/<name>.py`."""
        return self.module("inits", name)

    def module(self, folder: str, name: str):
        """`<folder>/<name>.py` under the benchmark's folder, loaded once for
        this Benchmark."""
        key = (folder, name)
        if key not in self._modules:
            path = self.dir / folder / f"{name}.py"
            if not path.is_file():
                raise KeyError(f"no {folder}/{name}.py in {self.dir}")
            spec = importlib.util.spec_from_file_location(f"sphbench_{folder}_{name}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._modules[key] = module
        return self._modules[key]

    def stages(self) -> dict[str, list[re.Pattern]]:
        """stage → its kernel-name patterns, from every file in `stages/`."""
        out: dict[str, list[re.Pattern]] = {}
        for path in sorted((self.dir / "stages").glob("*.json")):
            d = _load_json(path)
            out.setdefault(d["stage"], []).extend(re.compile(p) for p in d["patterns"])
        return out


def _metric(m: dict, kind: str) -> Metric:
    return Metric(name=m["name"], unit=m["unit"], kind=kind,
                  workloads=tuple(m["workloads"]) if "workloads" in m else None)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)
