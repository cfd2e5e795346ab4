"""Finds a cell's files by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
each lives in a file of its own: `configs/<config file>` as
BENCHMARK.json's `configs[].file` gives it, `traffic/<traffic>.json`,
`limits/<workload>.json` (the limits of the output check) and one reader
module per per-layer metric, `metrics/<metric>.py`. The configuration
names the modules that build the system under test and its plain
reference (`port_module`, `reference_module`), the mix the module that
generates it (`generator`). Adding a cell, a mix, a metric or a model
family adds files and entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any

HERE = Path(__file__).resolve().parent


def derive(seed: int, *parts: Any) -> int:
    """A 63-bit seed from the run's seed and a path of names: every
    generator of the benchmark takes its own, so adding a draw moves no
    other."""
    text = "/".join([str(int(seed))] + [str(p) for p in parts])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def name(self) -> str:
        return self.workload["name"]

    def modules(self) -> tuple[ModuleType, ModuleType, ModuleType]:
        """(the adapter of the system under test, the plain reference, the
        traffic generator), as the configuration and the mix name them:
        a model family brings its own files and names them here."""
        return (importlib.import_module(self.config["port_module"]),
                importlib.import_module(self.config["reference_module"]),
                importlib.import_module(self.traffic["generator"]))


def benchmark_json(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path | None = None) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json (default: the
    checkout this file lies in) with its configuration, traffic mix,
    limits and the metrics it reports."""
    root = HERE.parent if root is None else root
    bench = benchmark_json(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(by_name)}")
    w = by_name[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    config.setdefault("name", cfg_entry["name"])
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    traffic.setdefault("name", w["traffic"])
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return Cell(
        workload=w, config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def metric_reader(name: str) -> ModuleType:
    """`metrics/<name>.py`, loaded by path (a metric's name may hold
    dots). Its `read(run)` returns the metric's value, or None when the
    run holds nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_').replace('-', '_')}",
        path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader {path} for metric {name!r}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
