"""Where a cell's pieces live, found by name from ``BENCHMARK.json``.

A cell names a configuration and a traffic mix.  The configuration is the
JSON file that ``BENCHMARK.json`` points to; the traffic mix is
``benchmark/workloads/<traffic>.json``; the limits of the comparison that
decides ``correct`` are ``benchmark/checks/<cell>.json``; each per-layer
metric's reader is ``benchmark/metrics/<metric>.py``; the kernel-name
patterns of the work classes are every ``benchmark/kernels/*.json``.
Nothing here knows a cell by name, so a later change adds a cell, a
metric or a kernel pattern by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]        # the configuration file's contents
    traffic: Dict[str, Any]       # the traffic file's contents
    check: Dict[str, Any]         # the limits file's contents
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def metrics_of(spec: Dict[str, Any], section: str, cell: str
               ) -> List[Dict[str, Any]]:
    """The metrics of ``section`` that ``cell`` reports: those without a
    ``workloads`` key and those that list it."""
    return [m for m in spec[section]
            if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = load_benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _read(root / configs[w["config"]]["file"])
    traffic = _read(BENCH / "workloads" / f"{w['traffic']}.json")
    check = _read(BENCH / "checks" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, check=check,
                end_to_end=metrics_of(spec, "end_to_end", name),
                per_layer=metrics_of(spec, "per_layer", name))


def metric_reader(name: str, bench: Path = BENCH):
    """The ``read(ctx)`` function of ``benchmark/metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    mod_name = "benchmark_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_patterns(bench: Path = BENCH) -> List[Dict[str, Any]]:
    """Every ``benchmark/kernels/*.json`` in name order: each holds a work
    ``class`` and the substrings (``patterns``) of the device kernel names
    that do that class's work."""
    out = []
    for path in sorted((bench / "kernels").glob("*.json")):
        data = _read(path)
        out.append({"file": path.name, "class": data["class"],
                    "patterns": list(data["patterns"])})
    return out


def classify_kernel(name: str, patterns: List[Dict[str, Any]]
                    ) -> Optional[str]:
    """The work class of a device kernel by the first pattern file (in
    name order) with a substring of its name, or None."""
    for entry in patterns:
        if any(p in name for p in entry["patterns"]):
            return entry["class"]
    return None
