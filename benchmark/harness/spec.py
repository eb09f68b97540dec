"""Find a cell's parts by the names in ``BENCHMARK.json``.

A cell names a configuration (``configs[].file``) and a traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``generator`` names the
general generator under ``benchmark/generators/``). A per-layer metric is read by
``benchmark/metrics/<name>.py``, and a cell's correctness limits are in
``benchmark/limits/<workload>.json``. Adding a configuration, a mix, a metric
or a cell is adding files and entries: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

BENCH_DIR = "benchmark"


@dataclass
class Cell:
    root: str                   # the checkout holding BENCHMARK.json
    workload: dict              # the entry of ``workloads``
    config: dict                # the configuration file, as run
    mix: dict                   # the traffic mix file
    end_to_end: List[dict]      # metrics this cell reports with --trace 0
    per_layer: List[dict]       # metrics this cell reports with --trace 1
    limits: Dict[str, float] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_path(root: str, *parts: str) -> str:
    return os.path.join(root, BENCH_DIR, *parts)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: str, workload: str) -> Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json with its files."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    mix = load_json(bench_path(root, "traffic", w["traffic"] + ".json"))
    limits_file = bench_path(root, "limits", workload + ".json")
    limits = load_json(limits_file) if os.path.exists(limits_file) else {}
    return Cell(root=root, workload=w, config=config, mix=mix,
                end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
                per_layer=[m for m in spec["per_layer"] if _reports(m, workload)],
                limits=limits)


def _load_module(path: str, name: str):
    module_spec = importlib.util.spec_from_file_location(name, path)
    if module_spec is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(module_spec)
    sys.modules[name] = module
    module_spec.loader.exec_module(module)
    return module


def generator(cell: Cell):
    """The general generator the cell's mix names (``"generator"``)."""
    kind = cell.mix["generator"]
    return _load_module(bench_path(cell.root, "generators", kind + ".py"),
                        f"bench_generator_{kind}")


def metric_reader(root: str, name: str) -> Callable[[object], Optional[float]]:
    """``read(reading)`` of the per-layer metric ``name``: a number, or None
    where the run gave it nothing to read."""
    path = bench_path(root, "metrics", name + ".py")
    return _load_module(path, "bench_metric_" + name.replace(".", "_")).read
