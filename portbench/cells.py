"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix.  A
configuration is the JSON file its entry gives; a traffic mix is
``traffic/<mix>.json``, which names the runner of its session,
``sessions/<runner>.py``; a per-layer metric is read by
``metrics/<metric>.py``.  A new cell, mix or metric is new files and
entries: nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    workload: Dict
    config: Dict           # the configuration's file
    traffic: Dict          # the traffic mix's file
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _reported_in(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(by_name)})")
    w = by_name[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(w, config, traffic,
                [m for m in bench["end_to_end"]
                 if _reported_in(m, workload)],
                [m for m in bench["per_layer"]
                 if _reported_in(m, workload)])


def _module(path: Path, name: str):
    name = "".join(ch if ch.isalnum() else "_" for ch in name)
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT) -> Callable:
    """The ``read(view)`` function of a per-layer metric."""
    return _module(root / "portbench" / "metrics" / f"{metric}.py",
                   f"portbench_metric_{metric}").read


def runner(cell: Cell, root: Path = ROOT):
    """The module that runs the cell's traffic."""
    name = cell.traffic["session"]
    return _module(root / "portbench" / "sessions" / f"{name}.py",
                   f"portbench_session_{name}")
