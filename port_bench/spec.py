"""What a cell is made of, found by name: the cell in ``BENCHMARK.json``, its
configuration ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, the module of the mix's kind of request
``kinds/<kind>.py`` (its ``Cell``, ``cells.py``), its metrics (the
``end_to_end`` and ``per_layer`` entries that cover it), and each per-layer
metric's reader ``metrics/<name>.py`` with ``read(ctx) -> float | None``.
Adding a cell, a configuration, a mix, a kind of request or a metric is
adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import types
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str


@dataclasses.dataclass
class CellSpec:
    name: str
    chips: int
    config: dict
    traffic: dict
    kind: types.ModuleType  # kinds/<traffic["kind"]>.py
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _covers(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load(cell: str, benchmark=None, root: str = HERE) -> CellSpec:
    """The cell ``cell`` of ``benchmark`` (a path, or the parsed file;
    by default the checkout's ``BENCHMARK.json``)."""
    bench = benchmark if isinstance(benchmark, dict) else load_json(benchmark or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise SystemExit(f"unknown workload {cell!r}: one of {sorted(cells)}")
    w = cells[cell]
    config = load_json(os.path.join(root, "configs", w["config"] + ".json"))
    traffic = load_json(os.path.join(root, "traffic", w["traffic"] + ".json"))

    def metrics(key):
        return [Metric(m["name"], m["unit"], m["better"], m["source"]) for m in bench[key] if _covers(m, cell)]

    return CellSpec(cell, int(w["chips"]), config, traffic, kind(traffic["kind"], root),
                    metrics("end_to_end"), metrics("per_layer"))


def _module(folder: str, name: str, root: str) -> types.ModuleType:
    path = os.path.join(root, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(f"port_bench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str, root: str = HERE) -> types.ModuleType:
    """The module ``kinds/<name>.py``: its ``Cell`` and ``FAULTS``."""
    return _module("kinds", name, root)


def reader(name: str, root: str = HERE) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    return _module("metrics", name, root).read


def readers(names: List[str], root: str = HERE) -> Dict[str, Callable]:
    return {n: reader(n, root) for n in names}
