"""The harness around a driver: finding a cell, its files and its readers
by name, the run's context, the result line and its checks.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is a file found by the name ``BENCHMARK.json`` gives it:

* ``benchmark/configs/<config>.json``: the model's sizes and recipe (the
  ``file`` of the configuration's entry);
* ``benchmark/traffic/<traffic>.json``: the mix, with ``"driver"`` naming
  ``benchmark/drivers/<driver>.py``;
* ``benchmark/limits/<cell>.json``: the limit of each number that decides
  ``correct``;
* ``benchmark/metrics/<metric>.py``: the reader of a per-layer metric,
  ``read(stretch) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Callable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "ccnet_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    root: str  # the checkout whose files it was read from
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the metric entries this cell reports with --trace 0
    per_layer: list  # with --trace 1

    def driver(self):
        kind = self.traffic["driver"]
        return _load_module(os.path.join(self.root, "benchmark", "drivers", f"{kind}.py"),
                            f"benchmark_driver_{kind}")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; KeyError if none."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    here = os.path.join(root, "benchmark")
    traffic = load_json(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(here, "limits", f"{name}.json"))
    return Cell(name=name, root=root, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def read_per_layer(cell: Cell, stretch) -> dict:
    """Each per-layer metric of the cell read from the stretch by its own
    reader; a reader that finds nothing returns None and the metric is left
    out."""
    out = {}
    for m in cell.per_layer:
        path = os.path.join(cell.root, "benchmark", "metrics", f"{m['name']}.py")
        reader = _load_module(path, "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(stretch)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


@dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, its rank and
    device, and the clock of its set-up."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    rank: int = 0
    ranks: int = 1
    setup_clock: Callable[[], float] = lambda: 0.0


@dataclass
class Outcome:
    """What a driver returns on rank 0."""

    metrics: dict  # end-to-end metric name -> value
    attempted: int
    failed: int
    memory_peak_bytes: int
    compared: dict  # number name -> value; its limit is the cell's
    stretch: object = None  # benchmark.trace.Stretch of a traced run
    notes: list = field(default_factory=list)  # lines for standard error


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``ccnet_tpu_torch`` is not ``ccnet_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def result_line(cell: Cell, outcome: Outcome, trace: bool, device: dict,
                per_layer: dict | None = None) -> tuple:
    """``(result dict, lines of the compared numbers)``. ``correct`` holds
    when every compared number is within its limit and nothing failed."""
    compared, lines, ok = {}, [], outcome.failed == 0
    for name, limit in cell.limits.items():
        value = outcome.compared.get(name)
        good = value is not None and value <= limit
        ok = ok and good
        compared[name] = {"value": value, "limit": limit}
        lines.append(f"check {name} {value!r} limit {limit!r} {'ok' if good else 'FAILED'}")
    if trace:
        metrics = per_layer or {}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {n: {"value": float(v), "unit": units[n]}
                   for n, v in outcome.metrics.items() if n in units}
    result = {"correct": bool(ok), "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": metrics, "device": device}
    if trace and outcome.stretch is not None:
        result["breakdown"] = {"device_ops": outcome.stretch.top_ops(10),
                               "idle_gaps": outcome.stretch.idle_gaps(10)}
    result["compared"] = compared
    return result, lines
