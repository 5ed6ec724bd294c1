"""Everything a run needs, found by name: the cell in ``BENCHMARK.json``,
its configuration (``benchmarks/configs/<config>.json``), its traffic mix
(``benchmarks/traffic/<traffic>.json``, and the module
``benchmarks/traffic/<traffic>.py`` where the mix has code of its own:
:mod:`benchmarks.harness.driver`), the limits of its output check
(``benchmarks/checks/<cell>.json``) and each metric's reader
(``benchmarks/metrics/<metric>.py``).  A later cell, mix, configuration or
metric is new files and new entries; no file here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List, Optional

from benchmarks.harness import driver as drivers

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's object
    traffic: dict  # the mix's parameters
    driver: drivers.Driver  # how the mix drives the system
    limits: dict  # the output check's file: {"limits": {number: limit}, ...}
    end_to_end: List[dict]  # the BENCHMARK.json entries this cell reports with --trace 0
    per_layer: List[dict]  # ... and with --trace 1


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: Optional[set] = None) -> bool:
    """Whether ``metric`` belongs to ``cell``: listed in its ``workloads``,
    or, without that key, reported wherever what it moves is (a per-layer
    metric) or everywhere (an end-to-end one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(name: str, root: Optional[str] = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` (root: the checkout,
    the parent of this folder) with its files."""
    root = os.path.dirname(BENCH_DIR) if root is None else root
    bench = _read(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    here = os.path.join(root, "benchmarks")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    config = _read(os.path.join(here, "configs", f"{w['config']}.json"))
    listed = next((c.get("reduced", []) for c in bench.get("configs", []) if c["name"] == w["config"]), [])
    if set(listed) != set(config.get("reduced", {})):
        raise ValueError(f"configuration {w['config']}: BENCHMARK.json's reduced {sorted(listed)} is not its "
                         f"file's {sorted(config.get('reduced', {}))}")
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=_read(os.path.join(here, "traffic", f"{w['traffic']}.json")),
        driver=drivers.load(w["traffic"], here),
        limits=_read(os.path.join(here, "checks", f"{name}.json")),
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"] if _applies(m, name, reported)],
    )


def metric_reader(name: str, root: Optional[str] = None) -> ModuleType:
    """The module ``benchmarks/metrics/<name>.py``: its ``read(record)``
    returns the metric's value, or None where the run gave it nothing to
    read, and its ``UNIT``."""
    here = os.path.join(os.path.dirname(BENCH_DIR) if root is None else root, "benchmarks")
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmarks.metrics.{name.replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metrics(entries: List[dict], record, root: Optional[str] = None) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of each entry whose reader found
    something to read; the unit is BENCHMARK.json's, which the reader's
    must equal."""
    out = {}
    for m in entries:
        reader = metric_reader(m["name"], root)
        if reader.UNIT != m["unit"]:
            raise ValueError(f"metric {m['name']}: its reader's unit {reader.UNIT!r} is not BENCHMARK.json's "
                             f"{m['unit']!r}")
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
