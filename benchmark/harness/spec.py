"""Where the benchmark's files are, found by name.

``BENCHMARK.json`` at the repository root names the cells and metrics; a
cell ``<name>`` is ``benchmark/workloads/<name>.json``, its configuration
``benchmark/configs/<config>.json``, its traffic driver
``benchmark/traffic/<traffic>.py`` and a per-layer metric ``<family>[.x]``
``benchmark/metrics/<family>.py``.
"""

from __future__ import annotations

import importlib
import json
import os
import re
from typing import List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def benchmark() -> dict:
    return _read(os.path.join(ROOT, "BENCHMARK.json"))


def workload(name: str) -> dict:
    cell = _read(os.path.join(BENCH_DIR, "workloads", _checked(name) + ".json"))
    cell["name"] = name
    return cell


def config(name: str) -> dict:
    return _read(os.path.join(BENCH_DIR, "configs", _checked(name) + ".json"))


def driver(traffic: str):
    return importlib.import_module(f"traffic.{_checked(traffic)}")


def metric_reader(metric: str):
    return importlib.import_module(f"metrics.{_checked(metric).split('.')[0]}")


def _applies(entry: dict, cell: str, e2e: List[str]) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves", entry["name"]) in e2e


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(the cell's end-to-end metric entries, its per-layer entries)."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    names = [m["name"] for m in e2e]
    return e2e, [m for m in bench["per_layer"] if _applies(m, cell, names)]
