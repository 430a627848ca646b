"""`BENCHMARK.json` and the files it names, found by name.

A cell's traffic is `benchmark/workloads/<cell>.json`, its configuration the
`file` of its `configs` entry, and each per-layer metric the reader
`benchmark/metrics/<metric>.py`.  A configuration's `strategy` names the
semantics that the reference judges it by,
`benchmark/reference/strategies/<strategy>.py`.  A later change adds a cell,
a metric or a strategy by adding such files and an entry, and edits no file
that is there.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
WORKLOADS = os.path.join(ROOT, "benchmark", "workloads")
METRICS = os.path.join(ROOT, "benchmark", "metrics")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load() -> dict:
    return _load_json(MANIFEST)


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {MANIFEST}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    workload = _load_json(os.path.join(WORKLOADS, f"{name}.json"))
    if workload.get("config") != entry["config"]:
        raise ValueError(f"{name}.json names configuration "
                         f"{workload.get('config')!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    return Cell(name, entry["chips"], _load_json(os.path.join(ROOT, conf["file"])),
                workload,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


@functools.lru_cache(maxsize=None)
def by_name(folder: str, name: str, package: str):
    """The module `<folder>/<name>.py`, loaded once by its file name as
    `<package>._<name>`; `FileNotFoundError` if there is no such file."""
    path = os.path.join(folder, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {package} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"{package}._{name.replace('-', '_').replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The `read(trace)` function of a per-layer metric."""
    return by_name(METRICS, metric, "benchmark.metrics").read
