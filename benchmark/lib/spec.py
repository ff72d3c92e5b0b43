"""Where the benchmark finds each part by its name.

  BENCHMARK.json                       cells and metrics (the repo's root)
  benchmark/workloads/<cell>.json      a traffic mix: its kind, parameters
                                       and the limits of its check
  benchmark/configs/<config>.json      a configuration: scene, build,
                                       engine, render settings
  benchmark/traffic/<kind>.py          the generator and window of a kind
  benchmark/metrics/<metric>.py        the reader of one metric; a metric
                                       split by cells, <name>.<split>,
                                       may share the reader <name>.py

A new cell, configuration or metric is new files and a new entry in
BENCHMARK.json; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return _json(BENCH_DIR / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return _json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(kind: str):
    """The module of a traffic kind, benchmark/traffic/<kind>.py."""
    return importlib.import_module(f"benchmark.traffic.{kind}")


def reader(metric: str):
    """The `read(readings)` function of benchmark/metrics/<metric>.py, or
    of the split's shared <name>.py where the metric has no file of its
    own."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = BENCH_DIR / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics (traced False) or per-layer metrics
    (traced True): those that list it, or list no cells."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]
