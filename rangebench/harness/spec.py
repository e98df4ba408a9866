"""Finding a cell's files by name.

``BENCHMARK.json`` at the root lists the cells, configurations and
metrics. For a cell named C with configuration F and traffic T:

- ``<configs entry of F>["file"]`` (under ``rangebench/configs/``): the
  deployment: sizes, corpus dtype, generator, radius rule, search;
- ``rangebench/traffic/T.json``: the mix (``traffic.py``);
- ``rangebench/workloads/C.json``: the cell's own settings (pool, lanes
  judged, warm-up and traced batches) and the limits of its comparison;
- ``rangebench/metrics/M.py``: the reader of metric M.

A new cell, configuration, mix or metric is a new file and a new entry;
no file here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HOME = "rangebench"      # the benchmark's folder under the root
CELL_KEYS = ("config", "traffic", "pool_batches", "warmup_batches", "check_lanes",
             "trace_batches", "limits")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    settings: dict
    end_to_end: list       # metric entries of BENCHMARK.json this cell reports
    per_layer: list
    bench_dir: Path        # where its traffic, workloads and metrics live


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises ``KeyError``
    for a cell it does not list."""
    bench_dir = root / HOME
    bench = _json(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[entry["config"]]["file"])
    mix = _json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    settings = _json(bench_dir / "workloads" / f"{name}.json")
    missing = [k for k in CELL_KEYS if k not in settings]
    if missing:
        raise ValueError(f"{name}: the cell's file lacks {missing}")
    if (settings["config"], settings["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"{name}: the cell's file names {settings['config']}/"
                         f"{settings['traffic']}, BENCHMARK.json "
                         f"{entry['config']}/{entry['traffic']}")
    return Cell(name=name, chips=int(entry["chips"]), config=config, mix=mix,
                settings=settings,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
                bench_dir=bench_dir)


def reader(name: str, bench_dir: Path):
    """The module ``metrics/<name>.py``: ``read(ctx)`` returns the metric's
    number, or None where the run gave it nothing to read."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"rangebench_metric_{name}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
