"""The benchmark's own CPU tests (not part of the repository's test run):
``python -m pytest -q rangebench/tests``. Tests marked ``cuda`` need a card
and skip without one."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src"), str(ROOT / "rangebench")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tiny_root(base: Path, n: int = 3000, batch: int = 256) -> Path:
    """A throwaway benchmark root beside the real one: its own
    BENCHMARK.json with one f32 and one int8 cell at a small n, their
    configuration, traffic and cell files, and the real metric readers.
    Only files are added; no file of the harness changes."""
    bd = base / "rangebench"
    for sub in ("configs", "traffic", "workloads"):
        (bd / sub).mkdir(parents=True, exist_ok=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    # recall floors set from these tiny cells' own readings on seeds 31, 99
    # and 123456789: sound f32 0.847-0.997 against 0.447-0.530 with half of
    # each batch left out; int8 0.547-0.771 against 0.301-0.410. The int8
    # cell's dist_under: sound 0.0706 against 1.0706 with every distance
    # one radius too low
    for src, name, dim, floor, under in (("bigann-1m-f32", "tiny-f32", 128, 0.7, 1e-5),
                                         ("ssnpp-1m-int8", "tiny-int8", 64, 0.48, 0.25)):
        cfg = json.loads((ROOT / "rangebench" / "configs" / f"{src}.json").read_text())
        cfg.update(name=name, n=n, dim=dim)
        (bd / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test", "reduced": ["n"],
                                 "file": f"rangebench/configs/{name}.json", "why": "test"})
        cell = f"{name}.mixed"
        bench["workloads"].append({"name": cell, "config": name, "traffic": "mixed",
                                   "chips": 1, "why": "test"})
        (bd / "workloads" / f"{cell}.json").write_text(json.dumps({
            "config": name, "traffic": "mixed", "pool_batches": 2, "warmup_batches": 1,
            "check_lanes": batch, "trace_batches": 1,
            "limits": {"bad_rows": 0, "range_excess": 1e-5, "dist_over": 1e-5,
                       "dist_under": under, "recall": floor}}))
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    (bd / "traffic" / "mixed.json").write_text(json.dumps({
        "batch": batch, "loop": "closed",
        "radius": {"kind": "levels", "lo": 0.5, "hi": 1.5, "count": 8}}))
    shutil.copytree(ROOT / "rangebench" / "metrics", bd / "metrics", dirs_exist_ok=True)
    return base


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return tiny_root(tmp_path_factory.mktemp("tiny"))
