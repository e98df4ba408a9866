"""Discovery by file name, the result line, the import check, and runs of
a throwaway cell on the CPU with the program broken underneath."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch
from conftest import ROOT

import calibrate
from rangebench.harness import cell as cells
from rangebench.harness import guard, judge, reference, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_rangebench_every_cell_is_found(name):
    c = spec.load(ROOT, name)
    assert c.config["name"] == c.settings["config"]
    assert {m["name"] for m in c.end_to_end} >= {"qps", "ap", "setup_s"}
    assert c.per_layer and c.chips == 1
    assert reference.control_of(c.config["corpus_dtype"]) in ("tf32", "int4")
    assert set(c.settings["limits"]) == set(judge.NUMBERS)


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_rangebench_every_metric_has_a_reader(name):
    assert callable(spec.reader(name, ROOT / "rangebench").read)


def test_rangebench_every_configuration_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("rangebench/")


def test_rangebench_unknown_cell_refused():
    with pytest.raises(KeyError):
        spec.load(ROOT, "no-such-cell")


def _run(root, name, traced=False, seed=123456789):
    return cells.run(spec.load(root, name), seed, 0.5, traced, CPU, time.perf_counter())


def test_rangebench_a_throwaway_cell_runs(tiny):
    out = _run(tiny, "tiny-f32.mixed")
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] % 256 == 0
    assert set(out["metrics"]) == {"qps", "ap", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert list(out["checks"]) == ["bad_rows", "range_excess", "dist_over", "dist_under",
                                   "recall"]
    json.dumps(out)


def test_rangebench_the_traced_run_line(tiny):
    out = _run(tiny, "tiny-int8.mixed", traced=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert out["correct"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    # a CPU run reads no device metric: nothing from the trace, no launch counter
    assert set(out["metrics"]) == {"dist_per_query", "rerank_per_query"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_rangebench_ap_repeats_on_one_seed(tiny):
    a = _run(tiny, "tiny-f32.mixed", seed=99)
    b = _run(tiny, "tiny-f32.mixed", seed=99)
    assert a["metrics"]["ap"] == b["metrics"]["ap"]


def test_rangebench_guard_compares_whole_names():
    assert guard.forbidden_modules(["repro_torch", "repro_torch.core", "jaxtyping"]) == []
    assert guard.forbidden_modules(["repro.core.engine", "jaxlib._jax", "flax"]) == [
        "flax", "jaxlib", "repro"]


def test_rangebench_a_run_holds_no_jax(tiny):
    _run(tiny, "tiny-f32.mixed")
    assert guard.forbidden_modules() == [] or "jax" in sys.modules  # noqa: the test process
    # the harness's own check, in a fresh process that imports what a run imports
    code = ("import sys; sys.path[:0] = ['.', 'src']; import rangebench.harness.cell, "
            "rangebench.run, repro_torch.core, repro_torch.kernels.expand.ops; "
            "from rangebench.harness import guard; guard.check('test'); print('clean')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_rangebench_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, "rangebench/run.py", "--workload",
                          "bigann-1m-f32.bulk64k", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_rangebench_no_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "rangebench", tmp_path / "rangebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "rangebench/run.py", "--workload",
                          "bigann-1m-f32.bulk64k", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


# -- the comparison fails what it must --------------------------------------

def test_rangebench_control_and_faults_read_not_correct(tiny):
    for name in ("tiny-f32.mixed", "tiny-int8.mixed"):
        lines = list(calibrate.calibrate(spec.load(tiny, name), [31, 32], 1, CPU,
                                         time.perf_counter()))
        assert "control" in lines[0] and "control" not in lines[1]
        # the same work in another order: the same recall and ap
        for k in ("recall", "ap"):
            assert lines[0]["program"][k] == pytest.approx(lines[1]["program"][k], abs=1e-12)
        line = lines[0]
        assert line["program"]["correct"], line
        for variant in ("half", "altered", "lowered", "control"):
            assert not line[variant]["correct"], (name, variant, line[variant])
        if name.startswith("tiny-int8"):
            assert not line["no_rerank"]["correct"]


@pytest.fixture
def broken(monkeypatch):
    """Break the program underneath a run, one way per parameter."""
    from repro_torch.core import engine as engine_mod
    from repro_torch.kernels.expand import ops

    def apply(kind):
        if kind == "half":   # half of each batch left out
            real = engine_mod.RangeSearchEngine.range

            def half(self, queries, r, **kw):
                res = real(self, queries, r, **kw)
                gone = torch.arange(res.count.shape[0]) >= res.count.shape[0] // 2
                res.count = torch.where(gone, 0, res.count)
                res.ids = torch.where(gone[:, None], 2**31 - 1, res.ids)
                res.dists = torch.where(gone[:, None], torch.inf, res.dists)
                return res
            monkeypatch.setattr(engine_mod.RangeSearchEngine, "range", half)
        elif kind == "altered":   # distances altered where the kernel makes them
            for fn in ("expand_frontier_ref", "expand_frontier_int8_ref"):
                real = getattr(ops, fn)

                def alter(*a, real=real, **kw):
                    ids, dists, n = real(*a, **kw)
                    return ids, dists * 0.5, n
                monkeypatch.setattr(ops, fn, alter)
        elif kind == "unchanged":   # a walk step that returns its state unchanged
            for fn in ("expand_frontier_ref", "expand_frontier_int8_ref"):
                real = getattr(ops, fn)

                def stuck(*a, real=real, **kw):
                    ids, dists, n = real(*a, **kw)
                    return torch.full_like(ids, 2**31 - 1), torch.full_like(dists, torch.inf), n
                monkeypatch.setattr(ops, fn, stuck)
    return apply


def test_rangebench_window_keeps_answers_off_the_device(tiny):
    """One answer a pool batch is kept, with the times it came; the lanes
    judged count every time."""
    c = spec.load(tiny, "tiny-f32.mixed")
    setup = cells.build(c, 5, CPU, time.perf_counter())
    win = cells.window(setup, 0.0, CPU)          # one batch
    assert win.batches == 1 and len(win.answers) == 1 and win.answers[0].times == 1
    setup = cells.build(c, 5, CPU, time.perf_counter())
    win = cells.window(setup, 6 * win.wall_s, CPU)
    assert win.batches > len(setup.pool) and win.differed == 0
    assert sum(a.times for a in win.answers) == win.batches
    assert {a.index for a in win.answers} == set(range(min(win.batches, len(setup.pool))))
    # the buffers made in set-up hold the answers
    assert all(a is setup.hosts[a.index] for a in win.answers)


def test_rangebench_a_repeat_that_differs_is_judged(tiny, monkeypatch):
    """A program that answers a batch right the first time and wrong when
    it comes round again: the repeat is kept and fails."""
    from repro_torch.core import engine as engine_mod
    real = engine_mod.RangeSearchEngine.range
    calls = [0]

    def later_wrong(self, queries, r, **kw):
        res = real(self, queries, r, **kw)
        calls[0] += 1
        if calls[0] > 3:        # past the warm-up and the pool's first round of 2
            res.dists = res.dists * 0.5
        return res
    monkeypatch.setattr(engine_mod.RangeSearchEngine, "range", later_wrong)
    c = spec.load(tiny, "tiny-f32.mixed")
    out = cells.run(c, 7, 3.0, False, CPU, time.perf_counter())
    assert out["attempted"] >= 3 * 256
    assert not out["correct"] and out["checks"]["dist_under"]["value"] > 0.1


@pytest.mark.parametrize("kind", ["half", "altered", "unchanged"])
@pytest.mark.parametrize("name", ["tiny-f32.mixed", "tiny-int8.mixed"])
def test_rangebench_broken_program_not_correct(tiny, broken, kind, name):
    broken(kind)
    out = _run(tiny, name)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_rangebench_control_at_the_cells_size(name):
    """The control on the card at the cell's own size: ``correct`` false."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line, = calibrate.calibrate(spec.load(ROOT, name), [20261018], 1, torch.device("cuda", 0),
                                time.perf_counter())
    assert line["program"]["correct"] and not line["control"]["correct"]
