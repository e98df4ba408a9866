"""The port's spans and counters (``repro_torch.trace``) on the range path.

Spans off record nothing and spans on change no bit of a result; one
``engine.range`` call is one ``range`` root over its four stages; the
loops count their iterations, and ``host_syncs`` counts every blocking
read of the device on the path, where it happens; under a CPU profiler
the spans are events nested in the call's ``range`` event.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core import RangeConfig, RangeSearchEngine, SearchConfig, build_knn_graph
from repro_torch.core import range_search as rs
from repro_torch.core.beam_search import beam_search_batch, walk_trips

bs = sys.modules["repro_torch.core.beam_search"]   # the package attribute is the function
STAGES = {"range.phase1", "range.select", "range.phase2", "range.result"}
_RIG: dict = {}


def _rig(dtype):
    """(port engine on a k-NN graph, queries, mixed radii) on the CPU."""
    if dtype not in _RIG:
        rng = np.random.default_rng(0)
        centers = rng.standard_normal((8, 16)).astype(np.float32) * 3
        pts = (centers[rng.integers(0, 8, 1500)]
               + rng.standard_normal((1500, 16)).astype(np.float32) * 0.4)
        pts = torch.from_numpy(pts.astype(np.float32))
        graph = build_knn_graph(pts, k=16, device="cpu")
        eng = RangeSearchEngine.from_graph(pts, graph, corpus_dtype=dtype, device="cpu")
        qs = pts[:24] + 0.01
        exact = torch.cdist(qs, pts) ** 2
        quant = torch.linspace(0.01, 0.08, qs.shape[0])
        radii = torch.stack([torch.quantile(exact[i], quant[i])
                             for i in range(qs.shape[0])]).float()
        _RIG[dtype] = (eng, qs, radii)
    return _RIG[dtype]


def _cfg(mode="greedy"):
    return RangeConfig(search=SearchConfig(beam=16, max_beam=32 if mode == "doubling" else 16,
                                           visit_cap=64, expand_width=4),
                       mode=mode, result_cap=256)


@pytest.fixture(autouse=True)
def _clean():
    trace.reset()
    trace.reset_counters()
    yield
    trace.reset()
    trace.reset_counters()


def _bits(res):
    out = {}
    for name, t in vars(res).items():
        out[name] = t.view(torch.int32) if t.dtype == torch.float32 else t
    return out


def test_spans_off_record_nothing():
    eng, qs, radii = _rig("float32")
    assert trace.span("range") is trace.span("walk.step")     # one shared null context
    eng.range(qs, radii, cfg=_cfg())
    assert trace.spans() == []
    assert trace.counters()["host_syncs"] > 0                 # counters are always on


@pytest.mark.parametrize("compacted", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_spans_leave_results_bitwise(dtype, compacted):
    eng, qs, radii = _rig(dtype)
    off = eng.range(qs, radii, cfg=_cfg(), compacted=compacted)
    with trace.tracing():
        on = eng.range(qs, radii, cfg=_cfg(), compacted=compacted)
    assert trace.spans()
    a, b = _bits(off), _bits(on)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert bool(off.phase2.any()) and int(off.count.sum()) > 0


@pytest.mark.parametrize("compacted", [True, False])
def test_one_call_is_one_range_root(compacted):
    eng, qs, radii = _rig("int8")
    with trace.tracing():
        eng.range(qs, radii, cfg=_cfg(), compacted=compacted)
    got = trace.spans()
    roots = [s for s in got if s.parent == 0]
    assert [s.name for s in roots] == ["range"]
    root = roots[0]
    assert {s.root for s in got} == {root.id}
    kids = [s for s in got if s.parent == root.id]
    assert [s.name for s in kids] == ["range.phase1", "range.select", "range.phase2",
                                      "range.result"]
    assert all(s.end_ns >= s.start_ns > 0 for s in got)
    names = {s.name for s in got}
    assert {"walk.sync", "walk.step", "walk.merge", "result.rerank"} <= names
    by_id = {s.id: s for s in got}
    for s in got:                                   # children inside their parent
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    # self time: a span's duration less its children's, summed by name
    summ = trace.summary()
    assert summ["range"][0] == 1
    assert summ["range"][2] == root.duration_ns - sum(k.duration_ns for k in kids)
    steps = [s for s in got if s.name == "walk.step"]
    merges = {s.parent: s.duration_ns for s in got if s.name == "walk.merge"}
    assert summ["walk.step"][:2] == (len(steps), sum(s.duration_ns for s in steps))
    assert summ["walk.step"][2] == sum(s.duration_ns - merges.get(s.id, 0) for s in steps)
    # the walk's syncs and steps sit in the phases, never in the root itself
    for s in got:
        if s.name.startswith("walk."):
            assert by_id[s.parent].name != "range"


def test_summary_of_made_spans():
    made = [trace.Span("a", 1, 0, 1, 0, 100), trace.Span("b", 2, 1, 1, 10, 40),
            trace.Span("c", 3, 2, 1, 15, 25), trace.Span("b", 4, 1, 1, 50, 60),
            trace.Span("d", 5, 1, 1, 70)]                      # still open: left out
    assert trace.summary(made) == {"a": (1, 100, 60), "b": (2, 40, 30), "c": (1, 10, 10)}


@pytest.mark.parametrize("n", [1, 3])
def test_walk_trips_counts_each_loop(n):
    eng, qs, radii = _rig("float32")
    cfg = _cfg()
    with walk_trips(n):
        st = beam_search_batch(eng.points, eng.graph, qs, eng.start_ids, radii, cfg.search)
        assert trace.counters() == {"walk.beam_iters": n}
        rs.greedy_search(eng.points, eng.graph, qs, radii, st, cfg.result_cap,
                         cfg.frontier_rounds, cfg.search)
    # a fixed trip count reads nothing from the device
    assert trace.counters() == {"walk.beam_iters": n, "walk.greedy_iters": n}


@pytest.mark.parametrize("mode", ["greedy", "beam"])
@pytest.mark.parametrize("compacted", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_host_syncs_counted_where_they_happen(dtype, compacted, mode, monkeypatch):
    """Each loop syncs once an iteration and once at its end; the compacted
    path's survivors' select and the int8 band's select once each."""
    steps = {"beam": 0, "greedy": 0}

    def counted(fn, key):
        def call(*a, **kw):
            steps[key] += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(bs, "_step", counted(bs._step, "beam"))
    monkeypatch.setattr(rs, "_greedy_step", counted(rs._greedy_step, "greedy"))
    eng, qs, radii = _rig(dtype)
    res = eng.range(qs, radii, cfg=_cfg(mode), compacted=compacted)
    got = trace.counters()
    assert got.get("walk.beam_iters", 0) == steps["beam"] > 0
    assert got.get("walk.greedy_iters", 0) == steps["greedy"]
    want = steps["beam"] + 1
    if mode == "greedy":
        survivors = bool(res.phase2.any())
        assert survivors and steps["greedy"] > 0
        want += compacted                       # the survivors' nonzero
        want += steps["greedy"] + 1             # the greedy loop's tests
    if dtype == "int8":
        assert int(res.n_rerank.sum()) > 0
        want += 1                               # the band's nonzero
    assert got["host_syncs"] == want


def test_spans_nest_under_the_profiler():
    eng, qs, radii = _rig("int8")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.tracing():
        eng.range(qs, radii, cfg=_cfg())
    events = prof.events()
    roots = [e for e in events if e.name == "range"]
    assert len(roots) == 1
    seen = set()
    for e in events:
        if e.name in STAGES | {"walk.step", "walk.sync", "walk.merge", "result.rerank"}:
            seen.add(e.name)
            up = e.cpu_parent
            while up is not None and up.name != "range":
                up = up.cpu_parent
            assert up is roots[0], e.name
            assert roots[0].time_range.start <= e.time_range.start
            assert e.time_range.end <= roots[0].time_range.end
    assert seen == STAGES | {"walk.step", "walk.sync", "walk.merge", "result.rerank"}
    # the kernels' aten calls run inside the spans
    step = next(e for e in events if e.name == "walk.step")
    assert any(c.name.startswith("aten::") for c in step.cpu_children)


def test_counters_and_spans_across_threads():
    """Threads count into one table without losing an addition, and each
    thread's spans nest in its own stack."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n_threads, n = 12, 2000

    def work(k):
        for _ in range(n):
            trace.count("x")
            trace.count("y", 2)
        with trace.span(f"outer{k}"):
            for _ in range(50):
                with trace.span(f"inner{k}"):
                    pass

    try:
        with trace.tracing():
            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert trace.counters() == {"x": n_threads * n, "y": 2 * n_threads * n}
    got = trace.spans()
    by_id = {s.id: s for s in got}
    assert len(got) == n_threads * 51
    for s in got:
        if s.name.startswith("inner"):
            assert by_id[s.parent].name == "outer" + s.name[len("inner"):]
        else:
            assert s.parent == 0 and s.root == s.id


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_every_sync_on_the_card_is_counted(dtype):
    """On the card, ``host_syncs`` over one call equals the synchronizing
    calls ``torch.cuda.set_sync_debug_mode`` reports from the program."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu_eng, qs, radii = _rig(dtype)
    dev = torch.device("cuda", 0)
    pts = (cpu_eng.points if dtype == "float32" else cpu_eng.points.raw).to(dev)
    eng = RangeSearchEngine.from_graph(pts, cpu_eng.graph, corpus_dtype=dtype, device=dev)
    q, r = qs.to(dev), radii.to(dev)
    off = eng.range(q, r, cfg=_cfg())
    with trace.tracing():
        on = eng.range(q, r, cfg=_cfg())
    for name, t in _bits(off).items():
        assert torch.equal(t, _bits(on)[name]), name
    torch.cuda.synchronize(dev)
    trace.reset_counters()
    in_program = [f for f in trace.card_syncs(lambda: eng.range(q, r, cfg=_cfg())) if f]
    assert in_program and trace.counters()["host_syncs"] == len(in_program)
