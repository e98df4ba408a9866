"""The port's resumable greedy API and serving layer against the JAX package.

Both packages serve one index: the reference's two-pass Vamana graph on the
clustered rig of tests/test_fault.py (1,200 x 12), carried across with
``engine_from_arrays`` (int8: the reference's codes and metadata too; tiered:
each package's tier over them). The standards:

* ``greedy_seed_batch`` + ``greedy_resume_batch`` in slices, ``greedy_lane_done``
  and ``greedy_coverage`` against JAX's after every slice: ids, counts,
  pointers, rounds, n_dist and flags equal; distances
  ``allclose(rtol=1e-5, atol=1e-6)`` (the two frameworks sum a distance's
  terms in different orders, a few ulp apart).
* Within the port, slices are the one-shot ``greedy_search`` bit for bit
  (ids, distance bits, counts, pointers, rounds, n_dist, the bitset, and the
  overflow flag once ``greedy_lane_done``'s bit is applied), and a resumed
  checkpoint is left unchanged.
* ``RangeServer`` against JAX's on the same request streams (lockstep and
  continuous; f32, int8 and tiered; ``count`` and filtered requests;
  deadlines on a fake clock; in the f32 continuous case the JAX effort
  predictor carried across, so both split the buckets alike): per ``req_id`` the same
  op, ids, count, overflow, es_stopped, complete, coverage, code, filtered,
  radius and (the clock being fake) latency; distances within the same
  tolerance; the same ``stats`` counters.

The rest ports the reference's serving tests that apply to one engine
(tests/test_train_serve.py's RangeServer tests, tests/test_fault.py's
deadline tests, tests/test_oracle.py's effort-bucketed continuous batch,
tests/test_tier.py's count op) to the port alone.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.tier as JT
from repro.core.distances import point_dist
from repro.core.range_search import greedy_coverage as jax_greedy_coverage
from repro.models import EffortConfig as JEffortConfig
from repro.models import EffortPredictor as JEffortPredictor
from repro.serve import RangeServer as JRangeServer
from repro.serve import Request as JRequest
from repro.serve import ServerConfig as JServerConfig
from repro_torch.convert import effort_params_from_jax, engine_from_arrays
from repro_torch.core import (
    RangeConfig, SearchConfig, average_precision, build_knn_graph, exact_range_search,
    greedy_coverage, greedy_lane_done, greedy_resume_batch, greedy_search,
    greedy_seed_batch, pack_labels, range_phase1)
from repro_torch.core.corpus import hot_arm
from repro_torch.core.range_search import GreedyState
from repro_torch.fault import DEADLINE_EXPIRED, ERROR_CODES, QUEUE_FULL, SHARD_LOST
from repro_torch.models import EffortConfig, EffortPredictor
from repro_torch.serve import RangeServer, Request, ServerConfig
from repro_torch.tier import tiered_corpus

TOL = dict(rtol=1e-5, atol=1e-6)
N_LABELS = 8
_RIG: dict = {}


class FakeClock:
    """Injectable monotonic time: frozen until advanced by the test."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _rig():
    """(points, the reference's graph, its f32 engine, the port's) on the
    clustered rig, with 8 labels a point set drawn from a seed (1-2 each)."""
    if not _RIG:
        rng = np.random.default_rng(0)
        centers = rng.standard_normal((8, 12)).astype(np.float32) * 3
        pts = (centers[rng.integers(0, 8, 1200)]
               + rng.standard_normal((1200, 12)).astype(np.float32) * 0.4).astype(np.float32)
        graph = J.build_vamana(jnp.asarray(pts), J.BuildConfig(
            max_degree=24, beam=48, insert_batch=256, two_pass=True))
        lab_rng = np.random.default_rng(11)
        member = [sorted({int(a), int(b)}) for a, b in
                  zip(lab_rng.integers(0, N_LABELS, 1200), lab_rng.integers(0, N_LABELS, 1200))]
        _RIG.update(pts=pts, graph=graph, labels=pack_labels(member, N_LABELS))
    return _RIG["pts"], _RIG["graph"], _RIG["labels"]


def _engines(kind="float32"):
    """(JAX engine, port engine) of ``kind`` (float32 | int8 | tiered) on
    the rig, both labeled."""
    key = ("engines", kind)
    if key not in _RIG:
        pts, graph, labels = _rig()
        jeng = J.RangeSearchEngine.from_graph(
            jnp.asarray(pts), graph, corpus_dtype=None if kind == "float32" else "int8",
            labels=jnp.asarray(labels))
        codes = meta = None
        if kind != "float32":
            codes, meta = np.asarray(jeng.points.codes), np.asarray(jeng.points.meta)
        teng = engine_from_arrays(pts, np.asarray(graph.neighbors), np.asarray(jeng.start_ids),
                                  device="cpu", codes=codes, meta=meta)
        teng = dataclasses.replace(teng, labels=torch.from_numpy(labels.view(np.int32)))
        if kind == "tiered":
            jeng = dataclasses.replace(jeng, points=JT.tiered_corpus(
                jeng.points, corpus_dtype="int8", cache_rows=24))
            teng = dataclasses.replace(teng, points=tiered_corpus(
                teng.points, corpus_dtype="int8", cache_rows=24, device="cpu"))
        _RIG[key] = (jeng, teng)
    return _RIG[key]


def _cfgs(kind="float32", e=4, **kw):
    dt = "float32" if kind == "float32" else "int8"
    s = dict(beam=32, max_beam=32, visit_cap=256, expand_width=e, corpus_dtype=dt)
    r = dict(mode="greedy", result_cap=512, **kw)
    return (J.RangeConfig(search=J.SearchConfig(**s), **r),
            RangeConfig(search=SearchConfig(**s), **r))


def _queries(n=16):
    pts, _, _ = _rig()
    qs = pts[:n] + 0.01
    radii = np.where(np.arange(n) % 2 == 0, 9.0, 0.5).astype(np.float32)
    return qs, radii


# ---------------------------------------------------------------------------
# the resumable greedy API
# ---------------------------------------------------------------------------

def _state_np(gs):
    return {f.name: np.asarray(getattr(gs, f.name)) if not isinstance(
        getattr(gs, f.name), torch.Tensor) else getattr(gs, f.name).numpy()
        for f in dataclasses.fields(gs)}


def _assert_state_matches(jgs, tgs, where):
    j, t = _state_np(jgs), _state_np(tgs)
    for f in ("res_ids", "res_count", "expand_ptr", "rounds", "overflow", "n_dist"):
        np.testing.assert_array_equal(t[f], j[f], err_msg=f"{where}: {f}")
    fin = np.isfinite(j["res_dists"])
    np.testing.assert_array_equal(np.isfinite(t["res_dists"]), fin, err_msg=where)
    np.testing.assert_allclose(t["res_dists"][fin], j["res_dists"][fin], **TOL,
                               err_msg=where)


@pytest.mark.parametrize("kind", ["float32", "int8"])
@pytest.mark.parametrize("e", [1, 4])
def test_greedy_resume_matches_jax(kind, e):
    """Every lane of a phase-1 batch seeded, then resumed 8 rounds at a time
    under a 64-round budget (the radius-9 lanes spend it), against JAX's
    state, done flags, overflow bits and coverage after each slice."""
    jeng, teng = _engines(kind)
    jcfg, tcfg = _cfgs(kind, e)
    qs, radii = _queries()
    cap, rounds, sl = 512, 64, 8
    jst, _, _ = J.range_phase1(jeng.points, jeng.graph, jnp.asarray(qs), jeng.start_ids,
                               jnp.asarray(radii), jcfg)
    tst, _, _ = range_phase1(teng.points, teng.graph, torch.from_numpy(qs), teng.start_ids,
                             torch.from_numpy(radii), tcfg)
    jgs = J.greedy_seed_batch(jeng.points, jst, jnp.asarray(radii), cap, jcfg.search)
    tgs = greedy_seed_batch(teng.points, tst, torch.from_numpy(radii), cap, tcfg.search)
    _assert_state_matches(jgs, tgs, "seed")
    on = np.ones(len(qs), bool)
    for k in range(64):
        jgs = J.greedy_resume_batch(jeng.points, jeng.graph, jnp.asarray(qs),
                                    jnp.asarray(radii), jgs, jnp.asarray(on), cap, rounds,
                                    sl, jcfg.search)
        tgs = greedy_resume_batch(teng.points, teng.graph, torch.from_numpy(qs),
                                  torch.from_numpy(radii), tgs, torch.from_numpy(on), cap,
                                  rounds, sl, tcfg.search)
        _assert_state_matches(jgs, tgs, f"resume {k}")
        jd, jo = J.greedy_lane_done(jgs, rounds)
        td, to = greedy_lane_done(tgs, rounds)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(greedy_coverage(tgs), jax_greedy_coverage(jgs))
        if td.all():
            break
    assert td.all() and k >= 2          # it really ran in several slices
    assert to.any() and not to.all()    # some lanes spent the budget
    assert (greedy_coverage(tgs) == 1.0).sum() < len(qs)


def _clone(gs):
    return GreedyState(**{f.name: getattr(gs, f.name).clone()
                          for f in dataclasses.fields(gs)})


def _assert_bitwise(a, b, where, skip=()):
    for f in dataclasses.fields(a):
        if f.name in skip:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{where}: {f.name}"


@pytest.mark.parametrize("kind", ["float32", "int8"])
@pytest.mark.parametrize("e", [1, 4])
def test_slices_equal_one_shot(kind, e):
    """Seed + resumes of 3 rounds (E=4 overshoots a slice) equal one
    ``greedy_search`` bit for bit, every checkpoint stays as it was, and a
    checkpoint resumed twice gives the same state both times."""
    _, teng = _engines(kind)
    _, tcfg = _cfgs(kind, e)
    qs, radii = _queries()
    q, r = torch.from_numpy(qs), torch.from_numpy(radii)
    cap, rounds = 512, 64
    st, _, _ = range_phase1(teng.points, teng.graph, q, teng.start_ids, r, tcfg)
    one = greedy_search(hot_arm(teng.points), teng.graph, q, r, st, cap, rounds, tcfg.search)
    gs = greedy_seed_batch(teng.points, st, r, cap, tcfg.search)
    on = torch.ones(len(qs), dtype=torch.bool)
    n_resumes = 0
    while not greedy_lane_done(gs, rounds)[0].all():
        before = _clone(gs)
        nxt = greedy_resume_batch(teng.points, teng.graph, q, r, gs, on, cap, rounds, 3,
                                  tcfg.search)
        _assert_bitwise(gs, before, "the resumed checkpoint")
        again = greedy_resume_batch(teng.points, teng.graph, q, r, gs, on, cap, rounds, 3,
                                    tcfg.search)
        _assert_bitwise(nxt, again, "the same checkpoint resumed twice")
        gs, n_resumes = nxt, n_resumes + 1
    assert n_resumes > 3
    _, over = greedy_lane_done(gs, rounds)
    _assert_bitwise(gs, one, "slices against one shot", skip=("overflow",))
    np.testing.assert_array_equal(over, one.overflow.numpy())
    assert over.any()


# ---------------------------------------------------------------------------
# RangeServer against the reference's
# ---------------------------------------------------------------------------

def _effort_pair():
    """The reference's predictor fitted on 64 held-out rig queries with
    their exact counts, and the port's carrying its weights and statistics."""
    if "effort" not in _RIG:
        pts, _, _ = _rig()
        tq = pts[600:664]
        radii = np.where(np.arange(64) % 4 == 0, 9.0, 0.5).astype(np.float32)
        d = np.asarray(point_dist(jnp.asarray(pts)[None], jnp.asarray(tq)[:, None], "l2"))
        counts = (d <= radii[:, None]).sum(1)
        jp = JEffortPredictor.fit(tq, radii, counts, JEffortConfig(dim=12, steps=100))
        tp = EffortPredictor(EffortConfig(dim=12, steps=100),
                             effort_params_from_jax({k: np.asarray(v) for k, v in
                                                     jp.params.items()}, device="cpu"),
                             torch.from_numpy(np.array(jp.mu)),
                             torch.from_numpy(np.array(jp.sigma)))
        _RIG["effort"] = (jp, tp)
    return _RIG["effort"]


def _stream(n=16):
    """Mixed traffic: radius-9 lanes (phase 2) among radius-0.5 ones; every
    third request a count, every fourth filtered (AND over one label, or OR
    over three), every fifth with a 2.5 s budget and every seventh 0.5 s."""
    pts, _, _ = _rig()
    out = []
    for i in range(n):
        kw = dict(req_id=i, query=pts[i] + 0.01, radius=9.0 if i % 3 == 1 else 0.5,
                  op="count" if i % 3 == 0 else "range")
        if i % 4 == 0:
            kw.update(filter_labels=[i % N_LABELS] if i % 8 == 0 else
                      [(i + j) % N_LABELS for j in range(3)],
                      filter_mode="and" if i % 8 == 0 else "or")
        if i % 5 == 0:
            kw["deadline_s"] = 2.5
        elif i % 7 == 0:
            kw["deadline_s"] = 0.5
        out.append(kw)
    return out


def _drive(cls_server, cls_req, eng, cfg, scfg, effort, stream):
    """Submit half the stream, serve a step, advance the fake clock 1 s, then
    the rest and serve until drained, advancing 1 s a step."""
    clock = FakeClock()
    srv = cls_server(eng, cfg, scfg, effort=effort, clock=clock)
    resp = []
    half = len(stream) // 2
    for kw in stream[:half]:
        assert srv.submit(cls_req(**kw)) is None
    resp += srv.step()
    clock.advance(1.0)
    for kw in stream[half:]:
        assert srv.submit(cls_req(**kw)) is None
    clock.advance(1.0)      # the queued second half ages: tight budgets expire
    while srv.pending() or srv.in_flight():
        resp += srv.step()
        clock.advance(1.0)
    return srv, resp


FIELDS = ("op", "count", "overflow", "es_stopped", "complete", "coverage", "code",
          "filtered", "radius", "latency_s", "timings", "epoch")


@pytest.mark.parametrize("kind", ["float32", "int8", "tiered"])
@pytest.mark.parametrize("continuous", [False, True], ids=["lockstep", "continuous"])
def test_server_matches_jax(kind, continuous):
    jeng, teng = _engines(kind)
    jcfg, tcfg = _cfgs(kind)
    sc = (dict(max_batch=8, continuous=True, lanes=4, slice_rounds=2, effort_threshold=16.0)
          if continuous else dict(max_batch=8))
    # the effort split is the same code on every corpus: f32 carries it
    jp, tp = _effort_pair() if continuous and kind == "float32" else (None, None)
    stream = _stream()
    jsrv, jresp = _drive(JRangeServer, JRequest, jeng, jcfg, JServerConfig(**sc), jp, stream)
    tsrv, tresp = _drive(RangeServer, Request, teng, tcfg, ServerConfig(**sc), tp, stream)
    assert [r.req_id for r in tresp] == [r.req_id for r in jresp]   # the same order
    for a, b in zip(jresp, tresp):
        for f in FIELDS:
            assert getattr(b, f) == getattr(a, f), (a.req_id, f)
        np.testing.assert_array_equal(b.ids, a.ids, err_msg=str(a.req_id))
        np.testing.assert_allclose(b.dists, a.dists, **TOL, err_msg=str(a.req_id))
    assert tsrv.stats == jsrv.stats
    assert tsrv.latency_summary() == jsrv.latency_summary()
    assert tsrv.radius_dispersion() == jsrv.radius_dispersion()
    s = tsrv.stats
    assert s["count_requests"] and s["filtered_requests"] and s["deadline_shed"]
    if continuous:
        assert s["pool_admitted"] and s["pool_oneshot"] and s["deadline_partial"]
        assert s["bucket_cheap"] and s["pool_rotations"]
        assert bool(s["bucket_heavy"]) == (kind == "float32")
    if kind != "float32":
        assert s["reranked"]


# ---------------------------------------------------------------------------
# the reference's serving tests, on the port alone
# ---------------------------------------------------------------------------

def _oracle(pts, qs, radii):
    d = ((pts[None].astype(np.float64) - qs[:, None]) ** 2).sum(-1)
    return d


@pytest.fixture(scope="module")
def small_engine():
    """tests/test_train_serve.py's k-NN rig (1,500 x 12, k=10), on the
    port's own k-NN graph."""
    from repro_torch.core import RangeSearchEngine
    pts = np.random.default_rng(0).standard_normal((1500, 12)).astype(np.float32)
    graph = build_knn_graph(pts, k=10, device="cpu")
    return pts, RangeSearchEngine.from_graph(pts, graph, device="cpu")


def _lock_cfg(beam=32, visit_cap=128, cap=256, **kw):
    return RangeConfig(search=SearchConfig(beam=beam, max_beam=beam, visit_cap=visit_cap,
                                           **kw), mode="greedy", result_cap=cap)


def test_server_end_to_end_ap(small_engine):
    pts, eng = small_engine
    srv = RangeServer(eng, _lock_cfg(), ServerConfig(max_batch=32))
    qs = pts[:60] + 0.01
    for i in range(60):
        srv.submit(Request(req_id=i, query=qs[i], radius=4.0))
    resp = srv.run_until_drained()
    assert len(resp) == 60 and srv.pending() == 0
    assert srv.stats["batches"] >= 2  # micro-batching happened
    gt_ids, _, gt_counts = exact_range_search(pts, qs, 4.0, device="cpu")
    ids = np.full((60, 256), 2**31 - 1, np.int64)
    counts = np.zeros(60, np.int64)
    for r in resp:
        ids[r.req_id, :len(r.ids)] = r.ids
        counts[r.req_id] = len(r.ids)
    assert average_precision(gt_ids.numpy(), gt_counts.numpy(), ids, counts) > 0.8


def test_server_mixed_radius_batch_per_request_ground_truth():
    """Two requests with radii (1, 8) in one micro-batch each get exactly
    their own radius's oracle set."""
    pts, _, _ = _rig()
    _, eng = _engines()
    q = pts[0] + 0.01
    srv = RangeServer(eng, _lock_cfg(64, 256, 512), ServerConfig(max_batch=32))
    srv.submit(Request(req_id=0, query=q, radius=1.0))
    srv.submit(Request(req_id=1, query=q, radius=8.0))
    resp = sorted(srv.run_until_drained(), key=lambda x: x.req_id)
    assert srv.stats["batches"] == 1 and srv.stats["mixed_radius_batches"] == 1
    d = _oracle(pts, q[None], None)[0]
    gt = {r: set(np.nonzero(d <= r)[0].tolist()) for r in (1.0, 8.0)}
    assert gt[1.0] < gt[8.0]
    assert resp[0].radius == 1.0 and resp[1].radius == 8.0
    assert set(resp[0].ids.tolist()) == gt[1.0]
    assert set(resp[1].ids.tolist()) == gt[8.0]
    assert len(resp[0].ids) and resp[0].dists.max() <= 1.0 + 1e-5
    assert resp[1].dists.max() > 1.0


def test_server_results_sorted_and_deduped(small_engine):
    pts, eng = small_engine
    srv = RangeServer(eng, _lock_cfg(16, 64, 128))
    srv.submit(Request(req_id=0, query=pts[0], radius=4.0))
    (resp,) = srv.run_until_drained()
    assert len(np.unique(resp.ids)) == len(resp.ids)
    assert resp.count == len(resp.ids) or resp.overflow
    assert np.all(np.diff(resp.dists) >= 0)


def test_server_bounded_admission_queue(small_engine):
    """Beyond max_queue, submit sheds with a delivered
    ``Response(op="error", code="queue_full")``."""
    pts, eng = small_engine
    srv = RangeServer(eng, _lock_cfg(16, 64, 128), ServerConfig(max_batch=8, max_queue=4))
    outcome = [srv.submit(Request(req_id=i, query=pts[i], radius=1.0)) for i in range(7)]
    assert outcome[:4] == [None] * 4
    for i, rej in enumerate(outcome[4:], start=4):
        assert rej.op == "error" and rej.code == "queue_full"
        assert rej.req_id == i and not rej.complete and rej.coverage == 0.0
        assert len(rej.ids) == 0
    assert srv.pending() == 4 and srv.stats["rejected"] == 3
    resp = srv.run_until_drained()
    assert sorted(r.req_id for r in resp) == [0, 1, 2, 3]
    assert srv.submit(Request(req_id=9, query=pts[0], radius=1.0)) is None


def test_server_requests_and_arguments_of_later_slices(small_engine):
    """insert/delete raise the reference's "need a live index"; the
    constructor arguments of later slices raise NotImplementedError naming
    their ROADMAP item; malformed requests raise at submit."""
    pts, eng = small_engine
    cfg = _lock_cfg(16, 64, 128)
    srv = RangeServer(eng, cfg)
    with pytest.raises(ValueError, match="live"):
        srv.submit(Request(req_id=0, op="delete", delete_ids=np.asarray([1])))
    with pytest.raises(ValueError, match="live"):
        srv.submit(Request(req_id=0, op="insert", query=pts[0]))
    with pytest.raises(ValueError, match="unknown op"):
        srv.submit(Request(req_id=0, op="query", query=pts[0], radius=1.0))
    with pytest.raises(ValueError, match="query vector"):
        srv.submit(Request(req_id=0, radius=1.0))
    with pytest.raises(ValueError, match="no labels"):
        srv.submit(Request(req_id=0, query=pts[0], filter_labels=[1]))
    with pytest.raises(ValueError, match="insert"):
        srv.submit(Request(req_id=0, query=pts[0], labels=[1]))
    items = {"live": "item 2", "injector": "item 3", "retry": "item 3",
             "replicas": "item 3", "hedge": "item 3", "mesh": "item 4",
             "sharded": "item 4"}
    for name, item in items.items():
        with pytest.raises(NotImplementedError, match=rf"{name}=.*§1, {item}"):
            RangeServer(eng, cfg, **{name: 2 if name == "replicas" else object()})
    with pytest.raises(ValueError, match="need an engine"):
        RangeServer(None, cfg)
    with pytest.raises(ValueError, match="continuous"):
        RangeServer(eng, dataclasses.replace(cfg, mode="beam"),
                    ServerConfig(continuous=True))


def test_server_corpus_dtype_contract():
    """SearchConfig.corpus_dtype must match what the served corpus stores,
    and an int8 engine answers with exactly-in-range ids only."""
    pts, _, _ = _rig()
    _, eng = _engines()
    _, eng_i8 = _engines("int8")
    cfg_i8 = _lock_cfg(16, 64, 128, corpus_dtype="int8")
    with pytest.raises(ValueError, match="corpus_dtype"):
        RangeServer(eng, cfg_i8)
    srv = RangeServer(eng_i8, cfg_i8)
    qs = pts[:8] + 0.01
    for i in range(8):
        srv.submit(Request(req_id=i, query=qs[i], radius=4.0))
    resp = srv.run_until_drained()
    assert len(resp) == 8 and srv.stats["reranked"] > 0
    d2 = _oracle(pts, qs, None)
    for r in resp:
        assert np.all(d2[r.req_id, r.ids] <= 4.0 + 1e-5)


_POOL_CFG = dict(max_batch=8, continuous=True, lanes=4, slice_rounds=1)


def _drain(srv, reqs):
    for r in reqs:
        srv.submit(r)
    return srv.run_until_drained()


def test_server_continuous_straggler_rotation():
    """A straggler parked in the pool does not perturb point queries: the
    scheduler rotates past it, and the point queries' results and response
    order equal a run without it."""
    pts, _, _ = _rig()
    _, eng = _engines()
    cfg = _lock_cfg(32, 256, 512)
    qs = pts[:16] + 0.01
    point = [Request(req_id=i, query=qs[i], radius=0.5) for i in range(16)]
    straggler = Request(req_id=99, query=pts[40], radius=9.0)
    srv_a = RangeServer(eng, cfg, ServerConfig(**_POOL_CFG))
    resp_a = _drain(srv_a, [straggler] + point)
    srv_b = RangeServer(eng, cfg, ServerConfig(**_POOL_CFG))
    resp_b = _drain(srv_b, point)
    assert srv_a.stats["pool_admitted"] >= 1 and srv_a.stats["pool_rotations"] >= 1
    assert len(resp_a) == 17 and len(resp_b) == 16
    a = {r.req_id: r for r in resp_a}
    b = {r.req_id: r for r in resp_b}
    assert len(a[99].ids) >= 32
    for i in range(16):
        np.testing.assert_array_equal(a[i].ids, b[i].ids)
        np.testing.assert_array_equal(a[i].dists, b[i].dists)
        assert a[i].count == b[i].count
    assert [r.req_id for r in resp_a if r.req_id != 99] == [r.req_id for r in resp_b]


def test_server_continuous_matches_lockstep():
    """Continuous batching changes latency, not answers: per request the
    same ids (here bit for bit, distances too), counts and overflow flags as
    the lockstep server on a mixed-radius workload."""
    pts, _, _ = _rig()
    _, eng = _engines()
    cfg = _lock_cfg(32, 256, 512)
    qs = pts[:24] + 0.01
    radii = np.where(np.arange(24) % 3 == 0, 9.0, 0.5).astype(np.float32)
    reqs = lambda: [Request(req_id=i, query=qs[i], radius=float(radii[i]))  # noqa: E731
                    for i in range(24)]
    lock = RangeServer(eng, cfg, ServerConfig(max_batch=8))
    cont = RangeServer(eng, cfg, ServerConfig(**_POOL_CFG))
    rl = {r.req_id: r for r in _drain(lock, reqs())}
    rc = {r.req_id: r for r in _drain(cont, reqs())}
    assert cont.stats["pool_admitted"] > 0
    for i in range(24):
        np.testing.assert_array_equal(rl[i].ids, rc[i].ids)
        np.testing.assert_array_equal(rl[i].dists, rc[i].dists)
        assert (rl[i].count, rl[i].overflow) == (rc[i].count, rc[i].overflow)
    summ = cont.latency_summary()
    assert summ["all"]["count"] == 24 and summ["service"]["count"] == 24
    assert summ["all"]["p99_ms"] >= summ["all"]["p50_ms"] > 0
    for r in rc.values():
        assert set(r.timings) == {"queue_s", "service_s", "total_s"}
        assert r.timings["total_s"] >= r.timings["service_s"] >= 0


def test_deprecated_server_config_expand_width():
    with pytest.warns(DeprecationWarning, match="expand_width"):
        ServerConfig(expand_width=4)


# -- deadlines (tests/test_fault.py) ------------------------------------------

_DL_CFG = dict(beam=32, visit_cap=256, cap=512)


def _drive_with_deadline(eng, cfg, qs, radii, deadline_s, step_dt=1.0):
    clock = FakeClock()
    srv = RangeServer(eng, cfg, ServerConfig(max_batch=32, continuous=True, lanes=16,
                                             slice_rounds=1), clock=clock)
    for i in range(len(qs)):
        srv.submit(Request(req_id=i, query=qs[i], radius=float(radii[i]),
                           deadline_s=deadline_s))
    resp, guard = [], 0
    while srv.pending() or srv.in_flight():
        resp.extend(srv.step())
        clock.advance(step_dt)
        guard += 1
        assert guard < 3000, "pool stalled under deadline expiry"
    assert sorted(r.req_id for r in resp) == list(range(len(qs)))
    return {r.req_id: r for r in resp}, srv


def _assert_certified(resp, pts, qs, radii, exact_dists=True):
    """Every returned id, partial or not, is within its radius by the exact
    distance; on f32 the reported distances are the exact ones."""
    d2 = _oracle(pts, qs, None)
    for i, r in resp.items():
        assert np.all(d2[i, r.ids] <= radii[i] + 1e-3), i
        if exact_dists:
            assert np.all(r.dists <= radii[i] + 1e-5), i
            np.testing.assert_allclose(d2[i, r.ids], r.dists, atol=1e-4)
        assert len(np.unique(r.ids)) == len(r.ids)


def test_deadline_zero_and_queued_shed():
    pts, _, _ = _rig()
    _, eng = _engines()
    clock = FakeClock()
    srv = RangeServer(eng, _lock_cfg(**_DL_CFG), ServerConfig(max_batch=8), clock=clock)
    q = pts[:4] + 0.01
    with pytest.raises(ValueError, match="deadline_s"):
        srv.submit(Request(req_id=9, query=q[0], radius=0.5, deadline_s=-1.0))
    srv.submit(Request(req_id=0, query=q[0], radius=0.5, deadline_s=0.0))
    (r0,) = srv.step()
    assert r0.op == "range" and r0.complete and r0.code is None
    srv.submit(Request(req_id=1, query=q[1], radius=0.5, deadline_s=0.5))
    srv.submit(Request(req_id=2, query=q[2], radius=0.5, deadline_s=5.0))
    srv.submit(Request(req_id=3, query=q[3], radius=0.5))
    clock.advance(1.0)
    out = {r.req_id: r for r in srv.step()}
    assert out[1].op == "error" and out[1].code == DEADLINE_EXPIRED
    assert not out[1].complete and out[1].coverage == 0.0 and len(out[1].ids) == 0
    assert out[2].op == "range" and out[2].complete
    assert out[3].op == "range" and out[3].complete
    assert srv.stats["deadline_shed"] == 1


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_deadline_monotone_and_certified(kind):
    """A longer deadline never returns fewer results; complete responses
    equal the unbounded run bit for bit; partials are certified and
    annotated (complete=False, coverage in [0, 1), the code set)."""
    pts, _, _ = _rig()
    _, eng = _engines(kind)
    cfg = _lock_cfg(**_DL_CFG, corpus_dtype="float32" if kind == "float32" else "int8")
    qs = pts[:16] + 0.01
    radii = np.where(np.arange(16) % 2 == 0, 9.0, 0.5).astype(np.float32)
    exact = kind == "float32"
    base, _ = _drive_with_deadline(eng, cfg, qs, radii, None)
    assert all(r.complete and r.coverage == 1.0 and r.code is None for r in base.values())
    _assert_certified(base, pts, qs, radii, exact_dists=exact)
    runs = []
    for d in ([0.5, 2.5, 6.5] if exact else [2.5]):
        resp, _ = _drive_with_deadline(eng, cfg, qs, radii, d)
        _assert_certified(resp, pts, qs, radii, exact_dists=exact)
        for i, r in resp.items():
            if r.complete:
                np.testing.assert_array_equal(r.ids, base[i].ids)
                np.testing.assert_array_equal(r.dists, base[i].dists)
                assert r.count == base[i].count
            else:
                assert r.code == DEADLINE_EXPIRED and 0.0 <= r.coverage < 1.0
                assert set(r.ids.tolist()) <= set(base[i].ids.tolist())
                lut = dict(zip(base[i].ids.tolist(), base[i].dists.tolist()))
                for j, d_j in zip(r.ids.tolist(), r.dists.tolist()):
                    assert d_j == lut[j], (i, j)
        runs.append(resp)
    if exact:
        assert any(not r.complete for r in runs[0].values())
        for lo, hi in zip(runs, runs[1:]):
            for i in range(16):
                assert set(lo[i].ids.tolist()) <= set(hi[i].ids.tolist()), i
                assert lo[i].count <= hi[i].count


def test_deadline_partials_free_the_pool():
    pts, _, _ = _rig()
    _, eng = _engines()
    qs = pts[:12] + 0.01
    radii = np.full(12, 0.5, np.float32)
    radii[0] = 9.0
    resp, srv = _drive_with_deadline(eng, _lock_cfg(**_DL_CFG), qs, radii, 1.5)
    assert not resp[0].complete and resp[0].code == DEADLINE_EXPIRED
    assert srv.stats["deadline_partial"] >= 1
    for i in range(1, 12):
        assert resp[i].complete, i
    _assert_certified(resp, pts, qs, radii)


def test_error_code_taxonomy_and_queue_full():
    assert {QUEUE_FULL, DEADLINE_EXPIRED, SHARD_LOST} <= set(ERROR_CODES)
    pts, _, _ = _rig()
    _, eng = _engines()
    srv = RangeServer(eng, _lock_cfg(**_DL_CFG), ServerConfig(max_batch=4, max_queue=2))
    q = pts[0]
    assert srv.submit(Request(req_id=0, query=q, radius=0.5)) is None
    assert srv.submit(Request(req_id=1, query=q, radius=0.5)) is None
    rej = srv.submit(Request(req_id=2, query=q, radius=0.5))
    assert rej is not None and rej.op == "error" and rej.code == QUEUE_FULL
    assert rej.code in ERROR_CODES and not rej.complete
    assert srv.stats["rejected"] == 1


# -- the effort-bucketed continuous batch against the oracle (test_oracle.py)

def test_effort_bucketed_continuous_batch_matches_oracle():
    """Heavy lanes (96 matches, saturating a beam of 48) and point lanes (3)
    served through the pool with effort-predicted admission equal the
    brute-force oracle per request, and both buckets and the pool ran."""
    pts, _, _ = _rig()
    _, eng = _engines()
    qs = pts[:32] + 0.01
    srt = np.sort(_oracle(pts, qs, None), axis=1)
    r_heavy = (srt[:, 95] + srt[:, 96]) / 2
    r_point = (srt[:, 2] + srt[:, 3]) / 2
    radii = np.where(np.arange(32) % 4 == 0, r_heavy, r_point).astype(np.float32)
    tq = pts[200:456]
    t_srt = np.sort(_oracle(pts, tq, None), axis=1)
    t_radii = np.concatenate([(t_srt[:128, 95] + t_srt[:128, 96]) / 2,
                              (t_srt[128:, 2] + t_srt[128:, 3]) / 2]).astype(np.float32)
    t_counts = (_oracle(pts, tq, None) <= t_radii[:, None]).sum(axis=1)
    effort = EffortPredictor.fit(tq, t_radii, t_counts, device="cpu")
    srv = RangeServer(eng, _lock_cfg(48, 384, 512),
                      ServerConfig(max_batch=16, continuous=True, lanes=4, slice_rounds=4,
                                   effort_threshold=16.0), effort=effort)
    for i in range(32):
        srv.submit(Request(req_id=i, query=qs[i], radius=float(radii[i])))
    resp = {r.req_id: r for r in srv.run_until_drained()}
    d = _oracle(pts, qs, None)
    for i in range(32):
        assert not resp[i].overflow
        assert set(resp[i].ids.tolist()) == set(np.nonzero(d[i] <= radii[i])[0].tolist()), i
        np.testing.assert_allclose(resp[i].dists, d[i, resp[i].ids], rtol=1e-6, atol=1e-5)
    s = srv.stats
    assert s["bucket_cheap"] > 0 and s["bucket_heavy"] > 0 and s["pool_admitted"] > 0
    # every greedy lane retires once (pool lanes and the one-shot overflow)
    assert s["pool_retired"] == s["pool_admitted"] + s["pool_oneshot"]


# -- the count op on a tiered engine (test_tier.py) ---------------------------

@pytest.mark.parametrize("continuous", [False, True], ids=["lockstep", "continuous"])
def test_count_op_tiered_server(continuous):
    pts, _, _ = _rig()
    _, eng_t = _engines("tiered")
    cfg = _lock_cfg(48, 192, 512, corpus_dtype="int8")
    srv = RangeServer(eng_t, cfg, ServerConfig(max_batch=16, continuous=continuous, lanes=8))
    qs = pts[:8] + 0.01
    for i in range(8):
        srv.submit(Request(req_id=i, query=qs[i], radius=2.0))
        srv.submit(Request(req_id=100 + i, op="count", query=qs[i], radius=2.0))
    resp = {x.req_id: x for x in srv.run_until_drained()}
    for i in range(8):
        c = resp[100 + i]
        assert c.op == "count" and c.code is None
        assert c.ids.size == 0 and c.dists.size == 0
        assert c.count == resp[i].count == len(resp[i].ids)
    assert srv.stats["count_requests"] == 8
    assert eng_t.points.counters.pairs > 0       # the guard band went to the host store
