"""The port's fault-tolerant host fan-out against the JAX package's.

Both packages search identical shards: the reference's
``build_sharded`` over ``tests/test_fault.py``'s rig (800 clustered points
of d=8, 4 shards, a k-NN graph with an entry point per cluster) carried
across by ``convert.sharded_from_arrays``; for the tier, the port's own
``build_sharded(corpus_dtype="int8", tier=True)`` over the reference's
graphs, whose codes equal the reference's bit for bit. Under each fault
script the ``DegradedResult`` must equal JAX's field by field (ids, counts,
flags, counters, ``shard_ok``, ``attempts``, ``faults``, the injector's
tally and the backoff sleeps; distances ``allclose`` at 1e-6 relative, plus
1e-8 absolute on int8, whose sure members keep f32 lower bounds summed in
another order). The injector and ``RetryPolicy`` are held to the
reference's over grids of their inputs, the threaded fan-out to the serial
one bit for bit, and ``RangeServer(sharded=, injector=)`` to the
reference's server on one request stream on a fake clock.
"""
import dataclasses
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.fault.degraded as jdeg
from repro.dist.sharded_engine import build_sharded as jax_build_sharded
from repro.fault import FaultInjector as JFaultInjector
from repro.fault import RetryPolicy as JRetryPolicy
from repro.serve import RangeServer as JRangeServer
from repro.serve import Request as JRequest
from repro.serve import ServerConfig as JServerConfig
from repro_torch.convert import sharded_from_arrays
from repro_torch.core import Graph, RangeConfig, RangeResult, SearchConfig, make_label_filter
from repro_torch.dist import build_sharded
from repro_torch.fault import (
    SHARD_LOST, FaultInjector, RetryPolicy, ShardError, ShardTimeout,
    fault_tolerant_sharded_search, validate_shard_result)
from repro_torch.fault.degraded import _corrupt_result
from repro_torch.kernels._launch import count_launch
from repro_torch.serve import RangeServer, Request, ServerConfig
from repro_torch.utils import INVALID_ID

FIELDS = ("ids", "dists", "count", "overflow", "n_visited", "n_dist", "es_stopped",
          "phase2", "n_rerank")
TOL = {"float32": dict(rtol=1e-6, atol=0.0), "int8": dict(rtol=1e-6, atol=1e-8)}
R = 2.0
_RIG: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors: more only spin,
    and under the parallel test workers they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _cfgs(dt="float32", cap=512):
    s = dict(beam=32, max_beam=32, visit_cap=128, expand_width=4, corpus_dtype=dt)
    return (J.RangeConfig(search=J.SearchConfig(**s), mode="greedy", result_cap=cap),
            RangeConfig(search=SearchConfig(**s), mode="greedy", result_cap=cap))


def _rig():
    """(points, queries, radii, JAX f32 corpus, port f32 corpus, the
    reference's per-shard graphs and starts)."""
    if not _RIG:
        rng = np.random.default_rng(0)
        centers = rng.standard_normal((8, 8)).astype(np.float32) * 3
        pts = (centers[rng.integers(0, 8, 800)]
               + rng.standard_normal((800, 8)).astype(np.float32) * 0.3).astype(np.float32)
        centers_j = jnp.asarray(centers)
        lab = rng.integers(0, 8, 800)

        def builder(p):
            c = np.asarray(jnp.argmin(jnp.sum((p[:, None] - centers_j[None]) ** 2, -1), axis=1))
            starts = np.asarray([np.flatnonzero(c == k)[0] for k in range(8)], np.int32)
            return J.build_knn_graph(p, k=10), jnp.asarray(starts)

        packed = J.pack_labels([[int(x)] for x in lab], 8)
        jc = jax_build_sharded(pts, 4, builder, labels=packed)
        tc = sharded_from_arrays(np.asarray(jc.points), np.asarray(jc.neighbors),
                                 np.asarray(jc.start_ids), np.asarray(jc.offsets), jc.n_total,
                                 labels=np.asarray(jc.labels), device="cpu")
        qs = pts[:24] + 0.01
        _RIG.update(pts=pts, qs=qs, radii=np.linspace(0.5, 3.0, 24).astype(np.float32),
                    jax=jc, port=tc, builder=builder)
    return _RIG


def _tiered():
    """Fresh int8 tiered corpora, JAX's and the port's over the same graphs
    (the port quantizes each shard itself: its codes equal the reference's)."""
    rig = _rig()
    jc = jax_build_sharded(rig["pts"], 4, rig["builder"], corpus_dtype="int8", tier=True)
    graphs = iter(zip(np.asarray(jc.neighbors), np.asarray(jc.start_ids)))

    def carried(block):
        nbrs, starts = next(graphs)
        return Graph(neighbors=torch.tensor(nbrs)), torch.tensor(starts)

    tc = build_sharded(rig["pts"], 4, carried, corpus_dtype="int8", tier=True, device="cpu")
    np.testing.assert_array_equal(tc.points.codes.numpy(), np.asarray(jc.points.codes))
    return jc, tc


def _assert_degraded_equal(got, want, dt="float32"):
    for f in FIELDS:
        g, w = getattr(got.result, f).numpy(), np.asarray(getattr(want.result, f))
        if f == "dists":
            np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
            np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], **TOL[dt])
        else:
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=f)
    np.testing.assert_array_equal(got.shard_ok, want.shard_ok)
    np.testing.assert_array_equal(got.attempts, want.attempts)
    assert got.faults == want.faults
    assert (got.shards_ok, got.shards_total, got.coverage, got.complete, got.code) == \
        (want.shards_ok, want.shards_total, want.coverage, want.complete, want.code)


def _assert_bitwise(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a.result, f), getattr(b.result, f)), f
    np.testing.assert_array_equal(a.shard_ok, b.shard_ok)
    np.testing.assert_array_equal(a.attempts, b.attempts)
    assert a.faults == b.faults


# ---------------------------------------------------------------------------
# the injector and the retry policy
# ---------------------------------------------------------------------------

INJECTORS = [
    dict(seed=3, p_timeout=0.3, p_error=0.2, p_garbage=0.2),
    dict(seed=0, p_timeout=0.1, p_garbage=0.5),
    dict(seed=7, down_shards=(2,), down_replicas=((1, 1),), p_error=0.3),
    dict(seed=1, down_shards=(1,), p_timeout=0.2,
         script={(1, 0): None, (0, 0): "error", (0, 1, 1): "slow", (3, 2): "garbage"}),
]


@pytest.mark.parametrize("kw", INJECTORS, ids=["probabilities", "garbage", "down", "script"])
def test_injector_decisions_match_jax(kw):
    """Every (shard, replica, attempt) of a grid, drawn in reversed order in
    the port: the same fault, the same raised type, the same counter-based
    stream and the same tally."""
    a, b = FaultInjector(**kw), JFaultInjector(**kw)
    grid = [(s, rp, t) for s in range(5) for rp in range(3) for t in range(4)]
    got = {c: a.fault_for(c[0], c[2], c[1]) for c in reversed(grid)}
    want = {c: b.fault_for(c[0], c[2], c[1]) for c in grid}
    assert got == want
    assert a.injected == b.injected and sum(a.injected.values()) > 0
    for s, rp, t in grid[:20]:
        np.testing.assert_array_equal(a.rng(s, t, rp).random(4), b.rng(s, t, rp).random(4))
        kind = want[(s, rp, t)]
        if kind in ("timeout", "error"):
            with pytest.raises(ShardTimeout if kind == "timeout" else ShardError):
                a.raise_if_faulted(s, t, rp)
        else:
            assert a.raise_if_faulted(s, t, rp) == kind
    with pytest.raises(ValueError, match="probabilities"):
        FaultInjector(p_timeout=0.7, p_error=0.7)
    with pytest.raises(ValueError, match="script"):
        FaultInjector(script={(0, 0): "explode"})


def test_retry_policy_delays_match_jax():
    for kw in (dict(), dict(backoff_s=1.0, backoff_factor=10.0, backoff_max_s=5.0),
               dict(backoff_s=0.3, jitter=0.5, seed=7), dict(backoff_s=0.0, jitter=1.0),
               dict(backoff_s=1.0, backoff_factor=1.0, jitter=2.0, seed=11)):
        a, b = RetryPolicy(**kw), JRetryPolicy(**kw)
        for attempt in range(6):
            for key in range(5):
                assert a.delay_s(attempt, key=key) == b.delay_s(attempt, key=key)
    assert RetryPolicy(backoff_s=0.05).delay_s(1) == 0.1


def test_corrupt_result_draws_the_references_garbage():
    cap, n = 16, 6
    ids = np.full((n, cap), INVALID_ID, np.int32)
    res = RangeResult(ids=torch.from_numpy(ids), dists=torch.full((n, cap), float("inf")),
                      count=torch.zeros(n, dtype=torch.int32),
                      overflow=torch.zeros(n, dtype=torch.bool),
                      n_visited=torch.zeros(n, dtype=torch.int32),
                      n_dist=torch.zeros(n, dtype=torch.int32),
                      es_stopped=torch.zeros(n, dtype=torch.bool),
                      phase2=torch.zeros(n, dtype=torch.bool),
                      n_rerank=torch.zeros(n, dtype=torch.int32))
    jres = J.RangeResult(**{f.name: jnp.asarray(getattr(res, f.name).numpy())
                            for f in dataclasses.fields(res)})
    got = _corrupt_result(res, FaultInjector(seed=4).rng(2, 1))
    want = jdeg._corrupt_result(jres, JFaultInjector(seed=4).rng(2, 1))
    for f in ("ids", "dists", "count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert not validate_shard_result(got, 0, 10, 100, np.ones(n, np.float32))


def _mk_result(ids, dists, cap_count=None):
    ids = torch.as_tensor(np.asarray(ids, np.int32))
    n = ids.shape[0]
    count = (cap_count if cap_count is not None
             else (ids.numpy() != INVALID_ID).sum(1))
    z = torch.zeros(n, dtype=torch.int32)
    return RangeResult(ids=ids, dists=torch.as_tensor(np.asarray(dists, np.float32)),
                       count=torch.as_tensor(np.asarray(count, np.int32)),
                       overflow=z.bool(), n_visited=z, n_dist=z, es_stopped=z.bool(),
                       phase2=z.bool(), n_rerank=z)


def test_validate_shard_result_invariants():
    """``tests/test_fault.py``'s invariants on the port, and the relative
    tolerance."""
    radii = np.asarray([1.0], np.float32)
    assert validate_shard_result(_mk_result([[12, INVALID_ID]], [[0.5, np.inf]]),
                                 10, 10, 100, radii)
    for ids, dists, n_total in (([[9, INVALID_ID]], [[0.5, np.inf]], 100),
                                ([[15, INVALID_ID]], [[0.5, np.inf]], 12),
                                ([[12, INVALID_ID]], [[-0.5, np.inf]], 100),
                                ([[12, INVALID_ID]], [[np.nan, np.inf]], 100),
                                ([[12, INVALID_ID]], [[1.5, np.inf]], 100)):
        assert not validate_shard_result(_mk_result(ids, dists), 10, 10, n_total, radii)
    assert not validate_shard_result(_mk_result([[12, INVALID_ID]], [[0.5, np.inf]], [3]),
                                     10, 10, 100, radii)
    big = np.asarray([100.0], np.float32)
    near = _mk_result([[12, INVALID_ID]], [[100.0005, np.inf]])
    assert not validate_shard_result(near, 10, 10, 100, big, atol=1e-4, rtol=0.0)
    assert validate_shard_result(near, 10, 10, 100, big, atol=1e-4, rtol=1e-5)
    assert not validate_shard_result(_mk_result([[12, INVALID_ID]], [[101.0, np.inf]]),
                                     10, 10, 100, big, atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# the fan-out against JAX's
# ---------------------------------------------------------------------------

SCRIPTS = {
    "healthy": (None, dict()),
    "down": (dict(down_shards=(1,)), dict(backoff_s=0.0)),
    "garbage_then_timeout": (dict(script={(2, 0): "garbage", (2, 1): "timeout"}),
                             dict(max_attempts=3, backoff_s=0.1, backoff_factor=2.0)),
    "garbage_always": (dict(script={(3, t): "garbage" for t in range(3)}),
                       dict(backoff_s=0.2, jitter=0.5, seed=3)),
    "chaos": (dict(seed=5, p_timeout=0.2, p_error=0.2, p_garbage=0.2), dict(backoff_s=0.0)),
    "all_lost": (dict(down_shards=(0, 1, 2, 3)), dict(max_attempts=2, backoff_s=0.0)),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_fan_out_matches_jax(name):
    """Each fault script, serial in both packages (so the sleeps come in
    one order): the merged result, the per-shard health and the sleeps."""
    rig = _rig()
    inj_kw, retry_kw = SCRIPTS[name]
    jcfg, tcfg = _cfgs()
    sleeps = ([], [])
    inj = (None, None) if inj_kw is None else (FaultInjector(**inj_kw), JFaultInjector(**inj_kw))
    got = fault_tolerant_sharded_search(
        corpus=rig["port"], queries=rig["qs"], r=rig["radii"], cfg=tcfg, injector=inj[0],
        retry=RetryPolicy(**retry_kw), sleep=sleeps[0].append, max_workers=0)
    want = jdeg.fault_tolerant_sharded_search(
        corpus=rig["jax"], queries=jnp.asarray(rig["qs"]), r=jnp.asarray(rig["radii"]),
        cfg=jcfg, injector=inj[1], retry=JRetryPolicy(**retry_kw), sleep=sleeps[1].append,
        max_workers=0)
    _assert_degraded_equal(got, want)
    assert sleeps[0] == sleeps[1]
    if inj_kw is not None:
        assert inj[0].injected == inj[1].injected
    if name == "down":
        assert got.coverage == 0.75 and got.shards_ok == 3 and got.code == SHARD_LOST
        ids = got.result.ids.numpy()
        assert not ((ids >= 200) & (ids < 400)).any()
    if name == "garbage_then_timeout":
        assert got.complete and list(got.attempts) == [1, 1, 3, 1]
        assert sleeps[0] == [0.1, 0.2]
    if name == "all_lost":
        assert (got.result.ids.numpy() == INVALID_ID).all() and got.coverage == 0.0


def test_fan_out_with_tombstones_and_filter_matches_jax():
    rig = _rig()
    jcfg, tcfg = _cfgs()
    n = rig["port"].shard_size
    tomb = np.zeros((4, -(-n // 32)), np.uint32)
    tomb[:, 0] = 0x55555555                  # the even slots of each shard's first word
    entries = [[q % 8] if q % 2 else [q % 8, (q + 1) % 8] for q in range(24)]
    modes = ["and" if q % 2 else "or" for q in range(24)]
    got = fault_tolerant_sharded_search(
        corpus=rig["port"], queries=rig["qs"], r=R, cfg=tcfg, tombstones=tomb,
        label_filter=make_label_filter(entries, 8, modes=modes),
        injector=FaultInjector(down_shards=(0,)), retry=RetryPolicy(backoff_s=0.0))
    want = jdeg.fault_tolerant_sharded_search(
        corpus=rig["jax"], queries=jnp.asarray(rig["qs"]), r=R, cfg=jcfg, tombstones=tomb,
        label_filter=J.make_label_filter(entries, 8, modes=modes),
        injector=JFaultInjector(down_shards=(0,)), retry=JRetryPolicy(backoff_s=0.0))
    _assert_degraded_equal(got, want)
    assert got.result.count.sum() > 0


def test_tier_fetch_fault_degrades_and_retries_as_jax():
    """A scripted host-store failure on shard 2's first fetch: the shard
    retries and the answer equals JAX's (int8, tiered)."""
    jc, tc = _tiered()
    rig = _rig()
    jcfg, tcfg = _cfgs("int8")
    jc.tiers[2].store.fail_next = 1
    tc.tiers[2].store.fail_next = 1
    got = fault_tolerant_sharded_search(corpus=tc, queries=rig["qs"], r=R, cfg=tcfg,
                                        retry=RetryPolicy(backoff_s=0.0))
    want = jdeg.fault_tolerant_sharded_search(corpus=jc, queries=jnp.asarray(rig["qs"]), r=R,
                                              cfg=jcfg, retry=JRetryPolicy(backoff_s=0.0))
    _assert_degraded_equal(got, want, "int8")
    assert got.faults[2] == "tier_fetch" and list(got.attempts) == [1, 1, 2, 1]
    assert got.complete and got.result.n_rerank.sum() > 0
    with pytest.raises(ValueError, match="tiered"):
        from repro_torch.dist import sharded_range_search
        sharded_range_search(mesh=None, corpus=tc, queries=rig["qs"], r=R, cfg=tcfg)


@pytest.mark.parametrize("name", ["healthy", "garbage_always", "chaos"])
def test_threaded_fan_out_equals_serial(name):
    """Four worker threads merge in shard order: bit for bit the serial
    loop, under each fault script."""
    rig = _rig()
    inj_kw, retry_kw = SCRIPTS[name]
    _, tcfg = _cfgs()
    runs = [fault_tolerant_sharded_search(
        corpus=rig["port"], queries=rig["qs"], r=rig["radii"], cfg=tcfg,
        injector=None if inj_kw is None else FaultInjector(**inj_kw),
        retry=dataclasses.replace(RetryPolicy(**retry_kw), backoff_s=0.0), max_workers=w)
        for w in (0, None, 2)]
    _assert_bitwise(runs[1], runs[0])
    _assert_bitwise(runs[2], runs[0])


def test_launch_counts_survive_threads():
    """The kernel wrappers' counts under many more threads than cores, with
    a short switch interval: no increment is lost."""
    def wrapper():
        pass
    wrapper.launches = 0
    wrapper.routes = {"a": 0, "b": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(2000):
                count_launch(wrapper, "ab"[i % 2])
        threads = [threading.Thread(target=work, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 64_000
    assert wrapper.routes == {"a": 32_000, "b": 32_000}


def test_fan_out_needs_every_shard_and_no_replicas():
    rig = _rig()
    _, tcfg = _cfgs()
    local = dataclasses.replace(rig["port"], points=rig["port"].points[:2],
                                neighbors=rig["port"].neighbors[:2], total_shards=4)
    with pytest.raises(ValueError, match="every shard"):
        fault_tolerant_sharded_search(corpus=local, queries=rig["qs"], r=R, cfg=tcfg)
    # the reference's routing: ``fleet=`` runs the replicated fan-out (the
    # corpus is then the fleet's), and ``hedge=`` alone has no replica to
    # hedge to
    from repro_torch.fault import ReplicaFleet, ReplicatedCorpus, ReplicatedResult
    plain = fault_tolerant_sharded_search(corpus=rig["port"], queries=rig["qs"], r=R, cfg=tcfg)
    fleet = ReplicaFleet(ReplicatedCorpus.replicate(rig["port"], 2))
    for kw in (dict(fleet=fleet), dict(fleet=fleet, corpus=local), dict(hedge=object())):
        kw.setdefault("corpus", rig["port"])
        got = fault_tolerant_sharded_search(queries=rig["qs"], r=R, cfg=tcfg, **kw)
        assert isinstance(got, ReplicatedResult) == ("fleet" in kw)
        _assert_bitwise(got, plain)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _serve(server_cls, request_cls, srv_kw, qs, radii):
    clock = FakeClock()
    srv = server_cls(**srv_kw, clock=clock)
    for i, q in enumerate(qs):
        clock.t = 0.5 * i
        srv.submit(request_cls(req_id=i, op="count" if i % 5 == 4 else "range", query=q,
                               radius=float(radii[i]),
                               filter_labels=[i % 8] if i % 3 == 1 else None))
    clock.t = 20.0
    return [vars(r) for r in srv.run_until_drained()], dict(srv.stats)


@pytest.mark.parametrize("fault", ["shard_down", "healthy"])
def test_server_sharded_fan_out_matches_jax(fault):
    """``RangeServer(sharded=, injector=)`` (and without an injector: the
    healthy fan-out) against the reference's, one request stream on a fake
    clock: every Response field, the shard annotations, the counters."""
    rig = _rig()
    jcfg, tcfg = _cfgs()
    inj = dict(down_shards=(3,)) if fault == "shard_down" else None
    got, got_stats = _serve(RangeServer, Request, dict(
        engine=None, cfg=tcfg, server_cfg=ServerConfig(max_batch=8), sharded=rig["port"],
        injector=None if inj is None else FaultInjector(**inj),
        retry=RetryPolicy(max_attempts=2, backoff_s=0.0)), rig["qs"], rig["radii"])
    want, want_stats = _serve(JRangeServer, JRequest, dict(
        engine=None, cfg=jcfg, server_cfg=JServerConfig(max_batch=8), sharded=rig["jax"],
        injector=None if inj is None else JFaultInjector(**inj),
        retry=JRetryPolicy(max_attempts=2, backoff_s=0.0)), rig["qs"], rig["radii"])
    assert [g["req_id"] for g in got] == [w["req_id"] for w in want]
    for g, w in zip(got, want):
        for k in w:
            if k not in ("ids", "dists", "timings"):
                assert g[k] == w[k], (g["req_id"], k)
        np.testing.assert_array_equal(np.asarray(g["ids"], np.int64),
                                      np.asarray(w["ids"], np.int64))
        np.testing.assert_allclose(g["dists"], w["dists"], **TOL["float32"])
        assert g["timings"] == pytest.approx(w["timings"])
        if fault == "shard_down":
            assert (g["shards_ok"], g["shards_total"], g["code"]) == (3, 4, SHARD_LOST)
        else:
            assert (g["shards_ok"], g["complete"], g["code"]) == (4, True, None)
    for k in ("served", "batches", "overflow", "filtered_batches", "count_requests",
              "shard_retries", "shards_lost", "degraded_batches", "reranked"):
        assert got_stats[k] == want_stats[k], k


def test_server_sharded_arguments_are_checked():
    rig = _rig()
    _, tcfg = _cfgs()
    _, tcfg8 = _cfgs("int8")
    with pytest.raises(ValueError, match="sharded"):
        RangeServer(None, tcfg, injector=FaultInjector())
    with pytest.raises(ValueError, match="continuous"):
        RangeServer(None, tcfg, ServerConfig(continuous=True), sharded=rig["port"])
    with pytest.raises(ValueError, match="corpus_dtype"):
        RangeServer(None, tcfg8, sharded=rig["port"])
    with pytest.raises(ValueError, match="replicas > 1 needs a sharded corpus"):
        RangeServer(None, tcfg, replicas=2)
    assert RangeServer(None, tcfg, sharded=rig["port"], replicas=2).fleet.n_replicas == 2
    srv = RangeServer(None, tcfg, sharded=rig["port"])
    assert srv.device.type == "cpu" and srv.retry == RetryPolicy()
