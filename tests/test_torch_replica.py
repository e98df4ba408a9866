"""The port's replication (``fault/replica.py``) against the JAX package's.

Case for case ``tests/test_replica.py``, held against the reference on the
same inputs: the shards are the reference's ``build_sharded`` over
``tests/test_fault.py``'s rig (800 clustered points of d=8, 4 shards, a
k-NN graph with an entry point per cluster), one int8 build whose raw rows
are the f32 corpus, carried across by ``convert.sharded_from_arrays``.

* Under every fault script (the reference's ``_SCRIPTS`` and the replica
  scenarios of its tests: replicas down, scripted-slow primaries with and
  without a hedge, replica errors, seeded chaos), f32 and int8, the
  ``ReplicatedResult`` equals JAX's field by field (result, ``shard_ok``,
  ``attempts``, ``faults``, ``replica_ok``, ``served_by``, the hedge and
  breaker counts), and so do the fleet's stats and breaker states, the
  injector's tally and the backoff sleeps. Distances ``allclose`` at 1e-6
  relative, plus 1e-8 absolute on int8 (``tests/test_torch_degraded.py``).
* The breaker's state sequence over a seeded grid of calls on a fake
  clock, ``HedgePolicy.delay_for`` on the same histogram samples, the fleet's
  loss and recovery sequences: equal to the reference's.
* The wall-clock hedge and the threaded fan-out: bit for bit the serial
  path (hedge counts are timing and not compared).
* ``RangeServer(sharded=, replicas=2, injector=, hedge=)`` against the
  reference's server on one request stream on a fake clock: every Response
  field (``replicas_ok``, ``replicas_total``, ``code`` included) and the
  counters; and the ``maintain`` recovery cases.
* The reference's live replica-group tests, on the port.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.fault as JF
from repro.dist.sharded_engine import ShardedCorpus as JShardedCorpus
from repro.dist.sharded_engine import build_sharded as jax_build_sharded
from repro.serve import RangeServer as JRangeServer
from repro.serve import Request as JRequest
from repro.serve import ServerConfig as JServerConfig
from repro.serve.latency import LatencyHistogram as JLatencyHistogram
from repro_torch.convert import sharded_from_arrays
from repro_torch.core import BuildConfig, RangeConfig, SearchConfig
from repro_torch.fault import (
    ERROR_CODES, REPLICA_LOST, SHARD_LOST, BreakerConfig, CircuitBreaker, FaultInjector,
    HedgePolicy, ReplicaFleet, ReplicatedCorpus, ReplicatedResult, RetryPolicy,
    fault_tolerant_sharded_search, replicated_fan_out)
from repro_torch.live import LiveConfig, LiveIndex, LiveShardedIndex, clone_live_index
from repro_torch.serve import RangeServer, Request, ServerConfig
from repro_torch.serve.latency import LatencyHistogram
from repro_torch.train import CheckpointManager

FIELDS = ("ids", "dists", "count", "overflow", "n_visited", "n_dist", "es_stopped",
          "phase2", "n_rerank")
TOL = {"float32": dict(rtol=1e-6, atol=0.0), "int8": dict(rtol=1e-6, atol=1e-8)}
FAST = dict(max_attempts=3, backoff_s=0.0)
R = 2.0


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

    def advance(self, dt: float) -> None:
        self.t += dt


def _cfgs(dt="float32"):
    s = dict(beam=32, max_beam=32, visit_cap=128, expand_width=4, corpus_dtype=dt)
    return (J.RangeConfig(search=J.SearchConfig(**s), mode="greedy", result_cap=512),
            RangeConfig(search=SearchConfig(**s), mode="greedy", result_cap=512))


@pytest.fixture(scope="module")
def rig():
    """{dtype: (JAX ShardedCorpus, port ShardedCorpus)} and the queries."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((8, 8)).astype(np.float32) * 3
    pts = (centers[rng.integers(0, 8, 800)]
           + rng.standard_normal((800, 8)).astype(np.float32) * 0.3).astype(np.float32)
    centers_j = jnp.asarray(centers)

    def builder(p):
        lab = np.asarray(jnp.argmin(jnp.sum((p[:, None] - centers_j[None]) ** 2, -1), axis=1))
        starts = np.asarray([np.flatnonzero(lab == c)[0] for c in range(8)], np.int32)
        return J.build_knn_graph(p, k=10), jnp.asarray(starts)

    j8 = jax_build_sharded(pts, 4, builder, corpus_dtype="int8")
    arrs = [np.asarray(x) for x in (j8.points.raw, j8.neighbors, j8.start_ids, j8.offsets)]
    j32 = JShardedCorpus(points=j8.points.raw, neighbors=j8.neighbors, start_ids=j8.start_ids,
                         offsets=j8.offsets, n_total=j8.n_total)
    t32 = sharded_from_arrays(*arrs, j8.n_total, device="cpu")
    t8 = sharded_from_arrays(*arrs, j8.n_total, codes=np.asarray(j8.points.codes),
                             meta=np.asarray(j8.points.meta), device="cpu")
    return {"float32": (j32, t32), "int8": (j8, t8), "qs": pts[:24] + 0.01}


def _fleets(rig, dt, n=2, **kw):
    """A (JAX, port) pair of R-way fleets, each on its own fake clock."""
    j, t = rig[dt]
    cj, ct = FakeClock(), FakeClock()
    return (JF.ReplicaFleet(JF.ReplicatedCorpus.replicate(j, n), clock=cj, **kw),
            ReplicaFleet(ReplicatedCorpus.replicate(t, n), clock=ct, **kw), cj, ct)


def _assert_result_equal(got, want, dt="float32"):
    for f in FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f == "dists":
            np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
            np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], **TOL[dt])
        else:
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=f)


def _assert_replicated_equal(got, want, dt="float32"):
    assert isinstance(got, ReplicatedResult)
    _assert_result_equal(got.result, want.result, dt)
    for f in ("shard_ok", "attempts", "replica_ok", "served_by"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in ("faults", "hedges_fired", "hedge_wins", "breaker_trips", "shards_ok",
              "shards_total", "coverage", "complete", "code", "replicas_ok",
              "replicas_total"):
        assert getattr(got, f) == getattr(want, f), f


def _breakers(fleet):
    return {k: (b.state, b.failures, b.trips, b._probing, b.opened_at)
            for k, b in fleet.breakers.items()}


def _assert_fleet_equal(got, want):
    assert got.stats == want.stats
    assert _breakers(got) == _breakers(want)
    assert got.lost == want.lost


def _assert_bitwise(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---------------------------------------------------------------------------
# replica parity: bit-identical copies, unobservable choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "int8"])
def test_replicated_corpus_parity_and_delegation(rig, dt):
    _, corpus = rig[dt]
    rc = ReplicatedCorpus.replicate(corpus, 3)
    assert rc.n_replicas == 3 and rc.parity_ok()
    # fresh buffers, not aliases of the original
    for rep in rc.replicas[1:]:
        assert rep.neighbors.data_ptr() != corpus.neighbors.data_ptr()
        leaf = rep.points.codes if dt == "int8" else rep.points
        base = corpus.points.codes if dt == "int8" else corpus.points
        assert leaf.data_ptr() != base.data_ptr() and torch.equal(leaf, base)
    assert rc.n_shards == corpus.n_shards and rc.n_total == corpus.n_total
    assert rc.shard_size == corpus.shard_size
    assert torch.equal(rc.offsets, corpus.offsets) and rc.points is corpus.points
    rc.replica(2).neighbors[1, 5, 0] += 1          # one entry of one replica
    assert not rc.parity_ok()
    with pytest.raises(ValueError, match="replicas"):
        ReplicatedCorpus.replicate(corpus, 0)


def test_replica_choice_is_unobservable(rig):
    """Serving from any replica (``preferred``) gives the same bits, and
    JAX's answer."""
    jc, tc = rig["float32"]
    jcfg, tcfg = _cfgs()
    rc = ReplicatedCorpus.replicate(tc, 3)
    runs = [replicated_fan_out(fleet=ReplicaFleet(rc), queries=rig["qs"], r=R, cfg=tcfg,
                               retry=RetryPolicy(**FAST), preferred=p) for p in range(3)]
    for p, run in enumerate(runs):
        assert run.complete and run.code is None
        assert set(run.served_by.tolist()) == {p}
        _assert_bitwise(run.result, runs[0].result)
    want = JF.replicated_fan_out(fleet=JF.ReplicaFleet(JF.ReplicatedCorpus.replicate(jc, 3)),
                                 queries=jnp.asarray(rig["qs"]), r=R, cfg=jcfg,
                                 retry=JF.RetryPolicy(**FAST), preferred=2)
    _assert_replicated_equal(runs[2], want)


# ---------------------------------------------------------------------------
# the replicated fan-out against JAX's under every script
# ---------------------------------------------------------------------------

SLOW = {(s, 0, 0): "slow" for s in range(4)}
SCENARIOS = {
    # tests/test_replica.py::_SCRIPTS
    "healthy": (None, {}),
    "one_shard_lost": (dict(seed=0, down_shards=(1,)), {}),
    "all_shards_lost": (dict(seed=0, down_shards=(0, 1, 2, 3)), {}),
    "garbage_mid_retry": (dict(seed=0, script={(2, 0): "garbage", (0, 1): "garbage"}), {}),
    # the replica scenarios of its tests
    "replicas_down": (dict(seed=0, down_replicas=((0, 0), (1, 1), (2, 0), (3, 1))), {}),
    "slow_hedged": (dict(seed=0, script=SLOW), dict(hedge=0.0)),
    "slow_unhedged": (dict(seed=0, script=SLOW), {}),
    "replica_errors": (dict(seed=0, script={(0, 0, 0): "error", (1, 1, 0): "timeout",
                                            (2, 0, 0): "garbage", (2, 1, 0): "garbage",
                                            (3, 0, 0): "slow", (3, 1, 0): "error"}),
                       dict(hedge=0.0, preferred=1)),
    "chaos": (dict(seed=5, p_timeout=0.25, p_error=0.2, p_garbage=0.2), dict(hedge=0.0)),
}
RETRY = dict(max_attempts=3, backoff_s=0.1, backoff_factor=2.0, jitter=0.5, seed=3)


@pytest.mark.parametrize("dt", ["float32", "int8"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_replicated_fan_out_matches_jax(rig, name, dt):
    """Each script, serial in both packages (so the sleeps come in one
    order), on R=2 fleets: the ReplicatedResult, the fleet (stats, every
    breaker, lost set), the injector's tally and the sleeps; then a second
    call on the same fleets, whose breakers carry the first call's
    failures."""
    inj_kw, kw = SCENARIOS[name]
    jcfg, tcfg = _cfgs(dt)
    jfleet, tfleet, _, _ = _fleets(rig, dt)
    inj = (None, None) if inj_kw is None else (FaultInjector(**inj_kw), JF.FaultInjector(**inj_kw))
    hedge = kw.get("hedge")
    sleeps = ([], [])
    for call in range(2):
        got = fault_tolerant_sharded_search(
            fleet=tfleet, queries=rig["qs"], r=R, cfg=tcfg, injector=inj[0],
            retry=RetryPolicy(**RETRY), sleep=sleeps[0].append, max_workers=0,
            hedge=None if hedge is None else HedgePolicy(delay_s=hedge)) \
            if "preferred" not in kw else replicated_fan_out(
            fleet=tfleet, queries=rig["qs"], r=R, cfg=tcfg, injector=inj[0],
            retry=RetryPolicy(**RETRY), sleep=sleeps[0].append, max_workers=0,
            hedge=HedgePolicy(delay_s=hedge), preferred=kw["preferred"])
        want = JF.fault_tolerant_sharded_search(
            fleet=jfleet, queries=jnp.asarray(rig["qs"]), r=R, cfg=jcfg, injector=inj[1],
            retry=JF.RetryPolicy(**RETRY), sleep=sleeps[1].append, max_workers=0,
            hedge=None if hedge is None else JF.HedgePolicy(delay_s=hedge)) \
            if "preferred" not in kw else JF.replicated_fan_out(
            fleet=jfleet, queries=jnp.asarray(rig["qs"]), r=R, cfg=jcfg, injector=inj[1],
            retry=JF.RetryPolicy(**RETRY), sleep=sleeps[1].append, max_workers=0,
            hedge=JF.HedgePolicy(delay_s=hedge), preferred=kw["preferred"])
        _assert_replicated_equal(got, want, dt)
        _assert_fleet_equal(tfleet, jfleet)
        assert sleeps[0] == sleeps[1]
        if inj_kw is not None:
            assert inj[0].injected == inj[1].injected
    if name == "replicas_down":   # the headline contract: whole, annotated
        assert got.complete and got.coverage == 1.0 and got.code == REPLICA_LOST
        assert REPLICA_LOST in ERROR_CODES
        assert got.replicas_ok < got.replicas_total == 8
        assert got.served_by.tolist() == [1, 0, 1, 0]
    if name == "one_shard_lost":  # R=2 cannot save a shard whose replicas all die
        assert got.coverage == 0.75 and got.code == SHARD_LOST and got.served_by[1] == -1
    if name == "slow_hedged":     # slow is not sick: no breaker penalty
        assert got.hedges_fired == got.hedge_wins == 4 and got.code is None
        assert tfleet.stats["breaker_trips"] == 0
        assert all(b.failures == 0 for b in tfleet.breakers.values())
    if name == "slow_unhedged":
        assert got.hedges_fired == 0 and got.code is None
    if name == "all_shards_lost":
        assert got.coverage == 0.0 and got.result.ids.device == torch.device("cpu")


def test_slow_with_no_peer_is_a_late_success(rig):
    """R=1 with a hedge policy: nothing to hedge to, so slow is a late
    success, as in the reference."""
    jc, tc = rig["float32"]
    jcfg, tcfg = _cfgs()
    got = fault_tolerant_sharded_search(
        fleet=ReplicaFleet(tc), queries=rig["qs"], r=R, cfg=tcfg, retry=RetryPolicy(**FAST),
        injector=FaultInjector(seed=0, script=SLOW), hedge=HedgePolicy(delay_s=0.0))
    want = JF.fault_tolerant_sharded_search(
        fleet=JF.ReplicaFleet(jc), queries=jnp.asarray(rig["qs"]), r=R, cfg=jcfg,
        retry=JF.RetryPolicy(**FAST), injector=JF.FaultInjector(seed=0, script=SLOW),
        hedge=JF.HedgePolicy(delay_s=0.0))
    _assert_replicated_equal(got, want)
    assert got.hedges_fired == 0 and got.code is None


def test_threaded_and_wall_clock_paths_equal_serial(rig):
    """The threaded replicated fan-out merges in shard order, and the
    wall-clock hedge race (no injector, a zero delay: hedges do fire)
    cannot change a bit: both equal the serial call."""
    _, tc = rig["float32"]
    _, tcfg = _cfgs()
    rc = ReplicatedCorpus.replicate(tc, 2)
    kw = dict(queries=rig["qs"], r=R, cfg=tcfg, retry=RetryPolicy(**FAST))
    serial = replicated_fan_out(fleet=ReplicaFleet(rc), max_workers=0, **kw)

    def inj():
        return FaultInjector(seed=0, down_replicas=((0, 0), (2, 1)))
    down = [replicated_fan_out(fleet=ReplicaFleet(rc), injector=inj(), max_workers=w, **kw)
            for w in (0, None)]
    _assert_bitwise(down[1].result, down[0].result)
    _assert_bitwise(down[0].result, serial.result)
    np.testing.assert_array_equal(down[0].served_by, down[1].served_by)
    assert down[0].code == down[1].code == REPLICA_LOST
    for workers in (None, 0):
        fleet = ReplicaFleet(rc)
        raced = replicated_fan_out(fleet=fleet, hedge=HedgePolicy(delay_s=0.0),
                                   max_workers=workers, **kw)
        assert raced.complete and raced.code is None and raced.hedges_fired >= 0
        _assert_bitwise(raced.result, serial.result)
        assert sum(fleet.hist(s).n for s in range(4)) >= 4


def test_fan_out_arguments_match_the_reference(rig):
    _, tc = rig["float32"]
    _, tcfg = _cfgs()
    local = dataclasses.replace(tc, points=tc.points[:2], neighbors=tc.neighbors[:2],
                                total_shards=4)
    with pytest.raises(ValueError, match="every shard"):
        replicated_fan_out(fleet=ReplicaFleet(local), queries=rig["qs"], r=R, cfg=tcfg)
    with pytest.raises(ValueError, match="no labels"):
        replicated_fan_out(fleet=ReplicaFleet(tc), queries=rig["qs"], r=R, cfg=tcfg,
                           label_filter=object())


# ---------------------------------------------------------------------------
# circuit breaker, hedge policy: the same sequences as the reference's
# ---------------------------------------------------------------------------

def _breaker_grid(cls, cfg_cls, seed):
    clock = FakeClock()
    br = cls(cfg_cls(fail_threshold=3, cooldown_s=30.0), clock=clock)
    rng = np.random.default_rng(seed)
    ops = ("allow", "peek", "record_success", "record_failure", "release_probe",
           "force_open", "to_half_open", "advance")
    weights = np.asarray([5, 3, 2, 6, 1, 0.3, 0.3, 3])
    seq = []
    for op in rng.choice(ops, size=400, p=weights / weights.sum()):
        if op == "advance":
            clock.advance(float(rng.choice([0.0, 10.0, 29.9, 31.0])))
            out = clock.t
        else:
            out = getattr(br, op)()
        seq.append((op, out, br.state, br.failures, br.trips, br._probing, br.opened_at))
    return seq


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_breaker_state_sequence_matches_jax(seed):
    got = _breaker_grid(CircuitBreaker, BreakerConfig, seed)
    want = _breaker_grid(JF.CircuitBreaker, JF.BreakerConfig, seed)
    assert got == want
    assert {s[2] for s in got} == {"closed", "open", "half_open"}


def test_breaker_trip_halfopen_recovery_roundtrip():
    """tests/test_replica.py's breaker round trip, on the port."""
    clock = FakeClock()
    br = CircuitBreaker(BreakerConfig(fail_threshold=3, cooldown_s=30.0), clock=clock)
    assert br.state == "closed" and br.allow()
    assert not br.record_failure() and not br.record_failure()
    assert br.allow()
    assert br.record_failure()
    assert br.state == "open" and br.trips == 1 and not br.allow()
    clock.advance(29.9)
    assert not br.allow()
    clock.advance(0.2)
    assert br.allow() and br.state == "half_open"
    assert not br.allow() and not br.peek()
    br.release_probe()
    assert br.peek() and br.allow()
    assert br.record_failure() and br.state == "open" and br.trips == 2
    clock.advance(30.1)
    assert br.peek() and br.state == "open"    # peek moves nothing
    assert br.allow()
    br.record_success()
    assert br.state == "closed" and br.failures == 0 and br.allow()
    br.record_failure()
    br.record_failure()
    br.record_success()
    assert not br.record_failure() and br.state == "closed"
    br = CircuitBreaker(BreakerConfig(cooldown_s=1e9), clock=clock)
    br.force_open()
    assert br.state == "open" and not br.allow()
    br.to_half_open()
    assert br.allow() and br.state == "half_open"
    br.record_success()
    assert br.state == "closed"


def test_hedge_policy_delay_matches_jax():
    rng = np.random.default_rng(4)
    samples = np.exp(rng.normal(-6.0, 1.0, 300))
    got_h, want_h = LatencyHistogram(), JLatencyHistogram()
    for x in samples:
        got_h.record(float(x))
        want_h.record(float(x))
    policies = [dict(), dict(percentile=50.0), dict(factor=2.5), dict(min_delay_s=0.5),
                dict(delay_s=0.003), dict(percentile=99.0, factor=0.5, min_delay_s=1e-4)]
    for kw in policies:
        for hists in ((got_h, want_h), (LatencyHistogram(), JLatencyHistogram()), (None, None)):
            assert HedgePolicy(**kw).delay_for(hists[0]) == JF.HedgePolicy(**kw).delay_for(
                hists[1]), (kw, hists[0])
    # the reference's fact (ROADMAP.md §3): LatencyHistogram keeps its sample
    # count in ``n``, so ``delay_for`` never sees ``count`` and a fleet's own
    # histograms always give ``fallback_s``, in both packages
    assert got_h.n == 300 and not hasattr(got_h, "count")
    assert HedgePolicy().delay_for(got_h) == JF.HedgePolicy().delay_for(want_h) == 0.05

    class Hist:
        count = 4

        @staticmethod
        def percentile(p):
            return 0.2

    assert HedgePolicy(delay_s=0.0).delay_for(Hist) == 0.0
    assert HedgePolicy().delay_for(None) == 0.05
    assert HedgePolicy().delay_for(Hist) == pytest.approx(0.2)
    assert HedgePolicy(factor=0.5).delay_for(Hist) == pytest.approx(0.1)
    assert HedgePolicy(min_delay_s=0.5).delay_for(Hist) == 0.5


# ---------------------------------------------------------------------------
# breakers in the fan-out; loss and recovery: step for step the reference
# ---------------------------------------------------------------------------

def test_breaker_trips_in_fan_out_then_recovers(rig):
    """A down primary fails once a search until its breaker trips; it is
    then skipped; past the cooldown the next search probes it half-open and
    closes it. Both packages, each step: result, fleet, health."""
    j, t = rig["float32"]
    cj, ct = FakeClock(), FakeClock()
    jfleet = JF.ReplicaFleet(JF.ReplicatedCorpus.replicate(j, 2), clock=cj,
                             breaker=JF.BreakerConfig(fail_threshold=3, cooldown_s=30.0))
    tfleet = ReplicaFleet(ReplicatedCorpus.replicate(t, 2), clock=ct,
                          breaker=BreakerConfig(fail_threshold=3, cooldown_s=30.0))
    jcfg, tcfg = _cfgs()
    q = rig["qs"]
    steps = [dict(down=True)] * 3 + [dict()] + [dict(advance=31.0)]
    for st in steps:
        if "advance" in st:
            cj.advance(st["advance"])
            ct.advance(st["advance"])
        inj = (FaultInjector(seed=0, down_replicas=((2, 0),)),
               JF.FaultInjector(seed=0, down_replicas=((2, 0),))) if st.get("down") else (None,
                                                                                          None)
        got = replicated_fan_out(fleet=tfleet, queries=q, r=R, cfg=tcfg,
                                 retry=RetryPolicy(**FAST), injector=inj[0])
        want = JF.replicated_fan_out(fleet=jfleet, queries=jnp.asarray(q), r=R, cfg=jcfg,
                                     retry=JF.RetryPolicy(**FAST), injector=inj[1])
        _assert_replicated_equal(got, want)
        _assert_fleet_equal(tfleet, jfleet)
    assert tfleet.breakers[(2, 0)].state == "closed" and got.code is None
    assert tfleet.stats["breaker_trips"] == 1


def test_fleet_loss_and_recovery_match_jax(rig):
    """``lose`` (idempotent), searches with a replica lost, ``maintain``
    (re-admission through half-open), a probe aimed at the recovered
    replica; a whole shard lost (nothing to rebuild from); ``recover_fn``
    holding a rebuild back. Each step equal to the reference's."""
    jcfg, tcfg = _cfgs()
    q = rig["qs"]

    def search(pair, preferred=0):
        got = replicated_fan_out(fleet=pair[1], queries=q, r=R, cfg=tcfg,
                                 retry=RetryPolicy(**FAST), preferred=preferred)
        want = JF.replicated_fan_out(fleet=pair[0], queries=jnp.asarray(q), r=R, cfg=jcfg,
                                     retry=JF.RetryPolicy(**FAST), preferred=preferred)
        _assert_replicated_equal(got, want)
        _assert_fleet_equal(pair[1], pair[0])
        return got

    pair = _fleets(rig, "float32")[:2]
    for f in pair:
        f.lose(2, 1)
        f.lose(2, 1)
    assert pair[1].stats["replicas_lost"] == 1
    res = search(pair)
    assert res.code == REPLICA_LOST and not res.replica_ok[2, 1] and res.replicas_ok == 7
    assert pair[0].maintain() == pair[1].maintain() == 1
    _assert_fleet_equal(pair[1], pair[0])
    assert pair[1].breakers[(2, 1)].state == "half_open" and not pair[1].lost
    assert search(pair).code is None
    search(pair, preferred=1)
    assert pair[1].breakers[(2, 1)].state == "closed"

    pair = _fleets(rig, "float32")[:2]
    for f in pair:
        f.lose(1, 0)
        f.lose(1, 1)
    assert pair[0].maintain() == pair[1].maintain() == 0
    res = search(pair)
    assert res.code == SHARD_LOST and res.coverage == 0.75

    pair = _fleets(rig, "float32", recover_fn=lambda s, rep: False)[:2]
    for f in pair:
        f.lose(3, 0)
    assert pair[0].maintain() == pair[1].maintain() == 0
    for f in pair:
        f.recover_fn = lambda s, rep: True
    assert pair[0].maintain() == pair[1].maintain() == 1
    _assert_fleet_equal(pair[1], pair[0])
    assert pair[1].replica_ok_matrix().all() == pair[0].replica_ok_matrix().all()


# ---------------------------------------------------------------------------
# serving: RangeServer(replicas=, hedge=) against the reference's
# ---------------------------------------------------------------------------

def _serve(server_cls, request_cls, srv_kw, qs, prep=None, n=12):
    clock = FakeClock()
    srv = server_cls(**srv_kw, clock=clock)
    if prep is not None:
        prep(srv)
    out = []
    for i in range(n):
        clock.t = 0.5 * i
        srv.submit(request_cls(req_id=i, op="count" if i % 5 == 4 else "range",
                               query=qs[i], radius=R - 0.5 * (i % 3)))
        if i % 6 == 5:      # two streams' worth: the fleet's sweep runs between
            clock.t += 0.25
            out.extend(srv.run_until_drained())
    return [vars(r) for r in out], dict(srv.stats)


SERVED = {
    "replicas_down": dict(inj=dict(seed=0, down_replicas=((0, 0), (1, 1), (2, 0), (3, 1)))),
    "hedged": dict(inj=dict(seed=0, script=SLOW), hedge=0.0),
    "maintain": dict(lose=(1, 1)),
    "shard_down": dict(inj=dict(seed=0, down_shards=(3,))),
}


@pytest.mark.parametrize("case", list(SERVED))
def test_server_replicated_matches_jax(rig, case):
    """One request stream (mixed radii, count requests) on a fake clock,
    R=2, ``max_batch`` 4: every Response field, the shard and replica
    annotations, and the counters, the fleet's mirrored ones included."""
    c = SERVED[case]
    jcfg, tcfg = _cfgs()
    jc, tc = rig["float32"]

    def kw(pkg, corpus, cfg):
        inj = None if "inj" not in c else (FaultInjector if pkg == "t" else JF.FaultInjector)(
            **c["inj"])
        hedge = None if "hedge" not in c else (HedgePolicy if pkg == "t" else JF.HedgePolicy)(
            delay_s=c["hedge"])
        return dict(engine=None, cfg=cfg, server_cfg=(ServerConfig if pkg == "t" else
                                                      JServerConfig)(max_batch=4),
                    sharded=corpus, replicas=2, injector=inj, hedge=hedge,
                    retry=(RetryPolicy if pkg == "t" else JF.RetryPolicy)(max_attempts=2,
                                                                          backoff_s=0.0))

    prep = None if "lose" not in c else (lambda srv: srv.fleet.lose(*c["lose"]))
    got, got_stats = _serve(RangeServer, Request, kw("t", tc, tcfg), rig["qs"], prep)
    want, want_stats = _serve(JRangeServer, JRequest, kw("j", jc, jcfg), rig["qs"], prep)
    assert [g["req_id"] for g in got] == [w["req_id"] for w in want] == list(range(12))
    for g, w in zip(got, want):
        for k in w:
            if k not in ("ids", "dists", "timings"):
                assert g[k] == w[k], (g["req_id"], k)
        np.testing.assert_array_equal(np.asarray(g["ids"], np.int64),
                                      np.asarray(w["ids"], np.int64))
        np.testing.assert_allclose(g["dists"], w["dists"], **TOL["float32"])
        assert g["timings"] == pytest.approx(w["timings"])
        assert g["replicas_total"] == 8
    for k in ("served", "batches", "overflow", "count_requests", "shard_retries",
              "shards_lost", "degraded_batches", "hedges_fired", "hedge_wins",
              "breaker_trips", "replicas_lost", "replicas_recovered"):
        assert got_stats[k] == want_stats[k], k
    if case == "replicas_down":
        assert all(g["complete"] and g["code"] == REPLICA_LOST and g["replicas_ok"] < 8
                   for g in got)
        assert got_stats["replicas_lost"] == 0 and got_stats["degraded_batches"] == 0
    if case == "hedged":
        assert got_stats["hedges_fired"] > 0
        assert got_stats["hedge_wins"] == got_stats["hedges_fired"]
        assert all(g["code"] is None for g in got)
    if case == "maintain":    # swept before the first batch, probed clean
        assert got_stats["replicas_lost"] == got_stats["replicas_recovered"] == 1
        assert all(g["code"] is None and g["replicas_ok"] == 8 for g in got)
    if case == "shard_down":
        assert all(g["code"] == SHARD_LOST and g["coverage"] == 0.75 for g in got)


def test_server_replication_arguments(rig):
    _, tc = rig["float32"]
    _, tcfg = _cfgs()
    base = RangeServer(None, tcfg, ServerConfig(max_batch=8), sharded=tc,
                       retry=RetryPolicy(**FAST))
    for i in range(3):
        base.submit(Request(req_id=i, query=rig["qs"][i], radius=R))
    assert all(r.replicas_ok is None and r.replicas_total is None
               for r in base.run_until_drained())  # unreplicated: no replica annotations
    with pytest.raises(ValueError, match="replicas > 1 needs a sharded corpus"):
        RangeServer(None, tcfg, replicas=2)
    with pytest.raises(ValueError, match="host fan-out"):
        RangeServer(None, tcfg, sharded=tc, replicas=2, mesh=object())
    rc = ReplicatedCorpus.replicate(tc, 3)
    srv = RangeServer(None, tcfg, sharded=rc)
    assert srv.fleet.corpus is rc and srv.sharded is tc
    fleet = ReplicaFleet(rc)
    assert RangeServer(None, tcfg, sharded=fleet).fleet is fleet


# ---------------------------------------------------------------------------
# live replica groups (the reference's tests, on the port)
# ---------------------------------------------------------------------------

_LCFG = LiveConfig(capacity=96, insert_batch=16)
_LBUILD = BuildConfig(max_degree=8, beam=16, insert_batch=32)


def _churn(idx, seed, n_ops=10):
    rng = np.random.default_rng(seed)
    for _ in range(n_ops):
        roll = rng.random()
        if roll < 0.5:
            idx.insert(rng.standard_normal((int(rng.integers(1, 4)), 8)).astype(np.float32))
        elif roll < 0.9:
            idx.delete(rng.integers(0, idx.next_ext_id, size=int(rng.integers(1, 4))))
        else:
            idx.maybe_consolidate()


def test_live_replicas_stay_bitwise_under_churn():
    pts = np.random.default_rng(1).standard_normal((128, 8)).astype(np.float32)
    idx = LiveShardedIndex.create(pts, 2, _LCFG, build_cfg=_LBUILD, replicas=2,
                                  device="cpu")
    assert idx.n_replicas == 2
    idx.assert_replica_parity()
    _churn(idx, seed=2)
    for g in idx.groups:
        for member in g:
            member.consolidate()
    idx.assert_replica_parity()
    rc, tomb, flat_ext = idx.replicated_corpus()
    assert rc.n_replicas == 2 and rc.parity_ok()
    cfg = RangeConfig(search=SearchConfig(beam=16, max_beam=16, visit_cap=64),
                      mode="greedy", result_cap=128)
    qs = pts[:8] + 0.01
    a = fault_tolerant_sharded_search(corpus=rc.replica(0), queries=qs, r=R, cfg=cfg,
                                      retry=RetryPolicy(**FAST), tombstones=tomb)
    b = replicated_fan_out(fleet=ReplicaFleet(rc), queries=qs, r=R, cfg=cfg,
                           retry=RetryPolicy(**FAST), tombstones=tomb, preferred=1)
    assert set(b.served_by.tolist()) == {1}
    _assert_bitwise(a.result, b.result)
    assert flat_ext.shape == (2 * 96,)


def test_live_rebuild_replica_from_checkpoint_and_wal(tmp_path):
    from repro_torch.fault import WriteAheadLog
    pts = np.random.default_rng(3).standard_normal((96, 8)).astype(np.float32)
    idx = LiveShardedIndex.create(pts, 2, _LCFG, build_cfg=_LBUILD, replicas=2,
                                  device="cpu")
    wal = WriteAheadLog(str(tmp_path / "shard0.wal"))
    idx.groups[0][0].attach_wal(wal)  # exactly one group member logs
    cm = CheckpointManager(str(tmp_path / "ck"))
    _churn(idx, seed=4, n_ops=5)
    idx.groups[0][0].save(cm)
    _churn(idx, seed=5, n_ops=5)
    idx.assert_replica_parity()
    idx.groups[0][1] = None
    rebuilt = idx.rebuild_replica(0, 1, cm, wal=WriteAheadLog(str(tmp_path / "shard0.wal")))
    assert rebuilt.wal is None and idx.groups[0][1] is rebuilt
    idx.assert_replica_parity()
    with pytest.raises(ValueError, match="primary"):
        idx.rebuild_replica(0, 0, cm)


def test_clone_live_index_is_independent():
    pts = np.random.default_rng(5).standard_normal((64, 8)).astype(np.float32)
    a = LiveIndex.create(pts, _LCFG, _LBUILD, metric="l2", device="cpu")
    b = clone_live_index(a)
    a.insert(np.ones((2, 8), np.float32))
    assert a.n_live == b.n_live + 2
    assert a.next_ext_id != b.next_ext_id


def test_live_replica_group_validation():
    pts = np.random.default_rng(6).standard_normal((64, 8)).astype(np.float32)
    sh = LiveIndex.create(pts, _LCFG, _LBUILD, metric="l2", device="cpu")
    other = clone_live_index(sh)
    with pytest.raises(ValueError, match="replica_groups"):
        LiveShardedIndex([sh], replica_groups=[[other, sh]])
    with pytest.raises(ValueError, match="replicas"):
        LiveShardedIndex.create(pts, 2, _LCFG, build_cfg=_LBUILD, replicas=0, device="cpu")
    with pytest.raises(ValueError, match="same replica count"):
        LiveShardedIndex([sh, other], replica_groups=[[sh, clone_live_index(sh)], [other]])
