"""The port's tiered corpus against its resident corpus and the JAX package.

The contract (the reference's tests/test_tier.py): an engine whose exact
rerank rows live in a host row store answers bit for bit as the resident
engine over the same codes and graph, whatever the cache size (0 included),
its eviction history or the order of the queries, on the fused and the
compacted paths. Against the JAX package's tiered engine on a shared graph
and shared codes, every lane's ids, counts and flags are equal and the
distances ``allclose(rtol=1e-5, atol=1e-5)``. The rest holds the machinery:
the fetch planner's dedup and buckets, the LRU cache's semantics, the
``REPRO_TIER_CACHE_ROWS`` override and the store's layout.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.tier as JT
from repro_torch.convert import engine_from_arrays
from repro_torch.core import RangeConfig, SearchConfig, make_label_filter, pack_labels
from repro_torch.core.labels import as_label_rows
from repro_torch.tier import (
    ROW_ALIGN, DeviceRowCache, HostRowStore, TierFetchError, plan_fetch, tiered_corpus)

D = 10
CFG = dict(beam=48, max_beam=48, visit_cap=192, expand_width=4)
TOL = dict(rtol=1e-5, atol=1e-5)
_BASE: dict = {}


def _clustered(n, seed=0, d=D, scale=0.35, k=6):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * 3
    return (centers[rng.integers(0, k, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * scale).astype(np.float32)


def _base():
    """(points (500, D), the reference's Vamana graph, its engine, queries
    (24, D), a radius of ~20 matches a query, so the int8 band is never
    empty)."""
    if not _BASE:
        pts = _clustered(500)
        graph = J.build_vamana(jnp.asarray(pts), J.BuildConfig(
            max_degree=24, beam=48, insert_batch=256, two_pass=True))
        qs = _clustered(24, seed=3)
        dmat = np.linalg.norm(pts[None] - qs[:, None], axis=-1) ** 2
        jeng = J.RangeSearchEngine.from_graph(jnp.asarray(pts), graph,
                                              corpus_dtype="int8")
        _BASE.update(pts=pts, graph=graph, jeng=jeng, qs=qs,
                     r=float(np.quantile(dmat, 20.0 / pts.shape[0])))
    b = _BASE
    return b["pts"], b["graph"], b["jeng"], b["qs"], b["r"]


def _engines(corpus_dtype="int8", cache_rows=24):
    """(resident engine, tiered engine) of the port sharing codes, graph and
    entry points: only where the exact rows live differs."""
    pts, graph, jeng, _, _ = _base()
    nbrs, starts = np.asarray(graph.neighbors), np.asarray(jeng.start_ids)
    if corpus_dtype == "int8":
        eng = engine_from_arrays(pts, nbrs, starts, device="cpu",
                                 codes=np.asarray(jeng.points.codes),
                                 meta=np.asarray(jeng.points.meta))
        src = eng.points
    else:
        eng = engine_from_arrays(pts, nbrs, starts, device="cpu")
        src = pts
    tier = tiered_corpus(src, corpus_dtype=corpus_dtype, cache_rows=cache_rows,
                         device="cpu")
    return eng, dataclasses.replace(eng, points=tier)


def _cfg(**kw):
    return RangeConfig(search=SearchConfig(**CFG), mode="greedy", result_cap=512, **kw)


def _assert_bitwise(a, b):
    for f in ("ids", "dists", "count", "overflow", "n_visited", "n_dist", "n_rerank"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---------------------------------------------------------------------------
# bitwise parity: resident against tiered
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compacted", [True, False], ids=["compacted", "fused"])
@pytest.mark.parametrize("corpus_dtype", ["float32", "int8"])
def test_tiered_bitwise_parity(corpus_dtype, compacted):
    eng, eng_t = _engines(corpus_dtype)
    _, _, _, qs, r = _base()
    res = eng.range(qs, r, cfg=_cfg(), compacted=compacted)
    res_t = eng_t.range(qs, r, cfg=_cfg(), compacted=compacted)
    _assert_bitwise(res, res_t)
    b = eng_t.points.budget()
    assert b.device["row_cache"] <= 0.25 * b.host["row_store"], b.as_dict()
    c = eng_t.points.counters
    if corpus_dtype == "int8":
        assert c.pairs == int(res_t.n_rerank.sum()) > 0
        assert c.fetched_rows + c.cache_hits == c.unique_rows
    else:
        assert c.pairs == 0
    st = eng_t.stats()
    assert st["memory_budget"]["device_total"] == b.device_total
    assert st["tier"]["pairs"] == c.pairs
    assert st["num_points"] == 500 and st["corpus_dtype"] == corpus_dtype


def test_tiered_parity_per_query_radii():
    eng, eng_t = _engines("int8")
    _, _, _, qs, r = _base()
    radii = np.geomspace(0.25 * r, 2.0 * r, qs.shape[0]).astype(np.float32)
    _assert_bitwise(eng.range(qs, radii, cfg=_cfg()), eng_t.range(qs, radii, cfg=_cfg()))


def test_cache_eviction_adversarial_ordering():
    """A 4-row cache (thrashing), no cache (pure streaming) and the resident
    engine agree bit for bit on every permutation of the batch."""
    eng, eng_tiny = _engines("int8", cache_rows=4)
    _, eng_none = _engines("int8", cache_rows=0)
    _, _, _, qs, r = _base()
    rng = np.random.default_rng(5)
    n = qs.shape[0]
    for order in (np.arange(n), np.arange(n)[::-1], rng.permutation(n), rng.permutation(n)):
        ref = eng.range(qs[order], r, cfg=_cfg())
        _assert_bitwise(ref, eng_tiny.range(qs[order], r, cfg=_cfg()))
        _assert_bitwise(ref, eng_none.range(qs[order], r, cfg=_cfg()))
    ct, cn = eng_tiny.points.counters, eng_none.points.counters
    assert ct.cache_evictions > 0
    assert cn.cache_hits == 0 and cn.fetched_rows == cn.unique_rows
    assert ct.pairs >= ct.unique_rows


def test_tiered_fallback_scan_equals_resident():
    """The filtered fallback scan reads its exact rows through the tier too:
    bit for bit the resident engine's, with the fallback lanes off the
    graph."""
    eng, eng_t = _engines("int8", cache_rows=16)
    pts, _, _, qs, r = _base()
    labels = as_label_rows(pack_labels([[i % 5] for i in range(pts.shape[0])], 5))
    eng, eng_t = (dataclasses.replace(e, labels=labels) for e in (eng, eng_t))
    filt = make_label_filter([[q % 5] if q % 2 else [0, 1, 2] for q in range(qs.shape[0])],
                             5, modes="or")
    cfg = _cfg(filter_threshold=0.3)
    res, res_t = eng.range(qs, r, cfg=cfg, filter=filt), eng_t.range(qs, r, cfg=cfg, filter=filt)
    _assert_bitwise(res, res_t)
    assert (res_t.n_visited[1::2] == 0).all() and (res_t.n_visited[::2] > 0).all()


@pytest.mark.parametrize("compacted", [True, False], ids=["compacted", "fused"])
def test_tiered_matches_jax_tiered(compacted):
    """The port's tiered engine against the JAX package's on the same graph
    and codes, every lane."""
    pts, graph, jeng, qs, r = _base()
    jtier = dataclasses.replace(jeng, points=JT.tiered_corpus(jeng.points, cache_rows=8))
    _, eng_t = _engines("int8", cache_rows=8)
    jcfg = J.RangeConfig(search=J.SearchConfig(**CFG), mode="greedy", result_cap=512)
    jres = jtier.range(jnp.asarray(qs), r, cfg=jcfg, compacted=compacted)
    tres = eng_t.range(qs, r, cfg=_cfg(), compacted=compacted)
    for f in ("ids", "count", "overflow", "n_visited", "n_dist", "es_stopped", "phase2",
              "n_rerank"):
        np.testing.assert_array_equal(getattr(tres, f).numpy(),
                                      np.asarray(getattr(jres, f)), err_msg=f)
    a, b = tres.dists.numpy(), np.asarray(jres.dists)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_allclose(a[np.isfinite(b)], b[np.isfinite(b)], **TOL)
    assert eng_t.points.counters.pairs == int(tres.n_rerank.sum()) > 0


# ---------------------------------------------------------------------------
# the machinery
# ---------------------------------------------------------------------------

def test_device_row_cache_reference_semantics():
    """Random lookup / insert / invalidate interleavings: every reported hit
    returns the stored row, the population stays within capacity, and
    invalidated slots miss. The reference's cache, driven the same way,
    reports the same hits and lines."""
    rng = np.random.default_rng(0)
    raw = rng.standard_normal((64, 4)).astype(np.float32)
    cache, ref = DeviceRowCache(4, 8), JT.DeviceRowCache(4, 8)
    for step in range(120):
        slots = np.unique(rng.integers(0, 64, rng.integers(1, 6)))
        hit, lines = cache.lookup(slots)
        rhit, rlines = ref.lookup(slots)
        np.testing.assert_array_equal(hit, rhit)
        np.testing.assert_array_equal(lines[hit], rlines[rhit])
        for s, h, ln in zip(slots.tolist(), hit.tolist(), lines.tolist()):
            if h:
                np.testing.assert_array_equal(cache.rows([ln])[0].numpy(), raw[s])
        miss = slots[~hit]
        if miss.size:
            assert cache.insert(miss, torch.from_numpy(raw[miss])) == \
                ref.insert(miss, jnp.asarray(raw[miss]))
            assert cache.lookup(miss)[0].all() and ref.lookup(miss)[0].all()
        assert len(cache) <= 8
        if step % 7 == 0:
            stale = np.unique(rng.integers(0, 64, 3))
            assert cache.invalidate(stale) == ref.invalidate(stale)
            assert not cache.lookup(stale)[0].any()


def test_cache_insert_more_rows_than_lines():
    """Inserting more new slots than the cache has lines evicts the call's
    own earlier slots, as the reference's does; each line keeps the last
    row written to it."""
    raw = np.arange(40, dtype=np.float32).reshape(10, 4)
    cache, ref = DeviceRowCache(4, 3), JT.DeviceRowCache(4, 3)
    slots = np.arange(10)
    assert cache.insert(slots, torch.from_numpy(raw)) == ref.insert(slots, jnp.asarray(raw)) == 7
    hit, lines = cache.lookup(slots)
    rhit, rlines = ref.lookup(slots)
    np.testing.assert_array_equal(hit, rhit)
    np.testing.assert_array_equal(lines[hit], rlines[rhit])
    np.testing.assert_array_equal(cache.rows(lines[hit]).numpy(), raw[slots[hit]])


def test_plan_fetch_dedup_sort_and_buckets():
    slots = np.asarray([7, 3, 7, 7, 1, 9, 3])
    plan = plan_fetch(slots, None, bucket_rows=2)
    assert plan.uniques.tolist() == [1, 3, 7, 9]
    np.testing.assert_array_equal(plan.uniques[plan.inverse], slots)
    assert plan.n_pairs == 7 and plan.n_unique == 4 and plan.n_miss == 4
    assert all(c.size <= 2 for c in plan.miss_chunks)
    assert (np.diff(np.concatenate(plan.miss_chunks)) > 0).all()
    assert plan_fetch(np.asarray([], np.int64)) is None
    jplan = JT.plan_fetch(slots, None, bucket_rows=2)
    np.testing.assert_array_equal(plan.inverse, jplan.inverse)
    assert [c.tolist() for c in plan.miss_chunks] == [c.tolist() for c in jplan.miss_chunks]
    cache = DeviceRowCache(4, 4)
    cache.insert(np.asarray([3, 9]), torch.zeros((2, 4)))
    plan = plan_fetch(slots, cache, bucket_rows=4)
    assert plan.hit_mask.tolist() == [False, True, False, True] and plan.n_miss == 2


def test_cache_rows_env_override(monkeypatch):
    pts = _clustered(64, seed=2)
    monkeypatch.setenv("REPRO_TIER_CACHE_ROWS", "3")
    assert tiered_corpus(pts, device="cpu").cache.capacity == 3
    assert tiered_corpus(pts, cache_rows=9, device="cpu").cache.capacity == 9
    assert tiered_corpus(pts, resident_mb=1.0, device="cpu").cache.capacity == \
        (1 << 20) // (D * 4)
    monkeypatch.delenv("REPRO_TIER_CACHE_ROWS")
    assert tiered_corpus(pts, device="cpu").cache.capacity == 64 // 8


def test_host_row_store_layout_and_faults():
    raw = _clustered(33, d=D)
    store = HostRowStore(raw)
    assert (store.stride * 4) % ROW_ALIGN == 0 and store.stride >= D
    assert store.nbytes == 33 * store.stride * 4 and not store.pinned
    got = store.gather(np.asarray([5, 0, 32, 5]))
    np.testing.assert_array_equal(got.numpy().view(np.int32), raw[[5, 0, 32, 5]].view(np.int32))
    out = torch.full((8, D), -1.0)
    assert store.gather(np.asarray([1, 2]), out=out).data_ptr() == out.data_ptr()
    np.testing.assert_array_equal(out[:2].numpy(), raw[[1, 2]])
    with pytest.raises(TierFetchError):
        store.gather(np.asarray([33]))
    store.fail_next = 1
    with pytest.raises(TierFetchError):
        store.gather(np.asarray([0]))
    assert store.gather(np.asarray([0])).shape == (1, D)
    with pytest.raises(ValueError):
        tiered_corpus(dataclasses.replace(_engines()[0].points, raw=None), device="cpu")
