"""The port's int8 corpus path end to end against the JAX package.

Both engines search one index: a Vamana graph built by the reference, and
the corpus quantized by the reference and carried across with
``engine_from_arrays(codes=, meta=)``, so both search the identical codes.
With ``use_expand_kernel=False`` (the f32-query form, the reference's
default) every lane must agree: ids, count, overflow, phase2, n_dist and
n_rerank equal, distances ``allclose(rtol=1e-5, atol=1e-6)`` (sums run in
another order, a few ulp). The guard-band contract is then checked on the
port alone, in both forms, against the exact oracle.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.distances import point_dist
from repro_torch.convert import engine_from_arrays
from repro_torch.core import (
    Graph, RangeConfig, RangeSearchEngine, SearchConfig, average_precision,
    exact_range_search)
from repro_torch.utils import INVALID_ID

TOL = dict(rtol=1e-5, atol=1e-6)
_RIG: dict = {}


def _rig(metric):
    """(points, JAX int8 engine, port int8 engine, port f32 engine, queries,
    mixed radii, exact (Q, N) distances) on one graph."""
    if metric not in _RIG:
        rng = np.random.default_rng(0)
        centers = rng.standard_normal((8, 16)).astype(np.float32) * 3
        pts = (centers[rng.integers(0, 8, 2000)]
               + rng.standard_normal((2000, 16)).astype(np.float32) * 0.4)
        pts = pts.astype(np.float32)
        graph = J.build_vamana(jnp.asarray(pts), J.BuildConfig(
            max_degree=16, beam=32, insert_batch=256, metric=metric))
        jf = J.RangeSearchEngine.from_graph(jnp.asarray(pts), graph, metric=metric)
        jqc = J.quantize_corpus(jnp.asarray(pts))
        jeng = J.RangeSearchEngine(points=jqc, graph=graph,
                                   start_ids=jf.start_ids, metric=metric)
        arrays = (pts, np.asarray(graph.neighbors), np.asarray(jf.start_ids), metric)
        teng = engine_from_arrays(*arrays, device="cpu", codes=np.asarray(jqc.codes),
                                  meta=np.asarray(jqc.meta))
        tf = engine_from_arrays(*arrays, device="cpu")
        qs = pts[:32] + 0.01
        exact = np.asarray(point_dist(pts[None], qs[:, None], metric))
        quant = np.linspace(0.02, 0.10, qs.shape[0])
        radii = np.array([np.quantile(exact[i], quant[i])
                          for i in range(qs.shape[0])], np.float32)
        _RIG[metric] = (pts, jeng, teng, tf, qs, radii, exact)
    return _RIG[metric]


def _cfgs(mode, metric, **kw):
    sk = dict(beam=16, max_beam=64 if mode == "doubling" else 16,
              visit_cap=128, metric=metric, expand_width=4)
    return (J.RangeConfig(search=J.SearchConfig(**sk, corpus_dtype="int8"),
                          mode=mode, result_cap=512),
            RangeConfig(search=SearchConfig(**sk, **kw), mode=mode, result_cap=512))


def _assert_result_equal(jres, tres):
    for f in ("ids", "count", "overflow", "n_visited", "n_dist", "es_stopped",
              "phase2", "n_rerank"):
        np.testing.assert_array_equal(getattr(tres, f).cpu().numpy(),
                                      np.asarray(getattr(jres, f)), err_msg=f)
    a, b = tres.dists.cpu().numpy(), np.asarray(jres.dists)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_allclose(a[np.isfinite(b)], b[np.isfinite(b)], **TOL)


@pytest.mark.parametrize("mode,metric,compacted", [
    (mode, metric, True) for mode in ("beam", "doubling", "greedy")
    for metric in ("l2", "ip")] + [
    ("greedy", "l2", False), ("greedy", "ip", False), ("doubling", "l2", False)])
def test_int8_engine_range_matches_jax(mode, metric, compacted):
    _, jeng, teng, _, qs, radii, _ = _rig(metric)
    jcfg, tcfg = _cfgs(mode, metric)
    jres = jeng.range(jnp.asarray(qs), jnp.asarray(radii), cfg=jcfg,
                      compacted=compacted)
    tres = teng.range(qs, radii, cfg=tcfg, compacted=compacted)
    _assert_result_equal(jres, tres)
    assert tres.n_rerank.sum() > 0        # the band is exercised
    if mode != "beam":
        assert tres.phase2.any()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("mode", ["beam", "doubling", "greedy"])
@pytest.mark.parametrize("use_expand_kernel", [False, True])
def test_int8_guard_band_contract(metric, mode, use_expand_kernel):
    """The reference's guard-band contract (tests/test_oracle.py), for the
    port in both arithmetic forms, with mixed per-query radii:
    (a) the post-rerank set is a subset of the rerank-disabled set;
    (b) every returned id is exactly in range;
    (c) the post-rerank set equals the rerank-disabled set filtered by the
        exact oracle;
    (d) returned distances never exceed the exact ones;
    (e) AP within 0.01 of the f32 engine on the same graph."""
    pts, _, teng, tf, qs, radii, exact = _rig(metric)
    _, cfg = _cfgs(mode, metric, use_expand_kernel=use_expand_kernel)
    res = teng.range(qs, radii, cfg=cfg)
    pre = teng.range(qs, radii, cfg=dataclasses.replace(cfg, rerank=False))
    if mode != "beam":  # beam mode keeps 16 slots a lane, often all sure
        assert int(res.n_rerank.sum()) > 0
    ids, dists, count = res.ids.numpy(), res.dists.numpy(), res.count.numpy()
    over = res.overflow.numpy() | pre.overflow.numpy()
    ids_pre = pre.ids.numpy()
    for i in range(ids.shape[0]):
        ok = ids[i] != INVALID_ID
        got = ids[i][ok]
        tol = 1e-5 + 1e-6 * abs(float(radii[i]))
        assert np.all(exact[i, got] <= radii[i] + tol), f"lane {i}"       # (b)
        assert np.all(dists[i][ok] <= exact[i, got] + tol), f"lane {i}"   # (d)
        assert count[i] == ok.sum()
        if over[i]:
            continue  # capped buffers may drop members legitimately
        s_post = set(got.tolist())
        s_pre = set(ids_pre[i][ids_pre[i] != INVALID_ID].tolist())
        assert s_post <= s_pre, f"lane {i}"                               # (a)
        want = {j for j in s_pre if exact[i, j] <= radii[i] + tol}
        assert s_post == want, f"lane {i}: {sorted(s_post ^ want)}"       # (c)
    gt = exact_range_search(pts, qs, radii, metric, device="cpu")
    res_f = tf.range(qs, radii, cfg=cfg)
    ap_q, ap_f = (average_precision(gt[0].numpy(), gt[2].numpy(), x.ids.numpy(),
                                    x.count.numpy()) for x in (res, res_f))
    assert ap_q >= ap_f - 0.01, (ap_q, ap_f)                              # (e)


@pytest.mark.parametrize("use_expand_kernel", [False, True])
def test_int8_fused_matches_compacted(use_expand_kernel):
    """The fused walk (phase 2 masked over every lane) and the compacted
    walk end in the same rerank: the same sets and the same band sizes."""
    _, _, teng, _, qs, radii, _ = _rig("l2")
    _, cfg = _cfgs("greedy", "l2", use_expand_kernel=use_expand_kernel)
    a = teng.range(qs, radii, cfg=cfg, compacted=True)
    b = teng.range(qs, radii, cfg=cfg, compacted=False)
    assert torch.equal(a.count, b.count) and torch.equal(a.n_rerank, b.n_rerank)
    for ra, rb in zip(a.ids.numpy(), b.ids.numpy()):
        assert set(ra[ra != INVALID_ID]) == set(rb[rb != INVALID_ID])


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_from_graph_int8_matches_jax_quantize(metric):
    """``from_graph(corpus_dtype="int8")`` quantizes as the reference does,
    keeps the raw rows, reports int8 stats, and answers top-k like the
    reference's int8 engine."""
    pts, jeng, teng, _, qs, _, _ = _rig(metric)
    eng = RangeSearchEngine.from_graph(pts, Graph(teng.graph.neighbors),
                                       metric=metric, corpus_dtype="int8",
                                       device="cpu")
    np.testing.assert_array_equal(eng.points.codes.numpy(),
                                  np.asarray(jeng.points.codes))
    np.testing.assert_allclose(eng.points.meta.numpy(),
                               np.asarray(jeng.points.meta), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(eng.points.raw.numpy(), pts)
    np.testing.assert_array_equal(eng.start_ids.numpy(), teng.start_ids.numpy())
    stats = eng.stats()
    assert stats["corpus_dtype"] == "int8" and stats["hot_bytes_per_vector"] == 16 + 12
    assert stats == J.RangeSearchEngine.stats(jeng) | {
        "mean_degree": stats["mean_degree"]}
    jids, jd = jeng.topk(jnp.asarray(qs), k=10)
    tids, td = teng.topk(qs, k=10)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
