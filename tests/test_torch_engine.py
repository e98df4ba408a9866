"""The port's engine, oracle and radius methodology against the JAX package.

Both engines search one index (a Vamana graph built by the reference and
carried across with ``engine_from_arrays``), so the answers must agree:
ids, counts and flags equal, distances ``allclose(rtol=1e-5, atol=1e-6)``
(summation order differs by a few ulp). On the exact-recovery rig — radii
midway between consecutive sorted distances, a graph and beam that recover
each ball — the results equal the brute-force oracle as sets.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.distances import point_dist
from repro.core.graph import start_points as jax_start_points
from repro_torch.convert import engine_from_arrays
from repro_torch.core import (
    Graph, RangeConfig, RangeSearchEngine, SearchConfig, average_precision,
    build_knn_graph, default_grid, exact_range_search, exact_topk,
    make_label_filter, match_histogram, range_counts_at, recall_at_k,
    select_radius, start_points, sweep, zero_result_accuracy)
from repro_torch.utils import INVALID_ID

TOL = dict(rtol=1e-5, atol=1e-6)
MODES = ("beam", "doubling", "greedy")
_RIG: dict = {}


def _toy(n=2000, d=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, d)).astype(np.float32) * 3
    pts = (centers[rng.integers(0, 8, n)]
           + rng.standard_normal((n, d)).astype(np.float32) * 0.4)
    return pts.astype(np.float32)


def _rig(metric):
    """(points, JAX engine, port engine on its index, queries, mixed radii)."""
    if metric not in _RIG:
        pts = _toy()
        graph = J.build_vamana(jnp.asarray(pts), J.BuildConfig(
            max_degree=16, beam=32, insert_batch=256, metric=metric))
        jeng = J.RangeSearchEngine.from_graph(jnp.asarray(pts), graph, metric=metric)
        teng = engine_from_arrays(pts, np.asarray(graph.neighbors),
                                  np.asarray(jeng.start_ids), metric, device="cpu")
        qs = pts[:32] + 0.01
        exact = np.asarray(point_dist(pts[None], qs[:, None], metric))
        quant = np.linspace(0.02, 0.10, qs.shape[0])
        radii = np.array([np.quantile(exact[i], quant[i])
                          for i in range(qs.shape[0])], np.float32)
        _RIG[metric] = (pts, jeng, teng, qs, radii)
    return _RIG[metric]


def _cfgs(mode, metric, e=4):
    kw = dict(beam=16, max_beam=64 if mode == "doubling" else 16,
              visit_cap=128, metric=metric, expand_width=e)
    return (J.RangeConfig(search=J.SearchConfig(**kw), mode=mode, result_cap=512),
            RangeConfig(search=SearchConfig(**kw), mode=mode, result_cap=512))


def _assert_result_equal(jres, tres):
    for f in ("ids", "count", "overflow", "n_visited", "n_dist", "es_stopped",
              "phase2", "n_rerank"):
        np.testing.assert_array_equal(getattr(tres, f).cpu().numpy(),
                                      np.asarray(getattr(jres, f)), err_msg=f)
    a, b = tres.dists.cpu().numpy(), np.asarray(jres.dists)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_allclose(a[np.isfinite(b)], b[np.isfinite(b)], **TOL)


def _sets(ids, counts=None):
    ids = np.asarray(ids)
    counts = (ids != INVALID_ID).sum(1) if counts is None else np.asarray(counts)
    return [set(row[:c][row[:c] != INVALID_ID].tolist())
            for row, c in zip(ids, counts)]


# ---------------------------------------------------------------------------
# engine.range against the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("compacted", [True, False])
def test_engine_range_matches_jax(mode, metric, compacted):
    _, jeng, teng, qs, radii = _rig(metric)
    jcfg, tcfg = _cfgs(mode, metric)
    jres = jeng.range(jnp.asarray(qs), jnp.asarray(radii), cfg=jcfg,
                      compacted=compacted)
    tres = teng.range(qs, radii, cfg=tcfg, compacted=compacted)
    _assert_result_equal(jres, tres)
    if mode != "beam":
        assert tres.phase2.any()


@pytest.mark.parametrize("mode", ["doubling", "greedy"])
def test_engine_range_reference_step_matches_jax(mode):
    """E=1: the paper-faithful single-node steps of both phases."""
    _, jeng, teng, qs, radii = _rig("l2")
    jcfg, tcfg = _cfgs(mode, "l2", e=1)
    _assert_result_equal(jeng.range(jnp.asarray(qs), jnp.asarray(radii), cfg=jcfg),
                         teng.range(qs, radii, cfg=tcfg))


@pytest.mark.parametrize("compacted", [True, False])
def test_tombstones_match_jax(compacted):
    """Tombstoned slots route the walk but never answer."""
    pts, jeng, teng, qs, radii = _rig("l2")
    rng = np.random.default_rng(5)
    dead = rng.choice(pts.shape[0], 300, replace=False)
    words = np.zeros(-(-pts.shape[0] // 32), np.uint32)
    np.bitwise_or.at(words, dead // 32, (np.uint32(1) << (dead % 32).astype(np.uint32)))
    jcfg, tcfg = _cfgs("greedy", "l2")
    jres = jeng.range(jnp.asarray(qs), jnp.asarray(radii), cfg=jcfg,
                      compacted=compacted, tombstones=jnp.asarray(words))
    tres = teng.range(qs, radii, cfg=tcfg, compacted=compacted, tombstones=words)
    _assert_result_equal(jres, tres)
    got = set(tres.ids.numpy().ravel().tolist())
    assert not got & set(dead.tolist())


def test_topk_matches_jax():
    _, jeng, teng, qs, _ = _rig("l2")
    jids, jd = jeng.topk(jnp.asarray(qs), k=10)
    tids, td = teng.topk(qs, k=10)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_from_graph_and_bf16_corpus_match_jax(metric):
    """``from_graph`` picks the reference's entry points; a bf16-stored
    corpus (f32 math) answers like the reference's bf16 engine."""
    pts, jeng, teng, qs, radii = _rig(metric)
    np.testing.assert_array_equal(
        start_points(torch.from_numpy(pts), metric, 4).numpy(),
        np.asarray(jax_start_points(jnp.asarray(pts), metric, 4)))
    jb = J.RangeSearchEngine.from_graph(jnp.asarray(pts), jeng.graph, metric=metric,
                                        corpus_dtype="bfloat16")
    tb = RangeSearchEngine.from_graph(pts, Graph(torch.from_numpy(
        np.array(jeng.graph.neighbors))), metric=metric, corpus_dtype="bfloat16",
        device="cpu")
    np.testing.assert_array_equal(tb.start_ids.numpy(), np.asarray(jb.start_ids))
    jcfg, tcfg = _cfgs("greedy", metric)
    _assert_result_equal(jb.range(jnp.asarray(qs), jnp.asarray(radii), cfg=jcfg),
                         tb.range(qs, radii, cfg=tcfg))
    stats = tb.stats()
    assert stats["corpus_dtype"] == "bfloat16" and stats["hot_bytes_per_vector"] == 32
    assert stats["num_points"] == pts.shape[0] and stats["max_degree"] == 16


def test_unported_options_raise():
    """A filter on an engine without labels raises ``ValueError``, as the
    reference's does."""
    _, jeng, teng, qs, radii = _rig("l2")
    jfilt = J.make_label_filter([[0]] * qs.shape[0], 4)
    with pytest.raises(ValueError, match="no labels"):
        jeng.range(jnp.asarray(qs), jnp.asarray(radii), filter=jfilt)
    with pytest.raises(ValueError, match="no labels"):
        teng.range(qs, radii, filter=make_label_filter([[0]] * qs.shape[0], 4))


# ---------------------------------------------------------------------------
# exact-recovery rig: results equal the brute-force oracle as sets
# ---------------------------------------------------------------------------

def _recovery_rig():
    """The reference's labeled-rig recipe without labels: a two-pass Vamana
    graph, beam >= ball size, and radii midway between the k-th and
    (k+1)-th sorted distances (16 <= k <= 96) so every ball is unambiguous
    at f32 precision."""
    if "recovery" not in _RIG:
        rng = np.random.default_rng(3)
        centers = rng.standard_normal((8, 10)).astype(np.float32) * 3
        pts = (centers[rng.integers(0, 8, 1200)]
               + rng.standard_normal((1200, 10)).astype(np.float32) * 0.4)
        pts = pts.astype(np.float32)
        graph = J.build_vamana(jnp.asarray(pts), J.BuildConfig(
            max_degree=24, beam=48, insert_batch=256, two_pass=True))
        jeng = J.RangeSearchEngine.from_graph(jnp.asarray(pts), graph)
        teng = engine_from_arrays(pts, np.asarray(graph.neighbors),
                                  np.asarray(jeng.start_ids), device="cpu")
        qs = pts[:24] + 0.01
        srt = np.sort(np.asarray(point_dist(pts[None], qs[:, None], "l2")), axis=1)
        ks = np.linspace(16, 96, qs.shape[0]).astype(int)
        lanes = np.arange(qs.shape[0])
        radii = ((srt[lanes, ks] + srt[lanes, ks + 1]) / 2).astype(np.float32)
        _RIG["recovery"] = (pts, jeng, teng, qs, radii, ks + 1)
    return _RIG["recovery"]


@pytest.mark.parametrize("compacted", [True, False])
def test_exact_recovery_equals_oracle(compacted):
    pts, jeng, teng, qs, radii, sizes = _recovery_rig()
    cfg = RangeConfig(search=SearchConfig(beam=48, max_beam=48, visit_cap=384),
                      mode="greedy", result_cap=512)
    res = teng.range(qs, radii, cfg=cfg, compacted=compacted)
    oracle = exact_range_search(pts, qs, radii, device="cpu")
    j_oracle = J.exact_range_search(jnp.asarray(pts), jnp.asarray(qs),
                                    jnp.asarray(radii))
    np.testing.assert_array_equal(oracle[2].numpy(), sizes)
    np.testing.assert_array_equal(oracle[2].numpy(), np.asarray(j_oracle[2]))
    want = _sets(oracle[0].numpy(), oracle[2].numpy())
    assert _sets(j_oracle[0], j_oracle[2]) == want
    assert _sets(res.ids.numpy(), res.count.numpy()) == want
    assert average_precision(oracle[0].numpy(), oracle[2].numpy(),
                             res.ids.numpy(), res.count.numpy()) == 1.0


# ---------------------------------------------------------------------------
# oracle, graph build, radius methodology, metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ground_truth_matches_jax(metric):
    pts, _, _, qs, radii = _rig(metric)
    t_pts, t_qs = torch.from_numpy(pts), torch.from_numpy(qs)
    for r, cap in ((radii, 4096), (radii, 16), (float(np.median(radii)), 64)):
        jr = J.exact_range_search(jnp.asarray(pts), jnp.asarray(qs),
                                  jnp.asarray(r), metric, cap=cap, block=512)
        tr = exact_range_search(t_pts, t_qs, r, metric, cap=cap, block=700,
                                device="cpu")
        np.testing.assert_array_equal(tr[2].numpy(), np.asarray(jr[2]))
        assert _sets(tr[0].numpy()) == _sets(jr[0])
        np.testing.assert_allclose(np.sort(np.where(np.isfinite(tr[1].numpy()),
                                                    tr[1].numpy(), 0)), np.sort(
            np.where(np.isfinite(np.asarray(jr[1])), np.asarray(jr[1]), 0)),
            rtol=1e-5, atol=1e-4)
    jk = J.exact_topk(jnp.asarray(pts), jnp.asarray(qs), k=12, metric=metric, block=512)
    tk = exact_topk(t_pts, t_qs, k=12, metric=metric, block=700, query_block=10,
                    device="cpu")
    np.testing.assert_array_equal(tk[0].numpy(), np.asarray(jk[0]))
    grid = np.quantile(radii, [0.1, 0.5, 0.9]).astype(np.float32)
    np.testing.assert_array_equal(
        range_counts_at(t_pts, t_qs, grid, metric, block=300, device="cpu").numpy(),
        np.asarray(J.range_counts_at(jnp.asarray(pts), jnp.asarray(qs),
                                     jnp.asarray(grid), metric)))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_build_knn_graph_matches_jax(metric):
    """Equal neighbor lists, except where two candidates tie at f32
    precision: the two frameworks' matmuls round the norm-form distances
    differently, so a near-tie may swap places (or swap across the k-th
    place). Every difference must be such a tie."""
    pts = _toy(n=600, d=12, seed=4)
    k = 8
    want = np.asarray(J.build_knn_graph(jnp.asarray(pts), k=k, metric=metric).neighbors)
    got = build_knn_graph(pts, k=k, metric=metric, device="cpu", block=256,
                          query_block=100).neighbors.numpy()
    p64 = pts.astype(np.float64)
    exact = (((p64[:, None] - p64[None]) ** 2).sum(-1) if metric == "l2"
             else -(p64 @ p64.T))
    rows = np.arange(pts.shape[0])[:, None]
    tie = 1e-5 * (1.0 + np.abs(exact[rows, want]))
    assert np.all(np.abs(exact[rows, got] - exact[rows, want]) <= tie)
    assert np.mean(got == want) > 0.99


def test_radius_methodology_matches_jax():
    pts, _, _, qs, _ = _rig("l2")
    grid = default_grid(pts, qs, "l2", num=24)
    np.testing.assert_array_equal(grid, J.default_grid(pts, qs, "l2", num=24))
    jp = J.sweep(pts, qs, grid, "l2")
    tp = sweep(pts, qs, grid, "l2", device="cpu")
    np.testing.assert_array_equal(tp.counts, jp.counts)
    np.testing.assert_allclose(tp.robustness, jp.robustness, rtol=1e-6)
    assert select_radius(tp, 0.5) == J.select_radius(jp, 0.5)
    assert match_histogram(tp.counts[:, 5]) == J.match_histogram(jp.counts[:, 5])


def test_metrics_match_jax():
    rng = np.random.default_rng(7)
    gt = rng.integers(0, 50, (20, 30)).astype(np.int32)
    gt_c = rng.integers(0, 40, 20)
    res = rng.integers(0, 50, (20, 25)).astype(np.int32)
    res[:, -3:] = INVALID_ID
    res_c = rng.integers(0, 25, 20)
    assert average_precision(gt, gt_c, res, res_c) == J.average_precision(gt, gt_c, res, res_c)
    assert recall_at_k(gt, res, 10) == J.recall_at_k(gt, res, 10)
    assert zero_result_accuracy(gt_c % 3, res_c % 4) == J.zero_result_accuracy(gt_c % 3, res_c % 4)
