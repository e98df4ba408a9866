"""The port's int8 corpus modules against the JAX package.

The same numpy inputs (from a seed) go through the JAX function and its
port, at n of a few hundred and d in {16, 17, 32}: quantization, the
query error and the certified bounds, and the plain versions of the three
int8-path kernels (expand-int8, gatherdist-int8, rerank_fetch) in both
arithmetic forms: the f32-query form against the JAX plain versions, the
int8-query form against the Pallas kernels in interpret mode.

Tolerances: codes, ids, n_dist and int32 dots equal; f32 metadata
``allclose(rtol=1e-5, atol=1e-6)``; distances and bounds ``allclose(rtol=
1e-5, atol=1e-5)`` — the two frameworks sum the d terms in different
orders, a few ulp. For ip the error of a reordered sum scales with its
terms (bounded by |x||q|), not its value, so ``atol`` is
1e-6 * max|x| * max|q|, as in ROADMAP §3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import corpus as jcorpus
from repro.dist import compression as jcomp
from repro.kernels import expand_frontier as jax_expand
from repro.kernels import expand_frontier_ref as jax_expand_ref
from repro.kernels import gatherdist as jax_gatherdist
from repro.kernels import gatherdist_ref as jax_gatherdist_ref
from repro.kernels.rerank_fetch import fetch_rerank_dists as jax_fetch
from repro_torch.core import corpus as tcorpus
from repro_torch.core.distances import gather_dist
from repro_torch.dist import compression as tcomp
from repro_torch.kernels.expand import (
    expand_frontier, expand_frontier_int8_ref, expand_frontier_ref, expand_int8_cuda)
from repro_torch.kernels.gatherdist import (
    gatherdist, gatherdist_int8_cuda, gatherdist_int8_ref)
from repro_torch.kernels.rerank_fetch import (
    fetch_rerank_dists, fetch_rerank_dists_ref, fetch_rerank_pairs, rerank_fetch_cuda)
from repro_torch.utils import INVALID_ID

META_TOL = dict(rtol=1e-5, atol=1e-6)
DIST_TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = (16, 17, 32)


def _tol(metric, pts, qs):
    if metric == "l2":
        return DIST_TOL
    scale = np.linalg.norm(pts, axis=1).max() * np.linalg.norm(qs, axis=1).max()
    return dict(rtol=1e-5, atol=1e-6 * max(1.0, float(scale)))


def _assert_dists(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **tol)


def _points(n, d, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    pts[0] = 0.0                                   # an all-zero row
    pts[1, :] = np.arange(d, dtype=np.float32) - d / 2  # codes on .5 steps
    return pts


def _both(pts):
    """One quantized corpus in both packages: the JAX package quantizes,
    the port carries the identical codes and metadata across."""
    jqc = jcorpus.quantize_corpus(jnp.asarray(pts))
    tqc = tcorpus.QuantizedCorpus(
        codes=torch.from_numpy(np.array(jqc.codes)),
        meta=torch.from_numpy(np.array(jqc.meta)),
        raw=torch.from_numpy(pts))
    return jqc, tqc


def _expand_fixture(n, r, d, q, e, seed=0):
    rng = np.random.default_rng(seed)
    pts = _points(n, d, seed)
    adj = rng.integers(0, n, (n, r)).astype(np.int32)
    adj[:, -max(1, r // 4):] = INVALID_ID      # INVALID-padded adjacency rows
    adj[0, 1] = adj[0, 0]                      # duplicate neighbor in-row
    adj[1, :2] = adj[0, :2]                    # duplicates across rows
    qs = rng.standard_normal((q, d)).astype(np.float32)
    fr = rng.integers(0, n, (q, e)).astype(np.int32)
    fr[0, 1] = fr[0, 0]                        # duplicate frontier node
    fr[-1, -1] = INVALID_ID                    # padded frontier lane
    return pts, adj, fr, qs


def _gather_fixture(n, d, q, s, seed=0):
    rng = np.random.default_rng(seed)
    pts = _points(n, d, seed)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    ids = rng.integers(0, n, (q, s)).astype(np.int32)
    ids[0, -1] = INVALID_ID
    ids[-1, 0] = n + 5  # out of range
    return pts, ids, qs


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


# ---------------------------------------------------------------------------
# quantization, query error, bounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", DIMS)
def test_quantize_matches_jax(d):
    pts = _points(300, d, seed=d)
    jc, jm = jcorpus.quantize_rows(jnp.asarray(pts))
    tc, tm = tcorpus.quantize_rows(torch.from_numpy(pts))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **META_TOL)
    assert tc.dtype == torch.int8 and tm.shape == (300, 3)
    # the two quantizers of dist.compression, and the dequantizer
    jq, js = jcomp.quantize_int8(jnp.asarray(pts))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(pts))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    jr, jrs = jcomp.quantize_int8_rows(jnp.asarray(pts))
    tr, trs = tcomp.quantize_int8_rows(torch.from_numpy(pts))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(trs.numpy(), np.asarray(jrs))
    np.testing.assert_array_equal(
        tcomp.dequantize_int8(tr, trs[:, None]).numpy(),
        np.asarray(jcomp.dequantize_int8(jr, jrs[:, None])))
    # the corpus helpers
    tqc = tcorpus.quantize_corpus(torch.from_numpy(pts))
    assert tcorpus.corpus_dtype_name(tqc) == "int8"
    assert tcorpus.bytes_per_vector(tqc) == d + tcorpus.META_BYTES
    assert (tcorpus.corpus_size(tqc), tcorpus.corpus_dim(tqc)) == (300, d)
    assert tcorpus.corpus_raw(tqc) is tqc.raw
    with pytest.raises(ValueError):
        tcorpus.corpus_raw(tcorpus.quantize_corpus(torch.from_numpy(pts),
                                                   keep_raw=False))
    np.testing.assert_array_equal(tqc.scales.numpy(), tm[:, 0].numpy())


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", DIMS)
def test_query_error_and_bounds_match_jax(metric, d):
    rng = np.random.default_rng(d)
    pts = _points(200, d, seed=d + 1)
    jqc, tqc = _both(pts)
    qs = rng.standard_normal((5, d)).astype(np.float32)
    np.testing.assert_allclose(tcorpus.query_quant_err(torch.from_numpy(qs)).numpy(),
                               np.asarray(jcorpus.query_quant_err(jnp.asarray(qs))),
                               rtol=1e-5, atol=1e-7)
    ids = rng.integers(0, 200, (5, 12)).astype(np.int32)
    d_hat = rng.uniform(-5, 40, (5, 12)).astype(np.float32)
    meta = np.asarray(jqc.meta)[ids]
    err_q = rng.uniform(0, 0.1, (5, 1)).astype(np.float32)
    q_norm = np.linalg.norm(qs, axis=1)[:, None].astype(np.float32)
    want = jcorpus.lower_bound_dists(jnp.asarray(meta), jnp.asarray(d_hat),
                                     jnp.asarray(err_q), jnp.asarray(q_norm), metric)
    got = tcorpus.lower_bound_dists(*_t(meta, d_hat, err_q, q_norm), metric)
    _assert_dists(got.numpy(), want, DIST_TOL)
    # the upper bound, one lane at a time in JAX (it takes one query)
    tub = tcorpus.upper_bound_dists(tqc, *_t(ids, d_hat, qs), metric)
    for i in range(qs.shape[0]):
        jub = jcorpus.upper_bound_dists(jqc, jnp.asarray(ids[i]),
                                        jnp.asarray(d_hat[i]), jnp.asarray(qs[i]),
                                        metric)
        _assert_dists(tub[i].numpy(), jub, DIST_TOL)
    # the f32-query gather, the loop's plain path
    want = jcorpus.quantized_gather_lb(jqc, jnp.asarray(ids), jnp.asarray(qs),
                                       metric)
    got = tcorpus.quantized_gather_lb(tqc, *_t(ids, qs), metric)
    _assert_dists(got.numpy(), want, _tol(metric, pts, qs))


# ---------------------------------------------------------------------------
# the plain versions of expand-int8 and gatherdist-int8, both forms
# ---------------------------------------------------------------------------

EXPAND_SHAPES = [(150, 8, 32, 6, 4), (64, 5, 17, 3, 2), (120, 6, 16, 4, 3)]


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n,r,d,q,e", EXPAND_SHAPES[:2])
def test_expand_f32_query_form_matches_jax(metric, n, r, d, q, e):
    pts, adj, fr, qs = _expand_fixture(n, r, d, q, e)
    jqc, tqc = _both(pts)
    ids, dd, nd = jax_expand_ref(jqc, jnp.asarray(adj), jnp.asarray(fr),
                                 jnp.asarray(qs), metric=metric)
    ta, tf, tq = _t(adj, fr, qs)
    for got in (expand_frontier(tqc, ta, tf, tq, metric=metric),
                expand_frontier_ref(tqc, ta, tf, tq, metric=metric)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ids))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(nd))
        _assert_dists(got[1].numpy(), dd, _tol(metric, pts, qs))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n,r,d,q,e", EXPAND_SHAPES)
def test_expand_int8_query_form_matches_pallas_interpret(metric, n, r, d, q, e):
    pts, adj, fr, qs = _expand_fixture(n, r, d, q, e, seed=1)
    jqc, tqc = _both(pts)
    ids, dd, nd = jax_expand(jqc, jnp.asarray(adj), jnp.asarray(fr),
                             jnp.asarray(qs), metric=metric, use_pallas=True,
                             interpret=True)
    ta, tf, tq = _t(adj, fr, qs)
    got = expand_frontier(tqc, ta, tf, tq, metric=metric, quantize_query=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ids))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(nd))
    _assert_dists(got[1].numpy(), dd, _tol(metric, pts, qs))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n,d,q,s", [(100, 32, 8, 16), (57, 17, 5, 7),
                                     (80, 16, 4, 4)])
def test_gatherdist_int8_forms_match_jax(metric, n, d, q, s):
    pts, ids, qs = _gather_fixture(n, d, q, s)
    jqc, tqc = _both(pts)
    ti, tq = _t(ids, qs)
    tol = _tol(metric, pts, qs)
    # f32-query form: JAX's plain version, and the loop's gather_dist
    want = jax_gatherdist_ref(jqc, jnp.asarray(ids), jnp.asarray(qs), metric=metric)
    _assert_dists(gatherdist(tqc, ti, tq, metric=metric).numpy(), want, tol)
    _assert_dists(gather_dist(tqc, ti, tq, metric).numpy(), want, tol)
    # int8-query form: the Pallas kernel in interpret mode
    want = jax_gatherdist(jqc, jnp.asarray(ids), jnp.asarray(qs), metric=metric,
                          use_pallas=True, interpret=True)
    got = gatherdist(tqc, ti, tq, metric=metric, quantize_query=True)
    _assert_dists(got.numpy(), want, tol)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("quantize_query", [False, True])
@pytest.mark.parametrize("d", DIMS)
def test_int8_bounds_lower_bound_exact_distances(metric, quantize_query, d):
    """Both forms, both kernels' plain versions: every bound <= the exact
    f32 distance (+1e-5)."""
    pts, adj, fr, qs = _expand_fixture(200, 8, d, 6, 4, seed=d)
    _, tqc = _both(pts)
    ta, tf, tq = _t(adj, fr, qs)
    ids, dd, _ = expand_frontier(tqc, ta, tf, tq, metric=metric,
                                 quantize_query=quantize_query)
    keep = ids != INVALID_ID
    vecs = torch.from_numpy(pts)[torch.where(keep, ids, 0).long()]
    exact = (((vecs - tq[:, None]) ** 2).sum(-1) if metric == "l2"
             else -(vecs * tq[:, None]).sum(-1))
    assert keep.sum() > 0
    assert (dd[keep] <= exact[keep] + 1e-5).all()
    g = gatherdist(tqc, torch.where(keep, ids, INVALID_ID), tq, metric=metric,
                   quantize_query=quantize_query)
    assert (g[keep] <= exact[keep] + 1e-5).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", (17, 32))
def test_int8_query_forms_agree_with_each_other(metric, d):
    """The two int8-query plain versions give equal int32 dots and equal
    bounds on the candidates they share (the CUDA kernels are held to the
    same, bit for bit, on a card)."""
    pts, adj, fr, qs = _expand_fixture(120, 6, d, 4, 3, seed=3)
    _, tqc = _both(pts)
    ta, tf, tq = _t(adj, fr, qs)
    ids, dd, _, dots = expand_frontier_int8_ref(tqc, ta, tf, tq, metric=metric,
                                                quantize_query=True,
                                                return_dots=True)
    g, gdots = gatherdist_int8_ref(tqc, ids, tq, metric=metric,
                                   quantize_query=True, return_dots=True)
    assert torch.equal(dots, gdots)
    keep = ids != INVALID_ID
    np.testing.assert_array_equal(g[keep].numpy(), dd[keep].numpy())


# ---------------------------------------------------------------------------
# rerank_fetch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", DIMS)
def test_fetch_rerank_matches_jax(metric, d):
    rng = np.random.default_rng(d)
    raw = rng.standard_normal((90, d)).astype(np.float32)
    p = 32                       # the Pallas kernel takes whole tiles of 16
    ids = rng.integers(0, 90, p).astype(np.int32)
    ids[3] = 95                  # clipped to N - 1, as the reference clips
    ids[4] = -2
    qv = rng.standard_normal((p, d)).astype(np.float32)
    want = jax_fetch(jnp.asarray(raw), jnp.asarray(ids), jnp.asarray(qv),
                     metric=metric, use_pallas=True, interpret=True)
    tr, ti, tq = _t(raw, ids, qv)
    tol = _tol(metric, raw, qv)
    _assert_dists(fetch_rerank_dists(tr, ti, tq, metric=metric).numpy(), want, tol)
    _assert_dists(fetch_rerank_dists_ref(tr, ti, tq, metric).numpy(), want, tol)
    # a ragged P and pairs that read the query rows in place
    lanes = rng.integers(0, 5, 17).astype(np.int32)
    queries = qv[:5]
    tl, tqq = _t(lanes, queries)
    want = jax_fetch(jnp.asarray(raw), jnp.asarray(ids[:17]),
                     jnp.asarray(queries[lanes]), metric=metric)
    _assert_dists(fetch_rerank_pairs(tr, tqq, ti[:17], tl, metric=metric).numpy(),
                  want, tol)


def test_int8_cuda_wrappers_refuse_cpu_tensors():
    """A CPU tensor reaches a kernel wrapper only by a direct call, and then
    it raises rather than computing anything or counting a launch."""
    pts, adj, fr, qs = _expand_fixture(40, 4, 16, 2, 2)
    _, tqc = _both(pts)
    ta, tf, tq = _t(adj, fr, qs)
    before = (expand_int8_cuda.launches, gatherdist_int8_cuda.launches,
              rerank_fetch_cuda.launches)
    with pytest.raises(ValueError):
        expand_int8_cuda(tqc.codes, tqc.meta, ta, tf, tq)
    with pytest.raises(ValueError):
        gatherdist_int8_cuda(tqc.codes, tqc.meta, ta[:2], tq)
    with pytest.raises(ValueError):
        rerank_fetch_cuda(tqc.raw, tq, ta[0], ta[1])
    expand_frontier(tqc, ta, tf, tq)  # CPU: the plain version
    assert (expand_int8_cuda.launches, gatherdist_int8_cuda.launches,
            rerank_fetch_cuda.launches) == before
