"""gatherdist-int8's and rerank_fetch's route plans and grids, and their
plain versions against the JAX package at the main path's forms.

* ``gatherdist/ops.py::plan``: ``regs`` for the f32-query form at l2 over
  code rows of whole 16-byte spans up to d = 256 on 16-byte bases, else
  ``warp``; one query a warp, no block without a query;
* ``rerank_fetch/ops.py::plan`` and ``persistent_blocks``: ``regs`` for
  at least ``REGS_MIN_PAIRS`` pairs over f32 rows of whole 16-byte spans up
  to d = 256 on 16-byte bases, else ``warp``; as many persistent blocks as
  the card holds, no more than the pairs' chunks fill (the card tests
  hold each route's split of that work against the plain version);
* the plain versions (what a CPU tensor dispatches to) against the JAX
  plain versions and the Pallas kernels in interpret mode: gatherdist-int8
  on (S,) shared start points expanded to (Q, S) as ``init_state`` does,
  both forms, int32 dots equal to the JAX codes' dot; rerank_fetch on the
  pairs ``_rerank_band`` builds (``torch.nonzero`` of a band mask, lane
  major), the same pairs shuffled, one-lane runs and a ragged P.

Tolerances as in ``test_torch_int8.py``: int32 dots equal; distances and
bounds ``allclose(rtol=1e-5, atol=1e-5)`` for l2, and for ip ``atol =
1e-6 * max|x| * max|q|`` (a reordered sum errs with its terms).
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import corpus as jcorpus
from repro.kernels import gatherdist as jax_gatherdist
from repro.kernels import gatherdist_ref as jax_gatherdist_ref
from repro.kernels.rerank_fetch import fetch_rerank_dists as jax_fetch
from repro_torch.core import corpus as tcorpus
from repro_torch.core.distances import gather_dist
from repro_torch.kernels.gatherdist import (
    gatherdist, gatherdist_int8_cuda, gatherdist_int8_ref)
from repro_torch.kernels.rerank_fetch import fetch_rerank_pairs, rerank_fetch_cuda
from repro_torch.utils import INVALID_ID

gops = sys.modules["repro_torch.kernels.gatherdist.ops"]
rops = sys.modules["repro_torch.kernels.rerank_fetch.ops"]

DIST_TOL = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132


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


def _both(pts):
    """One quantized corpus in both packages (the JAX package quantizes)."""
    jqc = jcorpus.quantize_corpus(jnp.asarray(pts))
    tqc = tcorpus.QuantizedCorpus(
        codes=torch.from_numpy(np.array(jqc.codes)),
        meta=torch.from_numpy(np.array(jqc.meta)),
        raw=torch.from_numpy(pts))
    return jqc, tqc


# ---------------------------------------------------------------------------
# the route plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,aligned,route", [
    (128, True, "regs"),      # the main path
    (256, True, "regs"),      # two 16-byte chunks a lane
    (16, True, "regs"),
    (144, True, "regs"),      # a ragged second chunk
    (272, True, "warp"),      # wider than two chunks a lane
    (120, True, "warp"),      # 4-byte words: d % 16 != 0
    (130, True, "warp"),
    (17, True, "warp"),
    (128, False, "warp"),     # a base off a 16-byte boundary
])
def test_gatherdist_int8_plan_routes_by_shape_and_alignment(d, aligned, route):
    """The f32-query form at l2 (what the main path launches) by shape and
    alignment; the int8-query form and ip always take warp."""
    for q in (0, 1, 8, 4096):
        p = gops.plan(q, d, aligned=aligned)
        assert p.route == route
        assert p.threads == 32 * gops.WARPS
        assert p.blocks == -(-q // gops.WARPS)
        for metric, quant in (("ip", False), ("l2", True), ("ip", True)):
            other = gops.plan(q, d, aligned=aligned, metric=metric,
                              quantize_query=quant)
            assert other == p._replace(route="warp")


@pytest.mark.parametrize("q", [1, 8, 9, 4096])
def test_gatherdist_int8_plan_grid_holds_every_query_once(q):
    """One query a warp: the grid's warps cover the queries, and no block
    is without one."""
    p = gops.plan(q, 128)
    assert p.blocks * gops.WARPS >= q > (p.blocks - 1) * gops.WARPS


def test_gatherdist_int8_plan_rejects():
    with pytest.raises(ValueError):
        gops.plan(4, 0)
    with pytest.raises(ValueError):
        gops.plan(-1, 128)
    with pytest.raises(ValueError):
        gops.plan(4, 128, metric="cosine")


@pytest.mark.parametrize("d,aligned,rows", [
    (128, True, True),        # the main path
    (256, True, True),
    (4, True, True),
    (132, True, True),        # a ragged last chunk
    (260, True, False),       # wider than eight chunks a lane
    (130, True, False),       # rows not whole 16-byte spans
    (17, True, False),
    (128, False, False),
])
def test_rerank_fetch_plan_routes_by_shape_and_alignment(d, aligned, rows):
    """regs where the rows allow and the band holds at least
    REGS_MIN_PAIRS pairs (the greedy band's 160,039 do), else warp."""
    assert rops.persistent_rows(d, aligned) == rows
    small, large = rops.REGS_MIN_PAIRS - 1, 160_039
    for p in (0, 1, 17, 4096, small):
        assert rops.plan(p, d, aligned=aligned) == "warp"
    for p in (rops.REGS_MIN_PAIRS, 65_536, large):
        assert rops.plan(p, d, aligned=aligned) == ("regs" if rows else "warp")


def test_rerank_fetch_plan_rejects():
    with pytest.raises(ValueError):
        rops.plan(10, 0)
    with pytest.raises(ValueError):
        rops.plan(-1, 128)


@pytest.mark.parametrize("pairs", [0, 1, 17, 4096, 160_039])
@pytest.mark.parametrize("sms,per_sm", [(H100_SMS, 1), (H100_SMS, 2), (H100_SMS, 6)])
def test_rerank_fetch_persistent_blocks(pairs, sms, per_sm):
    """As many blocks as the card holds, no more than the pairs' chunks of
    CHUNK fill: no block without a chunk, and every chunk on a warp of the
    grid in the first pass or a later one."""
    blocks = rops.persistent_blocks(pairs, sms, per_sm)
    chunks = -(-pairs // rops.CHUNK)
    assert 0 <= blocks <= sms * per_sm
    assert (blocks - 1) * rops.WARPS < chunks or blocks == 0
    assert (blocks > 0) == (pairs > 0)
    if chunks > rops.WARPS * sms * per_sm:
        assert blocks == sms * per_sm             # a full card when the pairs fill it
    else:
        assert blocks * rops.WARPS >= chunks      # one pass takes every chunk


# ---------------------------------------------------------------------------
# the plain versions at the main path's forms, against the JAX package
# ---------------------------------------------------------------------------

def _points(n, d, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    pts[0] = 0.0                                       # an all-zero row
    pts[1, :] = np.arange(d, dtype=np.float32) - d / 2  # codes on .5 steps
    return pts


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [16, 128])
def test_gatherdist_int8_shared_starts_match_jax(metric, d):
    """The start points as init_state gathers them: (S,) shared ids
    expanded to (Q, S), one of them the all-zero row."""
    rng = np.random.default_rng(d)
    pts = _points(300, d, d)
    qs = rng.standard_normal((12, d)).astype(np.float32)
    starts = np.array([0, 17, 1, 254], np.int32)
    jqc, tqc = _both(pts)
    tq = torch.from_numpy(qs)
    s = torch.from_numpy(starts).expand(qs.shape[0], -1)   # as init_state
    ids = np.broadcast_to(starts, (qs.shape[0], 4)).copy()
    tol = _tol(metric, pts, qs)
    # f32-query form: the loop's gather_dist against JAX's plain version
    want = jax_gatherdist_ref(jqc, jnp.asarray(ids), jnp.asarray(qs), metric=metric)
    _assert_dists(gather_dist(tqc, s, tq, metric).numpy(), want, tol)
    # int8-query form: the Pallas kernel in interpret mode
    want = jax_gatherdist(jqc, jnp.asarray(ids), jnp.asarray(qs), metric=metric,
                          use_pallas=True, interpret=True)
    got = gatherdist(tqc, s.contiguous(), tq, metric=metric, quantize_query=True)
    _assert_dists(got.numpy(), want, tol)
    _, dots = gatherdist_int8_ref(tqc, s.contiguous(), tq, metric=metric,
                                  quantize_query=True, return_dots=True)
    # the dots of the JAX package's codes and its query quantization
    scale = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(qs)), axis=-1), 1e-12) / 127.0
    qcodes = np.array(jnp.clip(jnp.round(jnp.asarray(qs) / scale[:, None]), -127, 127),
                      np.int32)
    want_dots = np.einsum("qsd,qd->qs", np.array(jqc.codes)[ids].astype(np.int32),
                          qcodes)
    np.testing.assert_array_equal(dots.numpy(), want_dots)


def _band_pairs(qn, cap, n, rng):
    """The pairs _rerank_band sends the kernel: a (Q, cap) result buffer,
    INVALID past each lane's count, a band mask on the valid entries, and
    (lanes, slots) by torch.nonzero (lane major)."""
    ids = torch.from_numpy(rng.integers(0, n, (qn, cap)).astype(np.int32))
    count = torch.from_numpy(rng.integers(0, cap + 1, qn))
    valid = torch.arange(cap)[None, :] < count[:, None]
    ids = torch.where(valid, ids, INVALID_ID)
    amb = valid & torch.from_numpy(rng.random((qn, cap)) < 0.6)
    lanes, slots = torch.nonzero(amb, as_tuple=True)
    return ids[lanes, slots].contiguous(), lanes.to(torch.int32).contiguous()


def _fetch_jax(raw, queries, ids, lanes, metric):
    """The JAX Pallas kernel in interpret mode on the pre-gathered query rows,
    padded to its tile of 16 (pad pairs: row 0, query 0) and cut back."""
    p = ids.shape[0]
    pad = -p % 16
    ids_p = np.concatenate([ids, np.zeros(pad, np.int32)])
    qv = queries[np.concatenate([lanes, np.zeros(pad, np.int32)])]
    out = jax_fetch(jnp.asarray(raw), jnp.asarray(ids_p), jnp.asarray(qv),
                    metric=metric, use_pallas=True, interpret=True)
    return np.asarray(out)[:p]


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("order", ["lane_major", "shuffled", "one_lane", "ragged"])
def test_rerank_fetch_band_pairs_match_jax(metric, order):
    rng = np.random.default_rng(7)
    n, d, qn, cap = 500, 128, 9, 24
    raw = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((qn, d)).astype(np.float32)
    ids, lanes = _band_pairs(qn, cap, n, rng)
    if order == "shuffled":
        perm = torch.from_numpy(rng.permutation(ids.shape[0]))
        ids, lanes = ids[perm].contiguous(), lanes[perm].contiguous()
    elif order == "one_lane":               # a single run of one lane
        lanes = torch.full_like(lanes, 3)
    elif order == "ragged":                 # P off every tile and chunk, ids clipped
        ids, lanes = ids[:37].clone(), lanes[:37].clone()
        ids[5], ids[6] = n + 4, -3
    assert ids.shape[0] >= 37
    got = fetch_rerank_pairs(torch.from_numpy(raw), torch.from_numpy(queries),
                             ids, lanes, metric=metric)
    want = _fetch_jax(raw, queries, np.clip(ids.numpy(), 0, n - 1), lanes.numpy(),
                      metric)
    _assert_dists(got.numpy(), want, _tol(metric, raw, queries))


def test_new_route_wrappers_refuse_cpu_tensors():
    """On a CPU tensor a wrapper of either kernel raises before it counts
    a launch or a route."""
    pts = _points(40, 32, 0)
    _, tqc = _both(pts)
    ids = torch.zeros((2, 4), dtype=torch.int32)
    qs = torch.zeros((2, 32))
    before = (dict(gatherdist_int8_cuda.routes), dict(rerank_fetch_cuda.routes))
    with pytest.raises(ValueError):
        gatherdist_int8_cuda(tqc.codes, tqc.meta, ids, qs, route="warp")
    with pytest.raises(ValueError):
        rerank_fetch_cuda(tqc.raw, qs, ids[0], ids[1], route="regs")
    assert (gatherdist_int8_cuda.routes, rerank_fetch_cuda.routes) == before
    assert set(gatherdist_int8_cuda.routes) == {"regs", "warp"}
    assert set(rerank_fetch_cuda.routes) == {"regs", "warp"}
