"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and skips without one; the module imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -q tests/test_torch_cuda.py

Tolerance: ids, counts and int32 dots equal; distances ``allclose(rtol=
1e-5, atol=1e-5)`` for l2, and for ip ``atol = 1e-6 * max|x| * max|q|`` —
the kernel sums the d terms in another order than PyTorch, and a reordered
dot product errs in proportion to its terms, not to its value. The two int8
kernels share their arithmetic and must agree bit for bit. expand's two
routes (bulk, warp) and gatherdist-int8's (regs, warp) take each row's sum
in the same order, so their outputs must agree bit for bit too;
rerank_fetch's routes (regs, warp) sum in different orders and are each
held to the plain version. Each such case asserts the route it took.

flashattn is held to its plain version with ``allclose(rtol=2e-4,
atol=2e-4)`` in f32 (the kernel scales q before the product and sums
online, the plain version scales the logits and sums once) and within one
bf16 ulp of the output in bf16 (``rtol=1e-2, atol=1e-2``).

rangescan runs on integer-valued rows (coordinates in [-3, 3]): every dot
product and norm is then an exact integer in f32 (and bf16) whatever the
order of the sum, and, on the wgmma route, every TF32 split is exact (hi =
v, lo = 0); radii sit at half-integers, so the kernel's ids, distances and
counts must equal the plain version's exactly, ties included (the lower id
first). Each wgmma-route case asserts the route it took. Two real-valued
cases (unit vectors, ip) are held by ``compare_scans``, which excuses only
what f32 rounding can explain.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import (
    RangeConfig, RangeSearchEngine, SearchConfig, build_knn_graph, quantize_corpus)
from repro_torch.kernels.expand import (
    expand_cuda, expand_frontier, expand_frontier_int8_ref, expand_frontier_ref,
    expand_int8_cuda)
from repro_torch.kernels.flashattn import (
    flash_attention, flash_attention_cuda, flash_attention_ref)
from repro_torch.kernels.flashattn import ops as flash_ops
from repro_torch.kernels.gatherdist import (
    gatherdist, gatherdist_cuda, gatherdist_int8_cuda, gatherdist_int8_ref,
    gatherdist_ref)
from repro_torch.kernels.rangescan import (
    rangescan, rangescan_cuda, rangescan_dists, rangescan_ref)
from repro_torch.kernels.rangescan.ref import compare_scans
from repro_torch.kernels.rerank_fetch import (
    fetch_rerank_dists, fetch_rerank_pairs, fetch_rerank_pairs_ref, rerank_fetch_cuda)
from repro_torch.utils import INVALID_ID

gather_ops = sys.modules["repro_torch.kernels.gatherdist.ops"]
rerank_ops = sys.modules["repro_torch.kernels.rerank_fetch.ops"]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tol(metric, pts, qs):
    if metric == "l2":
        return dict(rtol=1e-5, atol=1e-5)
    scale = float(pts.float().norm(dim=1).max() * qs.norm(dim=1).max())
    return dict(rtol=1e-5, atol=1e-6 * max(1.0, scale))


def _assert_dists(got, want, tol):
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    torch.testing.assert_close(got[fin], want[fin], **tol)


def _expand_inputs(n, r, d, q, e, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    pts = torch.randn(n, d, generator=g)
    adj = torch.randint(0, n, (n, r), generator=g, dtype=torch.int32)
    adj[:, -max(1, r // 4):] = INVALID_ID
    adj[0, 1] = adj[0, 0]
    adj[1, :2] = adj[0, :2]
    fr = torch.randint(0, n, (q, e), generator=g, dtype=torch.int32)
    fr[0, 1] = fr[0, 0]
    fr[-1, -1] = INVALID_ID
    if e >= 3:
        fr[0, 2] = n + 3
    qs = torch.randn(q, d, generator=g)
    return [x.to(dev) for x in (pts, adj, fr, qs)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n,r,d,q,e", [
    (150, 8, 32, 6, 4),
    (64, 5, 17, 3, 2),         # ragged degree and dim: the scalar path
    (40, 4, 16, 1, 6),
    (2000, 32, 128, 64, 4),    # the main path's R, d and E
    (500, 100, 130, 8, 3),     # R > 32 lanes, d not a multiple of 4
])
def test_expand_kernel_matches_ref(cuda_device, dtype, metric, n, r, d, q, e):
    pts, adj, fr, qs = _expand_inputs(n, r, d, q, e, cuda_device)
    pts = pts.to(DTYPES[dtype])
    before = expand_cuda.launches
    ids, dd, nd = expand_frontier(pts, adj, fr, qs, metric=metric)
    assert expand_cuda.launches == before + 1
    rids, rd, rnd = expand_frontier_ref(pts, adj, fr, qs, metric=metric)
    torch.cuda.synchronize()
    assert torch.equal(ids, rids) and torch.equal(nd, rnd)
    _assert_dists(dd, rd, _tol(metric, pts, qs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n,d,q,s", [(100, 32, 8, 16), (57, 19, 5, 7),
                                     (4000, 128, 64, 4)])
def test_gatherdist_kernel_matches_ref(cuda_device, dtype, metric, n, d, q, s):
    g = torch.Generator().manual_seed(1)
    pts = torch.randn(n, d, generator=g).to(cuda_device, DTYPES[dtype])
    qs = torch.randn(q, d, generator=g).to(cuda_device)
    ids = torch.randint(0, n, (q, s), generator=g, dtype=torch.int32)
    ids[0, -1] = INVALID_ID
    ids[-1, 0] = n + 5
    ids = ids.to(cuda_device)
    before = gatherdist_cuda.launches
    got = gatherdist(pts, ids, qs, metric=metric)
    assert gatherdist_cuda.launches == before + 1
    want = gatherdist_ref(pts, ids, qs, metric=metric)
    torch.cuda.synchronize()
    _assert_dists(got, want, _tol(metric, pts, qs))


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    pts, adj, fr, qs = _expand_inputs(64, 8, 16, 4, 2, cuda_device)
    with pytest.raises(ValueError):
        expand_cuda(pts.double(), adj, fr, qs)           # dtype
    with pytest.raises(ValueError):
        expand_cuda(pts, adj.long(), fr, qs)             # index dtype
    with pytest.raises(ValueError):
        expand_cuda(pts.t().contiguous().t(), adj, fr, qs)  # not contiguous
    with pytest.raises(ValueError):
        expand_cuda(pts, adj, fr, qs[:, :8].contiguous())   # shape
    with pytest.raises(ValueError):
        gatherdist_cuda(pts, adj[:4], qs.cpu())          # device


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["beam", "doubling", "greedy"])
def test_engine_kernel_path_matches_plain_path(cuda_device, mode):
    """The engine through the kernels and through their plain versions on
    the same card: both kernels launch, and the answers agree."""
    g = torch.Generator().manual_seed(2)
    centers = torch.randn(16, 32, generator=g) * 3
    pts = centers[torch.randint(0, 16, (6000,), generator=g)] + 0.4 * torch.randn(
        6000, 32, generator=g)
    qs = (pts[:128] + 0.01).to(cuda_device)
    graph = build_knn_graph(pts, k=16, device=cuda_device)
    eng = RangeSearchEngine.from_graph(pts, graph, device=cuda_device)
    r = float(torch.quantile(((pts[:128, None] - pts[None, :2000]) ** 2).sum(-1), 0.01))
    cfg = RangeConfig(search=SearchConfig(
        beam=16, max_beam=64 if mode == "doubling" else 16, visit_cap=128),
        mode=mode, result_cap=256)
    plain = dataclasses.replace(cfg, search=dataclasses.replace(
        cfg.search, use_kernels=False))
    expand_cuda.launches = gatherdist_cuda.launches = 0
    a = eng.range(qs, r, cfg=cfg)
    assert expand_cuda.launches > 0 and gatherdist_cuda.launches > 0
    launched = (expand_cuda.launches, gatherdist_cuda.launches)
    b = eng.range(qs, r, cfg=plain)
    assert (expand_cuda.launches, gatherdist_cuda.launches) == launched
    # sums run in another order, so a near-tie may flip a few lanes
    same = ((a.ids == b.ids).all(dim=1) & (a.count == b.count)).float().mean()
    assert same.item() >= 0.95, same
    assert np.isfinite(a.dists[a.ids != INVALID_ID].cpu().numpy()).all()


# ---------------------------------------------------------------------------
# the int8 corpus path: expand-int8, gatherdist-int8, rerank_fetch
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("quantize_query", [False, True])
@pytest.mark.parametrize("n,r,d,q,e", [
    (150, 8, 32, 6, 4),
    (64, 5, 17, 3, 2),         # ragged degree and dim: byte loads
    (2000, 32, 128, 64, 4),    # the main path's R, d and E
    (500, 40, 130, 8, 3),      # R > 32 lanes, d not a multiple of 4
    (120, 6, 20, 5, 3),        # 4-byte words: d % 4 == 0, d % 16 != 0
    (300, 16, 256, 8, 2),      # two 16-byte chunks a lane
])
def test_expand_int8_kernel_matches_ref(cuda_device, metric, quantize_query,
                                        n, r, d, q, e):
    pts, adj, fr, qs = _expand_inputs(n, r, d, q, e, cuda_device)
    fr[1] = INVALID_ID                    # a frozen lane: its block leaves early
    qc = quantize_corpus(pts)
    before = expand_int8_cuda.launches
    ids, dd, nd = expand_frontier(qc, adj, fr, qs, metric=metric,
                                  quantize_query=quantize_query)
    assert expand_int8_cuda.launches == before + 1
    rids, rd, rnd = expand_frontier_int8_ref(qc, adj, fr, qs, metric=metric,
                                             quantize_query=quantize_query)
    torch.cuda.synchronize()
    assert torch.equal(ids, rids) and torch.equal(nd, rnd)
    _assert_dists(dd, rd, _tol(metric, pts, qs))
    if quantize_query:
        dots = expand_int8_cuda(qc.codes, qc.meta, adj, fr, qs, metric=metric,
                                quantize_query=True, return_dots=True)[3]
        rdots = expand_frontier_int8_ref(qc, adj, fr, qs, metric=metric,
                                         quantize_query=True, return_dots=True)[3]
        assert torch.equal(dots, rdots)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("quantize_query", [False, True])
@pytest.mark.parametrize("n,d,q,s", [(100, 32, 8, 16), (57, 19, 5, 7),
                                     (60, 17, 3, 5), (4000, 128, 64, 4),
                                     (90, 20, 11, 9), (200, 256, 9, 33)])
def test_gatherdist_int8_kernel_matches_ref(cuda_device, metric,
                                            quantize_query, n, d, q, s):
    g = torch.Generator().manual_seed(1)
    pts = torch.randn(n, d, generator=g).to(cuda_device)
    qs = torch.randn(q, d, generator=g).to(cuda_device)
    ids = torch.randint(0, n, (q, s), generator=g, dtype=torch.int32)
    ids[0, -1] = INVALID_ID
    ids[-1, 0] = n + 5
    ids = ids.to(cuda_device)
    qc = quantize_corpus(pts)
    before = gatherdist_int8_cuda.launches
    got = gatherdist(qc, ids, qs, metric=metric, quantize_query=quantize_query)
    assert gatherdist_int8_cuda.launches == before + 1
    want = gatherdist_int8_ref(qc, ids, qs, metric=metric,
                               quantize_query=quantize_query)
    torch.cuda.synchronize()
    _assert_dists(got, want, _tol(metric, pts, qs))
    if quantize_query:
        dots = gatherdist_int8_cuda(qc.codes, qc.meta, ids, qs, metric=metric,
                                    quantize_query=True, return_dots=True)[1]
        rdots = gatherdist_int8_ref(qc, ids, qs, metric=metric,
                                    quantize_query=True, return_dots=True)[1]
        assert torch.equal(dots, rdots)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("quantize_query", [False, True])
@pytest.mark.parametrize("n,r,d,q,e", [(64, 5, 17, 3, 2), (120, 6, 20, 5, 3),
                                       (2000, 32, 128, 64, 4)])
def test_int8_kernels_agree_bitwise(cuda_device, metric, quantize_query,
                                    n, r, d, q, e):
    """expand-int8 and gatherdist-int8 share their query quantization, dot
    and bound: on the candidates they share, the same bits."""
    pts, adj, fr, qs = _expand_inputs(n, r, d, q, e, cuda_device, seed=4)
    qc = quantize_corpus(pts)
    kw = dict(metric=metric, quantize_query=quantize_query)
    ids, dd, _ = expand_int8_cuda(qc.codes, qc.meta, adj, fr, qs, **kw)
    g = gatherdist_int8_cuda(qc.codes, qc.meta, ids, qs, **kw)
    torch.cuda.synchronize()
    keep = ids != INVALID_ID
    assert keep.any()
    assert torch.equal(g[keep].view(torch.int32), dd[keep].view(torch.int32))
    assert torch.isinf(g[~keep]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("p,d", [(1, 128), (17, 128), (4096, 128),
                                 (65536, 128), (17, 17), (300, 130)])
def test_rerank_fetch_kernel_matches_ref(cuda_device, metric, p, d):
    g = torch.Generator().manual_seed(3)
    n, nq = 100_000 if p > 4096 else 2000, 64
    raw = torch.randn(n, d, generator=g).to(cuda_device)
    queries = torch.randn(nq, d, generator=g).to(cuda_device)
    ids = torch.randint(0, n, (p,), generator=g, dtype=torch.int32)
    lanes = torch.randint(0, nq, (p,), generator=g, dtype=torch.int32)
    ids[0] = n + 7                      # clipped, as the reference clips
    ids, lanes = ids.to(cuda_device), lanes.to(cuda_device)
    before = rerank_fetch_cuda.launches
    got = fetch_rerank_pairs(raw, queries, ids, lanes, metric=metric)
    assert rerank_fetch_cuda.launches == before + 1
    want = fetch_rerank_pairs_ref(raw, queries, ids, lanes, metric)
    torch.cuda.synchronize()
    _assert_dists(got, want, _tol(metric, raw, queries))
    qv = queries[lanes.long()]          # the reference's signature
    _assert_dists(fetch_rerank_dists(raw, ids, qv, metric=metric), want,
                  _tol(metric, raw, queries))


@pytest.mark.cuda
def test_int8_scales_are_true_divisions_on_the_card(cuda_device):
    """max|x| / 127 as an IEEE f32 division, as the kernels and the
    reference divide. (CUDA divides a tensor by a Python scalar as a
    product with the scalar's rounded reciprocal: 1 ulp off for many rows,
    and a query code on a .5 boundary then moved, so the plain int8-query
    form's dots and bounds parted from the kernels' on one query of 512.)"""
    from repro_torch.core.corpus import quantize_queries
    from repro_torch.dist.compression import quantize_int8_rows
    g = torch.Generator().manual_seed(11)
    x = torch.randn(4096, 128, generator=g)
    amax = x.abs().amax(dim=1).numpy()
    want = torch.from_numpy(np.maximum(amax, np.float32(1e-12)) / np.float32(127.0))
    xd = x.to(cuda_device)
    _, scale, _, _ = quantize_queries(xd)
    _, scales = quantize_int8_rows(xd)
    assert torch.equal(scale.cpu(), want) and torch.equal(scales.cpu(), want)
    codes = torch.from_numpy(np.clip(np.rint(x.numpy() / want.numpy()[:, None]),
                                     -127, 127))
    assert torch.equal(quantize_queries(xd)[0].cpu(), codes)


@pytest.mark.cuda
def test_int8_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    pts, adj, fr, qs = _expand_inputs(64, 8, 16, 4, 2, cuda_device)
    qc = quantize_corpus(pts)
    with pytest.raises(ValueError):
        expand_int8_cuda(qc.codes.float(), qc.meta, adj, fr, qs)       # dtype
    with pytest.raises(ValueError):
        expand_int8_cuda(qc.codes, qc.meta[:, :2].contiguous(), adj, fr, qs)
    with pytest.raises(ValueError):
        expand_int8_cuda(qc.codes, qc.meta, adj, fr, qs, return_dots=True)
    with pytest.raises(ValueError):
        gatherdist_int8_cuda(qc.codes, qc.meta, adj[:4], qs.cpu())     # device
    with pytest.raises(ValueError):
        rerank_fetch_cuda(pts.double(), qs, adj[0], adj[1])            # dtype
    with pytest.raises(ValueError):
        rerank_fetch_cuda(pts, qs, adj[0], adj[1, :3].contiguous())    # shape


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["beam", "doubling", "greedy"])
@pytest.mark.parametrize("use_expand_kernel", [False, True])
def test_int8_engine_kernel_path_matches_plain_path(cuda_device, mode,
                                                    use_expand_kernel):
    """The int8 engine through the three kernels and through their plain
    versions on the same card: every kernel launches, and the answers
    agree."""
    g = torch.Generator().manual_seed(2)
    centers = torch.randn(16, 32, generator=g) * 3
    pts = centers[torch.randint(0, 16, (6000,), generator=g)] + 0.4 * torch.randn(
        6000, 32, generator=g)
    qs = (pts[:128] + 0.01).to(cuda_device)
    graph = build_knn_graph(pts, k=16, device=cuda_device)
    eng = RangeSearchEngine.from_graph(pts, graph, corpus_dtype="int8",
                                       device=cuda_device)
    r = float(torch.quantile(((pts[:128, None] - pts[None, :2000]) ** 2).sum(-1), 0.01))
    cfg = RangeConfig(search=SearchConfig(
        beam=16, max_beam=64 if mode == "doubling" else 16, visit_cap=128,
        use_expand_kernel=use_expand_kernel), mode=mode, result_cap=256)
    plain = dataclasses.replace(cfg, search=dataclasses.replace(
        cfg.search, use_kernels=False))
    kernels = (expand_int8_cuda, gatherdist_int8_cuda, rerank_fetch_cuda)
    for k in kernels:
        k.launches = 0
        k.routes = dict.fromkeys(k.routes, 0)
    a = eng.range(qs, r, cfg=cfg)
    launched = tuple(k.launches for k in kernels)
    # the rerank launches once a batch, when the batch has a band at all
    band = int(a.n_rerank.sum())
    assert min(launched[:2]) > 0 and launched[2] == int(band > 0), launched
    # every launch on the route its plan names (d = 32: whole 16-byte rows;
    # a band this small runs rerank_fetch's warp route)
    planned = ("bulk", "regs", rerank_ops.plan(band, 32))
    for k, route, count in zip(kernels, planned, launched):
        assert k.routes == {rt: count if rt == route else 0 for rt in k.routes}, k.routes
    if mode == "greedy":
        assert band > 0
    b = eng.range(qs, r, cfg=plain)
    assert tuple(k.launches for k in kernels) == launched
    same = ((a.ids == b.ids).all(dim=1) & (a.count == b.count)).float().mean()
    assert same.item() >= 0.95, same
    ok = a.ids != INVALID_ID
    exact = ((eng.points.raw[a.ids[ok].long()]
              - qs[torch.nonzero(ok)[:, 0]]) ** 2).sum(-1)
    assert (exact <= r + 1e-5).all()          # no false positive


# ---------------------------------------------------------------------------
# expand's two routes: bulk (persistent blocks, bulk copies into shared
# memory, linear dedup) against the plain version and, bit for bit, against
# the warp route on the same inputs; each call's route asserted
# ---------------------------------------------------------------------------

def _on_route(fn, want, *args, **kw):
    """Call ``fn`` (a kernel wrapper that counts ``.routes``) and assert
    that the call launched once, on route ``want``."""
    before = dict(fn.routes)
    out = fn(*args, **kw)
    moved = {r: fn.routes[r] - before[r] for r in before}
    assert moved == {r: int(r == want) for r in before}, moved
    return out


def _bulk_case(case, dev, d=128, seed=0):
    """(points f32, adjacency, frontier, queries) of one stress case."""
    g = torch.Generator().manual_seed(seed)
    n, r, q, e = 2000, 32, 512, 4
    if case == "r100":
        r = 100
    if case == "one_live":
        q = 4096
    elif case == "q400":       # on an H100 at d=128: three warps a query
        q = 400
    pts = torch.randn(n, d, generator=g)
    adj = torch.randint(0, n, (n, r), generator=g, dtype=torch.int32)
    adj[:, -(r // 4):] = INVALID_ID
    adj[:, 1] = adj[:, 0]                          # in-row duplicates
    fr = torch.randint(0, n, (q, e), generator=g, dtype=torch.int32)
    fr[::8, 3] = INVALID_ID                        # exhausted slots
    fr[::16, 1] = fr[::16, 0]                      # repeated frontier nodes
    if case == "frozen":
        fr[:] = INVALID_ID
    elif case == "one_live":
        live = fr[1234].clone()
        fr[:] = INVALID_ID
        fr[1234] = live
    elif case == "duplicates":
        adj[:] = adj[7]                            # every adjacency row the same
        adj[:, 1::2] = adj[:, 0::2]
        fr[: q // 2] = fr[: q // 2, :1]            # E equal frontier nodes
    elif case == "out_of_range":
        fr[::3, 0] = n + 3
        fr[1::3, 2] = -5
        fr[2::5] = n
        adj[:, 2] = n + 7
        adj[:, 3] = -2
    qs = torch.randn(q, d, generator=g)
    return [x.to(dev) for x in (pts, adj, fr, qs)]


BULK_CASES = ["main", "frozen", "one_live", "duplicates", "out_of_range", "r100",
              "q400"]


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("case", BULK_CASES)
def test_expand_bulk_route_matches_ref_and_warp(cuda_device, metric, case):
    pts, adj, fr, qs = _bulk_case(case, cuda_device)
    got = _on_route(expand_cuda, "bulk", pts, adj, fr, qs, metric=metric)
    warp = _on_route(expand_cuda, "warp", pts, adj, fr, qs, metric=metric,
                     route="warp")
    want = expand_frontier_ref(pts, adj, fr, qs, metric=metric)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    _assert_dists(got[1], want[1], _tol(metric, pts, qs))
    for a, b in zip(got, warp):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if case == "frozen":
        assert (got[0] == INVALID_ID).all() and (got[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype,d", [("bfloat16", 128), ("float32", 256)])
def test_expand_bulk_route_bf16_and_two_tower_width(cuda_device, metric, dtype, d):
    """bf16 rows at d=128 (256-byte rows) and f32 at d=256 (the two-tower
    graph half's 1 KB rows)."""
    pts, adj, fr, qs = _bulk_case("main", cuda_device, d=d, seed=5)
    pts = pts.to(DTYPES[dtype])
    got = _on_route(expand_cuda, "bulk", pts, adj, fr, qs, metric=metric)
    warp = _on_route(expand_cuda, "warp", pts, adj, fr, qs, metric=metric,
                     route="warp")
    want = expand_frontier_ref(pts, adj, fr, qs, metric=metric)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    _assert_dists(got[1], want[1], _tol(metric, pts, qs))
    for a, b in zip(got, warp):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("quantize_query", [False, True])
@pytest.mark.parametrize("d,case", [(128, "main"), (128, "duplicates"),
                                    (128, "one_live"), (128, "out_of_range"),
                                    (256, "main"), (128, "r100")])
def test_expand_int8_bulk_route_matches_ref_and_warp(cuda_device, metric,
                                                     quantize_query, d, case):
    """Both forms: ids, n_dist and dots equal to the plain version, bounds
    within its tolerance; every output bit for bit the warp route's; and
    gatherdist-int8 bit for bit on the candidates the two share."""
    pts, adj, fr, qs = _bulk_case(case, cuda_device, d=d, seed=6)
    qc = quantize_corpus(pts)
    kw = dict(metric=metric, quantize_query=quantize_query,
              return_dots=quantize_query)
    args = (qc.codes, qc.meta, adj, fr, qs)
    got = _on_route(expand_int8_cuda, "bulk", *args, **kw)
    warp = _on_route(expand_int8_cuda, "warp", *args, **kw, route="warp")
    want = expand_frontier_int8_ref(qc, adj, fr, qs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    _assert_dists(got[1], want[1], _tol(metric, pts, qs))
    if quantize_query:
        assert torch.equal(got[3], want[3])
    for a, b in zip(got, warp):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    ids, dd = got[0], got[1]
    gd = gatherdist_int8_cuda(qc.codes, qc.meta, ids, qs, metric=metric,
                              quantize_query=quantize_query)
    torch.cuda.synchronize()
    keep = ids != INVALID_ID
    assert keep.any()
    assert torch.equal(gd[keep].view(torch.int32), dd[keep].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,r,d", [
    ("float32", 64, 8, 17),      # rows not a whole number of 16-byte spans
    ("bfloat16", 64, 8, 20),
    ("int8", 120, 8, 20),
    ("float32", 500, 100, 130),
    ("float32", 64, 5, 32),      # R % 4 != 0: adjacency rows not 16-byte spans
    ("misaligned", 64, 8, 32),   # a base 4 bytes past a 16-byte boundary
])
def test_expand_warp_route_takes_what_bulk_cannot(cuda_device, dtype, n, r, d):
    pts, adj, fr, qs = _expand_inputs(n, r, d, 6, 3, cuda_device)
    if dtype == "misaligned":
        buf = torch.empty(n * d + 1, device=cuda_device)
        buf[1:] = pts.flatten()
        pts = buf[1:].view(n, d)
    if dtype == "int8":
        qc = quantize_corpus(pts)
        for quant in (False, True):
            got = _on_route(expand_int8_cuda, "warp", qc.codes, qc.meta, adj, fr,
                            qs, quantize_query=quant)
            want = expand_frontier_int8_ref(qc, adj, fr, qs, quantize_query=quant)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
            _assert_dists(got[1], want[1], _tol("l2", pts, qs))
        with pytest.raises(ValueError):
            expand_int8_cuda(qc.codes, qc.meta, adj, fr, qs, route="bulk")
        return
    if dtype == "bfloat16":
        pts = pts.to(torch.bfloat16)
    got = _on_route(expand_cuda, "warp", pts, adj, fr, qs)
    want = expand_frontier_ref(pts, adj, fr, qs)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    _assert_dists(got[1], want[1], _tol("l2", pts, qs))
    with pytest.raises(ValueError):
        expand_cuda(pts, adj, fr, qs, route="bulk")


@pytest.mark.cuda
def test_expand_bulk_route_in_a_cuda_graph(cuda_device):
    """Replayed from a CUDA graph, as chip_smoke.py times it: the same
    outputs as the direct call."""
    pts, adj, fr, qs = _bulk_case("main", cuda_device, seed=9)
    want = expand_cuda(pts, adj, fr, qs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        expand_cuda(pts, adj, fr, qs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = expand_cuda(pts, adj, fr, qs)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _int_rig(q, n, d, dev, seed=0, dtype=torch.float32):
    """Integer rows and queries (exact sums in any order); rows 7 and
    n // 2 .. n // 2 + 4 are duplicates."""
    g = torch.Generator().manual_seed(seed)
    pts = torch.randint(-3, 4, (n, d), generator=g).float()
    qs = torch.randint(-3, 4, (q, d), generator=g).float()
    if n > 20:
        pts[n // 2:n // 2 + 5] = pts[7]
    return pts.to(dev, dtype), qs.to(dev, dtype)


def _half_integer_radius(qs, pts, metric, frac):
    """A radius between two integers near the ``frac`` quantile of the
    distances of the first query, so no distance equals it."""
    dist = rangescan_dists(qs[:1], pts, metric)[0]
    return float(torch.quantile(dist.double(), frac).floor()) + 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("q,n,d,k", [
    (1, 100_000, 128, 256),   # retrieval_cand's one query
    (1, 100_000, 256, 8),
    (37, 1000, 17, 8),        # ragged Q, N and d
    (5, 3001, 33, 128),
    (70, 5000, 128, 256),
    (300, 2000, 256, 128),
])
def test_rangescan_kernel_matches_ref(cuda_device, dtype, metric, q, n, d, k):
    pts, qs = _int_rig(q, n, d, cuda_device, seed=q + n, dtype=DTYPES[dtype])
    for frac in (0.001, 0.2):    # counts below and above k
        r = _half_integer_radius(qs, pts, metric, frac)
        before = rangescan_cuda.launches
        ids, dd, c = rangescan(qs, pts, r, k=k, metric=metric)
        assert rangescan_cuda.launches == before + 1
        rids, rd, rc = rangescan_ref(qs, pts, r, k=k, metric=metric)
        torch.cuda.synchronize()
        assert torch.equal(c, rc)
        assert torch.equal(ids, rids)
        assert torch.equal(dd, rd)
    assert (c > k).any() or n < 2 * k


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(256, 16), (100_000, 256)])
def test_rangescan_kernel_counts_exceed_k(cuda_device, n, k):
    """All points at distance 0: the counts stay exact far above k and the
    k lowest ids are kept, in order."""
    pts = torch.zeros((n, 8), device=cuda_device)
    qs = torch.zeros((4, 8), device=cuda_device)
    ids, dd, c = rangescan_cuda(qs, pts, 1.0, k=k)
    assert (c == n).all()
    assert torch.equal(ids, torch.arange(k, dtype=torch.int32,
                                         device=cuda_device).expand(4, k))
    assert (dd == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rangescan_kernel_every_point_in_range(cuda_device, metric):
    """An infinite radius: every split keeps k, so the merge runs several
    rounds."""
    pts, qs = _int_rig(40, 20_000, 64, cuda_device, seed=5)
    ids, dd, c = rangescan_cuda(qs, pts, float("inf"), k=256, metric=metric)
    rids, rd, rc = rangescan_ref(qs, pts, float("inf"), k=256, metric=metric)
    assert (c == 20_000).all() and torch.equal(c, rc)
    assert torch.equal(ids, rids) and torch.equal(dd, rd)


@pytest.mark.cuda
def test_rangescan_kernel_duplicate_rows_tie_by_id(cuda_device):
    """Real-valued duplicated rows at scattered positions get identical
    distance bits, and the lower id ranks first."""
    g = torch.Generator().manual_seed(4)
    pts = torch.randn(5000, 96, generator=g)
    pts[[3, 1500, 2999, 4998]] = pts[77].clone()
    qs = torch.cat([pts[77:78] + 0.01, torch.randn(2, 96, generator=g)])
    pts, qs = pts.to(cuda_device), qs.to(cuda_device)
    for metric in ("l2", "ip"):
        ids, dd, _ = rangescan_cuda(qs, pts, float("inf"), k=64, metric=metric)
        row = ids[0].tolist()
        pos = [row.index(i) for i in (3, 77, 1500, 2999, 4998) if i in row]
        if metric == "l2":
            assert len(pos) == 5
        assert pos == sorted(pos)
        assert len({dd[0, p].item() for p in pos}) <= 1
        full = rangescan_cuda(qs, pts, float("inf"), k=256, metric=metric)
        lanes = full[0].cpu().numpy()
        for i in range(qs.shape[0]):
            hit = [list(lanes[i]).index(j) for j in (3, 77, 1500, 2999, 4998)
                   if j in lanes[i]]
            assert hit == sorted(hit)


@pytest.mark.cuda
def test_rangescan_kernel_empty_result(cuda_device):
    pts, qs = _int_rig(9, 3000, 40, cuda_device)
    ids, dd, c = rangescan_cuda(qs, pts, -1.0, k=128)
    assert (c == 0).all() and (ids == INVALID_ID).all() and torch.isinf(dd).all()


@pytest.mark.cuda
def test_rangescan_kernel_unit_vectors_within_rounding(cuda_device):
    """Real-valued unit vectors (the two-tower corpus's kind), ip: what
    differs from the plain version is only what f32 rounding explains."""
    g = torch.Generator().manual_seed(6)
    pts = torch.nn.functional.normalize(torch.randn(50_000, 256, generator=g), dim=1)
    qs = torch.nn.functional.normalize(torch.randn(64, 256, generator=g), dim=1)
    pts, qs = pts.to(cuda_device), qs.to(cuda_device)
    dist = rangescan_dists(qs, pts, "ip")
    # about 128 members a query on average: lanes on both sides of k
    r = float(torch.quantile(dist[:, :10_000].flatten().cpu(), 0.0026))
    got = rangescan_cuda(qs, pts, r, k=128, metric="ip")
    want = rangescan_ref(qs, pts, r, k=128, metric="ip")
    excused, unexcused, err = compare_scans(got, want, dist, r, 1e-5)
    print(f"unit vectors, ip, k=128: excused={excused} unexcused={unexcused} "
          f"max_abs_err={err:.3g}")
    assert unexcused == 0 and err <= 1e-5, (excused, unexcused, err)
    assert (want[2] > 128).any() and (want[2] < 128).any()


def _scan_on_route(route, qs, pts, r, **kw):
    """One rangescan call, asserted to have taken ``route``."""
    before = dict(rangescan_cuda.routes)
    out = rangescan(qs, pts, r, **kw)
    moved = {k: rangescan_cuda.routes[k] - before[k] for k in before}
    assert moved == {**dict.fromkeys(before, 0), route: 1}, moved
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("q,n,d", [
    (1, 10_007, 256),    # one request: the 8-query tile, two blocks an SM
    (8, 3001, 96),       # an odd number of 32-dim chunks
    (9, 3001, 128),
    (256, 2003, 64),
    (257, 3001, 128),    # a second, nearly empty query tile
    (512, 5003, 256),    # the served batch's tile: 256 queries, two tiles
])
def test_rangescan_wgmma_route_matches_ref(cuda_device, dtype, metric, q, n, d):
    """The tensor-core route on integer rows: hi = v, lo = 0 and exact sums,
    so every id, distance and count equals the plain version's."""
    pts, qs = _int_rig(q, n, d, cuda_device, seed=q + n + d, dtype=DTYPES[dtype])
    for frac, k in ((0.001, 256), (0.2, 128)):    # counts below and above k
        r = _half_integer_radius(qs, pts, metric, frac)
        ids, dd, c = _scan_on_route("wgmma", qs, pts, r, k=k, metric=metric)
        rids, rd, rc = rangescan_ref(qs, pts, r, k=k, metric=metric)
        torch.cuda.synchronize()
        assert torch.equal(c, rc)
        assert torch.equal(ids, rids)
        assert torch.equal(dd, rd)
    assert (c > k).any()


@pytest.mark.cuda
def test_rangescan_wgmma_unit_vectors_within_rounding(cuda_device):
    """The served kind at the served batch: unit vectors, ip, Q=512 against
    200,000 points of d=256; 3xTF32 differs from the plain f32 product only
    by what f32 rounding explains."""
    g = torch.Generator().manual_seed(7)
    pts = torch.nn.functional.normalize(torch.randn(200_000, 256, generator=g), dim=1)
    qs = torch.nn.functional.normalize(torch.randn(512, 256, generator=g), dim=1)
    pts, qs = pts.to(cuda_device), qs.to(cuda_device)
    dist = rangescan_dists(qs, pts, "ip")
    # about 128 members a query on average: lanes on both sides of k
    r = float(torch.quantile(dist[:, :10_000].flatten().cpu(), 128 / 200_000))
    got = _scan_on_route("wgmma", qs, pts, r, k=128, metric="ip")
    want = rangescan_ref(qs, pts, r, k=128, metric="ip")
    excused, unexcused, err = compare_scans(got, want, dist, r, 1e-5)
    print(f"unit vectors, ip, Q=512, k=128: excused={excused} unexcused={unexcused} "
          f"max_abs_err={err:.3g}")
    assert unexcused == 0 and err <= 1e-5, (excused, unexcused, err)
    assert (want[2] > 128).any() and (want[2] < 128).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("q", [1, 512])
def test_rangescan_wgmma_duplicate_rows_tie_by_id(cuda_device, dtype, q):
    """Real-valued duplicated rows at scattered positions (other tiles,
    other N splits) on the tensor-core route: identical distance bits, the
    lower id first."""
    g = torch.Generator().manual_seed(8)
    pts = torch.randn(300_000, 128, generator=g)
    dup = [5, 77, 131_072, 150_001, 299_998]
    pts[dup] = pts[4242].clone()
    qs = torch.cat([pts[4242:4243] + 0.01, torch.randn(q - 1, 128, generator=g)])
    pts, qs = pts.to(cuda_device, DTYPES[dtype]), qs.to(cuda_device)
    rows = sorted(dup + [4242])
    for metric in ("l2", "ip"):
        ids, dd, _ = _scan_on_route("wgmma", qs, pts, float("inf"), k=256, metric=metric)
        for i in range(min(q, 3)):
            row = ids[i].tolist()
            pos = [row.index(j) for j in rows if j in row]
            if i == 0 and metric == "l2":
                assert len(pos) == len(rows)     # the query sits next to them
            assert pos == sorted(pos)
            assert len({dd[i, p].item() for p in pos}) <= 1
            # every kept row's distance equals its duplicates', bit for bit
            if pos:
                assert all(torch.equal(dd[i, pos[0]], dd[i, p]) for p in pos)


@pytest.mark.cuda
def test_rangescan_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    pts, qs = _int_rig(4, 100, 16, cuda_device)
    with pytest.raises(ValueError):
        rangescan_cuda(qs, pts.double(), 1.0)                    # dtype
    with pytest.raises(ValueError):
        rangescan_cuda(qs.long(), pts, 1.0)                      # dtype
    with pytest.raises(ValueError):
        rangescan_cuda(qs, pts.t().contiguous().t(), 1.0)        # not contiguous
    with pytest.raises(ValueError):
        rangescan_cuda(qs[:, :8].contiguous(), pts, 1.0)         # shape
    with pytest.raises(ValueError):
        rangescan_cuda(qs.cpu(), pts, 1.0)                       # device
    with pytest.raises(ValueError):
        rangescan_cuda(qs.cpu(), pts.cpu(), 1.0)                 # CPU tensors
    for k in (0, 257):
        with pytest.raises(ValueError):
            rangescan_cuda(qs, pts, 1.0, k=k)                    # k
    with pytest.raises(ValueError):
        rangescan_cuda(qs, pts, 1.0, metric="cos")               # metric


# ---------------------------------------------------------------------------
# flashattn
# ---------------------------------------------------------------------------

FLASH_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
             "bfloat16": dict(rtol=1e-2, atol=1e-2)}


def _route(q, hkv):
    """The route ops.py takes: by the rows of a kv head, the dtype and dh."""
    b, hq, sq, dh = q.shape
    if hq // hkv * sq <= 16:
        return "decode_split"
    return "wgmma" if q.dtype == torch.bfloat16 and dh in (64, 128) else "tile_f32"


def _qkv(b, hq, hkv, sq, skv, dh, dev, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, hq, sq, dh, generator=g)
    k = torch.randn(b, hkv, skv, dh, generator=g)
    v = torch.randn(b, hkv, skv, dh, generator=g)
    return [x.to(dev, DTYPES[dtype]) for x in (q, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window,cap,qoff", [
    # the five cases of tests/test_kernels.py
    (2, 4, 2, 64, 64, 32, True, 0, 0.0, 0),
    (1, 8, 2, 37, 37, 16, True, 0, 50.0, 0),
    (1, 4, 4, 16, 128, 32, True, 64, 0.0, 112),
    (2, 2, 1, 33, 65, 64, False, 0, 0.0, 0),
    (1, 6, 3, 128, 128, 64, True, 32, 30.0, 0),
    # GQA groups 5 and 9, ragged lengths past one tile
    (2, 10, 2, 100, 130, 128, True, 0, 0.0, 30),
    (1, 9, 1, 70, 70, 128, True, 24, 0.0, 0),
    # decode: Sq = 1, the G heads of a kv head as the rows
    (4, 32, 16, 1, 4097, 128, True, 0, 0.0, 4096),
    (4, 32, 16, 1, 4097, 128, True, 1024, 0.0, 4096),
    (2, 40, 8, 1, 300, 128, True, 0, 0.0, 299),
    (1, 36, 4, 1, 513, 128, True, 0, 0.0, 512),
    (1, 4, 1, 3, 40, 16, True, 0, 10.0, 37),
    # gemma3-27b's layer width at a shorter prompt: global and local
    (1, 32, 16, 1500, 1500, 128, True, 0, 0.0, 0),
    (1, 32, 16, 1500, 1500, 128, True, 1024, 0.0, 0),
    # ragged Sq and Skv around the 64-row, 128-row and 128-key tile edges,
    # G = 1, 2, 5 and 9 at dh 64 and 128
    (1, 2, 2, 127, 129, 128, True, 0, 0.0, 2),
    (1, 4, 2, 129, 129, 64, True, 0, 0.0, 0),
    (1, 2, 1, 255, 4097, 128, True, 0, 0.0, 3842),
    (1, 2, 1, 127, 1, 128, False, 0, 0.0, 0),
    (2, 10, 2, 64, 129, 64, True, 0, 0.0, 65),
    (1, 9, 1, 130, 257, 64, True, 0, 0.0, 127),
    (1, 4, 4, 255, 255, 64, True, 0, 0.0, 0),
    # chunked prefill, a window narrower than a tile, the soft cap
    (1, 10, 2, 200, 500, 128, True, 0, 0.0, 300),
    (1, 4, 2, 300, 300, 128, True, 24, 0.0, 0),
    (1, 4, 2, 300, 300, 128, True, 0, 20.0, 0),
    (1, 4, 2, 96, 96, 64, False, 0, 30.0, 0),
    # decode at Skv = 1, just past a split boundary, a window over splits
    (2, 4, 2, 1, 1, 128, True, 0, 0.0, 0),
    (1, 2, 1, 1, 513, 128, True, 0, 0.0, 512),
    (4, 32, 16, 1, 1025, 128, True, 0, 0.0, 1024),
    (2, 8, 4, 1, 3000, 64, True, 1024, 0.0, 2999),
])
def test_flashattn_kernel_matches_ref(cuda_device, dtype, b, hq, hkv, sq, skv, dh,
                                      causal, window, cap, qoff):
    q, k, v = _qkv(b, hq, hkv, sq, skv, dh, cuda_device, dtype, seed=sq + skv)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff)
    before = flash_attention_cuda.launches
    routes = dict(flash_attention_cuda.routes)
    got = flash_attention(q, k, v, **kw)
    assert flash_attention_cuda.launches == before + 1
    routes[_route(q, hkv)] += 1
    assert flash_attention_cuda.routes == routes
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 200])
def test_flashattn_kernel_reads_the_model_layouts(cuda_device, sq):
    """q as (B, S, Hq, dh) and a cache as (B, T, Hkv, dh) sliced to its
    valid length, seen as (B, H, S, dh): read in place, the output in q's
    layout, the same values as contiguous copies give."""
    g = torch.Generator().manual_seed(sq)
    q = torch.randn(2, sq, 8, 64, generator=g).to(cuda_device, torch.bfloat16)
    cache = torch.randn(2, 300, 4, 64, generator=g).to(cuda_device, torch.bfloat16)
    t = 250
    k, v = cache[:, :t].transpose(1, 2), cache.flip(1)[:, :t].transpose(1, 2)
    kw = dict(causal=True, window=64, q_offset=t - sq)
    got = flash_attention(q.transpose(1, 2), k, v, **kw)
    assert got.transpose(1, 2).is_contiguous()
    want = flash_attention(q.transpose(1, 2).contiguous(), k.contiguous(),
                           v.contiguous(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 8, 80])
def test_flashattn_kernel_rows_that_see_no_key(cuda_device, sq):
    """Rows whose window ends before every key give 0, as the plain version
    (both kernels: decode rows and tile rows)."""
    q, k, v = _qkv(1, 2, 1, sq, 16, 32, cuda_device, "float32", seed=9)
    for qoff in (14, 40):
        kw = dict(causal=True, window=4, q_offset=qoff)
        got = flash_attention_cuda(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **FLASH_TOL["float32"])
        assert not got[:, :, max(0, 19 - qoff):].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flashattn_decode_splits_a_row_cannot_see(cuda_device, dtype, monkeypatch):
    """Splits narrower than the rows' windows (one key each): a split that
    a row cannot see adds l = 0 and no NaN, and the merge still matches
    the plain version; a row that sees no key at all gives 0."""
    monkeypatch.setattr(flash_ops, "decode_splits", lambda n, blocks: max(1, min(n, 64)))
    q, k, v = _qkv(2, 4, 2, 8, 300, 64, cuda_device, dtype, seed=5)   # 16 rows a kv head
    for kw in (dict(causal=True, window=16, q_offset=292),
               dict(causal=True, window=4, q_offset=298)):
        before = flash_attention_cuda.routes["decode_split"]
        got = flash_attention_cuda(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention_cuda.routes["decode_split"] == before + 1
        assert not torch.isnan(got).any()
        torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    assert not got[:, :, 5:].any()    # positions 303.. see no key


@pytest.mark.cuda
def test_flashattn_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q, k, v = _qkv(1, 4, 2, 8, 8, 32, cuda_device, "float32")
    with pytest.raises(ValueError):
        flash_attention_cuda(q.double(), k.double(), v.double())   # dtype
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k.bfloat16(), v)                   # mixed dtypes
    with pytest.raises(ValueError):
        flash_attention_cuda(q[..., :24], k[..., :24], v[..., :24])   # dh 24
    with pytest.raises(ValueError):
        flash_attention_cuda(q[:, :3], k, v)                       # 3 over 2 heads
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k, v[:, :, :4])                    # k/v shapes
    with pytest.raises(ValueError):
        flash_attention_cuda(q.transpose(2, 3), k, v)              # last dim strided
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k, v, q_offset=-1)
    with pytest.raises(ValueError):
        flash_attention_cuda(q.cpu(), k.cpu(), v.cpu())            # CPU tensors


@pytest.mark.cuda
def test_lm_kernel_path_matches_plain_path(cuda_device):
    """A reduced gemma3 (window 16 under a 40-token prompt) in f32 on the
    card: prefill and 6 decode steps through the kernel equal the plain
    path's within 1e-4, and the greedy tokens are equal."""
    import dataclasses

    from repro_torch.configs.gemma3_27b import reduced
    from repro_torch.models import decode_step, greedy_token, init_transformer, prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced()
    model = init_transformer(cfg, seed=0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(0))
    toks = toks.to(cuda_device)
    runs = []
    for use in (True, False):
        c = dataclasses.replace(cfg, use_kernels=use)
        before = flash_attention_cuda.launches
        lg, cache, pos = prefill(model, toks, c, max_len=48)
        out = [lg]
        tok = greedy_token(lg)
        for _ in range(6):
            lg, cache = decode_step(model, tok, cache, pos, c)
            tok, pos = greedy_token(lg), pos + 1
            out.append(lg)
        assert flash_attention_cuda.launches - before == (7 * cfg.n_layers if use else 0)
        runs.append(torch.stack(out))
    torch.cuda.synchronize()
    torch.testing.assert_close(runs[0], runs[1], rtol=1e-4, atol=1e-4)
    assert torch.equal(runs[0].argmax(-1), runs[1].argmax(-1))


# ---------------------------------------------------------------------------
# gatherdist-int8's two routes (regs, the f32-query form at l2: the rows'
# loads issued before the query is read into registers; warp: the first
# kernel, every other form) and rerank_fetch's two (regs: persistent
# blocks, rows in registers; warp: the first kernel): gatherdist-int8's bit
# for bit equal, rerank_fetch's within tolerance of the plain version; each
# call's route asserted
# ---------------------------------------------------------------------------

def _gather_int8_case(n, d, q, s, dev, seed=8):
    g = torch.Generator().manual_seed(seed)
    pts = torch.randn(n, d, generator=g).to(dev)
    qs = torch.randn(q, d, generator=g).to(dev)
    ids = torch.randint(0, n, (q, s), generator=g, dtype=torch.int32)
    ids[0, -1] = INVALID_ID
    ids[-1, 0] = n + 5
    ids[q // 2, s // 2] = -4
    return quantize_corpus(pts), ids.to(dev), qs, pts


def _gather_route(q, d, metric, quantize_query):
    """gatherdist-int8's plan for aligned rows, checked against the rule:
    regs for the f32-query form at l2 (d % 16 == 0, d <= 256), else warp."""
    route = gather_ops.plan(q, d, metric=metric, quantize_query=quantize_query).route
    regs = metric == "l2" and not quantize_query and d % 16 == 0 and d <= 256
    assert route == ("regs" if regs else "warp")
    return route


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("quantize_query", [False, True])
@pytest.mark.parametrize("n,d,q,s", [
    (4000, 128, 64, 4),       # the start points' S at the main path's d
    (2000, 128, 300, 32),     # the E=1 steps: S = R, four rows a group a pass
    (500, 256, 9, 33),        # two 16-byte chunks a lane, a ragged last pass
    (300, 144, 7, 5),         # a ragged second chunk
    (300, 16, 11, 1),
])
def test_gatherdist_int8_regs_route_matches_ref_and_warp(cuda_device, metric,
                                                         quantize_query, n, d, q, s):
    qc, ids, qs, pts = _gather_int8_case(n, d, q, s, cuda_device)
    kw = dict(metric=metric, quantize_query=quantize_query,
              return_dots=quantize_query)
    args = (qc.codes, qc.meta, ids, qs)
    planned = _gather_route(q, d, metric, quantize_query)
    got = _on_route(gatherdist_int8_cuda, planned, *args, **kw)
    old = _on_route(gatherdist_int8_cuda, "warp", *args, **kw, route="warp")
    want = gatherdist_int8_ref(qc, ids, qs, **kw)
    torch.cuda.synchronize()
    got, old, want = [x if quantize_query else (x,) for x in (got, old, want)]
    for a, b in zip(got, old):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    _assert_dists(got[0], want[0], _tol(metric, pts, qs))
    if quantize_query:
        assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("quantize_query", [False, True])
def test_gatherdist_int8_main_path_shape(cuda_device, metric, quantize_query):
    """4096 queries against the same 4 start ids, as init_state sends them
    (engine.start_ids expanded, made contiguous by gather_dist)."""
    g = torch.Generator().manual_seed(9)
    n, d, qn = 20_000, 128, 4096
    pts = torch.randn(n, d, generator=g).to(cuda_device)
    qs = torch.randn(qn, d, generator=g).to(cuda_device)
    qc = quantize_corpus(pts)
    ids = torch.randint(0, n, (4,), generator=g, dtype=torch.int32).to(
        cuda_device).expand(qn, -1).contiguous()
    kw = dict(metric=metric, quantize_query=quantize_query,
              return_dots=quantize_query)
    planned = _gather_route(qn, d, metric, quantize_query)
    got = _on_route(gatherdist_int8_cuda, planned, qc.codes, qc.meta, ids, qs, **kw)
    old = _on_route(gatherdist_int8_cuda, "warp", qc.codes, qc.meta, ids, qs, **kw,
                    route="warp")
    want = gatherdist_int8_ref(qc, ids, qs, **kw)
    torch.cuda.synchronize()
    got, old, want = [x if quantize_query else (x,) for x in (got, old, want)]
    for a, b in zip(got, old):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    _assert_dists(got[0], want[0], _tol(metric, pts, qs))
    if quantize_query:
        assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("quantize_query", [False, True])
@pytest.mark.parametrize("expand_route", ["bulk", "warp"])
def test_gatherdist_int8_routes_agree_with_expand_int8_routes(
        cuda_device, metric, quantize_query, expand_route):
    """Each route of gatherdist-int8 against each route of expand-int8 on
    the candidates they share: the same bits, int32 dots too."""
    pts, adj, fr, qs = _bulk_case("main", cuda_device, seed=10)
    qc = quantize_corpus(pts)
    kw = dict(metric=metric, quantize_query=quantize_query,
              return_dots=quantize_query)
    ex = _on_route(expand_int8_cuda, expand_route, qc.codes, qc.meta, adj, fr, qs,
                   **kw, **({"route": "warp"} if expand_route == "warp" else {}))
    ids, dd = ex[0], ex[1]
    keep = ids != INVALID_ID
    assert keep.any()
    planned = _gather_route(ids.shape[0], qc.shape[1], metric, quantize_query)
    for route in dict.fromkeys((planned, "warp")):
        g = _on_route(gatherdist_int8_cuda, route, qc.codes, qc.meta, ids, qs, **kw,
                      **({"route": "warp"} if route == "warp" else {}))
        torch.cuda.synchronize()
        gd = g[0] if quantize_query else g
        assert torch.equal(gd[keep].view(torch.int32), dd[keep].view(torch.int32))
        assert torch.isinf(gd[~keep]).all()
        if quantize_query:
            assert torch.equal(g[1][keep], ex[3][keep])


@pytest.mark.cuda
@pytest.mark.parametrize("d,misaligned", [(120, False), (272, False), (20, False),
                                          (128, True)])
def test_gatherdist_int8_warp_route_takes_what_regs_cannot(cuda_device, d, misaligned):
    qc, ids, qs, pts = _gather_int8_case(300, d, 6, 5, cuda_device)
    codes = qc.codes
    if misaligned:  # a base 4 bytes past a 16-byte boundary
        buf = torch.empty(codes.numel() + 4, dtype=torch.int8, device=cuda_device)
        buf[4:] = codes.flatten()
        codes = buf[4:].view(codes.shape)
    for quant in (False, True):
        got = _on_route(gatherdist_int8_cuda, "warp", codes, qc.meta, ids, qs,
                        quantize_query=quant)
        want = gatherdist_int8_ref(qc, ids, qs, quantize_query=quant)
        torch.cuda.synchronize()
        _assert_dists(got, want, _tol("l2", pts, qs))
    with pytest.raises(ValueError):
        gatherdist_int8_cuda(codes, qc.meta, ids, qs, route="regs")


def _fetch_case(p, d, order, dev, seed=11):
    g = torch.Generator().manual_seed(seed)
    n, nq = (100_000 if p > 4096 else 2000), 64
    raw = torch.randn(n, d, generator=g).to(dev)
    queries = torch.randn(nq, d, generator=g).to(dev)
    ids = torch.randint(0, n, (p,), generator=g, dtype=torch.int32)
    lanes = torch.randint(0, nq, (p,), generator=g, dtype=torch.int32)
    if order == "lane_major":     # as torch.nonzero gives the band
        lanes = torch.sort(lanes).values
    elif order == "one_lane":
        lanes[:] = 5
    ids[0] = n + 7                # clipped, as the reference clips
    if p > 1:
        ids[1] = -3
        lanes[-1] = nq + 2        # a lane out of range: clipped too
    return raw, queries, ids.to(dev), lanes.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("order", ["lane_major", "shuffled", "one_lane"])
@pytest.mark.parametrize("p", [1, 17, 65536])
@pytest.mark.parametrize("d", [17, 128, 130])
def test_rerank_fetch_routes_match_ref(cuda_device, metric, order, p, d):
    raw, queries, ids, lanes = _fetch_case(p, d, order, cuda_device)
    args = (raw, queries, ids, lanes)
    want = fetch_rerank_pairs_ref(*args, metric)
    tol = _tol(metric, raw, queries)
    planned = rerank_ops.plan(p, d)
    assert planned == ("regs" if d == 128 and p >= rerank_ops.REGS_MIN_PAIRS else "warp")
    got = _on_route(rerank_fetch_cuda, planned, *args, metric=metric)
    torch.cuda.synchronize()
    _assert_dists(got, want, tol)
    if d == 128:      # both routes on the same pairs
        for route in ("regs", "warp"):
            out = _on_route(rerank_fetch_cuda, route, *args, metric=metric, route=route)
            torch.cuda.synchronize()
            _assert_dists(out, want, tol)
    else:             # rows the persistent routes cannot take
        old = _on_route(rerank_fetch_cuda, "warp", *args, metric=metric, route="warp")
        torch.cuda.synchronize()
        _assert_dists(old, want, tol)
        with pytest.raises(ValueError):
            rerank_fetch_cuda(*args, metric=metric, route="regs")


# ---------------------------------------------------------------------------
# the engine's own surface on the card: the Vamana build, filtered search,
# the tiered corpus. Integer coordinates keep every distance exact, so the
# card's answers must equal the CPU path's bit for bit.
# ---------------------------------------------------------------------------

def _integer_rig(n, d, seed):
    return np.random.default_rng(seed).integers(-8, 9, (n, d)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_vamana_build_on_the_card_equals_cpu(cuda_device, metric):
    from repro_torch.core import BuildConfig, build_vamana
    pts = _integer_rig(2000, 16, 0)
    cfg = BuildConfig(max_degree=16, beam=32, insert_batch=256, metric=metric)
    want = build_vamana(pts, cfg, device="cpu").neighbors
    launches = (expand_cuda.launches, gatherdist_cuda.launches)
    got = build_vamana(pts, cfg, device=cuda_device).neighbors
    torch.cuda.synchronize()
    assert expand_cuda.launches > launches[0] and gatherdist_cuda.launches > launches[1]
    assert torch.equal(got.cpu(), want)


def _labeled_engines(dev, corpus_dtype=None):
    from repro_torch.core import Graph, build_vamana, pack_labels
    from repro_torch.core import BuildConfig
    pts = _integer_rig(3000, 16, 1)
    graph = build_vamana(pts, BuildConfig(max_degree=16, beam=32, insert_batch=256),
                         device="cpu")
    rng = np.random.default_rng(17)
    labels = pack_labels([rng.choice(16, int(rng.integers(1, 3)), replace=False)
                          for _ in range(pts.shape[0])], 16)
    return pts, [RangeSearchEngine.from_graph(pts, Graph(graph.neighbors), labels=labels,
                                              corpus_dtype=corpus_dtype, device=d)
                 for d in ("cpu", dev)]


def _filtered_case():
    from repro_torch.core import make_label_filter
    filt = make_label_filter([[q % 16] if q % 2 == 0 else [q % 16, (q + 5) % 16, 1, 2]
                              for q in range(64)], 16,
                             modes=["and" if q % 2 == 0 else "or" for q in range(64)])
    return filt


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [0.0, 0.2])
@pytest.mark.parametrize("compacted", [True, False])
def test_filtered_search_on_the_card_equals_cpu(cuda_device, threshold, compacted):
    """f32 corpus: every lane and field equal (walk, seeded walk and
    fallback lanes)."""
    pts, (cpu, card) = _labeled_engines(cuda_device)
    qs = pts[:64] + 0.5
    r = float(np.quantile(((pts[None, :200] - qs[:, None]) ** 2).sum(-1), 0.3))
    filt = _filtered_case()
    cfg = RangeConfig(search=SearchConfig(beam=32, max_beam=32, visit_cap=128),
                      result_cap=512, filter_threshold=threshold)
    launches = rerank_fetch_cuda.launches
    want = cpu.range(qs, r, cfg=cfg, compacted=compacted, filter=filt)
    got = card.range(qs, r, cfg=cfg, compacted=compacted, filter=filt)
    torch.cuda.synchronize()
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name).cpu(), getattr(want, f.name)), f.name
    if threshold and compacted:
        assert (got.n_visited[::2] == 0).all() and (got.n_visited[1::2] > 0).all()
        assert rerank_fetch_cuda.launches > launches    # the fallback's exact scan


@pytest.mark.cuda
def test_fallback_lanes_on_the_card_equal_cpu_int8(cuda_device):
    """int8 corpus: the fallback lanes read exact rows only, so they equal
    the CPU path bit for bit (the walk lanes' bounds may round otherwise)."""
    pts, (cpu, card) = _labeled_engines(cuda_device, "int8")
    qs = pts[:64] + 0.5
    r = float(np.quantile(((pts[None, :200] - qs[:, None]) ** 2).sum(-1), 0.3))
    cfg = RangeConfig(search=SearchConfig(beam=32, max_beam=32, visit_cap=128),
                      result_cap=512, filter_threshold=0.2)
    want = cpu.range(qs, r, cfg=cfg, filter=_filtered_case())
    got = card.range(qs, r, cfg=cfg, filter=_filtered_case())
    torch.cuda.synchronize()
    assert (got.n_visited[::2] == 0).all()
    for f in ("ids", "dists", "count", "overflow", "n_visited", "n_dist"):
        assert torch.equal(getattr(got, f)[::2].cpu(), getattr(want, f)[::2]), f


@pytest.mark.cuda
@pytest.mark.parametrize("n_queries", [64, 2048])
def test_tiered_rerank_on_the_card_is_bitwise_resident(cuda_device, n_queries):
    """Five repeats with a cache that evicts: every call bit for bit the
    resident int8 engine's, each rerank on the same route."""
    from repro_torch.tier import tiered_corpus
    g = torch.Generator().manual_seed(3)
    pts = torch.randn(20000, 32, generator=g)
    qs = pts[:n_queries] + 0.1 * torch.randn(n_queries, 32, generator=g)
    graph = build_knn_graph(pts, k=16, device=cuda_device)
    eng = RangeSearchEngine.from_graph(pts, graph, corpus_dtype="int8", device=cuda_device)
    tier = tiered_corpus(eng.points, cache_rows=512, fetch_bucket=256, device=cuda_device)
    eng_t = dataclasses.replace(eng, points=tier)
    r = float(torch.quantile(((pts[:500, None] - qs[None, :64]) ** 2).sum(-1), 0.01))
    cfg = RangeConfig(search=SearchConfig(beam=32, max_beam=32, visit_cap=128),
                      result_cap=256)
    for _ in range(5):
        routes = [dict(rerank_fetch_cuda.routes)]
        res = eng.range(qs, r, cfg=cfg)
        routes.append(dict(rerank_fetch_cuda.routes))
        res_t = eng_t.range(qs, r, cfg=cfg)
        routes.append(dict(rerank_fetch_cuda.routes))
        torch.cuda.synchronize()
        moved = [{k: b[k] - a[k] for k in a} for a, b in zip(routes, routes[1:])]
        assert moved[0] == moved[1] and sum(moved[0].values()) == 1, moved
        p = int(res.n_rerank.sum())
        assert moved[0][rerank_ops.plan(p, 32)] == 1
        for f in ("ids", "dists", "count", "n_rerank"):
            assert torch.equal(getattr(res, f), getattr(res_t, f)), f
    c = tier.counters
    assert c.cache_evictions > 0 and c.fetch_batches > 5 and c.cache_hits > 0


# ---------------------------------------------------------------------------
# the serving layer on the card: integer coordinates make every distance
# exact, so served answers must equal engine.range's bit for bit on any route
# ---------------------------------------------------------------------------

def _serve_rig(dev, corpus_dtype):
    from repro_torch.core import BuildConfig, Graph, build_vamana
    pts = _integer_rig(3000, 16, 2)
    graph = build_vamana(pts, BuildConfig(max_degree=16, beam=32, insert_batch=256),
                         device="cpu")
    eng = RangeSearchEngine.from_graph(pts, Graph(graph.neighbors), corpus_dtype=corpus_dtype,
                                       device=dev)
    qs = pts[:96] + 0.5
    d2 = ((pts[None] - qs[:, None]) ** 2).sum(-1)
    cfg = RangeConfig(search=SearchConfig(beam=32, max_beam=32, visit_cap=128,
                                          corpus_dtype=corpus_dtype or "float32"),
                      result_cap=512)
    return pts, eng, qs, d2, cfg


def _serve(srv, qs, radii):
    from repro_torch.serve import Request
    for i in range(qs.shape[0]):
        assert srv.submit(Request(req_id=i, query=qs[i], radius=float(radii[i]))) is None
    return sorted(srv.run_until_drained(), key=lambda x: x.req_id)


@pytest.mark.cuda
@pytest.mark.parametrize("corpus_dtype", [None, "int8"])
def test_lockstep_server_equals_engine_range_on_the_card(cuda_device, corpus_dtype):
    """Micro-batches of 32 against one engine.range over all 96 queries:
    every response equals its lane (ids, distance bits, count, overflow,
    es_stopped), and the path's kernels launched."""
    from repro_torch.serve import RangeServer, ServerConfig
    pts, eng, qs, d2, cfg = _serve_rig(cuda_device, corpus_dtype)
    radii = np.full(qs.shape[0], float(np.quantile(d2, 0.01)) + 0.5, np.float32)
    want = eng.range(qs, radii, cfg=cfg)
    kern = expand_int8_cuda if corpus_dtype else expand_cuda
    before = kern.launches
    resp = _serve(RangeServer(eng, cfg, ServerConfig(max_batch=32)), qs, radii)
    torch.cuda.synchronize()
    assert kern.launches > before
    ids, dists = want.ids.cpu().numpy(), want.dists.cpu().numpy()
    for i, x in enumerate(resp):
        keep = ids[i] != INVALID_ID
        np.testing.assert_array_equal(x.ids, ids[i][keep])
        np.testing.assert_array_equal(x.dists.view(np.int32), dists[i][keep].view(np.int32))
        assert (x.count, x.overflow, x.es_stopped) == (
            int(want.count[i]), bool(want.overflow[i]), bool(want.es_stopped[i]))
    assert sum(x.count for x in resp) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("corpus_dtype", [None, "int8"])
def test_continuous_server_equals_lockstep_on_the_card(cuda_device, corpus_dtype):
    """Every fourth request at a radius of ~300 matches (phase 2 in the pool
    of 4 lanes, 2 rounds a slice, the overflow one-shot), the rest at ~10:
    per request the lockstep server's ids, distance bits, count and
    overflow."""
    from repro_torch.serve import RangeServer, ServerConfig
    pts, eng, qs, d2, cfg = _serve_rig(cuda_device, corpus_dtype)
    srt = np.sort(d2, 1)
    radii = np.where(np.arange(qs.shape[0]) % 4 == 0, srt[:, 300], srt[:, 10]).astype(np.float32)
    lock = _serve(RangeServer(eng, cfg, ServerConfig(max_batch=16)), qs, radii)
    srv = RangeServer(eng, cfg, ServerConfig(max_batch=16, continuous=True, lanes=4,
                                             slice_rounds=2))
    cont = _serve(srv, qs, radii)
    torch.cuda.synchronize()
    assert srv.stats["pool_admitted"] and srv.stats["pool_oneshot"]
    assert srv.stats["pool_rotations"]
    for a, b in zip(lock, cont):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists.view(np.int32), b.dists.view(np.int32))
        assert (a.count, a.overflow) == (b.count, b.overflow)


# ---------------------------------------------------------------------------
# the live index on the card: WAL replay needs every mutation deterministic
# ---------------------------------------------------------------------------

def _live_state(idx) -> dict:
    from repro_torch.core import corpus_raw
    pts = idx.points
    hot = pts.device if getattr(pts, "is_tiered", False) else pts
    out = dict(raw=corpus_raw(pts), neighbors=idx.neighbors, start_ids=idx.start_ids,
               tombstones=idx.tombstones, ext_ids=torch.from_numpy(idx.ext_ids),
               counters=torch.tensor([idx.live_count, idx.next_ext_id, idx.epoch]))
    if hasattr(hot, "codes"):
        out.update(codes=hot.codes, meta=hot.meta)
    return {k: v.cpu() for k, v in out.items()}


def _live_stream(seed):
    """Float data (ties are rare, so every order the card picks shows):
    inserts, deletes of initial and fresh ids, an explicit consolidation,
    and one past the threshold."""
    rng = np.random.default_rng(seed)
    ops = [("insert", rng.standard_normal((100, 16)).astype(np.float32)),
           ("delete", rng.choice(1000, 120, replace=False)),
           ("insert", rng.standard_normal((70, 16)).astype(np.float32)),
           ("delete", np.arange(1000, 1040)),
           ("consolidate", None),
           ("insert", rng.standard_normal((90, 16)).astype(np.float32)),
           ("delete", rng.choice(1260, 400, replace=False)),
           ("maybe", None),
           ("insert", rng.standard_normal((40, 16)).astype(np.float32))]
    return ops


def _run_live(live, ops):
    for op, arg in ops:
        if op == "insert":
            live.insert(arg)
        elif op == "delete":
            live.delete(arg)
        elif op == "maybe":
            assert live.maybe_consolidate()
        else:
            live.consolidate()
    torch.cuda.synchronize()
    return live


def _live_card(dev, corpus_dtype="float32", graph=None):
    from repro_torch.core import BuildConfig, build_vamana
    from repro_torch.live import LiveConfig, LiveIndex
    pts = np.random.default_rng(0).standard_normal((1000, 16)).astype(np.float32)
    bcfg = BuildConfig(max_degree=16, beam=32, insert_batch=256)
    graph = graph or build_vamana(pts, bcfg, device=dev)
    return LiveIndex.create(pts, LiveConfig(capacity=1400, insert_batch=32), bcfg,
                            corpus_dtype=corpus_dtype, graph=graph, device=dev), graph


@pytest.mark.cuda
@pytest.mark.parametrize("corpus_dtype", ["float32", "int8"])
def test_live_index_mutations_are_deterministic_on_the_card(cuda_device, corpus_dtype):
    """One mutation stream run twice on the card from the same graph:
    every tensor of the two indices' states equal bit for bit, and the
    kernels of the insert path launched."""
    a, graph = _live_card(cuda_device, corpus_dtype)
    b, _ = _live_card(cuda_device, corpus_dtype, graph)
    before = (expand_cuda.launches, gatherdist_cuda.launches)
    sa, sb = _live_state(_run_live(a, _live_stream(1))), _live_state(_run_live(b, _live_stream(1)))
    assert expand_cuda.launches > before[0] and gatherdist_cuda.launches > before[1]
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a._slot_of == b._slot_of and a._dead == b._dead


@pytest.mark.cuda
def test_live_restore_with_wal_equals_the_control_on_the_card(cuda_device, tmp_path):
    """Checkpoint mid-stream, a torn record after the last durable one:
    restore + replay on the card equals the index that ran uninterrupted."""
    from repro_torch.fault import WriteAheadLog
    from repro_torch.fault.wal import encode_record
    from repro_torch.live import LiveIndex
    from repro_torch.train import CheckpointManager
    live, _ = _live_card(cuda_device)
    live.attach_wal(WriteAheadLog(str(tmp_path / "wal.bin")))
    cm = CheckpointManager(str(tmp_path / "ck"))
    ops = _live_stream(2)
    _run_live(live, ops[:3])
    live.save(cm)
    _run_live(live, ops[3:])
    with open(str(tmp_path / "wal.bin"), "ab") as f:
        f.write(encode_record(live.wal_seq + 1, "consolidate", {})[:11])
    got = LiveIndex.restore(cm, wal=WriteAheadLog(str(tmp_path / "wal.bin")),
                            device=cuda_device)
    sg, sw = _live_state(got), _live_state(live)
    for k in sw:
        assert torch.equal(sg[k], sw[k]), k
    assert got.wal_seq == live.wal_seq and got.neighbors.device.type == cuda_device.type


@pytest.mark.cuda
@pytest.mark.parametrize("corpus_dtype", ["float32", "int8"])
def test_live_snapshot_kernel_path_equals_plain_path(cuda_device, corpus_dtype):
    """After churn, a snapshot's kernel path equals its plain path on every
    lane: integer coordinates make every exact distance exact, so ids,
    counts, flags and counters are equal, and f32 distances too; int8
    keeps a sure member's certified lower bound, a sum over dequantized
    codes that the kernel orders otherwise (``_tol``)."""
    from repro_torch.core import BuildConfig, build_vamana
    from repro_torch.live import LiveConfig, LiveIndex
    pts = _integer_rig(2000, 16, 4)
    bcfg = BuildConfig(max_degree=16, beam=32, insert_batch=256)
    graph = build_vamana(pts, bcfg, device=cuda_device)
    live = LiveIndex.create(pts, LiveConfig(capacity=2400, insert_batch=64), bcfg,
                            corpus_dtype=corpus_dtype, graph=graph, device=cuda_device)
    live.insert(_integer_rig(300, 16, 5))
    live.delete(np.arange(0, 2300, 7))
    snap = live.snapshot()
    qs = _integer_rig(128, 16, 6) + 0.5
    d2 = ((pts[None] - qs[:, None]) ** 2).sum(-1)
    radii = np.where(np.arange(128) % 4 == 0, np.quantile(d2, 0.05, axis=1),
                     np.quantile(d2, 0.002, axis=1)).round() + 0.5
    cfg = RangeConfig(search=SearchConfig(beam=32, max_beam=32, visit_cap=128,
                                          corpus_dtype=corpus_dtype), result_cap=512)
    plain = dataclasses.replace(cfg, search=dataclasses.replace(cfg.search, use_kernels=False))
    kern = expand_int8_cuda if corpus_dtype == "int8" else expand_cuda
    before = kern.launches
    got, want = snap.range(qs, radii, cfg=cfg), snap.range(qs, radii, cfg=plain)
    torch.cuda.synchronize()
    assert kern.launches > before
    for f in dataclasses.fields(want):
        if f.name == "dists" and corpus_dtype == "int8":
            _assert_dists(got.dists, want.dists, _tol("l2", None, None))
        else:
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    assert int(got.count.sum()) > 0 and bool(got.phase2.any())


def _sharded_rig(device, corpus_dtype):
    """Integer coordinates (every exact distance an integer, decided alike
    on every path) in 4 shards, an exact k-NN graph and the medoid a shard,
    built once on the CPU and carried to ``device`` (the CPU corpus too, for
    the plain path), and queries half a unit off the lattice at per-lane
    radii."""
    from repro_torch.core import medoid
    from repro_torch.dist import build_sharded
    pts = _integer_rig(2001, 16, 7)
    graphs = []

    def knn(block):
        graphs.append((build_knn_graph(block, k=16, device="cpu"), medoid(block).reshape(1)))
        return graphs[-1]

    cpu = build_sharded(pts, 4, knn, corpus_dtype=corpus_dtype, device="cpu")
    again = iter(graphs)
    corpus = build_sharded(pts, 4, lambda b: next(again), corpus_dtype=corpus_dtype,
                           device=device)
    qs = _integer_rig(96, 16, 8) + 0.5
    d2 = ((pts[None] - qs[:, None]) ** 2).sum(-1)
    radii = (np.where(np.arange(96) % 3 == 0, np.quantile(d2, 0.05, axis=1),
                      np.quantile(d2, 0.005, axis=1)).round() + 0.5).astype(np.float32)
    cfg = RangeConfig(search=SearchConfig(beam=32, max_beam=32, visit_cap=128,
                                          corpus_dtype=corpus_dtype), result_cap=256)
    return cpu, corpus, qs, radii, cfg


def _same(a, b, exact_dists=True):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name).cpu(), getattr(b, f.name).cpu()
        if f.name == "dists" and not exact_dists:
            _assert_dists(x, y, _tol("l2", None, None))
        else:
            assert torch.equal(x.view(torch.int32) if f.name == "dists" else x,
                               y.view(torch.int32) if f.name == "dists" else y), f.name


@pytest.mark.cuda
@pytest.mark.parametrize("corpus_dtype", ["float32", "int8"])
def test_sharded_fan_out_threads_on_the_card(cuda_device, corpus_dtype):
    """Four worker threads issuing onto one card: bit for bit the serial
    fan-out, the launch counts exact, and equal to the same fan-out on the
    CPU's plain path (integer coordinates; int8 lower bounds to ``_tol``)."""
    from repro_torch.fault import FaultInjector, RetryPolicy, fault_tolerant_sharded_search
    cpu, corpus, qs, radii, cfg = _sharded_rig(cuda_device, corpus_dtype)
    kern = expand_int8_cuda if corpus_dtype == "int8" else expand_cuda
    runs, counts = [], []
    for workers in (0, None, 0, None):
        before = kern.launches
        runs.append(fault_tolerant_sharded_search(
            corpus=corpus, queries=qs, r=radii, cfg=cfg, max_workers=workers,
            injector=FaultInjector(script={(2, 0): "garbage"}),
            retry=RetryPolicy(backoff_s=0.0)))
        torch.cuda.synchronize()
        counts.append(kern.launches - before)
    for d in runs[1:]:
        _same(d.result, runs[0].result)
        assert list(d.attempts) == [1, 1, 2, 1]
    assert counts[0] == counts[2] and counts[1] == counts[3] and min(counts) > 0
    plain = fault_tolerant_sharded_search(corpus=cpu, queries=qs, r=radii, cfg=cfg)
    _same(runs[1].result, plain.result, exact_dists=corpus_dtype == "float32")
    assert int(plain.result.count.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("corpus_dtype", ["float32", "int8"])
def test_sharded_collective_one_rank_on_the_card(cuda_device, corpus_dtype):
    """``sharded_range_search`` over a one-rank NCCL mesh (every collective
    over a group of one) equals the host fan-out bit for bit."""
    import torch.distributed as dist
    from repro_torch.dist import make_mesh, sharded_range_search
    from repro_torch.fault import fault_tolerant_sharded_search
    _, corpus, qs, radii, cfg = _sharded_rig(cuda_device, corpus_dtype)
    mesh = make_mesh((1, 1))
    try:
        assert dist.get_backend() == "nccl"
        got = sharded_range_search(mesh=mesh, corpus=corpus, queries=qs, r=radii, cfg=cfg)
    finally:
        dist.destroy_process_group()
    want = fault_tolerant_sharded_search(corpus=corpus, queries=qs, r=radii, cfg=cfg)
    _same(got, want.result)


@pytest.mark.cuda
@pytest.mark.parametrize("corpus_dtype", ["float32", "int8"])
def test_replicated_fan_out_threads_on_the_card(cuda_device, corpus_dtype):
    """The replicated fan-out on the card, R=2: threaded and serial, with
    replicas down and with the wall-clock hedge (its losing walks waited
    out), each bit for bit the serial unreplicated fan-out, which equals the
    CPU's plain path (integer coordinates)."""
    import threading
    import time
    from repro_torch.fault import (
        FaultInjector, HedgePolicy, ReplicaFleet, ReplicatedCorpus, RetryPolicy,
        fault_tolerant_sharded_search, replicated_fan_out)
    cpu, corpus, qs, radii, cfg = _sharded_rig(cuda_device, corpus_dtype)
    kw = dict(queries=qs, r=radii, cfg=cfg, retry=RetryPolicy(backoff_s=0.0))
    base = fault_tolerant_sharded_search(corpus=corpus, max_workers=0, **kw)
    rc = ReplicatedCorpus.replicate(corpus, 2)
    assert rc.parity_ok() and rc.replica(1).neighbors.is_cuda
    baseline = threading.active_count()
    for workers in (0, None):
        for inj, hedge in ((None, None), (FaultInjector(down_replicas=((1, 0), (3, 1))), None),
                           (None, HedgePolicy(delay_s=0.0))):
            got = replicated_fan_out(fleet=ReplicaFleet(rc), injector=inj, hedge=hedge,
                                     max_workers=workers, **kw)
            torch.cuda.synchronize()
            _same(got.result, base.result)
            assert got.complete
    deadline = time.monotonic() + 60
    while threading.active_count() > baseline and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == baseline
    plain = fault_tolerant_sharded_search(corpus=cpu, **kw)
    _same(base.result, plain.result, exact_dists=corpus_dtype == "float32")


@pytest.mark.cuda
def test_live_sharded_index_create_on_the_card(cuda_device):
    """``LiveShardedIndex.create`` builds a Vamana graph a shard on the card
    (small n), clones replica groups, takes a churn, keeps parity, and its
    ``range`` over a one-rank NCCL mesh equals the union of the shards' own
    searches."""
    import torch.distributed as dist
    from repro_torch.core import BuildConfig
    from repro_torch.dist import make_mesh
    from repro_torch.live import LiveConfig, LiveShardedIndex
    pts = _integer_rig(1200, 16, 3)
    sl = LiveShardedIndex.create(pts, 4, LiveConfig(capacity=400, insert_batch=32),
                                 BuildConfig(max_degree=12, beam=24), replicas=2,
                                 device=cuda_device)
    assert sl.shards[0].neighbors.is_cuda and sl.n_replicas == 2
    fresh = sl.insert(_integer_rig(100, 16, 4))
    assert sl.delete(np.r_[0:1200:5, fresh[:10]]) == 250
    sl.assert_replica_parity()
    qs = pts[:32] + 0.5
    cfg = RangeConfig(search=SearchConfig(beam=24, max_beam=24, visit_cap=96), result_cap=128)
    mesh = make_mesh((1, 1))
    try:
        got = sl.range(mesh, qs, 40.5, cfg)
    finally:
        dist.destroy_process_group()
    per = [sh.snapshot().range(qs, 40.5, cfg=cfg, compacted=False) for sh in sl.shards]
    from repro_torch.dist.sharded_engine import union_merge
    ids, dists = union_merge(torch.cat([p.ids for p in per], 1),
                             torch.cat([p.dists for p in per], 1), cfg.result_cap)
    assert torch.equal(got.ids, ids) and torch.equal(got.dists, dists)
    assert int(got.count.sum()) > 0
    assert not np.isin(got.ids.cpu().numpy(), np.r_[0:1200:5]).any()


# ---------------------------------------------------------------------------
# the MoE and MLA members of the LM family: plain PyTorch on the card (no
# TPU kernel covers them), held to the same code on the CPU; the MoE layer
# bit for bit deterministic (its combine gathers, it never scatter-adds)
# ---------------------------------------------------------------------------

def _moe_on_card_and_cpu(cfg, dev, dtype=torch.float32):
    import copy

    from repro_torch.layers import init_moe
    torch.backends.cuda.matmul.allow_tf32 = False
    layer = init_moe(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev,
                     dtype=dtype)
    return layer, copy.deepcopy(layer).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,n_groups", [(4, 1, 32), (2, 2050, 3), (1, 4096, 32)])
def test_moe_layer_on_the_card_equals_cpu(cuda_device, b, s, n_groups):
    """f32: y within 1e-5 of the CPU's, the routing (so every kept slot:
    the slots are a function of the ids) and the drops equal; two calls on
    the card bit for bit equal (decode-sized, padded groups, two groups)."""
    from repro_torch.layers import MoEConfig, moe_layer
    from repro_torch.layers.moe import dispatch_plan, route
    cfg = MoEConfig(d_model=64, n_experts=12, n_experts_alloc=16, top_k=4, d_expert=48,
                    n_shared=2, n_groups=n_groups)
    layer, cpu = _moe_on_card_and_cpu(cfg, cuda_device)
    x = torch.randn((b, s, 64), generator=torch.Generator(device=cuda_device).manual_seed(1),
                    device=cuda_device)
    y, aux = moe_layer(layer, x, cfg)
    y2, aux2 = moe_layer(layer, x, cfg)
    yc, auxc = moe_layer(cpu, x.cpu(), cfg)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(aux["dropped_frac"], aux2["dropped_frac"])
    assert torch.equal(route(layer, x.reshape(-1, 64), cfg)[2].cpu(),
                       route(cpu, x.cpu().reshape(-1, 64), cfg)[2])
    groups, tg, c = dispatch_plan(b * s, cfg)
    n = groups * tg * cfg.top_k
    assert round(float(aux["dropped_frac"]) * n) == round(float(auxc["dropped_frac"]) * n)
    torch.testing.assert_close(y.cpu(), yc, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux["aux_loss"].cpu(), auxc["aux_loss"], rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_moe_layer_bf16_is_deterministic_on_the_card(cuda_device):
    from repro_torch.layers import MoEConfig, moe_layer
    cfg = MoEConfig(d_model=128, n_experts=60, n_experts_alloc=64, top_k=4, d_expert=64,
                    n_shared=4, n_groups=32)
    layer, _ = _moe_on_card_and_cpu(cfg, cuda_device, torch.bfloat16)
    assert layer.router.dtype == torch.float32
    x = torch.randn((4, 2048, 128), device=cuda_device).to(torch.bfloat16)
    outs = [moe_layer(layer, x, cfg) for _ in range(3)]
    torch.cuda.synchronize()
    for y, aux in outs[1:]:
        assert torch.equal(y, outs[0][0])
        assert torch.equal(aux["dropped_frac"], outs[0][1]["dropped_frac"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2_moe_a27b", "deepseek_v2_236b"])
def test_moe_and_mla_models_on_the_card_equal_cpu(cuda_device, arch):
    """The reduced qwen2-moe (GQA through flashattn) and deepseek-v2 (MLA
    through sdpa, a leading dense layer) in f32 at capacity factor 1.0 (so
    decode steps drop): prefill and 4 greedy steps on the card within 1e-4
    of the same model on the CPU, the tokens equal; flashattn launched once
    a GQA layer a call, never for MLA. The reduced qwen2-moe's head dim,
    12, is not one the kernel takes (16, 32, 64, 128): it runs here at 16."""
    import copy
    import importlib

    from repro_torch.models import decode_step, greedy_token, init_transformer, prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(importlib.import_module(f"repro_torch.configs.{arch}").reduced(),
                              capacity_factor=1.0)
    if cfg.attn_kind == "gqa":
        cfg = dataclasses.replace(cfg, d_head=16)
    model = init_transformer(cfg, seed=0, device=cuda_device)
    cpu = copy.deepcopy(model).cpu()
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(0))
    runs, launches = [], []
    for m, dev in ((model, cuda_device), (cpu, torch.device("cpu"))):
        before = flash_attention_cuda.launches
        lg, cache, pos = prefill(m, toks.to(dev), cfg, max_len=32)
        out, tok = [lg.cpu()], greedy_token(lg)
        for _ in range(4):
            lg, cache = decode_step(m, tok, cache, pos, cfg)
            tok, pos = greedy_token(lg), pos + 1
            out.append(lg.cpu())
        launches.append(flash_attention_cuda.launches - before)
        runs.append(torch.stack(out))
    assert launches == [0 if cfg.attn_kind == "mla" else 5 * cfg.n_layers, 0]
    torch.testing.assert_close(runs[0], runs[1], rtol=1e-4, atol=1e-4)
    assert torch.equal(runs[0].argmax(-1), runs[1].argmax(-1))


# ---------------------------------------------------------------------------
# Training on the card against the CPU (no kernel: the training path
# launches none). Tolerance: 1e-4 relative L2 a leaf after one AdamW step
# (the card's matmuls and index_add atomics sum in other orders; TF32 off).
# ---------------------------------------------------------------------------

def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev).clone()


def _train_step_card_vs_cpu(family, cfg, opt, batch, cuda_device, tol=1e-4):
    """One AdamW step of the family's loss from the same weights on
    the CPU and on the card: every leaf within ``tol`` relative L2."""
    import functools

    from repro_torch.launch.train import init_params
    from repro_torch.models import gcn_loss, loss_fn, recsys_loss
    from repro_torch.optim import init_adamw, make_train_step
    from repro_torch.optim.adamw import _leaves

    loss = functools.partial({"lm": loss_fn, "gnn": gcn_loss, "recsys": recsys_loss}[family],
                             cfg=cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    start = init_params(family, cfg, 0, torch.device("cpu"))
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        tree = _to(start, dev)
        step = make_train_step(loss, opt)
        tree, _, metrics = step(tree, init_adamw(tree, opt), batch)
        out[dev.type] = (tree, float(metrics["loss"]))
    (cpu, lc), (card, lg) = out["cpu"], out["cuda"]
    assert abs(lc - lg) <= 1e-5 * abs(lc)
    for a, b in zip(_leaves(card), _leaves(cpu)):
        assert a.device.type == "cuda" and a.dtype == b.dtype == torch.float32
        err = float((a.cpu() - b).norm() / b.norm().clamp(min=1e-30))
        assert err <= tol, err


@pytest.mark.cuda
def test_lm_train_step_on_the_card_equals_cpu(cuda_device):
    from repro_torch.configs import qwen3_14b
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(qwen3_14b.reduced(), remat=True)
    batch = lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=64, batch=2), 0)
    _train_step_card_vs_cpu("lm", cfg, AdamWConfig(lr=1e-3, warmup_steps=1), batch,
                            cuda_device)


@pytest.mark.cuda
def test_gcn_train_step_on_the_card_equals_cpu(cuda_device):
    from repro_torch.configs import gcn_cora
    from repro_torch.data import make_sbm_graph
    cfg = gcn_cora.reduced()
    g = make_sbm_graph(400, cfg.n_classes, cfg.d_feat, avg_degree=8)
    batch = {"feats": g.feats, "edge_src": g.edge_src, "edge_dst": g.edge_dst,
             "labels": g.labels}
    _train_step_card_vs_cpu("gnn", cfg, gcn_cora.ARCH.opt_cfg, batch, cuda_device, tol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["wide_deep", "dlrm_rm2", "autoint", "two_tower_retrieval"])
def test_recsys_train_step_on_the_card_equals_cpu(cuda_device, arch):
    import importlib

    from repro_torch.data import RecsysDataConfig, recsys_batch
    from repro_torch.optim import AdamWConfig
    cfg = importlib.import_module(f"repro_torch.configs.{arch}").reduced()
    batch = recsys_batch(RecsysDataConfig(
        n_dense=cfg.n_dense, n_sparse=cfg.n_sparse, vocab=cfg.vocab, batch=256,
        two_tower=cfg.kind == "two_tower", n_sparse_item=cfg.n_sparse_item), 0)
    _train_step_card_vs_cpu("recsys", cfg, AdamWConfig(lr=1e-3, warmup_steps=1), batch,
                            cuda_device)
