"""expand's route plan, and its plain versions against the JAX package on
the inputs the bulk route's design stresses.

* ``ops.plan`` / ``ops._route``: which shapes the ``bulk`` route takes
  (rows whole 16-byte spans on a 16-byte base, R % 4 == 0, a stage in a
  block's shared memory) and which go to ``warp``, by dtype, d, R, E and
  the alignment of a sliced tensor; ``ops.bulk_launch``: the blocks,
  stages and split of a launch, within an H100's shared memory;
* the plain versions (what a CPU tensor dispatches to) against the JAX
  plain versions and the Pallas kernels in interpret mode, on all-duplicate
  tiles, repeated frontier nodes, all-INVALID and out-of-range frontiers,
  and R > 32.

Tolerances as in ``test_torch_kernels.py`` and ``test_torch_int8.py``: ids,
n_dist and int32 dots equal; distances ``allclose(rtol=1e-5, atol=1e-6)``
against the JAX plain version (1e-5 for the int8 bounds), and for ip
``atol = 1e-6 * max|x| * max|q|`` (a reordered sum errs with its terms);
against the f32 Pallas kernel, which takes the norm form |x|^2 + |q|^2 -
2x.q, ``rtol=1e-3, atol=1e-4`` as JAX's own kernel test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import corpus as jcorpus
from repro.kernels import expand_frontier as jax_expand
from repro.kernels import expand_frontier_ref as jax_expand_ref
from repro_torch.core import corpus as tcorpus
from repro_torch.kernels.expand import expand_frontier, expand_frontier_int8_ref
from repro_torch.kernels.expand import ops
from repro_torch.utils import INVALID_ID

TOL = dict(rtol=1e-5, atol=1e-6)
INT8_TOL = dict(rtol=1e-5, atol=1e-5)
PALLAS_TOL = dict(rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# the route plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,r,e,route", [
    (torch.float32, 128, 32, 4, "bulk"),     # the main path
    (torch.float32, 256, 32, 4, "bulk"),     # the two-tower graph half
    (torch.bfloat16, 128, 32, 4, "bulk"),
    (torch.int8, 128, 32, 4, "bulk"),
    (torch.int8, 256, 32, 4, "bulk"),
    (torch.float32, 20, 32, 4, "bulk"),      # 80-byte rows
    (torch.float32, 128, 100, 4, "bulk"),    # R > 32
    (torch.float32, 128, 32, 32, "bulk"),    # the widest frontier
    (torch.float32, 512, 100, 4, "bulk"),    # one stage of 200 KB
    (torch.float32, 256, 100, 4, "bulk"),
    (torch.float32, 17, 32, 4, "warp"),      # 68-byte rows
    (torch.float32, 130, 32, 4, "warp"),
    (torch.bfloat16, 20, 32, 4, "warp"),     # 40-byte rows
    (torch.int8, 20, 32, 4, "warp"),
    (torch.int8, 130, 32, 4, "warp"),
    (torch.float32, 128, 5, 4, "warp"),      # adjacency rows of 20 bytes
    (torch.float32, 128, 6, 4, "warp"),
    (torch.float32, 4096, 32, 4, "warp"),    # one stage of 16 KB rows does not fit
    (torch.float32, 1024, 100, 4, "warp"),
])
def test_plan_routes_by_shape_dtype(dtype, d, r, e, route):
    p = ops.plan(e, r, d, dtype)
    assert p.route == route
    row_bytes = d * torch.empty((), dtype=dtype).element_size()
    if route == "warp":
        assert p == ops.ExpandPlan("warp", ops.warp_smem(e, r, d))
        return
    assert p.smem == ops.bulk_smem(e, r, d, row_bytes, dtype == torch.int8, 1)
    assert p.smem <= ops.SMEM_PER_BLOCK


def test_plan_alignment_and_rejects():
    assert ops.plan(4, 32, 128, torch.float32, aligned=False).route == "warp"
    assert ops.plan(4, 32, 128, torch.int8, aligned=False).route == "warp"
    for e, r, d in ((0, 32, 128), (33, 32, 128), (4, 0, 128)):
        with pytest.raises(ValueError):
            ops.plan(e, r, d, torch.float32)


def test_bulk_smem_grows_with_each_part():
    """The layout's parts: a stage holds R ids, the query and R rows (and
    R 12-byte metadata rows for int8) beside its barrier; the rest is per
    block."""
    def bars(s):  # TB tile barriers and one a stage, 8 bytes each
        return (8 * (ops.TB + s) + 15) // 16 * 16

    stage = 16 + 4 * 32 + 4 * 128 + 32 * 512
    assert (ops.bulk_smem(4, 32, 128, 512, False, 2)
            - ops.bulk_smem(4, 32, 128, 512, False, 1)) == stage + bars(2) - bars(1)
    stage8 = 16 + 4 * 32 + 4 * 128 + 12 * 32 + 32 * 128
    assert (ops.bulk_smem(4, 32, 128, 128, True, 3)
            - ops.bulk_smem(4, 32, 128, 128, True, 2)) == stage8 + bars(3) - bars(2)
    # frontier ring of 5, 3 tiles, kept ids, a 512-slot table at T = 128
    fixed = ops.bulk_smem(4, 32, 128, 512, False, 0)
    assert fixed == 32 + 80 + 3 * 512 + 512 + 4 * 512


@pytest.mark.parametrize("qn", [1, 52, 308, 400, 617, 1000, 1500, 2000, 4096, 50_000])
@pytest.mark.parametrize("dtype,d", [(torch.float32, 128), (torch.float32, 256),
                                     (torch.bfloat16, 128), (torch.int8, 128),
                                     (torch.int8, 256)])
def test_bulk_launch_shapes(qn, dtype, d):
    """Every unit in one block's walk, no block idle, none beyond what an
    H100 holds at once: a query splits over up to E warps only while the
    queries are fewer than the blocks the card holds, and a block gets more
    than one stage only where the card still holds them all."""
    e, r, sms = 4, 32, 132
    row_bytes = d * torch.empty((), dtype=dtype).element_size()
    int8 = dtype == torch.int8
    b = ops.bulk_launch(qn, e, r, d, row_bytes, int8, sms)
    assert b.smem == ops.bulk_smem(e, r, d, row_bytes, int8, b.stages)
    assert 1 <= b.split <= e and 1 <= b.stages <= -(-e // b.split)
    cap = ops.blocks_per_sm(b.smem) * sms
    units = qn * b.split
    per_block = -(-units // b.blocks)
    assert b.blocks <= cap
    assert per_block == -(-units // cap)          # as few units a block as the card allows
    assert (b.blocks - 1) * per_block < units     # and no idle block
    one = ops.blocks_per_sm(ops.bulk_smem(e, r, d, row_bytes, int8, 1)) * sms
    if qn * e <= one:
        assert (b.split, b.stages) == (e, 1)      # a warp a frontier slot
    if qn >= one:
        assert (b.split, b.stages) == (1, 1)      # the whole card, whole queries


def test_bulk_launch_table_shape_is_balanced():
    """Q=4096 on an H100 at d=128 f32: 10 blocks an SM hold 1,320; four
    queries a block take 1,024 of them."""
    assert ops.bulk_launch(4096, 4, 32, 128, 512, False, 132) == ops.BulkLaunch(
        1024, 1, 1, ops.bulk_smem(4, 32, 128, 512, False, 1))


def _route_of(rows, neighbors, queries, route=None):
    r, d = neighbors.shape[1], rows.shape[1]
    return ops._route(rows, neighbors, queries, 4, r, d, route).route


def test_route_of_sliced_tensors():
    """The wrapper's alignment test on real tensors: a slice that keeps
    16-byte rows on a 16-byte boundary stays ``bulk``; a base 4 bytes off
    sends the call to ``warp``, whichever of rows, adjacency or queries it
    is."""
    n, d, r = 64, 128, 32
    pts = torch.zeros(n + 2, d)
    adj = torch.zeros((n + 2, r), dtype=torch.int32)
    qs = torch.zeros(10, d)
    assert _route_of(pts[2:], adj[2:], qs) == "bulk"
    flat = torch.zeros(n * d + 1)
    assert _route_of(flat[1:].view(n, d), adj[:n], qs) == "warp"
    aflat = torch.zeros(n * r + 1, dtype=torch.int32)
    assert _route_of(pts[:n], aflat[1:].view(n, r), qs) == "warp"
    qflat = torch.zeros(10 * d + 1)
    assert _route_of(pts[:n], adj[:n], qflat[1:].view(10, d)) == "warp"
    codes = torch.zeros((n + 1, d), dtype=torch.int8)
    assert _route_of(codes[1:], adj[:n], qs) == "bulk"    # 128-byte rows
    codes = torch.zeros((n * d + 8,), dtype=torch.int8)
    assert _route_of(codes[8:].view(n, d), adj[:n], qs) == "warp"


def test_route_forced():
    pts = torch.zeros(64, 128)
    adj = torch.zeros((64, 32), dtype=torch.int32)
    qs = torch.zeros(3, 128)
    assert _route_of(pts, adj, qs, route="warp") == "warp"
    assert _route_of(pts, adj, qs, route="bulk") == "bulk"
    with pytest.raises(ValueError):      # the plan sends d=17 to warp
        _route_of(torch.zeros(64, 17), adj, torch.zeros(3, 17), route="bulk")
    with pytest.raises(ValueError):
        _route_of(pts, adj, qs, route="tile")
    big = torch.zeros(64, 16_384)        # warp: the query alone is 64 KB
    with pytest.raises(ValueError):
        _route_of(big, adj, torch.zeros(3, 16_384))


# ---------------------------------------------------------------------------
# the plain versions against the JAX package on the stress cases
# ---------------------------------------------------------------------------

def _stress(case, n=120, r=8, d=32, q=6, e=4, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    pts[0] = 0.0
    adj = rng.integers(0, n, (n, r)).astype(np.int32)
    adj[:, -max(1, r // 4):] = INVALID_ID
    fr = rng.integers(0, n, (q, e)).astype(np.int32)
    if case == "duplicates":           # one adjacency row everywhere, E equal nodes
        adj[:] = adj[5]
        adj[:, 1::2] = adj[:, 0::2]    # and each id twice in it (r even)
        fr[: q // 2] = fr[: q // 2, :1]
    elif case == "repeated_frontier":
        fr[:, 1] = fr[:, 0]
        fr[::2, 3] = fr[::2, 2]
    elif case == "invalid":            # every lane frozen
        fr[:] = INVALID_ID
    elif case == "out_of_range":
        fr[0] = [n, n + 3, -5, INVALID_ID]
        fr[1, 2] = n + 1
        fr[2, 0] = -1
        adj[:, 2] = n + 7
        adj[:, 3] = -2
    qs = rng.standard_normal((q, d)).astype(np.float32)
    return pts, adj, fr, qs


CASES = ["duplicates", "repeated_frontier", "invalid", "out_of_range", "r40"]


def _case(case):
    if case == "r40":
        return _stress("repeated_frontier", r=40, seed=3)
    return _stress(case)


def _tol(metric, pts, qs, tol):
    if metric == "l2":
        return tol
    scale = np.linalg.norm(pts, axis=1).max() * np.linalg.norm(qs, axis=1).max()
    return dict(rtol=tol["rtol"], atol=max(tol["atol"], 1e-6 * float(scale)))


def _assert_dists(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **tol)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("case", CASES)
def test_expand_ref_stress_matches_jax(metric, case):
    pts, adj, fr, qs = _case(case)
    got = expand_frontier(*_t(pts, adj, fr, qs), metric=metric)
    for use_pallas, tol in ((False, TOL), (True, PALLAS_TOL)):
        ids, dd, nd = jax_expand(jnp.asarray(pts), jnp.asarray(adj), jnp.asarray(fr),
                                 jnp.asarray(qs), metric=metric,
                                 use_pallas=use_pallas, interpret=True)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ids))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(nd))
        _assert_dists(got[1].numpy(), dd, _tol(metric, pts, qs, tol))
    ids = got[0].numpy()
    for row in ids:                      # each id at most once a tile
        kept = row[row != INVALID_ID]
        assert len(np.unique(kept)) == len(kept)
    if case == "invalid":
        assert (ids == INVALID_ID).all() and (got[2].numpy() == 0).all()


def _both(pts):
    jqc = jcorpus.quantize_corpus(jnp.asarray(pts))
    tqc = tcorpus.QuantizedCorpus(codes=torch.from_numpy(np.array(jqc.codes)),
                                  meta=torch.from_numpy(np.array(jqc.meta)),
                                  raw=torch.from_numpy(pts))
    return jqc, tqc


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("case", CASES)
def test_expand_int8_ref_stress_matches_jax(metric, case):
    """The f32-query form against the JAX plain version; the int8-query
    form against the Pallas int8 kernel in interpret mode."""
    pts, adj, fr, qs = _case(case)
    jqc, tqc = _both(pts)
    ja, jf, jq = jnp.asarray(adj), jnp.asarray(fr), jnp.asarray(qs)
    ta, tf, tq = _t(adj, fr, qs)
    for quant, want in ((False, jax_expand_ref(jqc, ja, jf, jq, metric=metric)),
                        (True, jax_expand(jqc, ja, jf, jq, metric=metric,
                                          use_pallas=True, interpret=True))):
        got = expand_frontier_int8_ref(tqc, ta, tf, tq, metric=metric,
                                       quantize_query=quant)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        _assert_dists(got[1].numpy(), want[1], _tol(metric, pts, qs, INT8_TOL))
