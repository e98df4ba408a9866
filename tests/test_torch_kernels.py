"""The port's kernel modules against the JAX package, and the CUDA kernels
against their plain versions.

The same numpy inputs go through the JAX function and its port:

* ``expand`` and ``gatherdist``: the port's plain PyTorch version (what a
  CPU tensor dispatches to) against the JAX plain version, and against the
  Pallas kernel in interpret mode;
* the bitset and the f32 sort key, which the search loops build on.

Tolerances: ids, counts and bits are equal; f32 distances are
``allclose(rtol=1e-5, atol=1e-6)`` — the two frameworks sum the d terms in
different orders, which costs a few ulp. For ip the error of a reordered
sum scales with the terms (bounded by |x||q|), not with the result, which
can be near zero: there ``atol`` is 1e-6 * max|x| * max|q|. The CUDA
kernels are held to these plain versions on a card by
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as jbits
from repro.core.beam_search import _f32_ascending_key as jax_key
from repro.core.distances import gather_dist as jax_gather_dist
from repro.kernels import expand_frontier as jax_expand
from repro.kernels import expand_frontier_ref as jax_expand_ref
from repro.kernels import gatherdist as jax_gatherdist
from repro.kernels import gatherdist_ref as jax_gatherdist_ref
from repro_torch.core import bitset as tbits
from repro_torch.core.beam_search import _f32_ascending_key, _f32_from_key
from repro_torch.core.distances import gather_dist
from repro_torch.kernels.expand import (
    expand_cuda, expand_frontier, expand_frontier_1, expand_frontier_ref)
from repro_torch.kernels.gatherdist import gatherdist, gatherdist_cuda, gatherdist_ref
from repro_torch.utils import INVALID_ID

TOL = dict(rtol=1e-5, atol=1e-6)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _expand_fixture(n, r, d, q, e, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    adj = rng.integers(0, n, (n, r)).astype(np.int32)
    adj[:, -max(1, r // 4):] = INVALID_ID      # INVALID-padded adjacency rows
    if r >= 2:
        adj[0, 1] = adj[0, 0]                  # duplicate neighbor in-row
        adj[1, :2] = adj[0, :2]                # duplicates across rows
    qs = rng.standard_normal((q, d)).astype(np.float32)
    fr = rng.integers(0, n, (q, e)).astype(np.int32)
    if e >= 2:
        fr[0, 1] = fr[0, 0]                    # duplicate frontier node
        fr[-1, -1] = INVALID_ID                # padded frontier lane
    if e >= 3:
        fr[0, 2] = n + 3                       # out-of-range frontier entry
    return pts, adj, fr, qs


def _assert_dists(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **tol)


def _tol(metric, pts, qs):
    if metric == "l2":
        return TOL
    scale = np.linalg.norm(pts, axis=1).max() * np.linalg.norm(qs, axis=1).max()
    return dict(rtol=1e-5, atol=1e-6 * max(1.0, float(scale)))


def _torch(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


# ---------------------------------------------------------------------------
# expand
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n,r,d,q,e", [
    (150, 8, 32, 6, 4),
    (64, 5, 17, 3, 2),     # ragged degree/dim
    (40, 4, 16, 1, 6),     # E > eligible variety, single query
    (300, 32, 128, 8, 4),  # the main path's R and d
])
def test_expand_ref_matches_jax(dtype, metric, n, r, d, q, e):
    pts, adj, fr, qs = _expand_fixture(n, r, d, q, e)
    jdt, tdt = DTYPES[dtype]
    ids, dd, nd = jax_expand_ref(jnp.asarray(pts).astype(jdt), jnp.asarray(adj),
                                 jnp.asarray(fr), jnp.asarray(qs), metric=metric)
    tp, ta, tf, tq = _torch(pts, adj, fr, qs)
    got = expand_frontier(tp.to(tdt), ta, tf, tq, metric=metric)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ids))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(nd))
    _assert_dists(got[1].numpy(), dd, _tol(metric, pts, qs))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_expand_ref_matches_pallas_interpret(metric):
    """Against the Pallas TPU kernel itself (interpret mode): equal ids and
    n_dist; distances to the tolerance JAX's own kernel test uses, since the
    Pallas kernel takes the norm form |x|^2 + |q|^2 - 2x.q."""
    pts, adj, fr, qs = _expand_fixture(150, 8, 32, 6, 4, seed=1)
    ids, dd, nd = jax_expand(jnp.asarray(pts), jnp.asarray(adj), jnp.asarray(fr),
                             jnp.asarray(qs), metric=metric, use_pallas=True,
                             interpret=True)
    got = expand_frontier_ref(*_torch(pts, adj, fr, qs), metric=metric)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ids))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(nd))
    _assert_dists(got[1].numpy(), dd, dict(rtol=1e-3, atol=1e-4))


def test_expand_dedups_within_tile():
    """Duplicate adjacency entries and frontier nodes survive exactly once
    across a query's tile; invalid frontier slots give all-INVALID rows."""
    pts, adj, fr, qs = _expand_fixture(100, 6, 16, 4, 3)
    ids, dd, _ = expand_frontier_ref(*_torch(pts, adj, fr, qs))
    for row in ids.numpy():
        live = row[row != INVALID_ID]
        assert len(np.unique(live)) == len(live)
    assert (ids.numpy()[-1].reshape(3, -1)[-1] == INVALID_ID).all()
    assert np.isinf(dd.numpy()[ids.numpy() == INVALID_ID]).all()


def test_expand_frontier_1_is_one_lane():
    pts, adj, fr, qs = _expand_fixture(150, 8, 32, 6, 4)
    tp, ta, tf, tq = _torch(pts, adj, fr, qs)
    batch = expand_frontier_ref(tp, ta, tf, tq)
    for i in range(fr.shape[0]):
        one = expand_frontier_1(tp, ta, tf[i], tq[i])
        for a, b in zip(one, batch):
            np.testing.assert_array_equal(a.numpy(), b[i].numpy())


# ---------------------------------------------------------------------------
# gatherdist
# ---------------------------------------------------------------------------

def _gather_fixture(n, d, q, s, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    ids = rng.integers(0, n, (q, s)).astype(np.int32)
    ids[0, -1] = INVALID_ID
    ids[-1, 0] = n + 5  # out of range
    return pts, ids, qs


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n,d,q,s", [(100, 32, 8, 16), (57, 19, 5, 7),
                                     (300, 128, 6, 4)])
def test_gatherdist_ref_matches_jax(dtype, metric, n, d, q, s):
    pts, ids, qs = _gather_fixture(n, d, q, s)
    jdt, tdt = DTYPES[dtype]
    want = jax_gatherdist_ref(jnp.asarray(pts).astype(jdt), jnp.asarray(ids),
                              jnp.asarray(qs), metric=metric)
    tp, ti, tq = _torch(pts, ids, qs)
    tol = _tol(metric, pts, qs)
    _assert_dists(gatherdist(tp.to(tdt), ti, tq, metric=metric).numpy(), want, tol)
    # the search loops reach the kernel through core.distances.gather_dist
    jwant = jax_gather_dist(jnp.asarray(pts).astype(jdt), jnp.asarray(ids),
                            jnp.asarray(qs), metric)
    _assert_dists(gather_dist(tp.to(tdt), ti, tq, metric).numpy(), jwant, tol)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gatherdist_ref_matches_pallas_interpret(metric):
    pts, ids, qs = _gather_fixture(100, 32, 4, 8, seed=2)
    want = jax_gatherdist(jnp.asarray(pts), jnp.asarray(ids), jnp.asarray(qs),
                          metric=metric, interpret=True)
    _assert_dists(gatherdist_ref(*_torch(pts, ids, qs), metric=metric).numpy(),
                  want)


# ---------------------------------------------------------------------------
# bitset and sort key
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_nodes,cap", [(1, 32), (1000, 1 << 20), (2000, 512),
                                         (1 << 20, 1 << 20), (3_000_000, 1 << 20)])
def test_bitset_sizing_matches_jax(n_nodes, cap):
    w = tbits.bitset_num_words(n_nodes, cap)
    assert w == jbits.bitset_num_words(n_nodes, cap)
    assert tbits.bitset_exact(n_nodes, w) == jbits.bitset_exact(n_nodes, w)


@pytest.mark.parametrize("num_words", [64, 5])  # exact (n <= 2048), hashed
def test_bitset_add_contains_match_jax(num_words):
    """Per-lane marks over a tile with duplicate slots, bit 31 included;
    words equal the reference's uint32 words bit for bit."""
    rng = np.random.default_rng(0)
    q, t = 6, 40
    ids = rng.integers(0, 2048, (q, t)).astype(np.int32)
    ids[:, 0] = 31 + 32 * rng.integers(0, num_words, q)  # the sign bit
    ids[:, 1] = ids[:, 2]                                # duplicate ids
    valid = rng.random((q, t)) < 0.8
    tb = tbits.bitset_init(num_words, q)
    ti, tv = _torch(ids, valid)
    mark = tbits.first_slot_occurrence(tb, ti, tv)
    tbits.bitset_add(tb, ti, mark)
    probe = rng.integers(0, 2048, (q, 64)).astype(np.int32)
    got_in = tbits.bitset_contains(tb, torch.from_numpy(probe))
    for i in range(q):
        jb = jbits.bitset_init(num_words)
        jmark = jbits.first_slot_occurrence(jb, jnp.asarray(ids[i]),
                                            jnp.asarray(valid[i]))
        np.testing.assert_array_equal(mark[i].numpy(), np.asarray(jmark))
        jb = jbits.bitset_add(jb, jnp.asarray(ids[i]), jmark)
        np.testing.assert_array_equal(tb[i].numpy(),
                                      np.asarray(jb).view(np.int32))
        np.testing.assert_array_equal(
            got_in[i].numpy(),
            np.asarray(jbits.bitset_contains(jb, jnp.asarray(probe[i]))))
    # a shared (W,) bitset probes the same way
    shared = tbits.bitset_contains(tb[0], torch.from_numpy(probe))
    np.testing.assert_array_equal(shared[0].numpy(), got_in[0].numpy())


def test_f32_key_round_trip_and_order():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.array([np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, 3.4e38, -3.4e38,
                  1.0, -1.0], np.float32),
        rng.standard_normal(200).astype(np.float32) * 10]).astype(np.float32)
    key = _f32_ascending_key(torch.from_numpy(x))
    np.testing.assert_array_equal(key.numpy(),
                                  np.asarray(jax_key(jnp.asarray(x))).astype(np.int64))
    back = _f32_from_key(key).numpy()
    np.testing.assert_array_equal(back.view(np.int32), x.view(np.int32))
    # key order is the total order: ascending values, -0.0 before +0.0
    order = np.argsort(key.numpy(), kind="stable")
    assert np.all(np.diff(x[order]) >= 0)
    assert np.signbit(x[order][np.nonzero(x[order] == 0)[0][0]])
    # the int32 wrap used by the packed greedy buffer round-trips too
    wrapped = key.to(torch.int32).to(torch.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(wrapped.numpy(), key.numpy())


# ---------------------------------------------------------------------------
# dispatch and the CUDA kernels
# ---------------------------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_tensors():
    """A CPU tensor reaches the kernel wrapper only by a direct call, and
    then it raises rather than computing anything or counting a launch."""
    pts, adj, fr, qs = _expand_fixture(40, 4, 16, 2, 2)
    before = (expand_cuda.launches, gatherdist_cuda.launches)
    with pytest.raises(ValueError):
        expand_cuda(*_torch(pts, adj, fr, qs))
    with pytest.raises(ValueError):
        gatherdist_cuda(*_torch(pts, adj[:2], qs))
    expand_frontier(*_torch(pts, adj, fr, qs))  # CPU: the plain version
    assert (expand_cuda.launches, gatherdist_cuda.launches) == before
