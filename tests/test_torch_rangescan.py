"""The port's brute-force range scan against the JAX package's.

The same numpy inputs go through the port's plain rangescan (what a CPU
tensor dispatches to) and through JAX's ``rangescan`` in interpret mode
(the Pallas kernel) and ``rangescan_ref``. Radii sit midway between two
consecutive reference distances (as ``tests/test_oracle.py`` sets them),
so rounding cannot flip a member. Tolerances: counts and the ids of
finite slots are equal; f32 distances ``allclose(rtol=1e-5, atol=1e-5)``
(the two frameworks sum the d terms in different orders); bf16 inputs
2e-2, as ``tests/test_kernels.py`` holds the Pallas kernel. The CUDA
kernel is held to this plain version on a card by ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rangescan as jax_rangescan
from repro.kernels import rangescan_ref as jax_rangescan_ref
from repro_torch.kernels import rangescan
from repro_torch.kernels.rangescan import rangescan_dists, rangescan_ref
from repro_torch.kernels.rangescan.ops import (
    MAX_SPLITS, TILE, WGMMA_BLOCK_Q, _splits, plan, tma_rows)
from repro_torch.kernels.rangescan.ref import (
    compare_scans, dots_3xtf32, split_tf32, tf32_rn)
from repro_torch.utils import INVALID_ID

TOL = dict(rtol=1e-5, atol=1e-5)


def _dists64(qs, pts, metric):
    q, x = qs.astype(np.float64), pts.astype(np.float64)
    if metric == "ip":
        return -(q @ x.T)
    return ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)


def midpoint_radius(qs, pts, metric, frac):
    """The midpoint of the widest gap between consecutive distances (over
    every pair) among the 41 around the ``frac`` quantile."""
    d = np.sort(_dists64(qs, pts, metric).ravel())
    i = int(frac * (d.size - 1))
    lo, hi = max(0, i - 20), min(d.size - 1, i + 20)
    gaps = np.diff(d[lo:hi + 1])
    j = lo + int(np.argmax(gaps))
    return float((d[j] + d[j + 1]) / 2)


def _run_all(qs, pts, r, k, metric, bq=8, bn=128):
    jq, jx = jnp.asarray(qs), jnp.asarray(pts)
    pallas = jax_rangescan(jq, jx, jnp.float32(r), k=k, block_q=bq, block_n=bn,
                           metric=metric, interpret=True)
    ref = jax_rangescan_ref(jq, jx, jnp.float32(r), k=k, metric=metric)
    port = rangescan(torch.as_tensor(qs), torch.as_tensor(pts), r, k=k,
                     metric=metric)
    return ([np.asarray(t) for t in pallas], [np.asarray(t) for t in ref],
            [t.numpy() for t in port])


def _assert_same(port, want, tol=TOL):
    ids, dd, c = port
    wids, wd, wc = want
    np.testing.assert_array_equal(c, wc)
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(dd), fin)
    np.testing.assert_array_equal(ids[fin], wids[fin])
    assert (ids[~fin] == INVALID_ID).all()
    np.testing.assert_allclose(dd[fin], wd[fin], **tol)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("q,n,d,k,bq,bn", [
    (20, 300, 64, 16, 8, 128),
    (7, 100, 33, 8, 8, 64),      # non-divisible everything
    (1, 512, 128, 32, 8, 256),   # single query
    (33, 64, 16, 64, 16, 64),    # k > in-range count
])
def test_plain_rangescan_matches_jax(metric, q, n, d, k, bq, bn):
    rng = np.random.default_rng(q * 7 + n)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    for frac in (0.02, 0.3):
        r = midpoint_radius(qs, pts, metric, frac)
        pallas, ref, port = _run_all(qs, pts, r, k, metric, bq, bn)
        _assert_same(port, ref)
        _assert_same(port, pallas)
    assert (port[2] > k).any() or k >= n


def test_plain_rangescan_bf16_inputs():
    rng = np.random.default_rng(0)
    # bf16 values, carried as f32 numpy (exact): both sides read the same
    qs = np.array(jnp.asarray(rng.standard_normal((8, 32)), jnp.bfloat16)
                  .astype(jnp.float32))
    pts = np.array(jnp.asarray(rng.standard_normal((128, 32)), jnp.bfloat16)
                   .astype(jnp.float32))
    r = midpoint_radius(qs, pts, "l2", 0.2)
    jq = jnp.asarray(qs, jnp.bfloat16)
    jx = jnp.asarray(pts, jnp.bfloat16)
    pallas = jax_rangescan(jq, jx, jnp.float32(r), k=8, block_q=8, block_n=64,
                           interpret=True)
    ref = jax_rangescan_ref(jq, jx, jnp.float32(r), k=8)
    port = rangescan(torch.as_tensor(qs).bfloat16(),
                     torch.as_tensor(pts).bfloat16(), r, k=8)
    port = [t.numpy() for t in port]
    for want in (pallas, ref):
        _assert_same(port, [np.asarray(t) for t in want],
                     dict(rtol=2e-2, atol=2e-2))


def test_plain_rangescan_counts_exceed_k():
    """counts stay exact far above k; the k lowest ids are kept."""
    qs = np.zeros((4, 8), np.float32)
    pts = np.zeros((256, 8), np.float32)
    pallas, ref, port = _run_all(qs, pts, 1.0, 16, "l2", bq=4, bn=64)
    assert (port[2] == 256).all()
    np.testing.assert_array_equal(port[0], np.tile(np.arange(16), (4, 1)))
    _assert_same(port, ref)
    _assert_same(port, pallas)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_plain_rangescan_ties_go_to_the_lower_id(metric):
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((200, 16)).astype(np.float32)
    dup = [5, 60, 61, 150, 199]
    pts[dup] = pts[100]
    qs = np.concatenate([pts[100:101] + 0.05,
                         rng.standard_normal((3, 16)).astype(np.float32)])
    r = midpoint_radius(qs, pts, metric, 0.5)
    pallas, ref, port = _run_all(qs, pts, r, 64, metric)
    _assert_same(port, ref)
    _assert_same(port, pallas)
    row = list(port[0][0])
    pos = [row.index(i) for i in sorted(dup + [100]) if i in row]
    assert len(pos) == 6 and pos == sorted(pos)
    assert len({float(port[1][0, p]) for p in pos}) == 1


def test_plain_rangescan_nothing_in_range():
    rng = np.random.default_rng(4)
    qs = rng.standard_normal((5, 12)).astype(np.float32)
    pts = rng.standard_normal((90, 12)).astype(np.float32)
    pallas, ref, port = _run_all(qs, pts, -1.0, 16, "l2")
    assert (port[2] == 0).all() and (port[0] == INVALID_ID).all()
    assert np.isinf(port[1]).all()
    _assert_same(port, ref)
    _assert_same(port, pallas)


def test_rangescan_dispatch():
    rng = np.random.default_rng(5)
    qs = torch.as_tensor(rng.standard_normal((3, 8)).astype(np.float32))
    pts = torch.as_tensor(rng.standard_normal((50, 8)).astype(np.float32))
    got = rangescan(qs, pts, 10.0, k=8)
    for a, b in zip(got, rangescan_ref(qs, pts, 10.0, k=8)):
        assert torch.equal(a, b)
    got_np = rangescan(qs.numpy(), pts.numpy(), 10.0, k=8, device="cpu")
    for a, b in zip(got, got_np):
        assert torch.equal(a, b)
    # fewer points than k: still k columns, padded
    ids, dd, c = rangescan(qs, pts[:5], 1e9, k=8)
    assert ids.shape == (3, 8) and (ids[:, 5:] == INVALID_ID).all()
    assert torch.isinf(dd[:, 5:]).all() and (c == 5).all()


@pytest.mark.parametrize("q,n,bq", [(512, 1_000_000, 32), (1, 1_000_000, 8),
                                    (64, 1_000_000, 32), (3, 100, 8),
                                    (100_000, 7, 32), (1, 10**9, 8)])
def test_rangescan_splits_cover_n(q, n, bq):
    """The kernel's N split: whole tiles, at most 1024 splits, every point
    in exactly one split."""
    n_split, split_len = _splits(q, n, bq, 128, 132, 1024)
    assert split_len % 128 == 0 and 1 <= n_split <= 1024
    assert (n_split - 1) * split_len < n <= n_split * split_len


def test_compare_scans_excuses_only_rounding():
    """The card's check: a boundary member that one scan keeps and the
    other drops is excused; a wrong id is not."""
    rng = np.random.default_rng(6)
    qs = torch.as_tensor(rng.standard_normal((4, 16)).astype(np.float32))
    pts = torch.as_tensor(rng.standard_normal((300, 16)).astype(np.float32))
    dist = rangescan_dists(qs, pts, "ip")
    r = float(torch.sort(dist[0]).values[10])          # a pair exactly at r
    want = rangescan_ref(qs, pts, r, k=32, metric="ip")
    assert compare_scans(want, want, dist, r, 1e-5) == (0, 0, 0.0)
    shifted = rangescan_ref(qs, pts, r - 1e-6, k=32, metric="ip")
    excused, unexcused, _ = compare_scans(shifted, want, dist, r, 1e-5)
    assert excused >= 1 and unexcused == 0
    bad = [t.clone() for t in want]
    bad[0][1, 0] = (int(bad[0][1, 0]) + 1) % 300
    assert compare_scans(bad, want, dist, r, 1e-5)[1] >= 1


# ---------------------------------------------------------------------------
# The wgmma route's 3xTF32 scheme (ref.py's emulation) and the route plan
# ---------------------------------------------------------------------------

def _f32_specials(rng, n=20_000):
    """Random f32 over the whole exponent range, with 0, -0, negatives,
    subnormals, the largest finite value and values at rounding ties."""
    mant = rng.integers(0, 1 << 23, n, dtype=np.int64)
    expo = rng.integers(0, 255, n, dtype=np.int64)          # 0: subnormals
    sign = rng.integers(0, 2, n, dtype=np.int64)
    bits = (sign << 31) | (expo << 23) | mant
    ties = (np.int64(127) << 23) | (rng.integers(0, 1 << 10, 64) << 13) | 0x1000
    extra = np.array([0x00000000, 0x80000000, 0x00000001, 0x807FFFFF, 0x7F7FFFFF,
                      0x3F800000, 0xBF800000], dtype=np.int64)
    bits = np.concatenate([bits, ties, ties | (1 << 13), extra]).astype(np.uint32)
    return torch.as_tensor(bits.view(np.float32).copy())


def test_split_tf32_hi_keeps_ten_mantissa_bits():
    x = _f32_specials(np.random.default_rng(10))
    hi, _ = split_tf32(x)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    # round to nearest: |x - hi| is at most half a unit of hi's last place
    fin = torch.isfinite(hi) & (x.abs() < 3e38)
    # a unit in hi's last place: 2^(e - 11) for x = m 2^e, m in [0.5, 1), and
    # 2^-136 among the subnormals
    ulp = torch.ldexp(torch.ones_like(x).double(), (torch.frexp(x)[1] - 11).clamp(min=-136))
    assert ((x.double() - hi.double()).abs()[fin] <= ulp[fin] / 2).all()


def test_split_tf32_halves_sum_to_the_value_exactly():
    x = _f32_specials(np.random.default_rng(11))
    x = x[torch.isfinite(tf32_rn(x))]      # the largest values round to inf
    hi, lo = split_tf32(x)
    assert torch.equal(hi + lo, x)
    assert torch.equal(hi.double() + lo.double(), x.double())
    sub = x[(x != 0) & (x.abs() < 1.1754944e-38)]
    assert sub.numel() > 10 and torch.equal(sum(split_tf32(sub)), sub)


def test_split_tf32_lo_is_zero_on_bf16_and_small_integers():
    rng = np.random.default_rng(12)
    bf = torch.as_tensor(rng.standard_normal(10_000) * 10.0 ** rng.integers(-30, 30, 10_000),
                         dtype=torch.float32).bfloat16().float()
    ints = torch.arange(-2048, 2049, dtype=torch.float32)
    for v in (bf, ints):
        hi, lo = split_tf32(v)
        assert torch.equal(hi, v) and (lo == 0).all()


@pytest.mark.parametrize("q,n,d", [(7, 300, 17), (16, 1000, 256), (1, 5000, 128)])
def test_dots_3xtf32_exact_on_integer_rigs(q, n, d):
    g = torch.Generator().manual_seed(q + n + d)
    qs = torch.randint(-3, 4, (q, d), generator=g).float()
    pts = torch.randint(-3, 4, (n, d), generator=g).float()
    assert torch.equal(dots_3xtf32(qs, pts), qs @ pts.T)
    assert torch.equal(dots_3xtf32(qs, pts.bfloat16()), qs @ pts.T)


def test_dots_3xtf32_unit_vectors_within_2e6_of_f64():
    rng = np.random.default_rng(13)
    qs = rng.standard_normal((64, 256))
    pts = rng.standard_normal((4000, 256))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    want = qs.astype(np.float32).astype(np.float64) @ pts.astype(np.float32).astype(np.float64).T
    got = dots_3xtf32(torch.as_tensor(qs, dtype=torch.float32),
                      torch.as_tensor(pts, dtype=torch.float32)).double().numpy()
    err = np.abs(got - want).max()
    assert err <= 2e-6, err
    # plain TF32 errs a thousand times more: the reason for the split
    plain = (tf32_rn(torch.as_tensor(qs, dtype=torch.float32)).double()
             @ tf32_rn(torch.as_tensor(pts, dtype=torch.float32)).double().T).numpy()
    assert np.abs(plain - want).max() > 100 * err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [17, 33, 128, 256])
@pytest.mark.parametrize("q", [1, 7, 8, 9, 64, 257, 512])
def test_rangescan_plan_covers_every_pair_once(q, d, dtype):
    """The kernel's blocks: every (query, point) pair in exactly one (query
    tile, N split) block; the route by the rows' bytes alone."""
    for n in (1, 127, 3001, 1_000_003):
        p = plan(q, n, d, dtype)
        wgmma = d * (4 if dtype == torch.float32 else 2) % 16 == 0
        assert tma_rows(d, dtype) == wgmma
        assert p.route == ("wgmma" if wgmma else "simt")
        assert plan(q, n, d, dtype, aligned=False).route == "simt"
        if wgmma:
            # the smallest tile that holds the queries, up to 256; above 256,
            # 128 where it leaves fewer empty slots (257: 384 against 512)
            want = min(b for b in WGMMA_BLOCK_Q if b >= min(q, 256))
            if q > 256 and -(-q // 128) * 128 < -(-q // 256) * 256:
                want = 128
            assert p.block_q == want and p.block_q % 8 == 0
        else:
            assert p.block_q == (8 if q <= 8 else 32)
        assert p.q_tiles == -(-q // p.block_q) and (p.q_tiles - 1) * p.block_q < q
        assert p.split_len % TILE == 0 and 1 <= p.n_split <= MAX_SPLITS
        assert (p.n_split - 1) * p.split_len < n <= p.n_split * p.split_len
        # every pair once: the blocks' ranges tile [0, Q) x [0, N)
        cover_q = np.zeros(q, np.int64)
        for i in range(p.q_tiles):
            cover_q[i * p.block_q:(i + 1) * p.block_q] += 1
        cover_n = np.zeros(n, np.int64)
        for j in range(p.n_split):
            cover_n[j * p.split_len:(j + 1) * p.split_len] += 1
        assert (cover_q == 1).all() and (cover_n == 1).all()
