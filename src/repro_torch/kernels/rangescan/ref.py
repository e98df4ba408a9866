"""Plain-PyTorch version of the rangescan kernel."""
from __future__ import annotations

import torch

from ...utils import INVALID_ID


def rangescan_dists(queries, points, metric: str = "l2") -> torch.Tensor:
    """(Q, N) f32 distances in the reference's expression order: the norm
    form ``max(|q|^2 + |x|^2 - 2 q.x, 0)`` for l2, ``-q.x`` for ip; one
    product in full f32 (TF32 is switched off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q = queries.float()
    x = points.float()
    dots = q @ x.T
    if metric == "l2":
        qn = torch.sum(q * q, dim=1, keepdim=True)
        xn = torch.sum(x * x, dim=1, keepdim=True)
        return torch.clamp(qn + xn.T - 2.0 * dots, min=0.0)
    if metric != "ip":
        raise ValueError(f"unknown metric {metric!r}")
    return -dots


def tf32_rn(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits, to nearest, ties to
    even; the low 13 bits zero), as the kernel's wgmma route rounds them
    (``cvt.rn.tf32.f32``), by integer arithmetic on the bits."""
    b = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    return torch.where(b >= 1 << 31, b - (1 << 32), b).to(torch.int32).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32_rn(x) and lo = x - hi, exact in f32 (hi + lo
    == x); the products read tf32_rn(lo)."""
    hi = tf32_rn(x)
    return hi, x.float() - hi


def dots_3xtf32(queries, points) -> torch.Tensor:
    """(Q, N) dot products as the wgmma route forms them (3xTF32): each
    operand split into TF32 halves, lo.hi + hi.lo summed first, then hi.hi,
    in f32; lo.lo is dropped. Every TF32 product is exact in f32, so this
    pins the scheme's error on the CPU (the tensor cores' own order of
    summation is not modelled); the plain version ``rangescan_dists`` keeps
    the full-f32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    qh, ql = split_tf32(queries)
    xh, xl = split_tf32(points)
    ql, xl = tf32_rn(ql), tf32_rn(xl)
    return (ql @ xh.T + qh @ xl.T) + qh @ xh.T


def rangescan_ref(queries, points, r, *, k: int = 128, metric: str = "l2"):
    """(ids (Q, k), dists (Q, k), counts (Q,)): exact and unblocked. counts
    are the points with dist <= r; ids/dists the k in-range points with the
    smallest (dist, id), ascending (the reference's stable sort), ids
    INVALID-padded and dists +inf-padded; a non-finite kept distance gives
    INVALID. Unlike the JAX plain version, which keeps min(k, N) columns,
    the result always has k columns, as the kernels'."""
    from ...core.beam_search import _f32_ascending_key
    dist = rangescan_dists(queries, points, metric)
    ok = dist <= torch.as_tensor(r, dtype=torch.float32, device=dist.device)
    counts = torch.sum(ok, dim=1, dtype=torch.int32)
    masked = torch.where(ok, dist, torch.inf)
    qn, n = masked.shape
    kk = min(k, n)
    # (dist, id) as one int64 key; -0.0 + 0.0 folds -0 onto +0, which the
    # stable sort treats as equal
    col = torch.arange(n, dtype=torch.int64, device=dist.device)
    key = ((_f32_ascending_key(masked + 0.0) - 0x80000000) << 32) | col
    idx = torch.topk(key, kk, dim=1, largest=False, sorted=True).values & 0xFFFFFFFF
    d_sorted = torch.gather(masked, 1, idx)
    ids = torch.where(torch.isfinite(d_sorted), idx.to(torch.int32), INVALID_ID)
    if kk < k:
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=INVALID_ID)
        d_sorted = torch.nn.functional.pad(d_sorted, (0, k - kk), value=float("inf"))
    return ids, d_sorted, counts


def compare_scans(got, want, dist, r, tol: float):
    """Hold one scan's (ids, dists, counts) against another's where the two
    sum their dot products in different orders, so a pair whose distance
    lies within ``tol`` of r may fall either way, and two members whose
    distances lie within ``tol`` may swap ranks. ``dist`` is the (Q, N)
    plain distance matrix (``rangescan_dists``) on which ``want`` was
    decided; the check runs on its device. Returns (excused, unexcused,
    max_abs_err): the count steps and slots that such rounding explains,
    those it does not, and the largest distance difference where both
    scans hold a member."""
    dev = dist.device
    ids, dd, cnt = (t.to(dev) for t in got)
    rids, rd, rc = (t.to(dev) for t in want)
    near_r = ((dist - r).abs() <= tol).sum(1)
    dc = (cnt - rc).abs()
    bad = dc > near_r
    unexcused, excused = int(bad.sum()), int(dc[~bad].sum())
    both = (ids != INVALID_ID) & (rids != INVALID_ID)
    diff = (dd - rd).abs()[both]
    err = float(diff.max()) if diff.numel() else 0.0
    unexcused += int((diff > tol).sum())
    # every member the scan returned lies in range on the plain distances
    lane, slot = torch.nonzero(ids != INVALID_ID, as_tuple=True)
    unexcused += int((dist[lane, ids[lane, slot].long()] > r + tol).sum())
    lane, slot = torch.nonzero(ids != rids, as_tuple=True)
    a, b = ids[lane, slot], rids[lane, slot]
    va, vb = a != INVALID_ID, b != INVALID_ID
    da = dist[lane, torch.where(va, a, 0).long()]
    db = dist[lane, torch.where(vb, b, 0).long()]
    ok = torch.where(va & vb,
                     (da - rd[lane, slot]).abs() <= 2 * tol,   # a near-tie swap
                     (torch.where(va, da, db) - r).abs() <= tol)  # at the boundary
    return excused + int(ok.sum()), unexcused + int((~ok).sum()), err
