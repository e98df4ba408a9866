"""The plain reference: brute-force range search over the benchmark's own
corpus, in float64, and the control that stands in for the program.

It imports no part of the program and takes nothing the program made: it
reads the corpus and queries the benchmark drew (drawn again from the
seed), and the program's answers only to judge them.

- ``true_counts``: |K|, the exact number of corpus points within each
  query's radius (squared l2, or negative inner product, <= r).
- ``pair_dists``: the exact distance of each reported (query, id) pair.
- ``control``: the reference's own answers in the precision just below
  the configuration's, put where the program's answers go, so that the
  comparison can be shown to fail it: TF32 products for a float32
  configuration, int4 rows for an int8 one.
"""
from __future__ import annotations

import contextlib

import torch

ROW_BLOCK = 131_072     # corpus rows a product block
QUERY_BLOCK = 2_048     # queries a product block
PAIR_LANES = 256        # lanes a block of pair distances


def _dists64(q64: torch.Tensor, x64: torch.Tensor, x2: torch.Tensor, metric: str):
    dots = q64 @ x64.T
    if metric == "ip":
        return -dots
    return torch.sum(q64 * q64, dim=1, keepdim=True) + x2[None, :] - 2.0 * dots


def true_counts(points: torch.Tensor, queries: torch.Tensor, radii: torch.Tensor,
                metric: str) -> torch.Tensor:
    """(Q,) int64 exact match counts, in float64 (the expansion's rounding
    is ~1e-16 of the norms: far below any gap the comparison reads)."""
    out = torch.zeros(queries.shape[0], dtype=torch.int64, device=points.device)
    r64 = radii.double()
    for s in range(0, points.shape[0], ROW_BLOCK):
        x = points[s:s + ROW_BLOCK].double()
        x2 = torch.sum(x * x, dim=1)
        for q0 in range(0, queries.shape[0], QUERY_BLOCK):
            q = queries[q0:q0 + QUERY_BLOCK].double()
            d = _dists64(q, x, x2, metric)
            out[q0:q0 + QUERY_BLOCK] += torch.sum(d <= r64[q0:q0 + QUERY_BLOCK, None], dim=1)
    return out


def pair_dists(points: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor,
               valid: torch.Tensor, metric: str) -> torch.Tensor:
    """(Q, K) float64 exact distances of the pairs (q, ids[q, k]) where
    ``valid``, +inf elsewhere; each pair as a difference (l2) or a dot
    product (ip) of float64 rows."""
    out = torch.full(ids.shape, torch.inf, dtype=torch.float64, device=ids.device)
    n = points.shape[0]
    for s in range(0, ids.shape[0], PAIR_LANES):
        idx = torch.where(valid[s:s + PAIR_LANES], ids[s:s + PAIR_LANES], 0)
        idx = idx.long().clamp_(0, n - 1)
        rows = points[idx].double()                      # (L, K, d)
        q = queries[s:s + PAIR_LANES].double()[:, None, :]
        d = (-(rows * q).sum(-1) if metric == "ip" else ((rows - q) ** 2).sum(-1))
        out[s:s + PAIR_LANES] = torch.where(valid[s:s + PAIR_LANES], d, torch.inf)
    return out


# -- the control ------------------------------------------------------------

def _int4_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row quantized to int4 (symmetric, per-row absmax scale over
    [-7, 7]) and back: the rows one precision below int8 codes."""
    scale = x.abs().amax(dim=1, keepdim=True).clamp_min(1e-30) / 7.0
    return torch.round(x / scale).clamp_(-7, 7) * scale


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Each f32 value rounded to TF32 (10 explicit mantissa bits, to
    nearest), as the tensor cores round a TF32 product's inputs; done by
    hand, so the control reads the same on any device."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _exact_f32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# the control of each corpus dtype: the step just below the precision it stores
CONTROLS = {"float32": "tf32", "int8": "int4"}


def control_of(corpus_dtype: str) -> str:
    if corpus_dtype not in CONTROLS:
        raise ValueError(f"no control for corpus dtype {corpus_dtype!r}; known: {list(CONTROLS)}")
    return CONTROLS[corpus_dtype]


def control(kind: str, points: torch.Tensor, queries: torch.Tensor,
            radii: torch.Tensor, cap: int, metric: str):
    """Brute-force range search in lower precision, in the program's
    result layout: ``(ids (Q, cap) int32, dists (Q, cap) f32, count (Q,))``,
    each lane's matches closest first, at most ``cap`` of them, padded with
    ids outside the corpus and +inf. ``kind`` ``"tf32"`` takes the products
    of TF32-rounded rows and queries, summed in f32, as TF32 tensor cores
    take them (the float32 configuration's step down); ``"int4"`` takes f32
    products of int4-quantized rows (the int8 configuration's)."""
    if kind not in CONTROLS.values():
        raise ValueError(f"unknown control {kind!r}; known: {list(CONTROLS.values())}")
    dev, qn = points.device, queries.shape[0]
    best_d = torch.full((qn, cap), torch.inf, device=dev)
    best_i = torch.full((qn, cap), -1, dtype=torch.int64, device=dev)
    low = _tf32_round if kind == "tf32" else _int4_rows
    with _exact_f32():
        for s in range(0, points.shape[0], ROW_BLOCK):
            x = low(points[s:s + ROW_BLOCK])
            x2 = torch.sum(x * x, dim=1)
            for q0 in range(0, qn, QUERY_BLOCK):
                q = queries[q0:q0 + QUERY_BLOCK]
                if kind == "tf32":
                    q = _tf32_round(q)
                dots = q @ x.T
                d = (-dots if metric == "ip"
                     else torch.sum(q * q, dim=1, keepdim=True) + x2[None, :] - 2.0 * dots)
                d = torch.where(d <= radii[q0:q0 + QUERY_BLOCK, None], d, torch.inf)
                cd = torch.cat([best_d[q0:q0 + QUERY_BLOCK], d], 1)
                ci = torch.cat([best_i[q0:q0 + QUERY_BLOCK],
                                torch.arange(s, s + x.shape[0], device=dev).expand(q.shape[0], -1)], 1)
                top_d, pos = torch.topk(cd, cap, dim=1, largest=False, sorted=True)
                best_d[q0:q0 + QUERY_BLOCK] = top_d
                best_i[q0:q0 + QUERY_BLOCK] = torch.gather(ci, 1, pos)
    found = torch.isfinite(best_d)
    count = found.sum(1).to(torch.int32)
    ids = torch.where(found, best_i, -1).to(torch.int32)
    return ids, best_d, count
