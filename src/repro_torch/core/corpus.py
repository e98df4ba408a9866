"""Quantized corpus storage for the range engine (the two-pass pipeline).

Gathering corpus rows is the search loop's dominant memory term. An int8
corpus gathers ``d`` bytes of codes and a 12-byte metadata row per
candidate instead of ``4 d`` bytes, and every in-loop range test runs on a
*certified lower bound* of the true distance. Range retrieval makes that
safe: the decision is a threshold test against ``r``, so only the band of
candidates whose bounds straddle ``r`` needs the exact f32 rows, and the
result stage (``range_search``) reranks just that band.

Scheme — per-row symmetric absmax quantization (``dist.compression``):

    codes[i] = round(x[i] / scales[i]),  scales[i] = max|x[i]| / 127
    x_hat[i] = codes[i] * scales[i]
    err[i]   = ||x[i] - x_hat[i]||_2   (exact, computed at quantize time)

Bounds, with ``err_q`` the query-side quantization error of whichever form
computed ``d_hat`` (0 when the query stays f32; the int8-query kernels
quantize the query and charge their own exact error):

* l2 (squared, like the radii): ``g = err + err_q``,
  ``d_lb = max(sqrt(d_hat) - g, 0)^2``, ``d_ub = (sqrt(d_lb) + 2 G)^2``;
* ip (``d = -x.q``): ``eps = err ||q|| + ||x_hat|| err_q``,
  ``d_lb = d_hat - eps``, ``d_ub = d_lb + 2 Eps``.

The upper bound uses the envelope ``G = err + err_q(q)`` whichever form
produced the lower bound, so one rerank covers distances from either form
mixed in one search. ``d_lb <= d_true <= d_ub`` always: ``d_true <= r``
implies ``d_lb <= r`` (no false negatives in the walk), and after the
exact pass over ``d_ub > r`` no false positives remain.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..dist.compression import GUARD_SLACK as _SLACK, absmax_scale, quantize_int8_rows

CORPUS_DTYPES = ("float32", "bfloat16", "int8")

# metadata bytes gathered per int8 row: the (N, 3) f32 [scale, |x_hat|^2,
# err] row; every bytes-per-distance count uses this constant
META_BYTES = 12

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class QuantizedCorpus:
    """Int8 codes, per-row metadata and, optionally, the exact rows.

    ``meta`` packs ``[scale, |x_hat|^2, err]`` per row so a kernel reads
    one 12-byte row per candidate beside its codes. ``raw`` is what the
    rerank gathers; ``raw=None`` disables the rerank (the result is then
    the certified superset)."""

    codes: torch.Tensor            # (N, d) int8
    meta: torch.Tensor             # (N, 3) f32 [scale, |x_hat|^2, err]
    raw: Optional[torch.Tensor]    # (N, d) f32 exact rows, or None

    @property
    def shape(self):
        return self.codes.shape

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def scales(self) -> torch.Tensor:
        return self.meta[..., 0]

    @property
    def sqnorms(self) -> torch.Tensor:
        return self.meta[..., 1]

    @property
    def errs(self) -> torch.Tensor:
        return self.meta[..., 2]


# The third arm is ``tier.TieredCorpus`` (duck-typed via its ``is_tiered``
# marker rather than imported: core stays tier-free).
Corpus = Union[torch.Tensor, QuantizedCorpus, "TieredCorpus"]  # noqa: F821


def quantize_rows(vecs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize (B, d) rows -> (codes (B, d) int8, meta (B, 3) f32), with
    ``err`` the exact reconstruction error of each row."""
    vecs = vecs.float()
    codes, scales = quantize_int8_rows(vecs)
    deq = codes.float() * scales[:, None]
    sqnorms = torch.sum(deq * deq, dim=-1)
    err = torch.sqrt(torch.sum((vecs - deq) ** 2, dim=-1))
    return codes.contiguous(), torch.stack([scales, sqnorms, err], -1).contiguous()


def quantize_corpus(points: torch.Tensor, keep_raw: bool = True) -> QuantizedCorpus:
    """Per-row int8 quantization of an (N, d) corpus, on its device."""
    codes, meta = quantize_rows(points)
    return QuantizedCorpus(codes=codes, meta=meta,
                           raw=points.contiguous() if keep_raw else None)


def corpus_cast(points: torch.Tensor, corpus_dtype: str) -> Corpus:
    """An f32 corpus in its storage dtype (the ``corpus_dtype`` knob)."""
    if corpus_dtype not in CORPUS_DTYPES:
        raise ValueError(f"corpus_dtype {corpus_dtype!r} not in {CORPUS_DTYPES}")
    if corpus_dtype == "int8":
        return quantize_corpus(points.float())
    return points.to(_STORAGE[corpus_dtype]).contiguous()


def hot_arm(points):
    """What the search loop reads: a ``TieredCorpus``'s device arm (duck
    typed on its ``is_tiered`` marker; core never imports ``tier``), else
    the corpus itself."""
    return points.device if getattr(points, "is_tiered", False) else points


def corpus_dtype_name(points: Corpus) -> str:
    points = hot_arm(points)
    if isinstance(points, QuantizedCorpus):
        return "int8"
    return str(points.dtype).removeprefix("torch.")


def corpus_size(points: Corpus) -> int:
    return hot_arm(points).shape[0]


def corpus_dim(points: Corpus) -> int:
    return hot_arm(points).shape[-1]


def bytes_per_vector(points: Corpus) -> int:
    """Bytes the search loop gathers per distance."""
    points = hot_arm(points)
    if isinstance(points, QuantizedCorpus):
        return corpus_dim(points) + META_BYTES
    return corpus_dim(points) * points.element_size()


def corpus_raw(points: Corpus) -> torch.Tensor:
    """The exact rows of a corpus (a quantized one must carry them), what
    graph construction and mutation run on. A tiered corpus uploads its host
    store to the hot arm's device: a mutation cost, never a query cost."""
    if getattr(points, "is_tiered", False):
        return points.raw_array()
    if isinstance(points, QuantizedCorpus):
        if points.raw is None:
            raise ValueError("this QuantizedCorpus holds no raw rows; "
                             "quantize with keep_raw=True")
        return points.raw
    return points


def quantize_queries(q: torch.Tensor):
    """The int8-query form's query quantization, over the last axis:
    ``(codes (..., d) f32-valued in [-127, 127], scale (...,), err (...,),
    |q_hat|^2 (...,))``; ``err`` is the exact ``||q - q_hat||``."""
    qf = q.float()
    scale = absmax_scale(torch.amax(torch.abs(qf), dim=-1))
    codes = torch.clamp(torch.round(qf / scale[..., None]), -127, 127)
    q_hat = codes * scale[..., None]
    err = torch.sqrt(torch.sum((qf - q_hat) ** 2, dim=-1))
    return codes, scale, err, torch.sum(q_hat * q_hat, dim=-1)


def query_quant_err(q: torch.Tensor) -> torch.Tensor:
    """Exact query-side quantization error ``||q - q_hat||`` of the
    int8-query form, over the last axis. The upper bound charges it
    whichever form computed the lower bound."""
    return quantize_queries(q)[2]


def lower_bound_dists(meta: torch.Tensor, d_hat: torch.Tensor,
                      err_q, q_norm, metric: str) -> torch.Tensor:
    """Certified lower bound of the true distance from the approximate one;
    ``meta`` is the candidates' (..., 3) rows, ``err_q``/``q_norm``
    broadcast against ``d_hat``."""
    if metric == "l2":
        g = (meta[..., 2] + err_q) * (1.0 + _SLACK)
        return torch.clamp(torch.sqrt(torch.clamp(d_hat, min=0.0)) - g, min=0.0) ** 2
    eps = (meta[..., 2] * q_norm
           + torch.sqrt(torch.clamp(meta[..., 1], min=0.0)) * err_q) * (1.0 + _SLACK)
    return d_hat - eps


def quantized_gather_lb(corpus: QuantizedCorpus, safe_ids: torch.Tensor,
                        q: torch.Tensor, metric: str) -> torch.Tensor:
    """The f32-query form: gather int8 rows, dequantize, take the distance
    to the f32 query and lower it to the certified bound (``err_q = 0``).
    ``safe_ids`` (..., R) are pre-clamped to [0, N); ``q`` is (..., d)."""
    ids = safe_ids.long()
    meta = corpus.meta[ids]                               # (..., R, 3)
    vecs = corpus.codes[ids].float() * meta[..., 0:1]     # (..., R, d)
    qf = q.float()
    if metric == "l2":
        diff = vecs - qf[..., None, :]
        d = torch.sum(diff * diff, dim=-1)
    else:
        d = -torch.sum(vecs * qf[..., None, :], dim=-1)
    q_norm = torch.sqrt(torch.sum(qf * qf, dim=-1))[..., None]
    return lower_bound_dists(meta, d, 0.0, q_norm, metric)


def quantized_query_lb(corpus: QuantizedCorpus, safe_ids: torch.Tensor,
                       q: torch.Tensor, metric: str):
    """The int8-query form, the int8 kernels' arithmetic: quantize the query
    by absmax, take the exact int8 dot (an int32 elementwise product and
    sum, never an int8 matmul), dequantize it by ``scale_row * scale_q``
    (l2 in the norm form) and lower it by the row's error plus the query's
    own exact ``err_q``. Same arguments as ``quantized_gather_lb``; returns
    ``(bounds (..., R), dots (..., R) int32)``."""
    ids = safe_ids.long()
    meta = corpus.meta[ids]                               # (..., R, 3)
    codes_q, scale_q, err_q, sq_hat = quantize_queries(q)
    idot = torch.sum(corpus.codes[ids].to(torch.int32)
                     * codes_q.to(torch.int32)[..., None, :],
                     dim=-1, dtype=torch.int32)
    dots = idot.float() * (meta[..., 0] * scale_q[..., None])
    if metric == "l2":
        d_hat = torch.clamp(meta[..., 1] + sq_hat[..., None] - 2.0 * dots, min=0.0)
    else:
        d_hat = -dots
    qf = q.float()
    q_norm = torch.sqrt(torch.sum(qf * qf, dim=-1))[..., None]
    return lower_bound_dists(meta, d_hat, err_q[..., None], q_norm, metric), idot


def upper_bound_dists(corpus: QuantizedCorpus, ids: torch.Tensor,
                      d_lb: torch.Tensor, q: torch.Tensor,
                      metric: str) -> torch.Tensor:
    """Certified upper bound recovered from a stored lower bound. ``ids``
    (..., K) are pre-clamped to [0, N), ``d_lb`` their lower bounds, ``q``
    (..., d) the query of each row of ids. ``d_ub <= r`` proves
    membership; valid even where the l2 bound clamped to zero."""
    meta = corpus.meta[ids.long()]                        # (..., K, 3)
    err_q = query_quant_err(q)[..., None]
    if metric == "l2":
        g = (meta[..., 2] + err_q) * (1.0 + _SLACK)
        return (torch.sqrt(torch.clamp(d_lb, min=0.0)) + 2.0 * g) ** 2
    qf = q.float()
    q_norm = torch.sqrt(torch.sum(qf * qf, dim=-1))[..., None]
    eps = (meta[..., 2] * q_norm
           + torch.sqrt(torch.clamp(meta[..., 1], min=0.0)) * err_q) * (1.0 + _SLACK)
    return d_lb + 2.0 * eps


# -- live-index row mutation helpers ------------------------------------------
#
# The live index (``repro_torch.live``) pre-allocates the corpus at a fixed
# capacity and fills rows behind a watermark; these helpers are the only
# code that writes corpus rows after construction. Each returns new tensors
# and writes nothing in place into a tensor it was given: a published
# ``LiveSnapshot`` may still hold that tensor.

def corpus_with_capacity(points: Corpus, capacity: int, far: float = 1e30) -> Corpus:
    """``points`` grown to ``capacity`` rows with unreachable sentinel rows
    (no graph edge ever points at them, and their ``far`` coordinates rank
    last under l2)."""
    n = corpus_size(points)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < corpus size {n}")
    if capacity == n:
        return points
    if isinstance(points, QuantizedCorpus):
        return pad_corpus_rows(points, capacity - n, far)
    pad = torch.full((capacity - n, points.shape[-1]), far, dtype=points.dtype,
                     device=points.device)
    return torch.cat([points, pad])


def _set(rows: torch.Tensor, slots: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    out = rows.clone()
    out[slots] = vals.to(rows.dtype)
    return out


def corpus_set_rows(points: Corpus, slots: torch.Tensor, vecs: torch.Tensor,
                    active: torch.Tensor) -> Corpus:
    """A copy of ``points`` with ``vecs`` (B, d) f32 written into rows
    ``slots`` (B,) where ``active``; inactive lanes are dropped. A quantized
    corpus quantizes the rows on the way in, each with its own exact
    ``err``, so the certified guard band keeps holding under inserts. The
    active slots must be distinct."""
    dev = hot_arm(points).device
    keep = torch.as_tensor(active, device=dev).bool()
    slots = torch.as_tensor(slots, device=dev)[keep].long()
    vecs = torch.as_tensor(vecs, device=dev)[keep].float()
    if isinstance(points, QuantizedCorpus):
        codes, meta = quantize_rows(vecs)
        return QuantizedCorpus(
            codes=_set(points.codes, slots, codes), meta=_set(points.meta, slots, meta),
            raw=None if points.raw is None else _set(points.raw, slots, vecs))
    return _set(points, slots, vecs)


def corpus_take_rows(points: Corpus, idx: torch.Tensor) -> Corpus:
    """Rows ``idx`` of a corpus, in order (consolidation's compaction)."""
    if isinstance(points, QuantizedCorpus):
        idx = idx.to(points.device).long()
        return QuantizedCorpus(
            codes=points.codes.index_select(0, idx), meta=points.meta.index_select(0, idx),
            raw=None if points.raw is None else points.raw.index_select(0, idx))
    return points.index_select(0, idx.to(points.device).long())


def pad_corpus_rows(corpus: QuantizedCorpus, n_pad: int, far: float) -> QuantizedCorpus:
    """Append ``n_pad`` sentinel rows: zero codes, metadata ``[0, far, 0]``
    (a ``far`` raw value would register a huge error and put the row inside
    every rerank band; the ``far`` stored norm keeps the norm-form distance
    large) and ``far`` raw rows."""
    if n_pad <= 0:
        return corpus
    n, d = corpus.codes.shape
    dev = corpus.device
    meta = torch.tensor([0.0, far, 0.0], dtype=torch.float32, device=dev).expand(n_pad, 3)
    return QuantizedCorpus(
        codes=torch.cat([corpus.codes, torch.zeros((n_pad, d), dtype=torch.int8, device=dev)]),
        meta=torch.cat([corpus.meta, meta]),
        raw=None if corpus.raw is None else torch.cat(
            [corpus.raw, torch.full((n_pad, d), far, dtype=corpus.raw.dtype, device=dev)]))
