"""Per-point label sets and per-query label predicates (filtered retrieval).

Each corpus point carries a fixed ``(W,)`` row of packed label bits (one bit
per label id, 32 to a word), and each query carries a predicate over them:

* **AND** (``is_and=True``): the point carries every bit of the query's
  mask. A zero mask is vacuously true, so the all-pass predicate is AND
  over the empty mask (``all_pass_filter``).
* **OR** (``is_and=False``): the point carries some masked bit. A zero-mask
  OR matches nothing.

The predicate gates only the result stage of the range search
(``range_search.filter_labeled``, after the tombstone drop): a point that
fails it still routes the walk, so an all-pass predicate is bitwise equal
to no predicate. Both modes are evaluated for every lane and selected with
``where``, so one batch mixes AND, OR and unfiltered lanes.

Packing stays numpy on the host (``(N, W)`` uint32, as the reference's).
On the device the rows and masks are int32 tensors holding the same bits:
PyTorch's bitwise ops take no uint32 on every device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Union

import numpy as np
import torch

from ..utils import cdiv


def num_label_words(num_labels: int) -> int:
    """Packed 32-bit words a label row (at least 1)."""
    if num_labels < 1:
        raise ValueError("num_labels must be >= 1")
    return cdiv(num_labels, 32)


def pack_labels(labels: Union[Sequence[Iterable[int]], np.ndarray],
                num_labels: int) -> np.ndarray:
    """Pack per-point label sets into ``(N, W)`` uint32 rows. ``labels`` is
    a sequence of per-point label-id iterables or an ``(N, num_labels)``
    boolean membership matrix; ids lie in ``[0, num_labels)``."""
    w = num_label_words(num_labels)
    if isinstance(labels, np.ndarray) and labels.dtype != object and labels.ndim == 2:
        if labels.shape[1] != num_labels:
            raise ValueError(f"membership matrix has {labels.shape[1]} columns, "
                             f"expected {num_labels}")
        out = np.zeros((labels.shape[0], w), np.uint32)
        rows, ids = np.nonzero(labels)
        np.bitwise_or.at(out, (rows, ids // 32),
                         np.uint32(1) << (ids % 32).astype(np.uint32))
        return out
    out = np.zeros((len(labels), w), np.uint32)
    for i, row in enumerate(labels):
        for lid in row:
            lid = int(lid)
            if not 0 <= lid < num_labels:
                raise ValueError(f"label id {lid} outside [0, {num_labels})")
            out[i, lid // 32] |= np.uint32(1) << np.uint32(lid % 32)
    return out


def make_mask(label_ids: Iterable[int], num_labels: int) -> np.ndarray:
    """One predicate's ``(W,)`` uint32 bit mask."""
    return pack_labels([list(label_ids)], num_labels)[0]


def as_label_rows(labels, device=None) -> torch.Tensor:
    """Packed label rows (uint32 numpy or an int32 tensor) as an int32
    tensor holding the same bits, on ``device``."""
    if not isinstance(labels, torch.Tensor):
        arr = np.array(labels)
        if arr.dtype not in (np.uint32, np.int32):
            raise ValueError(f"label rows must be uint32 words, got {arr.dtype}")
        labels = torch.from_numpy(arr.view(np.int32))
    if labels.dtype != torch.int32:
        raise ValueError(f"label rows must be int32 words, got {labels.dtype}")
    return labels.to(device) if device is not None else labels


@dataclasses.dataclass
class LabelFilter:
    """Batched per-query predicate: ``masks`` (Q, W) int32 (the uint32
    bits), ``is_and`` (Q,) bool. The all-pass lane is AND over a zero
    mask."""

    masks: torch.Tensor   # (Q, W) int32
    is_and: torch.Tensor  # (Q,) bool

    def to(self, device) -> "LabelFilter":
        return LabelFilter(masks=self.masks.to(device), is_and=self.is_and.to(device))

    def select(self, lanes) -> "LabelFilter":
        """The predicates of the given lanes (an index tensor)."""
        return LabelFilter(masks=self.masks[lanes], is_and=self.is_and[lanes])


def all_pass_filter(n_queries: int, num_labels: int) -> LabelFilter:
    """The identity predicate for every lane (AND over an empty mask)."""
    w = num_label_words(num_labels)
    return LabelFilter(masks=torch.zeros((n_queries, w), dtype=torch.int32),
                       is_and=torch.ones((n_queries,), dtype=torch.bool))


def make_label_filter(label_ids: Sequence[Optional[Iterable[int]]],
                      num_labels: int,
                      modes: Union[str, Sequence[str]] = "and") -> LabelFilter:
    """A :class:`LabelFilter` from per-query label-id lists (host tensors;
    the engine moves them to its device). ``label_ids[i] = None`` (or an
    empty list under AND) makes lane i all-pass; ``modes`` is "and"/"or"
    for every lane or one a lane."""
    q = len(label_ids)
    if isinstance(modes, str):
        modes = [modes] * q
    if len(modes) != q:
        raise ValueError(f"{len(modes)} modes for {q} queries")
    masks = np.zeros((q, num_label_words(num_labels)), np.uint32)
    is_and = np.zeros((q,), bool)
    for i, (ids, mode) in enumerate(zip(label_ids, modes)):
        if mode not in ("and", "or"):
            raise ValueError(f"bad filter mode {mode!r}")
        if ids is None:
            is_and[i] = True
            continue
        masks[i] = make_mask(ids, num_labels)
        is_and[i] = mode == "and"
    return LabelFilter(masks=torch.from_numpy(masks.view(np.int32)),
                       is_and=torch.from_numpy(is_and))


def labels_match(rows: torch.Tensor, mask: torch.Tensor, is_and) -> torch.Tensor:
    """Branch-free predicate test: ``rows`` (..., W) packed label rows,
    ``mask`` a (W,) mask (or broadcastable), ``is_and`` the mode. Returns a
    (...,) bool."""
    hit = rows & mask
    and_ok = torch.all(hit == mask, dim=-1)
    or_ok = torch.any(hit != 0, dim=-1)
    return torch.where(torch.as_tensor(is_and, device=rows.device), and_ok, or_ok)


# predicates evaluated at once against the corpus: (lanes, N) bools of at
# most this many entries
_MATCH_BLOCK = 1 << 26


def _match_blocks(labels, filt: LabelFilter):
    """The (lanes, N) match blocks of ``filt``'s lanes, in order."""
    labels = as_label_rows(labels)
    filt = filt.to(labels.device)
    step = max(1, _MATCH_BLOCK // max(1, labels.shape[0]))
    for a in range(0, filt.masks.shape[0], step):
        yield labels_match(labels[None], filt.masks[a:a + step, None, :],
                           filt.is_and[a:a + step, None])


def label_match_matrix(labels, filt: LabelFilter) -> torch.Tensor:
    """Dense ``(Q, N)`` predicate-satisfaction matrix."""
    return torch.cat(list(_match_blocks(labels, filt)))


def label_match_counts(labels, filt: LabelFilter) -> torch.Tensor:
    """Per-lane posting-list sizes (Q,) int32: how many points satisfy each
    lane's predicate (the selectivity the compacted path dispatches on),
    without holding the whole (Q, N) matrix."""
    return torch.cat([torch.sum(m, dim=1, dtype=torch.int32)
                      for m in _match_blocks(labels, filt)])
