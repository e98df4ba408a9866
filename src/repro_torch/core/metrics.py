"""Accuracy metrics: average precision (paper Def. 2.2) and recall@k."""
from __future__ import annotations

import numpy as np

from ..utils import INVALID_ID


def _valid_rows(ids: np.ndarray, counts: np.ndarray) -> list[np.ndarray]:
    out = []
    for row, c in zip(ids, counts):
        row = row[: int(c)]
        out.append(row[row != INVALID_ID])
    return out


def average_precision(
    gt_ids: np.ndarray, gt_counts: np.ndarray,
    res_ids: np.ndarray, res_counts: np.ndarray,
) -> float:
    """sum_q |K ∩ K'| / sum_q |K|  (size-weighted, per the paper).

    ``gt_counts`` may exceed the ground-truth cap (``gt_ids`` row length); the
    denominator uses the true counts, so a capped GT understates nothing.
    """
    gt_ids = np.asarray(gt_ids)
    res_ids = np.asarray(res_ids)
    gt_counts = np.asarray(gt_counts)
    res_counts = np.asarray(res_counts)
    denom = int(gt_counts.sum())
    if denom == 0:
        return 1.0
    num = 0
    for g, res in zip(_valid_rows(gt_ids, np.minimum(gt_counts, gt_ids.shape[1])),
                      _valid_rows(res_ids, res_counts)):
        if len(g) == 0 or len(res) == 0:
            continue
        num += len(np.intersect1d(g, res, assume_unique=False))
    return num / denom


def recall_at_k(
    gt_ids: np.ndarray,   # (Q, k) exact top-k
    res_ids: np.ndarray,  # (Q, >=k) returned
    k: int,
) -> float:
    """Standard k@k recall for the top-k comparison experiment (Sec. 5)."""
    gt_ids = np.asarray(gt_ids)[:, :k]
    res_ids = np.asarray(res_ids)[:, :k]
    hits = 0
    for g, res in zip(gt_ids, res_ids):
        g = g[g != INVALID_ID]
        res = res[res != INVALID_ID]
        hits += len(np.intersect1d(g, res))
    return hits / max(1, gt_ids.shape[0] * k)


def zero_result_accuracy(gt_counts: np.ndarray, res_counts: np.ndarray) -> float:
    """Fraction of zero-result queries correctly answered with zero results."""
    gt_counts = np.asarray(gt_counts)
    res_counts = np.asarray(res_counts)
    mask = gt_counts == 0
    if mask.sum() == 0:
        return 1.0
    return float((res_counts[mask] == 0).mean())
