"""Radius-selection methodology (paper Sec. 3).

Sweep a radius grid over a corpus and a query sample, compute the
percent-captured curve (Fig. 3) and the match-size distribution (Fig. 4),
score each radius's robustness (local slope of the capture curve in log
space) and select a radius hitting a target match profile.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .ground_truth import range_counts_at


@dataclasses.dataclass(frozen=True)
class RadiusProfile:
    radii: np.ndarray            # (G,) swept grid
    percent_captured: np.ndarray # (G,) mean fraction of DB inside the ball
    zero_frac: np.ndarray        # (G,) fraction of queries with 0 matches
    robustness: np.ndarray       # (G,) |d log10(captured) / step|, lower = more robust
    counts: np.ndarray           # (Q, G) per-query match counts


# Fig. 4 bucketing: 0, <=10, <=100, <=1e3, <=1e4, <=1e5, >1e5
FIG4_BUCKETS = (0, 10, 100, 1_000, 10_000, 100_000)


def match_histogram(counts) -> dict[str, int]:
    """Bucket per-query match counts like the paper's Fig. 4 table, plus a
    terminal ``>1e5`` bucket so the buckets always sum to the query count."""
    counts = np.asarray(counts)
    out = {"0": int((counts == 0).sum())}
    prev = 0
    for b in FIG4_BUCKETS[1:]:
        out[f"<=1e{int(np.log10(b))}"] = int(((counts > prev) & (counts <= b)).sum())
        prev = b
    out[f">1e{int(np.log10(FIG4_BUCKETS[-1]))}"] = int(
        (counts > FIG4_BUCKETS[-1]).sum())
    return out


def sweep(points, queries, radii, metric: str = "l2", block: int = 2048,
          device="cuda") -> RadiusProfile:
    radii = np.asarray(radii, np.float32)
    counts = range_counts_at(points, queries, radii, metric, block,
                             device=device).cpu().numpy()
    n = points.shape[0]
    captured = counts.mean(axis=0) / n
    zero_frac = (counts == 0).mean(axis=0)
    lg = np.log10(np.maximum(captured, 1e-12))
    # a single-radius grid has no slope: score it perfectly robust
    slope = np.abs(np.gradient(lg)) if lg.size >= 2 else np.zeros_like(lg)
    return RadiusProfile(radii=radii, percent_captured=captured,
                         zero_frac=zero_frac, robustness=slope, counts=counts)


def default_grid(points, queries, metric: str = "l2", num: int = 48) -> np.ndarray:
    """A grid spanning ~0% to ~100% capture, from a distance sample."""
    pts = _numpy(points)
    qs = _numpy(queries)
    sample = pts[np.random.default_rng(0).choice(pts.shape[0], size=min(2048, pts.shape[0]), replace=False)]
    if metric == "l2":
        d = ((qs[:, None, :] - sample[None, : min(512, sample.shape[0]), :]) ** 2).sum(-1)
    else:
        d = -(qs @ sample[: min(512, sample.shape[0])].T)
    lo, hi = np.quantile(d, 0.0005), np.quantile(d, 0.9995)
    if metric == "l2":
        lo = max(lo, 1e-9)
        return np.geomspace(lo, hi, num).astype(np.float32)
    return np.linspace(lo, hi, num).astype(np.float32)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def select_radius(profile: RadiusProfile, target_zero_frac: float = 0.95,
                  robustness_weight: float = 1.0) -> tuple[float, int]:
    """The radius whose zero-result fraction is closest to the target,
    penalized by capture-curve steepness. Returns (radius, grid_index);
    raises ``ValueError`` when every radius yields zero matches for every
    query."""
    score = np.abs(profile.zero_frac - target_zero_frac) + robustness_weight * profile.robustness
    feasible = profile.zero_frac < 1.0
    if not feasible.any():
        raise ValueError(
            "no feasible radius in the swept grid: every candidate yields "
            "zero matches for every query — widen the grid (default_grid) "
            "or check the corpus/query scales")
    score = np.where(feasible, score, np.inf)
    gi = int(np.argmin(score))
    return float(profile.radii[gi]), gi
