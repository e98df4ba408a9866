"""The paper's radius rule (Sec. 3), as the port's ``core/radius.py``
(``sweep``, ``select_radius``) and ``chip_smoke.py::radius_and_oracle``
apply it: sweep a geometric grid of radii over the corpus with a sample of
queries, and pick the radius whose zero-result fraction is closest to the
target, penalised by the slope of the capture curve in log space.

The radius is a property of the deployment, not of one run: the grid is
fixed in the configuration (``radius_rule.grid``: ``lo``, ``hi``, ``num``,
from ``core/radius.py::default_grid``'s quantiles on the distribution,
extended three decades down as ``chip_smoke.py`` does), and the rule runs
over the draw of the distribution's own seed with a fixed sample of
queries (``corpus.calibration_queries``), so every seed gets the same r
(``cell.deployment_radius``). The target stays
``chip_smoke.py``'s 0.5: at the paper's 0.95 almost no lane saturates its
beam on these corpora, and greedy phase 2 would barely run.
"""
from __future__ import annotations

import numpy as np
import torch


def grid(rule: dict) -> np.ndarray:
    g = rule["grid"]
    space = np.linspace if g.get("spacing") == "linear" else np.geomspace
    return space(g["lo"], g["hi"], g["num"]).astype(np.float32)


def counts_at(points: torch.Tensor, queries: torch.Tensor, radii: np.ndarray,
              metric: str, block: int = 131_072) -> np.ndarray:
    """(Q, G) exact-in-f32 match counts of each query at each radius."""
    dev = points.device
    r = torch.as_tensor(radii, device=dev)
    qn = queries.shape[0]
    hist = torch.zeros((qn, len(radii) + 1), dtype=torch.int64, device=dev)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        q2 = torch.sum(queries * queries, dim=1, keepdim=True)
        for s in range(0, points.shape[0], block):
            x = points[s:s + block]
            dots = queries @ x.T
            if metric == "ip":
                d = -dots
            else:
                d = torch.clamp(q2 + torch.sum(x * x, dim=1)[None, :] - 2.0 * dots, min=0.0)
            # the first grid radius >= d: d counts at that radius and above
            idx = torch.searchsorted(r, d.contiguous())
            hist.scatter_add_(1, idx, torch.ones_like(idx))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.cumsum(hist, dim=1)[:, :-1].cpu().numpy()


def select(counts: np.ndarray, radii: np.ndarray, n: int,
           target_zero_frac: float, robustness_weight: float = 1.0) -> tuple[float, int, float]:
    """``select_radius`` over a sweep: returns (radius, grid index, the
    zero-result fraction there). Raises when every radius answers every
    query with nothing."""
    captured = counts.mean(axis=0) / n
    zero_frac = (counts == 0).mean(axis=0)
    lg = np.log10(np.maximum(captured, 1e-12))
    slope = np.abs(np.gradient(lg)) if lg.size >= 2 else np.zeros_like(lg)
    score = np.abs(zero_frac - target_zero_frac) + robustness_weight * slope
    feasible = zero_frac < 1.0
    if not feasible.any():
        raise ValueError("no feasible radius in the grid: every radius answers "
                         "every sampled query with nothing")
    gi = int(np.argmin(np.where(feasible, score, np.inf)))
    return float(radii[gi]), gi, float(zero_frac[gi])


def choose(points: torch.Tensor, sample: torch.Tensor, rule: dict, metric: str):
    """The configuration's radius over this run's corpus: (r, grid index,
    zero-result fraction)."""
    radii = grid(rule)
    counts = counts_at(points, sample, radii, metric)
    return select(counts, radii, points.shape[0], rule["target_zero_frac"])
