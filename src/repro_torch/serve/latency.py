"""Log-bucketed latency histograms for the serving layer.

Serving dashboards care about tail quantiles (p95/p99), and tails are
exactly what a running mean destroys. The standard production answer is a
fixed-bucket histogram: O(1) record, O(buckets) quantile, mergeable across
workers, and bounded memory no matter how many requests pass through.
Buckets are geometric (equal width in log-latency) so relative error is
uniform from 10us to 10s — the same shape Prometheus/HdrHistogram deploys
use. Exact percentiles over a retained sample window belong in benchmarks
(see ``benchmarks.run``); the server keeps only the histogram.
"""
from __future__ import annotations

import numpy as np


class LatencyHistogram:
    """Geometric-bucket latency histogram over ``[lo_s, hi_s]`` seconds.

    ``record`` is O(1) per sample; quantiles interpolate inside the owning
    bucket, so their relative error is bounded by the bucket ratio
    (~12% at the default 20 buckets/decade). Min/max/sum are tracked
    exactly alongside.
    """

    def __init__(self, lo_s: float = 1e-5, hi_s: float = 10.0,
                 buckets_per_decade: int = 20):
        if not (0 < lo_s < hi_s):
            raise ValueError("need 0 < lo_s < hi_s")
        decades = np.log10(hi_s / lo_s)
        n = int(np.ceil(decades * buckets_per_decade))
        # edges[i] .. edges[i+1] bounds bucket i; +2 catchall buckets for
        # samples below lo_s / above hi_s so nothing is ever dropped
        self.edges = lo_s * (hi_s / lo_s) ** (np.arange(n + 1) / n)
        self.counts = np.zeros(n + 2, np.int64)
        self.n = 0
        self.sum_s = 0.0
        self.min_s = float("inf")
        self.max_s = 0.0

    def record(self, seconds) -> None:
        s = np.atleast_1d(np.asarray(seconds, np.float64))
        if s.size == 0:
            return
        idx = np.searchsorted(self.edges, s, side="right")  # 0 => below lo
        np.add.at(self.counts, idx, 1)
        self.n += int(s.size)
        self.sum_s += float(s.sum())
        self.min_s = min(self.min_s, float(s.min()))
        self.max_s = max(self.max_s, float(s.max()))

    def percentile(self, p: float) -> float:
        """Approximate p-th percentile in seconds (nan when empty)."""
        if self.n == 0:
            return float("nan")
        rank = (p / 100.0) * self.n
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, max(rank, 1), side="left"))
        if b == 0:  # below-range catchall: bounded above by lo_s
            return float(min(self.edges[0], self.max_s))
        if b >= len(self.counts) - 1:  # above-range catchall
            return float(self.max_s)
        # linear interpolation inside bucket b (edges[b-1] .. edges[b])
        lo, hi = self.edges[b - 1], self.edges[b]
        prev = cum[b - 1]
        frac = (rank - prev) / max(self.counts[b], 1)
        val = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return float(min(max(val, self.min_s), self.max_s))

    def summary(self) -> dict:
        """The dashboard row: count/mean and the tail quantiles, in ms."""
        if self.n == 0:
            return dict(count=0, mean_ms=float("nan"), p50_ms=float("nan"),
                        p95_ms=float("nan"), p99_ms=float("nan"),
                        max_ms=float("nan"))
        return dict(
            count=self.n,
            mean_ms=1e3 * self.sum_s / self.n,
            p50_ms=1e3 * self.percentile(50),
            p95_ms=1e3 * self.percentile(95),
            p99_ms=1e3 * self.percentile(99),
            max_ms=1e3 * self.max_s,
        )
