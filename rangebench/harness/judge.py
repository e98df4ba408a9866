"""The comparison that decides ``correct``, and the answers' AP.

Every answer the window gave to a judged lane (a seeded sample of lanes
of every batch, the same lanes each time a batch comes round) is held
against the float64 reference (``reference.py``). The numbers, each with
the limit the cell's file gives it:

- ``bad_rows`` (limit 0): lanes whose layout is broken: a count outside
  [0, K], an id outside the corpus among the first ``count`` slots, a
  corpus id after them, an id twice in one lane, or a distance that is
  not finite among the first ``count``;
- ``range_excess``: the largest (exact distance - r) / |r| of a reported
  id: a reported answer that lies outside the query's radius;
- ``dist_over``: the largest (reported - exact) / |r|: a reported
  distance above the exact one;
- ``dist_under``: the largest (exact - reported) / |r|: a reported
  distance below the exact one. A float32 corpus reports exact
  distances, so both are held to rounding; an int8 corpus reports, for
  the points that are in range for sure, the walk's certified lower
  bound, which may lie below the exact distance by the codes'
  quantization error and never above it, and the exact distance for the
  guard band it reranked: its ``dist_under`` is held to that error;
- ``recall``, which may not fall below its limit: the mean, over every
  judged lane whose query has a match, of the share of its matches it
  returned (|K ∩ K'| / min(|K|, K), K the lane's result capacity), so a
  lost half of a batch, or a walk that stops where it starts, shows
  whatever the sizes of the lost answers.

Beside them, not compared: ``ap``, the paper's Def. 2.2, sum |K ∩ K'| /
sum |K| over every distinct query judged (a batch that came round more
than once counts once, from its first answer): the end-to-end metric.

The window keeps its answers off the device (``cell.py``): the first
answer of each pool batch in host memory, and for each later one a
``digest`` on the device; a later answer equal to the first is judged as
the first, ``times`` over, and one that differs is kept and judged on
its own.
"""
from __future__ import annotations

import dataclasses

import torch

from . import reference

NUMBERS = ("bad_rows", "range_excess", "dist_over", "dist_under", "recall")   # compared
AT_LEAST = ("recall",)      # the numbers whose limit is a floor


@dataclasses.dataclass
class Answer:
    index: int              # the pool batch it answers
    ids: torch.Tensor       # (S, K) int32
    dists: torch.Tensor     # (S, K) f32
    count: torch.Tensor     # (S,) int32
    times: int = 1          # how many times the window gave this very answer

    def to(self, device) -> "Answer":
        return dataclasses.replace(self, ids=self.ids.to(device), dists=self.dists.to(device),
                                   count=self.count.to(device))


@dataclasses.dataclass
class Truth:
    queries: torch.Tensor   # (S, d) f32, drawn again from the seed
    radii: torch.Tensor     # (S,) f32
    counts: torch.Tensor    # (S,) int64, |K| from the reference


@dataclasses.dataclass
class Verdict:
    readings: dict          # name -> number
    limits: dict            # name -> limit
    lanes: int              # lanes judged (every time they were answered)
    failed: int             # of those, lanes with a fault of their own
    distinct: int           # distinct queries in ``ap``

    @property
    def correct(self) -> bool:
        return self.lanes > 0 and all(ok for _, _, ok in self.table())

    def table(self):
        """(name, reading, within its limit) in NUMBERS' order."""
        out = []
        for name in NUMBERS:
            v, lim = self.readings[name], self.limits[name]
            ok = v >= lim if name in AT_LEAST else v <= lim
            out.append((name, v, ok))
        return out


def _lane_numbers(points, metric, ans: Answer, truth: Truth):
    n = points.shape[0]
    ids = ans.ids.long()
    k = ids.shape[1]
    count = ans.count.long()
    slot = torch.arange(k, device=ids.device)[None, :]
    pref = slot < count.clamp(0, k)[:, None]
    in_corpus = (ids >= 0) & (ids < n)
    valid = pref & in_corpus
    bad = ((count < 0) | (count > k) | (pref & ~in_corpus).any(1)
           | (~pref & in_corpus).any(1) | (pref & ~torch.isfinite(ans.dists)).any(1))
    # an id twice in one lane: distinct sentinels past the corpus elsewhere
    keyed = torch.sort(torch.where(valid, ids, n + slot), dim=1).values
    bad |= ((keyed[:, 1:] == keyed[:, :-1]) & (keyed[:, 1:] < n)).any(1)
    exact = reference.pair_dists(points, truth.queries, ans.ids, valid, metric)
    r = truth.radii.double()[:, None]
    scale = r.abs().clamp_min(1e-30)
    zero = torch.zeros((), dtype=torch.float64, device=ids.device)
    excess = torch.where(valid, torch.clamp((exact - r) / scale, min=0), zero).amax(1)
    gap = torch.where(valid, (ans.dists.double() - exact) / scale, zero)
    over = torch.clamp(gap, min=0).amax(1)
    under = torch.clamp(-gap, min=0).amax(1)
    hits = (valid & (exact <= r)).sum(1)
    want = torch.clamp(truth.counts, max=k)
    has = want > 0
    share = hits[has].double() / want[has].double()
    return bad, excess, over, under, hits, share


def judge(points: torch.Tensor, metric: str, answers: list, truths: dict,
          limits: dict) -> Verdict:
    """``answers`` in the order they were given, on any device; ``truths``
    by pool index."""
    worst = dict(range_excess=0.0, dist_over=0.0, dist_under=0.0)
    bad_rows = lanes = failed = 0
    hits_sum, true_sum, distinct = 0, 0, 0
    share_sum, share_n = 0.0, 0
    seen = set()
    for ans in answers:
        truth = truths[ans.index]
        ans = ans.to(points.device)
        bad, ex, over, under, hits, share = _lane_numbers(points, metric, ans, truth)
        t = int(ans.times)
        share_sum += float(share.sum()) * t
        share_n += int(share.numel()) * t
        bad_rows += int(bad.sum()) * t
        for name, v in (("range_excess", ex), ("dist_over", over), ("dist_under", under)):
            worst[name] = max(worst[name], float(v.max()) if v.numel() else 0.0)
        lanes += int(bad.numel()) * t
        failed += int((bad | (ex > limits["range_excess"]) | (over > limits["dist_over"])
                       | (under > limits["dist_under"])).sum()) * t
        if ans.index not in seen:
            seen.add(ans.index)
            hits_sum += int(hits.sum())
            true_sum += int(truth.counts.sum())
            distinct += int(hits.numel())
    ap = hits_sum / true_sum if true_sum else 1.0
    recall = share_sum / share_n if share_n else 1.0
    readings = dict(bad_rows=bad_rows, **worst, recall=recall, ap=ap)
    return Verdict(readings=readings, limits={k: limits[k] for k in NUMBERS},
                   lanes=lanes, failed=failed, distinct=distinct)


# odd 64-bit constants of splitmix64, as signed int64
_MUL = (-4658895280553007687, -7723592293110705685, -7046029254386353131)
DIGEST_LANES = 2048     # lanes a block of the digest, to bound its scratch


def _mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64, in place (arithmetic shifts and
    wrapping products: a fixed function on one device, all it needs)."""
    x ^= x >> 30
    x *= _MUL[1]
    x ^= x >> 27
    x *= _MUL[2]
    x ^= x >> 31
    return x


def digest(ids: torch.Tensor, dists: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """An int64 scalar on the answer's device that changes with any id,
    distance bit or count of any lane, and not with the order of a lane's
    slots (the comparison reads a lane as a set)."""
    s = ids.shape[0]
    bits = dists.contiguous().view(torch.int32)
    total = torch.zeros((), dtype=torch.int64, device=ids.device)
    for a in range(0, s, DIGEST_LANES):
        lane = torch.arange(a, min(a + DIGEST_LANES, s), device=ids.device)[:, None]
        x = ids[a:a + DIGEST_LANES].long() * _MUL[0] + bits[a:a + DIGEST_LANES]
        x += (lane << 32)
        total += _mix(x).sum()
        c = count[a:a + DIGEST_LANES, None].long() + ((lane + s) << 32)
        total += _mix(c).sum()
    return total


def truths_for(points: torch.Tensor, metric: str, batches: dict) -> dict:
    """The reference's |K| of each kept lane, by pool index; ``batches``
    maps a pool index to (queries, radii) of its kept lanes."""
    return {i: Truth(queries=q, radii=r,
                     counts=reference.true_counts(points, q, r, metric))
            for i, (q, r) in batches.items()}
