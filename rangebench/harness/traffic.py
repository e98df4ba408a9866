"""One general generator of traffic: a mix file's parameters turned into
batches of queries and per-query radii, from the run's seed.

A mix file (``traffic/<name>.json``) holds:

- ``batch``: queries a batch;
- ``loop``: ``"closed"`` (one client, each batch sent when the last is
  answered; the only loop this generator offers so far);
- ``radius``: ``{"kind": "fixed"}`` (every query at the configuration's
  radius r) or ``{"kind": "levels", "lo": a, "hi": b, "count": k}`` (k
  levels log-spaced from a·r to b·r, the same number of queries at each
  level in every batch, in a random order).

The queries are the deployment's, as a public benchmark's query file is:
``pool_batches`` batches drawn from the configuration's
``distribution_seed``, each with the same number of hit and background
probes and of queries at each radius level. The run's ``--seed`` deals
that fixed set out to the pool's batches and lanes in an order of its own
(``pool``), so two seeds send the same work in another order: the sizes
of the answers, which are heavy-tailed, do not move the numbers from seed
to seed. A seeded share of the set is judged (``pool``'s lanes).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import corpus

LOOPS = ("closed",)


@dataclasses.dataclass
class Batch:
    index: int              # the batch's place in the run's pool
    queries: torch.Tensor   # (B, d) f32
    radii: torch.Tensor     # (B,) f32


def check(mix: dict) -> None:
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"unknown loop {mix.get('loop')!r}; known: {LOOPS}")
    kind = mix["radius"]["kind"]
    if kind not in ("fixed", "levels"):
        raise ValueError(f"unknown radius kind {kind!r}")
    if int(mix["batch"]) < 1:
        raise ValueError("a batch holds at least one query")


def radius_levels(mix: dict, r: float) -> np.ndarray:
    spec = mix["radius"]
    if spec["kind"] == "fixed":
        return np.array([r], dtype=np.float32)
    return (np.float32(r) * np.geomspace(spec["lo"], spec["hi"], spec["count"])
            ).astype(np.float32)


def query_set(dist: corpus.Distribution, mix: dict, n: int, r: float,
              batches: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The deployment's ``batches`` x B queries and their radii, drawn from
    the distribution's seed one batch at a time: each block of B holds the
    mix's counts of hit and background probes and of each radius level."""
    check(mix)
    dev, size = dist.centers.device, int(mix["batch"])
    levels = torch.as_tensor(radius_levels(mix, r), device=dev)
    qs, rs = [], []
    for i in range(batches):
        gen = corpus.generator(dev, dist.knobs["distribution_seed"], 2, i)
        qs.append(corpus.queries(dist, size, n, gen))
        slot = torch.arange(size, device=dev) % len(levels)
        rs.append(levels[slot[torch.randperm(size, generator=gen, device=dev)]])
    return torch.cat(qs), torch.cat(rs).contiguous()


def order(total: int, seed: int, device) -> torch.Tensor:
    """The run's order: position p of the pool holds query ``order[p]``."""
    return torch.randperm(total, generator=corpus.generator(device, seed, 5), device=device)


def pool(dist: corpus.Distribution, mix: dict, n: int, r: float, batches: int,
         judged: int, seed: int) -> tuple[list, list, torch.Tensor]:
    """The run's pool: ``batches`` Batches dealt from ``query_set`` in the
    seed's order; the lanes of each batch that hold one of the set's first
    ``judged`` queries (ascending); and the order itself."""
    qs, rs = query_set(dist, mix, n, r, batches)
    perm = order(qs.shape[0], seed, qs.device)
    size = int(mix["batch"])
    out, lanes = [], []
    for i in range(batches):
        idx = perm[i * size:(i + 1) * size]
        out.append(Batch(index=i, queries=qs[idx].contiguous(), radii=rs[idx].contiguous()))
        lanes.append(torch.nonzero(idx < judged).flatten())
    return out, lanes, perm
