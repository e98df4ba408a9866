"""Synthetic recsys batches (Criteo-shaped clicks, two-tower pairs), numpy
only: the port's own copy of the reference's ``src/repro/data/recsys.py``,
so batch ``step`` is bit for bit the reference's."""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class RecsysDataConfig:
    n_dense: int = 13
    n_sparse: int = 26
    vocab: int = 100_000
    batch: int = 4096
    zipf_a: float = 1.2     # id popularity skew (real CTR ids are heavy-tailed)
    seed: int = 0
    two_tower: bool = False
    n_sparse_item: int = 0


def _ids(rng, shape, vocab, a):
    z = rng.zipf(a, size=shape)
    return np.minimum(z - 1, vocab - 1).astype(np.int32)


def recsys_batch(cfg: RecsysDataConfig, step: int) -> dict:
    """Batch ``step`` (a pure function of (cfg, step))."""
    rng = np.random.default_rng(cfg.seed * 999_983 + step)
    if cfg.two_tower:
        fu, fi = cfg.n_sparse, cfg.n_sparse_item or cfg.n_sparse
        user = _ids(rng, (cfg.batch, fu), cfg.vocab, cfg.zipf_a)
        # the positive item correlates with the user's first field
        item = _ids(rng, (cfg.batch, fi), cfg.vocab, cfg.zipf_a)
        item[:, 0] = (user[:, 0] * 13 + 5) % cfg.vocab
        logq = np.log(1.0 / cfg.vocab) * np.ones((cfg.batch,), np.float32)
        return {"user_sparse": user, "item_sparse": item, "log_q": logq}
    sparse = _ids(rng, (cfg.batch, cfg.n_sparse), cfg.vocab, cfg.zipf_a)
    dense = rng.standard_normal((cfg.batch, cfg.n_dense)).astype(np.float32) \
        if cfg.n_dense else np.zeros((cfg.batch, 0), np.float32)
    # clicks depend on a hash of two sparse fields and one dense feature
    signal = ((sparse[:, 0] + sparse[:, min(1, cfg.n_sparse - 1)]) % 7 < 2)
    if cfg.n_dense:
        signal = signal | (dense[:, 0] > 1.2)
    noise = rng.random(cfg.batch) < 0.05
    label = (signal ^ noise).astype(np.float32)
    out = {"sparse": sparse, "label": label}
    if cfg.n_dense:
        out["dense"] = dense
    return out


def recsys_batches(cfg: RecsysDataConfig, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield recsys_batch(cfg, step)
        step += 1
