"""Synthetic LM token pipeline: deterministic, shardable, restart-safe
(numpy only; the port keeps its own copy of the reference's
``src/repro/data/lm.py``).

A Zipf-distributed token stream with induced bigram structure. The iterator
is seeded by (global) step, so batch ``i`` is identical however many hosts
produce it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int = 1000
    seq_len: int = 128
    batch: int = 8
    zipf_a: float = 1.3
    seed: int = 0


def _zipf_tokens(rng, n, vocab, a):
    z = rng.zipf(a, size=n)
    return np.minimum(z - 1, vocab - 1).astype(np.int32)


def lm_batch(cfg: LMDataConfig, step: int) -> dict:
    """Batch ``step`` of the stream (pure function of (cfg, step))."""
    rng = np.random.default_rng(cfg.seed * 1_000_003 + step)
    toks = _zipf_tokens(rng, (cfg.batch * (cfg.seq_len + 1)), cfg.vocab, cfg.zipf_a)
    toks = toks.reshape(cfg.batch, cfg.seq_len + 1)
    # induce learnable structure: token t+1 = f(token t) half the time
    flip = rng.random((cfg.batch, cfg.seq_len)) < 0.5
    mapped = (toks[:, :-1] * 31 + 7) % cfg.vocab
    toks[:, 1:] = np.where(flip, mapped, toks[:, 1:])
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def lm_batches(cfg: LMDataConfig, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield lm_batch(cfg, step)
        step += 1
