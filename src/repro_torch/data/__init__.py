"""Synthetic corpora and the synthetic LM token stream (numpy only)."""
from .lm import LMDataConfig, lm_batch, lm_batches
from .synthetic import PROFILES, CorpusProfile, RangeDataset, make_corpus

__all__ = ["PROFILES", "CorpusProfile", "LMDataConfig", "RangeDataset",
           "lm_batch", "lm_batches", "make_corpus"]
