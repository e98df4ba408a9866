"""Synthetic corpora (numpy only)."""
from .synthetic import PROFILES, CorpusProfile, RangeDataset, make_corpus

__all__ = ["PROFILES", "CorpusProfile", "RangeDataset", "make_corpus"]
