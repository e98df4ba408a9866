"""Synthetic corpora, the synthetic LM token stream, recsys batches and
graph datasets (numpy only)."""
from .graphs import (
    GraphData, NeighborSampler, SampledBatch, make_sbm_graph, range_graph_dataset, to_csr)
from .lm import LMDataConfig, lm_batch, lm_batches
from .recsys import RecsysDataConfig, recsys_batch, recsys_batches
from .synthetic import PROFILES, CorpusProfile, RangeDataset, make_corpus

__all__ = ["PROFILES", "CorpusProfile", "GraphData", "LMDataConfig", "NeighborSampler",
           "RangeDataset", "RecsysDataConfig", "SampledBatch", "lm_batch", "lm_batches",
           "make_corpus", "make_sbm_graph", "range_graph_dataset", "recsys_batch",
           "recsys_batches", "to_csr"]
