"""Tiered corpus: device-resident int8 codes + a host-memory raw-row store.

The rerank's exact rows leave the device, so corpus size becomes a host
memory question. See ``tier.corpus`` for the parity contract and
``tier.store`` for the row layout.
"""
from .budget import MemoryBudget
from .cache import DeviceRowCache
from .corpus import TierCounters, TieredCorpus, tiered_corpus
from .planner import FetchPlan, plan_fetch
from .store import ROW_ALIGN, HostRowStore, TierFetchError

__all__ = ["MemoryBudget", "DeviceRowCache", "TierCounters", "TieredCorpus",
           "tiered_corpus", "FetchPlan", "plan_fetch", "ROW_ALIGN",
           "HostRowStore", "TierFetchError"]
