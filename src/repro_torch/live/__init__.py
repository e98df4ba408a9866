"""The live index: streaming inserts, tombstoned deletes and consolidation
over the frozen range-retrieval engine, with a write-ahead log and
checkpoints. ``LiveShardedIndex`` and ``clone_live_index`` (the sharded
live index) are a later slice of the port (ROADMAP.md §1, item 4)."""
from .consolidate import consolidate_index
from .index import FAR, LiveConfig, LiveIndex, LiveSnapshot, externalize_ids

__all__ = [
    "FAR",
    "LiveConfig",
    "LiveIndex",
    "LiveSnapshot",
    "consolidate_index",
    "externalize_ids",
]
