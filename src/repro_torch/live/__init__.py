"""The live index: streaming inserts, tombstoned deletes and consolidation
over the frozen range-retrieval engine, with a write-ahead log and
checkpoints; and the sharded live index (``LiveShardedIndex``: shard-routed
mutations, R-way replica groups kept bit-identical, ``clone_live_index``)."""
from .consolidate import consolidate_index
from .index import FAR, LiveConfig, LiveIndex, LiveSnapshot, externalize_ids
from .sharded import LiveShardedIndex, clone_live_index

__all__ = [
    "FAR",
    "LiveConfig",
    "LiveIndex",
    "LiveSnapshot",
    "LiveShardedIndex",
    "clone_live_index",
    "consolidate_index",
    "externalize_ids",
]
