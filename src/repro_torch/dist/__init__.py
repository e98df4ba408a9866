"""The distribution layer of the port, over ``torch.distributed``.

Everything above this package speaks in symbolic axes (``DP``/``TP``) and
rule tables; everything below resolves them against a ``DeviceMesh`` that
``make_mesh`` builds (one rank per device; ``sharding``'s docstring states
the SPMD contract that replaces ``shard_map``).

* ``sharding``          — the mesh (``make_mesh``), the rule tables
                          (``LM_RULES``/``RECSYS_RULES``/``GNN_RULES``),
                          ``spec_tree`` with the divisibility fallback,
                          ``bind_shardings`` (DTensor placements), and the
                          activation scope (``activation_sharding``,
                          ``current_mesh``, ``shard_activation``).
* ``sharded_engine``    — the multi-shard range-retrieval layout:
                          ``ShardedCorpus`` (one sub-index per shard, a
                          rank holding those of its model coordinate),
                          ``build_sharded``, ``union_merge`` and
                          ``sharded_range_search`` (the per-shard searches,
                          then the collectives and the union merge).
* ``collective_matmul`` — ring schedules of all-gather/reduce-scatter
                          matmuls (``allgather_matmul``,
                          ``matmul_reducescatter``).
* ``compression``       — int8 quantization (the corpus's, and the wire
                          format of ``compressed_psum_mean``).
* ``embedding``         — row-sharded embedding lookup over the mesh.

The engine's names load at first use (``core`` imports this package's
``compression`` through the kernels, so an eager import would be a cycle).
The reference's ``compat.py`` (``shard_map`` across jax versions) has no
counterpart: torch's device-mesh and collective API has no version split
for the port to bridge.
"""
from .compression import (
    GUARD_SLACK,
    compressed_psum_mean,
    dequantize_int8,
    quantize_int8,
    quantize_int8_rows,
)
from .sharding import (
    DP,
    GNN_RULES,
    LM_RULES,
    MODEL_AXIS,
    RECSYS_RULES,
    TP,
    Rule,
    Spec,
    activation_sharding,
    bind_shardings,
    current_mesh,
    make_mesh,
    mesh_axes,
    shard_activation,
    spec_tree,
)

__all__ = ["DP", "GNN_RULES", "GUARD_SLACK", "LM_RULES", "MODEL_AXIS", "RECSYS_RULES",
           "TP", "Rule", "ShardedCorpus", "Spec", "activation_sharding", "bind_shardings",
           "build_sharded", "current_mesh", "compressed_psum_mean", "dequantize_int8", "make_mesh",
           "mesh_axes", "quantize_int8", "quantize_int8_rows", "shard_activation",
           "sharded_range_search", "spec_tree", "union_merge"]

_ENGINE = ("ShardedCorpus", "build_sharded", "sharded_range_search", "union_merge")


def __getattr__(name):
    if name in _ENGINE:
        from . import sharded_engine
        return getattr(sharded_engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
