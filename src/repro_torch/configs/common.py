"""ArchSpec / ShapeSpec: the (architecture x input-shape) cell definitions.

Every configuration module exports ``ARCH`` (the exact published config)
and ``reduced()`` (a CPU-test version of the same family). ``rules`` are
the parameters' sharding rules (``dist.sharding.Rule``s; the reference
requires them, the port's configs that do not shard leave them empty) and
``opt_cfg`` the optimizer settings."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from ..optim.adamw import AdamWConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode | serve | bulk | retrieval |
                         # graph_full | graph_sampled | graph_batched
    seq_len: int = 0
    global_batch: int = 0
    n_candidates: int = 0
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple = ()
    n_graphs: int = 0
    nodes_per_graph: int = 0
    edges_per_graph: int = 0
    notes: str = ""


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                        # lm | gnn | recsys
    model_cfg: Any
    shapes: dict[str, ShapeSpec]
    rules: Any = ()                    # sharding Rule list
    opt_cfg: AdamWConfig = AdamWConfig()
    source: str = ""
    technique_note: str = ""           # paper-technique applicability
    reduced: Optional[Callable[[], Any]] = None  # smoke-size config factory


# The four LM shapes shared by all five LM archs.
def lm_shapes() -> dict[str, ShapeSpec]:
    return {
        "train_4k": ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32_768, global_batch=32),
        "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32_768, global_batch=128),
        "long_500k": ShapeSpec(
            "long_500k", "decode", seq_len=524_288, global_batch=1,
            notes="decode lowering: O(kv_len) per step for every attention "
                  "kind (DESIGN.md §6); gemma3 additionally has 5:1 "
                  "local:global sub-quadratic structure"),
    }


def recsys_shapes() -> dict[str, ShapeSpec]:
    return {
        "train_batch": ShapeSpec("train_batch", "train", global_batch=65_536),
        "serve_p99": ShapeSpec("serve_p99", "serve", global_batch=512),
        "serve_bulk": ShapeSpec("serve_bulk", "serve", global_batch=262_144),
        "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                    global_batch=1, n_candidates=1_000_000),
    }
