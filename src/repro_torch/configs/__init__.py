"""Architecture registry: the 10 assigned architectures and the paper's own
engine, as the reference's ``configs`` package. Each module exports
``ARCH`` (the exact published configuration) and ``reduced()`` (a CPU-test
version of the same family)."""
from . import (
    autoint, deepseek_v2_236b, dlrm_rm2, gcn_cora, gemma3_27b, qwen2_moe_a27b,
    qwen3_14b, range_engine, starcoder2_7b, two_tower_retrieval, wide_deep,
)
from .common import ArchSpec, ShapeSpec, gnn_shapes, lm_shapes, recsys_shapes

_MODULES = [
    gemma3_27b, qwen3_14b, starcoder2_7b, deepseek_v2_236b, qwen2_moe_a27b,
    gcn_cora, two_tower_retrieval, wide_deep, dlrm_rm2, autoint,
    range_engine,
]

REGISTRY: dict[str, ArchSpec] = {m.ARCH.arch_id: m.ARCH for m in _MODULES}

# The 40 cells: 10 assigned architectures x their own 4 shapes.
ASSIGNED = [m.ARCH.arch_id for m in _MODULES if m.ARCH.arch_id != "range-engine"]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def list_archs() -> list[str]:
    return list(REGISTRY)


def all_cells(include_engine: bool = False) -> list[tuple[str, str]]:
    out = []
    for aid in (list(REGISTRY) if include_engine else ASSIGNED):
        for shape in REGISTRY[aid].shapes:
            out.append((aid, shape))
    return out


__all__ = ["ASSIGNED", "REGISTRY", "ArchSpec", "ShapeSpec", "all_cells", "get_arch",
           "gnn_shapes", "list_archs", "lm_shapes", "recsys_shapes"]
