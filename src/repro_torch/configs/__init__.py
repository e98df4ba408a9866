"""Model configurations of the port, copied from the reference's
``configs`` package. Only ``range_engine``'s ``ARCH`` carries sharding rules
so far; the registry (``get_arch``) is ROADMAP.md §1, item 9."""
from .common import ArchSpec, ShapeSpec, lm_shapes, recsys_shapes

__all__ = ["ArchSpec", "ShapeSpec", "lm_shapes", "recsys_shapes"]
