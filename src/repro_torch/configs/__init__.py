"""Model configurations of the port, copied from the reference's
``configs`` package without its sharding rules and optimizer settings
(the multi-device and training slices)."""
from .common import ArchSpec, ShapeSpec, lm_shapes, recsys_shapes

__all__ = ["ArchSpec", "ShapeSpec", "lm_shapes", "recsys_shapes"]
