"""Model configurations of the port, copied from the reference's
``configs`` package without its sharding rules and optimizer settings
(the multi-device and training slices)."""
from .common import ArchSpec, ShapeSpec, recsys_shapes

__all__ = ["ArchSpec", "ShapeSpec", "recsys_shapes"]
