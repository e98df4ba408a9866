"""Production meshes, over ``dist.sharding.make_mesh``.

Functions, not module constants: importing this module touches no process
group. A 256- or 512-rank mesh needs a process group of that size already
initialized (one rank a card, or torch's fake process group for shapes
only); this module sets none up, as the reference's leaves the device
count to its dry run.
"""
from __future__ import annotations

import numpy as np

from ..dist.sharding import make_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_host_mesh(data: int = 2, model: int = 4, *, device_type: str = "cpu"):
    """Small mesh over the ranks of a host's world (tests: gloo)."""
    return make_mesh((data, model), ("data", "model"), device_type=device_type)


def mesh_devices(mesh) -> int:
    return int(np.prod(tuple(mesh.shape)))
