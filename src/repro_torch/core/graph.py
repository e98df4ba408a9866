"""Proximity-graph container: a dense padded adjacency matrix.

    neighbors : (N, R) int32, row i = out-neighbors of node i,
                padded with INVALID_ID.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils import INVALID_ID, resolve_device


@dataclasses.dataclass(frozen=True)
class Graph:
    """Padded fixed-degree adjacency."""

    neighbors: torch.Tensor  # (N, R) int32, INVALID_ID padded

    @property
    def num_nodes(self) -> int:
        return self.neighbors.shape[0]

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[1]

    def degrees(self) -> torch.Tensor:
        return torch.sum(self.neighbors != INVALID_ID, dim=1)

    def out_neighbors(self, ids: torch.Tensor) -> torch.Tensor:
        """Gather adjacency rows; invalid ids yield all-INVALID rows."""
        valid = (ids >= 0) & (ids < self.num_nodes)
        rows = self.neighbors[torch.where(valid, ids, 0).long()]
        return torch.where(valid[..., None], rows, INVALID_ID)

    def lane_padded(self, multiple: int = 128) -> "Graph":
        """Copy with the degree axis INVALID-padded up to ``multiple`` (the
        reference pads R to the TPU's 128 lanes; a padded row searches as
        the unpadded one)."""
        r = self.max_degree
        r_pad = -(-r // multiple) * multiple
        if r_pad == r:
            return self
        pad = torch.full((self.num_nodes, r_pad - r), INVALID_ID, dtype=torch.int32,
                         device=self.neighbors.device)
        return Graph(neighbors=torch.cat([self.neighbors, pad], dim=1))


def from_lists(lists: list[list[int]], max_degree: Optional[int] = None, *,
               device="cuda") -> Graph:
    """Build a Graph from python adjacency lists (testing convenience)."""
    r = max_degree if max_degree is not None else max((len(l) for l in lists), default=1)
    r = max(r, 1)
    out = np.full((len(lists), r), INVALID_ID, dtype=np.int32)
    for i, l in enumerate(lists):
        if len(l) > r:
            raise ValueError(f"node {i} has degree {len(l)} > max_degree {r}")
        out[i, : len(l)] = np.asarray(l, dtype=np.int32)
    return Graph(neighbors=torch.from_numpy(out).to(resolve_device(device)))


def random_regular(key, n: int, degree: int, *, device="cuda") -> Graph:
    """Random out-degree-``degree`` digraph (Vamana's initialization).
    ``key`` is an int seed (drawn on ``device``) or a ``torch.Generator``
    (drawn on its own device), where the reference takes a JAX key."""
    if isinstance(key, torch.Generator):
        gen, dev = key, key.device
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(key))
    nbrs = torch.randint(0, n, (n, degree), generator=gen, device=dev, dtype=torch.int32)
    # avoid trivial self loops (shift by 1 mod n where equal to row id)
    row = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    return Graph(neighbors=torch.where(nbrs == row, (nbrs + 1) % n, nbrs))


def medoid(points: torch.Tensor) -> torch.Tensor:
    """Index of the point closest to the dataset centroid (search entry)."""
    c = torch.mean(points, dim=0, keepdim=True)
    d = torch.sum((points - c) ** 2, dim=-1)
    return torch.argmin(d).to(torch.int32)


def start_points(points: torch.Tensor, metric: str = "l2", k: int = 1) -> torch.Tensor:
    """Search entry points.

    L2: the medoid plus k-1 spread points (farthest-point selection).
    MIPS: the top-norm points, ties to the lower index (as ``lax.top_k``).
    """
    if metric == "ip":
        norms = torch.sum(points * points, dim=-1)
        order = torch.sort(norms, descending=True, stable=True).indices
        return order[:k].to(torch.int32)
    starts = [medoid(points)]
    mind = None
    for _ in range(k - 1):
        ds = torch.sum((points - points[starts[-1].long()]) ** 2, dim=-1)
        mind = ds if mind is None else torch.minimum(mind, ds)
        starts.append(torch.argmax(mind).to(torch.int32))
    return torch.stack(starts).to(torch.int32)
