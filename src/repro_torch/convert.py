"""Carry a built index across from the JAX package as plain arrays.

The reference's ``RangeSearchEngine`` holds ``points``, ``graph.neighbors``
and ``start_ids``; given those as numpy arrays, ``engine_from_arrays``
builds this package's engine over the identical index, so both packages
can be run on the same graph. An int8 reference corpus comes across as its
``codes`` and ``meta`` beside the raw ``points``, so both packages search
the identical quantized corpus.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.corpus import QuantizedCorpus
from .core.engine import RangeSearchEngine
from .core.graph import Graph
from .utils import resolve_device


def engine_from_arrays(points, neighbors, start_ids, metric: str = "l2",
                       device="cuda", codes=None, meta=None) -> RangeSearchEngine:
    dev = resolve_device(device)
    pts = torch.as_tensor(np.array(points, np.float32), device=dev).contiguous()
    nbrs = torch.as_tensor(np.array(neighbors, np.int32), device=dev)
    starts = torch.as_tensor(np.array(start_ids, np.int32), device=dev)
    corpus = pts
    if (codes is None) != (meta is None):
        raise ValueError("an int8 corpus needs both codes and meta")
    if codes is not None:
        corpus = QuantizedCorpus(
            codes=torch.as_tensor(np.array(codes, np.int8), device=dev).contiguous(),
            meta=torch.as_tensor(np.array(meta, np.float32), device=dev).contiguous(),
            raw=pts)
    return RangeSearchEngine(points=corpus,
                             graph=Graph(neighbors=nbrs.contiguous()),
                             start_ids=starts.reshape(-1), metric=metric)
