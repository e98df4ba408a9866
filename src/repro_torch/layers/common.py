"""Initializers, filled in place from an explicit ``torch.Generator``, and
parameter-tree helpers.

The distributions are the reference's: a truncated normal cut at ±3σ, with
σ = fan_in^-0.5 (``dense_init``) or σ = 0.02 (``embed_init``). PyTorch's
generator cannot give JAX's bits, so parity with the JAX package goes
through ``convert.recsys_params_from_jax``, never through the draws. A
tensor on the meta device is left as it is (shapes only).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..utils import tree_count


def _trunc_normal_(t: torch.Tensor, std: float, generator) -> torch.Tensor:
    if t.device.type == "meta":
        return t
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(t, 0.0, std, -3.0 * std, 3.0 * std,
                                           generator=generator)


def dense_init(t: torch.Tensor, fan_in: int | None = None, *,
               generator=None) -> torch.Tensor:
    """Truncated-normal fan-in init of ``t`` in place (``fan_in`` defaults
    to ``t.shape[0]``, the reference's (in, out) layout)."""
    fan_in = t.shape[0] if fan_in is None else fan_in
    return _trunc_normal_(t, fan_in ** -0.5, generator)


def embed_init(t: torch.Tensor, *, generator=None) -> torch.Tensor:
    """Embedding init of ``t`` in place: σ = 0.02, cut at ±3σ. For a large
    (F, V, d) table, call it on one field at a time: each call makes no
    temporary of the slice's size."""
    return _trunc_normal_(t, 0.02, generator)


def split_keys(key: int, n: int) -> Iterator[int]:
    """``n`` seeds derived from the int seed ``key``, for the port's
    ``init_*(seed=)``: the children of ``numpy.random.SeedSequence(key)``.
    JAX's key stream cannot be reproduced; the same ``key`` gives the same
    seeds."""
    return iter(int(s.generate_state(2, np.uint64)[0] >> np.uint64(1))
                for s in np.random.SeedSequence(int(key)).spawn(n))


def flatten_paths(tree, prefix: str = "") -> dict:
    """{'a/b/c': leaf} view of a nested-dict param tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_paths(v, f"{prefix}/{k}" if prefix else k))
    else:
        out[prefix] = tree
    return out


def param_count(tree) -> int:
    return tree_count(tree)


def cast_tree(tree, dtype):
    """Every floating tensor of ``tree`` (dicts, lists, tuples) in ``dtype``;
    other leaves as they are. Meta tensors stay on the meta device."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    return tree
