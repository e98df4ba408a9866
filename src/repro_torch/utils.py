"""Small shared utilities: the INVALID sentinel, integer helpers, padding,
tree helpers, timing, devices."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

# Sentinel id for padded slots. A large positive int32 (not -1), so padded
# entries sort to the end of ascending id orderings.
INVALID_ID = 2**31 - 1
INF = float("inf")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def next_pow2(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (int(x) - 1).bit_length()


def pad_rows(x: torch.Tensor, target: int, fill) -> torch.Tensor:
    """Pad axis 0 of ``x`` to ``target`` rows with ``fill``."""
    if x.shape[0] == target:
        return x
    pad = torch.full((target - x.shape[0],) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


def tree_leaves(tree: Any) -> list:
    """The tensors and numpy arrays of a tree of dicts (in sorted key order,
    as the reference's pytrees), lists, tuples and dataclasses; other
    leaves (ints, None) are dropped."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree) for x in tree_leaves(getattr(tree, f.name))]
    return []


def _itemsize(x) -> int:
    return x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize


def tree_bytes(tree: Any) -> int:
    """Bytes of every array of ``tree`` (a meta tensor counts the bytes it
    stands for)."""
    return sum(int(np.prod(x.shape)) * _itemsize(x) for x in tree_leaves(tree))


def tree_count(tree: Any) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def block_until_ready(tree: Any) -> Any:
    """Wait for the work that makes ``tree``'s tensors: one
    ``torch.cuda.synchronize`` for each card among them. Returns ``tree``."""
    for dev in {x.device for x in tree_leaves(tree)
                if isinstance(x, torch.Tensor) and x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tree


def timeit(fn: Callable[[], Any], *, warmup: int = 1, iters: int = 3) -> float:
    """Median wall-clock seconds per call of ``fn``, each call waited for
    through ``block_until_ready`` on what it returns."""
    for _ in range(warmup):
        block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def masked_min(x: torch.Tensor, mask: torch.Tensor, axis: int = -1):
    """Min over ``x`` where ``mask``; returns (value, index). Empty -> (+inf, 0)."""
    masked = torch.where(mask, x, torch.full_like(x, INF))
    val, idx = torch.min(masked, dim=axis)
    return val, idx


def stable_compact_indices(active: torch.Tensor):
    """Indices that gather active rows to the front (stable), plus inverse.

    Returns (perm, inv_perm, n_active): ``x[perm]`` puts active rows first in
    original order; ``y[inv_perm]`` undoes it."""
    perm = torch.argsort((~active.bool()).to(torch.uint8), stable=True)
    inv_perm = torch.argsort(perm, stable=True)
    return perm, inv_perm, torch.sum(active.to(torch.int32)).to(torch.int32)


def resolve_device(device, *, meta: bool = False) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` is the default of every
    entry point and raises when no card is present: nothing falls back to
    the CPU unless the caller asks for it with ``device="cpu"``. ``meta``
    lets a model constructor take ``"meta"`` (shapes only, nothing allocated)."""
    dev = torch.device(device)
    if dev.type == "meta" and meta:
        return dev
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def param_tree(module: torch.nn.Module) -> dict:
    """The module's parameters as nested dicts, one level a dotted name
    part (``user.mlp.w0`` -> ``tree["user"]["mlp"]["w0"]``), each leaf the
    parameter's tensor detached: the reference's parameter tree wherever
    the port's modules name their parameters as its keys."""
    tree: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach()
    return tree


class TreeView:
    """Attribute access over a dict of a parameter tree: ``view.attn.wq`` is
    ``tree["attn"]["wq"]``, a nested dict reads as another view and a
    missing key as None (an optional weight). The model functions read a
    module's parameters by attribute, so they run on either."""

    __slots__ = ("_tree",)

    def __init__(self, tree: dict):
        object.__setattr__(self, "_tree", tree)

    def __getattr__(self, name):
        value = self._tree.get(name)
        return TreeView(value) if isinstance(value, dict) else value
