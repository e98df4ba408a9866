"""Small shared utilities: the INVALID sentinel, integer helpers, devices."""
from __future__ import annotations

import torch

# Sentinel id for padded slots. A large positive int32 (not -1), so padded
# entries sort to the end of ascending id orderings.
INVALID_ID = 2**31 - 1


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def next_pow2(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (int(x) - 1).bit_length()


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
