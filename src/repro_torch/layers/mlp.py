"""The plain dense stack of the recsys towers (``init_dense_stack`` /
``dense_stack`` of the reference, with ReLU, the towers' activation; the
reference's other activations and ``final_act`` serve models not ported
yet, ROADMAP.md §1 item 16). The gated LM MLP is ROADMAP.md §1 item 14."""
from __future__ import annotations

import torch
from torch import nn

from .common import dense_init

class DenseStack(nn.Module):
    """``x @ w{i} + b{i}`` for each layer, with ReLU between layers and
    none after the last. Weights keep the reference's (in, out) layout, so
    the product is the same; they are cast to the input's dtype as the
    reference casts them."""

    def __init__(self, weights, biases):
        super().__init__()
        if len(weights) != len(biases):
            raise ValueError("one bias per weight")
        self.n = len(weights)
        for i, (w, b) in enumerate(zip(weights, biases)):
            self.register_parameter(f"w{i}", nn.Parameter(w, requires_grad=False))
            self.register_parameter(f"b{i}", nn.Parameter(b, requires_grad=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        for i in range(self.n):
            x = x @ getattr(self, f"w{i}").to(dt) + getattr(self, f"b{i}").to(dt)
            if i < self.n - 1:
                x = torch.relu(x)
        return x


def init_dense_stack(dims, *, generator=None, device="cpu") -> DenseStack:
    """dims = (in, h1, ..., out): fan-in truncated-normal weights, zero
    biases, drawn layer by layer from ``generator``."""
    ws, bs = [], []
    for i in range(len(dims) - 1):
        w = torch.empty((dims[i], dims[i + 1]), device=device)
        ws.append(dense_init(w, dims[i], generator=generator))
        bs.append(torch.zeros((dims[i + 1],), device=device))
    return DenseStack(ws, bs)
