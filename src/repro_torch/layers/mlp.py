"""The LM's feed-forward block (``MLPConfig``, ``init_mlp``, ``mlp``: gated
SwiGLU / GeGLU or the classic two-matrix FFN) and the plain dense stack of
the recsys models and the effort regressor (``init_dense_stack`` /
``dense_stack`` of the reference with ReLU, the activation of every
caller: between layers, and after the last with ``final_act``, as DLRM's
bottom MLP)."""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..utils import resolve_device
from .common import dense_init

ACTS = {
    "silu": torch.nn.functional.silu,
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "relu": torch.relu,
}


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    act: str = "silu"
    gated: bool = True   # False -> classic 2-matrix FFN (starcoder2)


class MLP(nn.Module):
    """``w_up`` and ``w_gate`` (d_model, d_ff), ``w_down`` (d_ff, d_model):
    the reference's (in, out) layout, so the products are the same."""

    def __init__(self, w_up, w_down, w_gate=None):
        super().__init__()
        self.w_up = nn.Parameter(w_up, requires_grad=False)
        self.w_down = nn.Parameter(w_down, requires_grad=False)
        self.w_gate = (None if w_gate is None
                       else nn.Parameter(w_gate, requires_grad=False))


def draw_dense(shape, fan_in: int, *, generator, device, dtype) -> torch.Tensor:
    """A fan-in truncated-normal weight drawn in f32 and stored in ``dtype``
    (the reference keeps f32 weights and casts them at each use; casting
    once gives the same products)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device=device, dtype=dtype)
    w = torch.empty(shape, device=device, dtype=torch.float32)
    return dense_init(w, fan_in, generator=generator).to(dtype)


def init_mlp(cfg: MLPConfig, *, generator=None, device="cuda",
             dtype=torch.float32) -> MLP:
    dev = resolve_device(device, meta=True)
    draw = dict(generator=generator, device=dev, dtype=dtype)
    w_up = draw_dense((cfg.d_model, cfg.d_ff), cfg.d_model, **draw)
    w_down = draw_dense((cfg.d_ff, cfg.d_model), cfg.d_ff, **draw)
    w_gate = (draw_dense((cfg.d_model, cfg.d_ff), cfg.d_model, **draw)
              if cfg.gated else None)
    return MLP(w_up, w_down, w_gate)


def mlp(params: MLP, x: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    dt = x.dtype
    u = x @ params.w_up.to(dt)
    if cfg.gated:
        h = ACTS[cfg.act](x @ params.w_gate.to(dt)) * u
    else:
        h = ACTS[cfg.act](u)
    return h @ params.w_down.to(dt)


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
        return dense_stack(dict(self.named_parameters()), x, self.n)


def dense_stack(params: dict, x: torch.Tensor, n: int,
                final_act: bool = False) -> torch.Tensor:
    """The stack's function over a dict of its tensors (``w{i}``, ``b{i}``):
    what ``DenseStack`` computes, on tensors a caller may differentiate."""
    dt = x.dtype
    for i in range(n):
        x = x @ params[f"w{i}"].to(dt) + params[f"b{i}"].to(dt)
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


def init_dense_stack(dims, *, generator=None, device="cuda") -> DenseStack:
    """dims = (in, h1, ..., out): fan-in truncated-normal weights, zero
    biases, drawn layer by layer from ``generator``."""
    dev = resolve_device(device, meta=True)
    ws, bs = [], []
    for i in range(len(dims) - 1):
        w = torch.empty((dims[i], dims[i + 1]), device=dev)
        ws.append(dense_init(w, dims[i], generator=generator))
        bs.append(torch.zeros((dims[i + 1],), device=dev))
    return DenseStack(ws, bs)
