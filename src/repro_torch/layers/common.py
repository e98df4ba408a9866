"""Initializers, filled in place from an explicit ``torch.Generator``.

The distributions are the reference's: a truncated normal cut at ±3σ, with
σ = fan_in^-0.5 (``dense_init``) or σ = 0.02 (``embed_init``). PyTorch's
generator cannot give JAX's bits, so parity with the JAX package goes
through ``convert.recsys_params_from_jax``, never through the draws. A
tensor on the meta device is left as it is (shapes only).
"""
from __future__ import annotations

import torch


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
