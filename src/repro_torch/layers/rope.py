"""Rotary position embeddings (split-half convention).

``theta`` is a per-layer Python float: gemma3 alternates 10k (local layers)
and 1M (global layers). The frequencies and angles are computed in f32 in
the reference's order, ``inv_freq = theta ** -(arange(half) / half)`` and
``angle = position * inv_freq``: at a position of 4,096 the angle reaches
~4,100 rad, where one f32 ulp of the angle is 4.9e-4.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dist.sharding import replicate_like


def rope_freqs(positions: torch.Tensor, d_head: int, theta) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of shape positions.shape + (d_head // 2,)."""
    half = d_head // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    # theta goes in as a scalar argument, not a device tensor: making one
    # from a Python number is a host-to-device copy, which waits for the card
    inv_freq = torch.pow(float(np.float32(theta)), -exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta=10_000.0) -> torch.Tensor:
    """x: (..., S, H, dh); positions: (..., S)."""
    cos, sin = rope_freqs(positions, x.shape[-1], theta)   # (..., S, dh/2)
    cos = replicate_like(cos[..., None, :], x)              # broadcast over heads
    sin = replicate_like(sin[..., None, :], x)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
