"""RMSNorm / LayerNorm (f32 statistics, cast back to the input's dtype)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             unit_offset: bool = False) -> torch.Tensor:
    """``unit_offset=True`` applies (1 + scale), the gemma convention."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * (var + eps) ** -0.5
    w = scale.float()
    if unit_offset:
        w = 1.0 + w
    return (y * w).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * (var + eps) ** -0.5
    return (y * scale.float() + bias.float()).to(x.dtype)
