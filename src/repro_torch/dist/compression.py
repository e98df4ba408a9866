"""Symmetric absmax int8 quantization.

The quantized corpus (``core.corpus``) stores each row as int8 codes with
its own absmax scale; the element-wise error is then at most half a scale
step, which the corpus's guard band is derived from. Rounding is half to
even (``torch.round``), as in the reference, and every division is a true
f32 division, so a code on a .5 boundary lands where the reference puts it.
``compressed_psum_mean`` is the same quantization as the wire format of a
cross-device mean.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ._comm import all_gather, axis_group

# Relative slack on the quantized-corpus guard-band bounds (``core.corpus``
# and the int8 CUDA kernels): the bounds are derived in real arithmetic but
# evaluated in f32. Every lower-bound site must use this constant, because
# the rerank's upper-bound recovery assumes each producer used at least it.
GUARD_SLACK = 1e-4


def absmax_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 as a true f32 division on every device: CUDA
    divides by a Python scalar as a product with its rounded reciprocal,
    which can be 1 ulp off and move a code that sits on a .5 boundary."""
    amax = torch.clamp(amax, min=1e-12)
    return amax / torch.full_like(amax, 127.0)


def quantize_int8(x: torch.Tensor):
    """(q int8, scale) with one absmax scale for the whole tensor."""
    scale = absmax_scale(torch.max(torch.abs(x)))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8_rows(x: torch.Tensor):
    """(q (N, d) int8, scales (N,) f32): one absmax scale per row, so the
    element-wise error is at most ``scales[i] / 2``; ``scale = amax / 127``
    means no value clips."""
    scales = absmax_scale(torch.amax(torch.abs(x), dim=-1))
    q = torch.clamp(torch.round(x / scales[..., None]), -127, 127).to(torch.int8)
    return q, scales


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_mean(x: torch.Tensor, *, axis_name: str, n: int, mesh) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``mesh``'s axis ``axis_name`` (size
    ``n``) with an int8 wire format: one ``all_gather`` of the int8 payloads
    and one of the per-rank scales (the per-rank scales are why a direct
    int8 sum would be invalid), then each rank dequantizes and sums locally.
    Shapes are local: (..., D/n) in, the same out, equal on every rank."""
    group = axis_group(mesh, axis_name)
    if dist.get_world_size(group) != n:
        raise ValueError(f"axis {axis_name!r} has {dist.get_world_size(group)} ranks, not {n}")
    q, scale = quantize_int8(x)
    qs = torch.stack(all_gather(q, group))                   # (n, ...) int8 on the wire
    scales = torch.stack(all_gather(scale.reshape(1), group))  # (n, 1) f32
    deq = qs.float() * scales.reshape((-1,) + (1,) * x.dim())
    return torch.sum(deq, dim=0) / n

