"""Dispatch for flash attention.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the hand-written kernel (``csrc/flashattn.cu``) or raises; a caller that
wants the plain version on the card calls ``flash_attention_ref``. The
reference's ``use_pallas``, ``interpret``, ``block_q`` and ``block_k`` are
TPU concerns (the Pallas route, its CPU emulation, its VMEM blocks) and have
no counterpart here: the kernel picks its own tiles, masks ragged Sq and Skv
itself and reads its inputs through their strides, so nothing is padded or
copied.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._launch import ROW_DTYPES
from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, dh), k/v (B, Hkv, Skv, dh) -> (B, Hq, Sq, dh) in q's
    dtype. ``q_offset`` is the absolute position of query row 0, a Python
    int (at decode, the cache position)."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, **kw)
    return flash_attention_cuda(q, k, v, **kw)


def _check(name: str, t: torch.Tensor, ref: torch.Tensor) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != ref.device or t.dtype != ref.dtype:
        raise ValueError(f"{name} is {t.dtype} on {t.device}, expected "
                         f"{ref.dtype} on {ref.device}")
    if t.dim() != 4:
        raise ValueError(f"{name} must be 4-D, got shape {tuple(t.shape)}")
    step = 16 // t.element_size()
    if (t.stride(3) != 1 or any(s % step for s in t.stride()[:3])
            or t.data_ptr() % 16):
        raise ValueError(f"{name} needs a contiguous last dim and rows on "
                         f"16-byte boundaries (strides {t.stride()})")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, q_offset: int = 0,
                         scale: float | None = None) -> torch.Tensor:
    """Launch ``csrc/flashattn.cu`` on the current stream. q, k, v: f32 or
    bf16 alike, on one CUDA device, any strides whose last dim is
    contiguous and whose rows start on 16-byte boundaries (the model's
    (B, S, H, dh) tensors seen as (B, H, S, dh) qualify); dh in
    ``HEAD_DIMS``; Hq a multiple of Hkv. The output has q's strides."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {q.device}")
    if q.dtype not in ROW_DTYPES:
        raise ValueError(f"q has dtype {q.dtype}, expected one of {tuple(ROW_DTYPES)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q)
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, hkv, skv, dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B, Hkv, Skv, {dh}) alike, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    if q_offset < 0:
        raise ValueError(f"q_offset={q_offset} < 0")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = dh ** -0.5 if scale is None else scale
    lib = _build.load("flashattn")
    fn = lib.flashattn_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong)] * 4
                   + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    strides = [(ctypes.c_longlong * 3)(*t.stride()[:3]) for t in (q, k, v, out)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ROW_DTYPES[q.dtype], b, hq, hkv, sq, skv, dh, *strides,
                int(causal), int(window), int(q_offset), float(softcap),
                float(scale), stream)
    flash_attention_cuda.launches += 1
    _build.check(lib, "flashattn", rc)
    return out


flash_attention_cuda.launches = 0  # kernel launches since the last reset
