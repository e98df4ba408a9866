"""Dispatch for flash attention.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
a hand-written kernel or raises; a caller that wants the plain version on
the card calls ``flash_attention_ref``. The kernel's route depends on the
rows a kv head has (Sq * G), the dtype and dh alone, never on a failure:

- ``decode_split`` (Sq * G <= 16): ``csrc/flashattn.cu``'s split kernel,
  the visible keys split across blocks as ``decode_splits`` plans; one
  launch, in which the last block of each (b, kv head) to finish merges
  its splits;
- ``wgmma`` (bf16, dh 64 or 128): ``csrc/flashattn_wgmma.cu``, tensor
  cores fed by TMA;
- ``tile_f32`` (the rest: f32, bf16 at dh 16 or 32): ``csrc/flashattn.cu``'s
  tile kernel on the CUDA cores.

The reference's ``use_pallas``, ``interpret``, ``block_q`` and ``block_k`` are
TPU concerns (the Pallas route, its CPU emulation, its VMEM blocks) and have
no counterpart here: the kernel picks its own tiles, masks ragged Sq and Skv
itself and reads its inputs through their strides, so nothing is padded or
copied.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._launch import ROW_DTYPES, count_launch
from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
MAX_DECODE_ROWS = 16        # Sq * G of the decode_split route
SPLIT_BLOCKS = 264          # two blocks on each of the H100's 132 SMs
SPLIT_MIN_KEYS = 256        # the least keys a split sweeps


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


def visible_key_range(sq: int, skv: int, *, causal: bool, window: int,
                      q_offset: int) -> tuple[int, int]:
    """The keys [lo, hi) that some query row may see (hi <= lo: none)."""
    lo = max(0, q_offset - window + 1) if window > 0 else 0
    hi = min(skv, q_offset + sq) if causal else skv
    return lo, hi


def decode_splits(n_keys: int, blocks: int) -> int:
    """How many ranges the decode kernel splits ``n_keys`` visible keys of
    each of ``blocks`` (B * Hkv) sweeps into: enough for about
    ``SPLIT_BLOCKS`` blocks on the card (the power of two at or above
    SPLIT_BLOCKS / blocks), while every split keeps at least
    ``SPLIT_MIN_KEYS`` keys; at least 1."""
    want = 1 << max(0, -(-SPLIT_BLOCKS // max(blocks, 1)) - 1).bit_length()
    return max(1, min(n_keys // SPLIT_MIN_KEYS, want))


def split_bounds(lo: int, hi: int, splits: int) -> list[tuple[int, int]]:
    """The key range of each split, as the decode kernel computes it."""
    n = max(hi - lo, 0)
    return [(lo + s * n // splits, lo + (s + 1) * n // splits) for s in range(splits)]


_COUNTS: dict = {}   # device -> int32 zeros: the decode kernel's split counts


def _split_counts(device: torch.device, n: int) -> torch.Tensor:
    """The decode kernel's per-(b, kv head) counts of finished splits on
    ``device``: zeros that every launch leaves zero again (its last block
    of each (b, kv head) resets its count), so they are made once. The
    first decode call on a device must not be under CUDA-graph capture
    (the buffer is allocated then); launches on one device share them, so
    they run in stream order."""
    buf = _COUNTS.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("flash_attention_cuda: the first decode call on a device "
                               "(or one with more (b, kv head) pairs) is under graph capture")
        buf = _COUNTS[device] = torch.zeros(max(n, 1 << 16), dtype=torch.int32,
                                            device=device)
    return buf


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
    """Launch the route's kernel on the current stream. q, k, v: f32 or
    bf16 alike, on one CUDA device, any strides whose last dim is
    contiguous and whose rows start on 16-byte boundaries (the model's
    (B, S, H, dh) tensors seen as (B, H, S, dh) qualify); dh in
    ``HEAD_DIMS``; Hq a multiple of Hkv. The output has q's strides.
    ``flash_attention_cuda.launches`` counts calls and ``.routes`` the calls
    of each route."""
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
    rows = (hq // hkv) * sq
    if rows <= MAX_DECODE_ROWS:
        route = "decode_split"
    elif q.dtype == torch.bfloat16 and dh in WGMMA_HEAD_DIMS:
        route = "wgmma"
    else:
        route = "tile_f32"
    strides = [(ctypes.c_longlong * 3)(*t.stride()[:3]) for t in (q, k, v, out)]
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ROW_DTYPES[q.dtype],
            b, hq, hkv, sq, skv, dh, *strides, int(causal), int(window), int(q_offset),
            float(softcap), float(scale)]
    argtypes = _ARGTYPES
    if route == "decode_split":
        lo, hi = visible_key_range(sq, skv, causal=causal, window=window,
                                   q_offset=q_offset)
        splits = decode_splits(hi - lo, b * hkv)
        ws = count = None
        if splits > 1:
            ws = torch.empty((b, hkv, splits, rows, dh + 2), dtype=torch.float32,
                             device=q.device)
            count = _split_counts(q.device, b * hkv)
        args += [lo, hi, splits, None if ws is None else ws.data_ptr(),
                 None if count is None else count.data_ptr()]
        argtypes = _ARGTYPES + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib_name, fn_name = _ROUTES[route]
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes, fn.restype = argtypes + [ctypes.c_void_p], ctypes.c_int
    with torch.cuda.device(q.device):
        rc = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    count_launch(flash_attention_cuda, route)
    _build.check(lib, lib_name, rc)
    return out


# the launch functions' arguments, before a route's own and the stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)] * 4
             + [ctypes.c_int] * 3 + [ctypes.c_float] * 2)
# route -> (library, launch function)
_ROUTES = {"decode_split": ("flashattn", "flashattn_decode_launch"),
           "wgmma": ("flashattn_wgmma", "flashattn_wgmma_launch"),
           "tile_f32": ("flashattn", "flashattn_tile_launch")}
flash_attention_cuda.launches = 0  # calls that launched a kernel, since the last reset
flash_attention_cuda.routes = {route: 0 for route in _ROUTES}  # the same, by route
