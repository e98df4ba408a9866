"""Plain PyTorch flash attention (GQA + causal + sliding window + soft cap):
the oracle of ``csrc/flashattn.cu`` and the CPU route of ``ops``.

It computes what ``src/repro/kernels/flashattn/ref.py::flash_attention_ref``
computes, with one stated difference. For each query row (absolute position
``q_offset + row``) a key at position ``j`` is visible when ``j < Skv``,
``j <= q_pos`` if ``causal``, and ``q_pos - j < window`` if ``window > 0``;
logits are ``(q . k) * scale`` in f32, soft-capped, masked to -1e30, and
softmaxed in f32; the output is cast to q's dtype.

A row that sees no key at all returns 0 here (and in the kernel, which
skips the key tiles no row of its tile can see). The reference's softmax of
equal -1e30 logits returns the mean of all Skv value rows there instead,
and the TPU kernel the mean over its padded length. Such a row arises only
off the serving path (a window that ends before every key, as with a
``q_offset`` past ``Skv`` or ``causal=False``): on the serving path every
row sees its own position, and then all three agree.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def visible_mask(sq: int, skv: int, *, causal: bool, window: int,
                 q_offset: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query row may see."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, dh), k/v (B, Hkv, Skv, dh) with Hq % Hkv == 0 ->
    (B, Hq, Sq, dh) in q's dtype. GQA groups the G = Hq / Hkv query heads
    of a kv head inside one product (no repeated copy of k and v); the
    (B, Hq, Sq, Skv) f32 logits are made once and reused in place."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    g = hq // hkv
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(b, hkv, g * sq, dh).float()
    s = torch.matmul(qg, k.float().transpose(-1, -2)).view(b, hkv, g, sq, skv)
    s.mul_(scale)
    if softcap > 0:
        s.div_(softcap).tanh_().mul_(softcap)
    mask = visible_mask(sq, skv, causal=causal, window=window,
                        q_offset=q_offset, device=q.device)
    s.masked_fill_(~mask, NEG_INF)
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    s.masked_fill_(~mask, 0.0)          # a row that sees no key gives 0
    s.div_(s.sum(dim=-1, keepdim=True).clamp_min_(1e-30))
    out = torch.matmul(s.view(b, hkv, g * sq, skv), v.float())
    return out.view(b, hq, sq, dh).to(q.dtype)
