"""Attention layers: GQA (with qk-norm, sliding window and soft cap) and
MLA (deepseek-v2).

The layer's attention core is chosen by its config, never by a failure:
- serving: the flash-attention kernel (``kernels.flashattn``):
  ``flash_attention`` on the card (its plain version on the CPU), or
  ``flash_attention_ref`` on any device when ``use_kernels`` is off;
- training (``GQAConfig.sdpa``, which ``models.transformer.loss_fn`` sets):
  ``sdpa``, the reference's XLA formulation of the same function, through
  which the reference trains (unchunked: the reference chunks KV only on a
  cache). The kernel has no backward
  (nor has the reference's), and ``flash_attention`` refuses inputs that
  require grad.

Caches are updated in place: ``gqa_attention`` writes the new k and v into
the given ``KVCache`` at ``q_offset`` and returns the same object (the
reference returns a new cache; on the card a second 8 GB cache would not
fit beside gemma3-27b).

MLA compresses queries and keys to low-rank latents; its cache holds the
``kv_lora`` latent (in ``k``) and the shared ``qk_rope_dim`` rope key (in
``v``) a token, written in place as GQA's is. Its core is ``sdpa``, as in
the reference: the flash-attention kernel takes one head dim for q, k and
v, and MLA's are 192, 192 and 128.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..kernels.flashattn import flash_attention, flash_attention_ref
from ..utils import resolve_device
from .mlp import draw_dense
from .norm import rms_norm
from .rope import apply_rope

BIG_WINDOW = 2**30


@dataclasses.dataclass
class KVCache:
    """Decode-time cache. GQA: k/v are (B, S_max, Hkv, dh) for one layer,
    (L, B, S_max, Hkv, dh) for a model. MLA: k is the latent (B, S_max,
    kv_lora), v the rope key (B, S_max, qk_rope_dim)."""

    k: torch.Tensor
    v: torch.Tensor


# ---------------------------------------------------------------------------
# The reference's masked softmax attention core (plain, both branches)
# ---------------------------------------------------------------------------

def _chunk_logits(qg, k_chunk, c0, *, causal, window, softcap, scale,
                  q_positions, kv_valid_len):
    """f32 masked logits of one KV chunk: (B, Hkv, G, S, Tc)."""
    b, s = qg.shape[0], qg.shape[1]
    tc = k_chunk.shape[1]
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k_chunk.float()) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    q_pos = q_positions[:, None, None, :, None]                 # (B,1,1,S,1)
    k_pos = c0 + torch.arange(tc, device=qg.device)[None, None, None, None, :]
    mask = torch.ones((b, 1, 1, s, tc), dtype=torch.bool, device=qg.device)
    if causal:
        mask &= k_pos <= q_pos
    mask &= (q_pos - k_pos) < (window if window > 0 else BIG_WINDOW)
    if isinstance(kv_valid_len, int):   # a Python int needs no copy to the card
        mask &= k_pos < kv_valid_len
    elif kv_valid_len is not None:
        kvv = torch.as_tensor(kv_valid_len, device=qg.device)
        mask &= k_pos < kvv.reshape(-1, 1, 1, 1, 1)
    return logits.masked_fill(~mask, -1e30)


def sdpa(q, k, v, *, causal: bool, window: int, softcap: float, scale: float,
         q_positions, kv_valid_len=None, kv_chunk: int = 0) -> torch.Tensor:
    """The reference's ``sdpa``: q (B, S, Hq, dh), k/v (B, T, Hkv, dh) ->
    (B, S, Hq, dv), GQA grouped inside the products, f32 logits and
    softmax; ``q_positions`` (B, S); ``kv_valid_len`` masks the cache tail.
    As the reference, it rounds p to v's dtype before p . v, and its
    chunked branch (``kv_chunk > 0``, T a multiple of it and above twice
    it, S > 1) accumulates in v's dtype: in bf16 it is not the kernel's
    function to the last bit (the kernel keeps p and the sum in f32)."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dv = v.shape[-1]
    qg = q.reshape(b, s, hkv, g, dh)
    kwargs = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                  q_positions=q_positions, kv_valid_len=kv_valid_len)

    if kv_chunk > 0 and t > 2 * kv_chunk and t % kv_chunk == 0 and s > 1:
        m = torch.full((b, hkv, g, s), -1e30, device=q.device)
        l = torch.zeros((b, hkv, g, s), device=q.device)
        acc = torch.zeros((b, hkv, g, s, dv), dtype=v.dtype, device=q.device)
        for c0 in range(0, t, kv_chunk):
            kc, vc = k[:, c0:c0 + kv_chunk], v[:, c0:c0 + kv_chunk]
            lg = _chunk_logits(qg, kc, c0, **kwargs)
            m_cur = torch.maximum(m, lg.amax(dim=-1))
            alpha = torch.exp(m - m_cur)
            p = torch.exp(lg - m_cur[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgst,btkd->bkgsd", p.to(vc.dtype), vc)
            acc = acc * alpha[..., None].to(acc.dtype) + pv
            m = m_cur
        out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
        return torch.movedim(out, 3, 1).reshape(b, s, hq, dv)

    logits = _chunk_logits(qg, k, 0, **kwargs)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v)
    return out.reshape(b, s, hq, dv)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GQAConfig:
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    qk_norm: bool = False
    softcap: float = 0.0
    causal: bool = True
    use_kernels: bool = True   # the flash-attention kernel, or its plain version
    sdpa: bool = False         # the reference's sdpa instead (training)


class GQA(nn.Module):
    """wq (d, Hq, dh), wk/wv (d, Hkv, dh), wo (Hq, dh, d): the reference's
    layouts; q_norm/k_norm (dh,) f32 with qk-norm."""

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        for name, t in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo),
                        ("q_norm", q_norm), ("k_norm", k_norm)):
            self.register_parameter(
                name, None if t is None else nn.Parameter(t, requires_grad=False))


def init_gqa(cfg: GQAConfig, *, generator=None, device="cuda",
             dtype=torch.float32) -> GQA:
    """Fan-in truncated-normal projections drawn in f32, stored in
    ``dtype``; the qk-norm scales are f32 ones."""
    dev = resolve_device(device, meta=True)
    draw = dict(generator=generator, device=dev, dtype=dtype)
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    norms = ()
    if cfg.qk_norm:
        norms = (torch.ones((dh,), device=dev), torch.ones((dh,), device=dev))
    return GQA(draw_dense((d, h, dh), d, **draw), draw_dense((d, kv, dh), d, **draw),
               draw_dense((d, kv, dh), d, **draw), draw_dense((h, dh, d), h * dh, **draw),
               *norms)


def gqa_attention(params: GQA, x: torch.Tensor, cfg: GQAConfig, *,
                  q_offset: int, rope_theta: float, window: int,
                  cache: Optional[KVCache] = None,
                  kv_valid_len: Optional[int] = None
                  ) -> tuple[torch.Tensor, Optional[KVCache]]:
    """x (B, S, D) at positions ``q_offset + arange(S)`` (as the
    reference's ``forward`` always builds them; ``q_offset`` is also the
    cache write offset) -> (y (B, S, D), cache).

    With a cache, the new k and v are written into it in place and the
    keys are the cache sliced to ``[:kv_valid_len]`` (a view; the whole
    cache when it is None). The reference masks ``k_pos < kv_valid_len``
    over the whole cache instead; the slice gives the same result, and
    under causality (every row's keys end at its own position) so does the
    whole cache. ``q_offset`` and ``kv_valid_len`` are Python ints: the
    decode loop keeps its position on the host, so no step reads a device
    scalar back."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params.wq.to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params.wv.to(dt))
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm)
        k = rms_norm(k, params.k_norm)
    s = x.shape[1]
    positions = torch.arange(q_offset, q_offset + s, device=x.device)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    if cache is not None:
        cache.k[:, q_offset:q_offset + s] = k
        cache.v[:, q_offset:q_offset + s] = v
        t = cache.k.shape[1] if kv_valid_len is None else kv_valid_len
        k, v = cache.k[:, :t].to(dt), cache.v[:, :t].to(dt)

    if cfg.sdpa:   # unchunked, as the reference's training path (no cache)
        out = sdpa(q, k, v, causal=cfg.causal, window=window, softcap=cfg.softcap,
                   scale=cfg.d_head ** -0.5, q_positions=positions.expand(x.shape[0], s))
    else:
        core = flash_attention if cfg.use_kernels else flash_attention_ref
        out = core(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   causal=cfg.causal, window=window, softcap=cfg.softcap,
                   q_offset=q_offset, scale=cfg.d_head ** -0.5).transpose(1, 2)
    y = torch.einsum("bshk,hkd->bsd", out, params.wo.to(dt))
    return y, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    softcap: float = 0.0
    causal: bool = True
    kv_chunk: int = 0   # sdpa's online-softmax chunk on the cache path


class MLA(nn.Module):
    """w_dq (d, q_lora), q_norm (q_lora,) f32, w_uq (q_lora, H, dn + dr),
    w_dkv (d, kv_lora), kv_norm (kv_lora,) f32, w_uk (kv_lora, H, dn),
    w_uv (kv_lora, H, dv), w_kr (d, dr), wo (H, dv, d): the reference's
    layouts."""

    NAMES = ("w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv", "w_kr", "wo")

    def __init__(self, **weights):
        super().__init__()
        for name in self.NAMES:
            self.register_parameter(name, nn.Parameter(weights[name], requires_grad=False))


def init_mla(cfg: MLAConfig, *, generator=None, device="cuda",
             dtype=torch.float32) -> MLA:
    """Fan-in truncated-normal projections drawn in f32, stored in
    ``dtype``; the two latent norms' scales are f32 ones."""
    dev = resolve_device(device, meta=True)
    draw = dict(generator=generator, device=dev, dtype=dtype)
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return MLA(
        w_dq=draw_dense((d, cfg.q_lora), d, **draw),
        q_norm=torch.ones((cfg.q_lora,), device=dev),
        w_uq=draw_dense((cfg.q_lora, h, dn + dr), cfg.q_lora, **draw),
        w_dkv=draw_dense((d, cfg.kv_lora), d, **draw),
        kv_norm=torch.ones((cfg.kv_lora,), device=dev),
        w_uk=draw_dense((cfg.kv_lora, h, dn), cfg.kv_lora, **draw),
        w_uv=draw_dense((cfg.kv_lora, h, dv), cfg.kv_lora, **draw),
        w_kr=draw_dense((d, dr), d, **draw),
        wo=draw_dense((h, dv, d), h * dv, **draw))


def mla_attention(params: MLA, x: torch.Tensor, cfg: MLAConfig, *,
                  q_offset: int, rope_theta: float, window: int,
                  cache: Optional[KVCache] = None,
                  kv_valid_len: Optional[int] = None
                  ) -> tuple[torch.Tensor, Optional[KVCache]]:
    """x (B, S, D) at positions ``q_offset + arange(S)`` -> (y (B, S, D),
    cache). With a cache, the latent and the rope key are written into it
    in place and the keys are the whole cache, masked past
    ``kv_valid_len`` as the reference does, so ``sdpa`` takes the
    reference's branch (chunked when the cache is a multiple of
    ``kv_chunk`` above twice it and S > 1)."""
    dt = x.dtype
    b, s = x.shape[:2]
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    positions = torch.arange(q_offset, q_offset + s, device=x.device)

    cq = rms_norm(x @ params.w_dq.to(dt), params.q_norm)
    q = torch.einsum("bsl,lhk->bshk", cq, params.w_uq.to(dt))
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], positions, rope_theta)
    ckv = rms_norm(x @ params.w_dkv.to(dt), params.kv_norm)          # (B, S, kv_lora)
    k_rope = apply_rope((x @ params.w_kr.to(dt))[:, :, None, :], positions,
                        rope_theta)[:, :, 0, :]                       # (B, S, dr)

    if cache is not None:
        cache.k[:, q_offset:q_offset + s] = ckv
        cache.v[:, q_offset:q_offset + s] = k_rope
        ckv, k_rope = cache.k.to(dt), cache.v.to(dt)

    k_nope = torch.einsum("btl,lhk->bthk", ckv, params.w_uk.to(dt))
    v = torch.einsum("btl,lhk->bthk", ckv, params.w_uv.to(dt))
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(*k_nope.shape[:3], dr)], dim=-1)
    out = sdpa(torch.cat([q_nope, q_rope], dim=-1), k, v, causal=cfg.causal,
               window=window, softcap=cfg.softcap, scale=(dn + dr) ** -0.5,
               q_positions=positions.expand(b, s), kv_valid_len=kv_valid_len,
               kv_chunk=cfg.kv_chunk if cache is not None else 0)
    y = torch.einsum("bshk,hkd->bsd", out, params.wo.to(dt))
    return y, cache
