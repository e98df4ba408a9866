"""Decoder-only transformer: the reference's LM family (gemma3, qwen3,
starcoder2: dense GQA; qwen2-moe: GQA + MoE; deepseek-v2: MLA + MoE with a
leading dense layer), for serving.

* one ``Block`` per layer in an ``nn.ModuleList`` (the reference scans over
  stacked layers): the ``first_dense`` leading dense layers come first, then
  the MoE (or dense) layers; gemma3's 5 local : 1 global sliding-window
  pattern and its dual rope thetas come from ``TransformerConfig.layer_meta``,
  as Python numbers a layer at a time;
* weights are drawn in f32 and stored in ``cfg.dtype`` once (the reference
  keeps f32 masters and casts them at each use: the same products, and at
  gemma3-27b's width f32 weights, 108 GB, would not fit on the card); norm
  scales and MoE routers stay f32;
* the cache is one (L, B, T, ...) pair updated in place (GQA: k and v;
  MLA: the latent and the rope key), and the decode position is a Python
  int, so a decode step reads nothing back from the card;
* every GQA layer's attention core is the flash-attention kernel
  (``layers/attention.py``); ``use_kernels=False`` runs its plain version.
  MLA's core is the plain ``sdpa``, as in the reference, and the MoE
  dispatch is plain PyTorch (``layers/moe.py``): neither has a TPU kernel.

The training loss is not ported yet: it raises ``NotImplementedError``
naming its ROADMAP item. Serving only: parameters do not require gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ..layers.attention import (
    GQAConfig, KVCache, MLAConfig, gqa_attention, init_gqa, init_mla, mla_attention)
from ..layers.embedding import embed_tokens, init_token_embedding, unembed
from ..layers.mlp import MLPConfig, init_mlp, mlp
from ..layers.moe import MoE, MoEConfig, init_moe, moe_layer
from ..layers.norm import rms_norm
from ..utils import resolve_device

_TRAINING = "ROADMAP.md §1 item 6 (training)"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's fields, but for its XLA execution (``remat``,
    ``scan_unroll``: XLA's remat and scan) and training (``loss_chunk``)
    ones. ``attn_chunk`` is read by MLA only (GQA's flash-attention kernel
    streams KV itself). ``use_kernels`` is the port's: the flash-attention
    kernel (default) or its plain version."""
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv: int = 2
    d_head: int = 64
    d_ff: int = 1024
    ffn_gated: bool = True
    ffn_act: str = "silu"
    vocab: int = 1000
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0    # gemma3 local layers use 10k vs 1M global
    qk_norm: bool = False
    attn_chunk: int = 0              # MLA: sdpa's online-softmax KV chunk
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    window: int = 0                  # sliding window for local layers
    local_ratio: int = 0             # N local layers per global (gemma3: 5)
    attn_kind: str = "gqa"           # gqa | mla
    # MLA
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # MoE
    n_experts: int = 0
    n_experts_alloc: int = 0         # pad experts to the EP axis (qwen: 64)
    moe_groups: int = 1              # dispatch token groups (see layers/moe.py)
    n_shared: int = 0
    top_k: int = 0
    d_expert: int = 0
    first_dense: int = 0             # leading dense layers (deepseek-v2: 1)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.001
    dtype: Any = torch.bfloat16
    embed_scale: bool = False        # gemma multiplies embeds by sqrt(D)
    sandwich_norm: bool = False      # gemma3 post-attn/post-ffn norms
    tie_embeddings: bool = True
    use_kernels: bool = True

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def attn_cfg(self):
        if self.attn_kind == "mla":
            return MLAConfig(d_model=self.d_model, n_heads=self.n_heads,
                             q_lora=self.q_lora, kv_lora=self.kv_lora,
                             qk_nope_dim=self.qk_nope_dim,
                             qk_rope_dim=self.qk_rope_dim,
                             v_head_dim=self.v_head_dim,
                             softcap=self.attn_softcap, kv_chunk=self.attn_chunk)
        return GQAConfig(d_model=self.d_model, n_heads=self.n_heads,
                         n_kv=self.n_kv, d_head=self.d_head,
                         qk_norm=self.qk_norm, softcap=self.attn_softcap,
                         use_kernels=self.use_kernels)

    def moe_cfg(self) -> MoEConfig:
        """As the reference's: ``normalize_weights`` keeps its default."""
        return MoEConfig(d_model=self.d_model, n_experts=self.n_experts,
                         top_k=self.top_k, d_expert=self.d_expert,
                         n_shared=self.n_shared,
                         capacity_factor=self.capacity_factor,
                         n_experts_alloc=self.n_experts_alloc,
                         n_groups=self.moe_groups)

    def mlp_cfg(self) -> MLPConfig:
        return MLPConfig(d_model=self.d_model, d_ff=self.d_ff,
                         act=self.ffn_act, gated=self.ffn_gated)

    def layer_meta(self) -> tuple[np.ndarray, np.ndarray]:
        """(windows, thetas) per layer. Layer i is local iff the 5:1-style
        pattern says so (pattern position ``local_ratio`` is the global)."""
        L = self.n_layers
        windows = np.zeros((L,), np.int32)
        thetas = np.full((L,), self.rope_theta, np.float32)
        if self.window > 0 and self.local_ratio > 0:
            period = self.local_ratio + 1
            local = (np.arange(L) % period) != (period - 1)
            windows = np.where(local, self.window, 0).astype(np.int32)
            if self.rope_theta_local > 0:
                thetas = np.where(local, self.rope_theta_local,
                                  self.rope_theta).astype(np.float32)
        elif self.window > 0:
            windows[:] = self.window
        return windows, thetas


class Block(nn.Module):
    """One layer: attention (GQA or MLA) and a feed-forward block (an MLP,
    or MoE), each behind an RMSNorm (and, with sandwich norms, followed by
    one); ``forward`` is the reference's ``_layer_fwd`` and returns (x,
    the MoE's aux dict or None)."""

    def __init__(self, attn: nn.Module, ffn: nn.Module, norms: dict):
        super().__init__()
        self.attn = attn
        if isinstance(ffn, MoE):
            self.moe, self.mlp = ffn, None
        else:
            self.mlp, self.moe = ffn, None
        for name, t in norms.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def forward(self, x, cfg: TransformerConfig, *, q_offset: int, theta: float,
                window: int, cache: Optional[KVCache], kv_valid: Optional[int]):
        attn_fn = mla_attention if cfg.attn_kind == "mla" else gqa_attention
        h = rms_norm(x, self.attn_norm, unit_offset=cfg.sandwich_norm)
        attn_out, cache = attn_fn(
            self.attn, h, cfg.attn_cfg(), q_offset=q_offset, rope_theta=theta,
            window=window, cache=cache, kv_valid_len=kv_valid)
        if cfg.sandwich_norm:
            attn_out = rms_norm(attn_out, self.post_attn_norm, unit_offset=True)
        x = x + attn_out
        h = rms_norm(x, self.ffn_norm, unit_offset=cfg.sandwich_norm)
        aux = None
        if self.moe is not None:
            ffn_out, aux = moe_layer(self.moe, h, cfg.moe_cfg())
        else:
            ffn_out = mlp(self.mlp, h, cfg.mlp_cfg())
        if cfg.sandwich_norm:
            ffn_out = rms_norm(ffn_out, self.post_ffn_norm, unit_offset=True)
        return x + ffn_out, aux


class Transformer(nn.Module):
    def __init__(self, embed, final_norm, layers, unembed_table=None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.unembed = (None if unembed_table is None
                        else nn.Parameter(unembed_table, requires_grad=False))


def _norms(cfg: TransformerConfig, dev) -> dict:
    """gemma's sandwich norms are stored as offsets from 1 (zeros); the
    plain pre-norms as scales (ones); all f32."""
    fill = torch.zeros if cfg.sandwich_norm else torch.ones
    names = ["attn_norm", "ffn_norm"]
    if cfg.sandwich_norm:
        names += ["post_attn_norm", "post_ffn_norm"]
    return {n: fill((cfg.d_model,), device=dev) for n in names}


def init_transformer(cfg: TransformerConfig, *, seed: int = 0,
                     device="cuda") -> Transformer:
    """A model drawn from ``seed``: the token table first, then each layer
    in order (its attention, then its MLP or MoE), each weight drawn in f32
    and stored in ``cfg.dtype`` (but norm scales and routers). Layers below
    ``first_dense`` are dense. ``device="meta"`` builds shapes only."""
    dev = resolve_device(device, meta=True)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    draw = dict(generator=gen, device=dev, dtype=cfg.dtype)
    embed = init_token_embedding(cfg.vocab, cfg.d_model, **draw)
    init_attn = init_mla if cfg.attn_kind == "mla" else init_gqa
    layers = []
    for i in range(cfg.n_layers):
        attn = init_attn(cfg.attn_cfg(), **draw)
        ffn = (init_moe(cfg.moe_cfg(), **draw) if cfg.is_moe and i >= cfg.first_dense
               else init_mlp(cfg.mlp_cfg(), **draw))
        layers.append(Block(attn, ffn, _norms(cfg, dev)))
    final_norm = (torch.zeros if cfg.sandwich_norm else torch.ones)(
        (cfg.d_model,), device=dev)
    unembed_table = (None if cfg.tie_embeddings
                     else init_token_embedding(cfg.vocab, cfg.d_model, **draw))
    return Transformer(embed, final_norm, layers, unembed_table)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def cache_shapes(cfg: TransformerConfig, batch: int, max_len: int, dtype=None):
    """(k, v) on the meta device: the shapes and dtype ``init_cache`` makes.
    GQA: (L, B, T, Hkv, dh) twice; MLA: (L, B, T, kv_lora) and (L, B, T,
    qk_rope_dim)."""
    lead = (cfg.n_layers, batch, max_len)
    if cfg.attn_kind == "mla":
        shapes = (lead + (cfg.kv_lora,), lead + (cfg.qk_rope_dim,))
    else:
        shapes = (lead + (cfg.n_kv, cfg.d_head),) * 2
    dt = dtype or cfg.dtype
    return tuple(torch.empty(shp, dtype=dt, device="meta") for shp in shapes)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> KVCache:
    """A zeroed cache pair of ``cache_shapes``."""
    k, v = cache_shapes(cfg, batch, max_len, dtype)
    dev = resolve_device(device)
    return KVCache(k=torch.zeros_like(k, device=dev), v=torch.zeros_like(v, device=dev))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(model: Transformer, tokens: torch.Tensor, cfg: TransformerConfig, *,
            cache: Optional[KVCache] = None, cache_pos: int = 0,
            kv_valid: Optional[int] = None):
    """tokens (B, S) at positions ``cache_pos + arange(S)`` -> (hidden
    (B, S, D) after the final norm, the cache, updated in place, the MoE
    layers' aux loss summed: an f32 scalar, 0 without MoE)."""
    tokens = torch.as_tensor(tokens, device=model.embed.device)
    x = embed_tokens(model.embed, tokens, cfg.dtype, scale=cfg.embed_scale)
    windows, thetas = cfg.layer_meta()
    aux_total = torch.zeros((), device=x.device)
    for i, layer in enumerate(model.layers):
        layer_cache = None if cache is None else KVCache(k=cache.k[i], v=cache.v[i])
        x, aux = layer(x, cfg, q_offset=cache_pos, theta=float(thetas[i]),
                       window=int(windows[i]), cache=layer_cache, kv_valid=kv_valid)
        if aux is not None:
            aux_total = aux_total + aux["aux_loss"]
    return rms_norm(x, model.final_norm, unit_offset=cfg.sandwich_norm), cache, aux_total


def logits_from_hidden(model: Transformer, x: torch.Tensor,
                       cfg: TransformerConfig) -> torch.Tensor:
    table = model.embed if cfg.tie_embeddings else model.unembed
    return unembed(table, x, cfg.logit_softcap)


def chunked_ce_loss(model, hidden, labels, mask, cfg: TransformerConfig):
    raise NotImplementedError(f"chunked_ce_loss: {_TRAINING}")


def loss_fn(model, batch: dict, cfg: TransformerConfig):
    raise NotImplementedError(f"loss_fn: {_TRAINING}")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def prefill(model: Transformer, tokens, cfg: TransformerConfig, max_len: int):
    """Process a prompt: (last-token logits (B, 1, V) f32, cache, kv_len),
    kv_len the prompt length as a Python int."""
    tokens = torch.as_tensor(tokens, device=model.embed.device)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, device=model.embed.device)
    hidden, cache, _ = forward(model, tokens, cfg, cache=cache, cache_pos=0,
                               kv_valid=s)
    return logits_from_hidden(model, hidden[:, -1:], cfg), cache, s


def decode_step(model: Transformer, token, cache: KVCache, pos: int,
                cfg: TransformerConfig):
    """One decode step: token (B, 1) at position ``pos`` (a Python int) ->
    (logits (B, 1, V), the cache, updated in place)."""
    hidden, cache, _ = forward(model, token, cfg, cache=cache, cache_pos=pos,
                               kv_valid=pos + 1)
    return logits_from_hidden(model, hidden, cfg), cache


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)
