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

Training (``loss_fn``) takes the reference's parameter tree: nested dicts
with the reference's keys and leaves (``embed``, ``final_norm``,
``dense_layer{i}``, ``layers`` stacked on axis 0 over the scanned layers,
``unembed`` when untied), so a leaf walk in sorted key order (the
optimizer's grad norm and clipping, the checkpoints) meets the same leaves
in the same order as the reference's. ``transformer_tree`` makes that tree
from a ``Transformer``; ``init_transformer(f32_masters=True)`` draws f32
master weights, which every layer casts to ``cfg.dtype`` at each use, as
the reference does. The bridge from the tree to the model's functions is
attribute views (``utils.TreeView``; ``model_view`` unbinds the stacked
layers), not ``torch.func.functional_call``: with ``remat`` each ``Block``
runs under ``torch.utils.checkpoint`` (non-reentrant), which recomputes it
during the backward pass, after a ``functional_call`` would have put the
module's own parameters back; a view holds the tree's tensors for the
whole step. Under ``loss_fn`` (``forward(train=True)``) GQA's core is
``sdpa`` (the reference trains through it; the flash-attention kernel has
no backward), selected by the config the loss passes down
(``attn_cfg(train=True)``), and ``remat`` applies; serving does neither. The LM loss is a
sequence-chunked cross entropy: each chunk's f32 logits are made, reduced
and, under grad, recomputed in the backward pass (a checkpoint a chunk), so
the (B, S, V) logits never exist at once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import DP, TP, is_dtensor, lay_out, shard_activation, take_last, zeros_on
from ..layers.attention import (
    GQA, MLA, GQAConfig, KVCache, MLAConfig, gqa_attention, init_gqa, init_mla,
    mla_attention)
from ..layers.embedding import embed_tokens, init_token_embedding, unembed
from ..layers.mlp import MLP, MLPConfig, init_mlp, mlp
from ..layers.moe import MoE, MoEConfig, init_moe, moe_layer
from ..layers.norm import rms_norm
from ..utils import TreeView, param_tree, resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's fields but ``scan_unroll`` (XLA's scan). ``remat``
    checkpoints each ``Block`` under ``forward(train=True)``;
    ``loss_chunk`` is the CE loss's sequence chunk. ``attn_chunk`` is
    ``sdpa``'s KV chunk on a cache (MLA; GQA's flash-attention kernel
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
    remat: bool = True
    loss_chunk: int = 512
    use_kernels: bool = True

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_scanned(self) -> int:
        return self.n_layers - self.first_dense

    def attn_cfg(self, train: bool = False):
        """The attention layer's config; ``train`` selects GQA's training
        core, the reference's ``sdpa``."""
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
                         use_kernels=self.use_kernels, sdpa=train)

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


def block_forward(lp, x, cfg: TransformerConfig, attn_cfg, *, q_offset: int,
                  theta: float, window: int, cache: Optional[KVCache],
                  kv_valid: Optional[int]):
    """The reference's ``_layer_fwd`` on a ``Block`` or a view of a layer's
    tree -> (x, the MoE's aux dict or None)."""
    attn_fn = mla_attention if cfg.attn_kind == "mla" else gqa_attention
    # on a mesh the sequence is gathered before the projections (sequence
    # parallelism's all-gather); lay_out is the identity on plain tensors
    h = lay_out(rms_norm(x, lp.attn_norm, unit_offset=cfg.sandwich_norm), DP)
    attn_out, cache = attn_fn(
        lp.attn, h, attn_cfg, q_offset=q_offset, rope_theta=theta,
        window=window, cache=cache, kv_valid_len=kv_valid)
    # the branch outputs take the residual's layout where they are made, so
    # their gradients come back sequence-gathered (torch 2.11's DTensor
    # cannot fold a sequence-sharded gradient into its product's rows)
    attn_out = shard_activation(attn_out, DP, TP, None)
    if cfg.sandwich_norm:
        attn_out = rms_norm(attn_out, lp.post_attn_norm, unit_offset=True)
    x = x + attn_out
    x = shard_activation(x, DP, TP, None)
    h = lay_out(rms_norm(x, lp.ffn_norm, unit_offset=cfg.sandwich_norm), DP)
    aux = None
    if lp.moe is not None:
        ffn_out, aux = moe_layer(lp.moe, h, cfg.moe_cfg())
    else:
        ffn_out = mlp(lp.mlp, h, cfg.mlp_cfg())
    ffn_out = shard_activation(ffn_out, DP, TP, None)
    if cfg.sandwich_norm:
        ffn_out = rms_norm(ffn_out, lp.post_ffn_norm, unit_offset=True)
    return shard_activation(x + ffn_out, DP, TP, None), aux


class Block(nn.Module):
    """One layer: attention (GQA or MLA) and a feed-forward block (an MLP,
    or MoE), each behind an RMSNorm (and, with sandwich norms, followed by
    one); ``forward`` is ``block_forward``."""

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
        return block_forward(self, x, cfg, cfg.attn_cfg(), q_offset=q_offset,
                             theta=theta, window=window, cache=cache, kv_valid=kv_valid)


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
                     device="cuda", f32_masters: bool = False) -> Transformer:
    """A model drawn from ``seed``: the token table first, then each layer
    in order (its attention, then its MLP or MoE), each weight drawn in f32
    and stored in ``cfg.dtype`` (but norm scales and routers), or kept in
    f32 with ``f32_masters`` (training: the reference's masters, cast to
    ``cfg.dtype`` at each use; the same draws). Layers below
    ``first_dense`` are dense. ``device="meta"`` builds shapes only."""
    dev = resolve_device(device, meta=True)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    draw = dict(generator=gen, device=dev,
                dtype=torch.float32 if f32_masters else cfg.dtype)
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

def forward(model, tokens: torch.Tensor, cfg: TransformerConfig, *,
            cache: Optional[KVCache] = None, cache_pos: int = 0,
            kv_valid: Optional[int] = None, train: bool = False):
    """tokens (B, S) at positions ``cache_pos + arange(S)`` -> (hidden
    (B, S, D) after the final norm, the cache, updated in place, the MoE
    layers' aux loss summed: an f32 scalar, 0 without MoE). ``model`` is a
    ``Transformer`` or a ``model_view`` of a tree. ``train`` runs GQA
    through ``sdpa`` and, with ``cfg.remat``, recomputes each layer in the
    backward pass."""
    tokens = torch.as_tensor(tokens, device=model.embed.device)
    x = embed_tokens(model.embed, tokens, cfg.dtype, scale=cfg.embed_scale)
    x = shard_activation(x, DP, TP, None)
    windows, thetas = cfg.layer_meta()
    attn_cfg = cfg.attn_cfg(train=train)
    remat = train and cfg.remat
    aux_total = torch.zeros((), device=x.device)
    for i, layer in enumerate(model.layers):
        kw = dict(q_offset=cache_pos, theta=float(thetas[i]), window=int(windows[i]),
                  cache=None if cache is None else KVCache(k=cache.k[i], v=cache.v[i]),
                  kv_valid=kv_valid)
        if remat:
            x, aux = checkpoint(block_forward, layer, x, cfg, attn_cfg, **kw,
                                use_reentrant=False)
        else:
            x, aux = block_forward(layer, x, cfg, attn_cfg, **kw)
        if aux is not None:
            aux_total = aux_total + aux["aux_loss"]
    return rms_norm(x, model.final_norm, unit_offset=cfg.sandwich_norm), cache, aux_total


def logits_from_hidden(model, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    table = model.embed if cfg.tie_embeddings else model.unembed
    return unembed(table, x, cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Training: the reference's parameter tree, and the loss
# ---------------------------------------------------------------------------

def transformer_tree(model: Transformer, cfg: TransformerConfig) -> dict:
    """The model's parameters as the reference's tree (see the module
    docstring): the scanned layers' leaves stacked on a new axis 0 (a copy),
    the other leaves the model's own tensors."""
    layers = [param_tree(block) for block in model.layers]
    tree = {"embed": model.embed.detach(), "final_norm": model.final_norm.detach()}
    for i in range(cfg.first_dense):
        tree[f"dense_layer{i}"] = layers[i]
    scanned = layers[cfg.first_dense:]

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack(nodes)

    tree["layers"] = stack(scanned)
    if model.unembed is not None:
        tree["unembed"] = model.unembed.detach()
    return tree


_NORMS = ("attn_norm", "ffn_norm", "post_attn_norm", "post_ffn_norm")
_F32_LEAVES = ("q_norm", "k_norm", "kv_norm", "router", "final_norm")   # kept f32


def transformer_from_tree(tree: dict, cfg: TransformerConfig, *,
                          f32_masters: bool = False) -> Transformer:
    """The reference's tree (tensors, on one device) as a ``Transformer``:
    the stacked layers unstacked after the dense ones, weights cast to
    ``cfg.dtype`` (as the reference casts them at each use), norm scales and
    routers kept in f32; with ``f32_masters`` every leaf stays f32.
    Layouts are kept, so nothing is transposed."""
    def leaf(name, x):
        x = x.detach()
        keep = f32_masters or name in _F32_LEAVES or name in _NORMS
        return (x.float() if keep else x.to(cfg.dtype)).contiguous()

    def mlp_of(m):
        return MLP(leaf("w_up", m["w_up"]), leaf("w_down", m["w_down"]),
                   leaf("w_gate", m["w_gate"]) if "w_gate" in m else None)

    def block(lp):
        a = {n: leaf(n, x) for n, x in lp["attn"].items()}
        if cfg.attn_kind == "mla":
            attn = MLA(**a)
        else:
            attn = GQA(a["wq"], a["wk"], a["wv"], a["wo"], a.get("q_norm"), a.get("k_norm"))
        if "moe" in lp:
            m = lp["moe"]
            ffn = MoE(*(leaf(n, m[n]) for n in ("router", "w_gate", "w_up", "w_down")),
                      mlp_of(m["shared"]) if "shared" in m else None)
        else:
            ffn = mlp_of(lp["mlp"])
        return Block(attn, ffn, {n: leaf(n, lp[n]) for n in _NORMS if n in lp})

    def unstack(node, i):
        return {k: unstack(v, i) if isinstance(v, dict) else v[i] for k, v in node.items()}

    layers = [block(tree[f"dense_layer{i}"]) for i in range(cfg.first_dense)]
    layers += [block(unstack(tree["layers"], i)) for i in range(cfg.n_scanned)]
    unembed_table = None if cfg.tie_embeddings else leaf("unembed", tree["unembed"])
    return Transformer(leaf("embed", tree["embed"]), leaf("final_norm", tree["final_norm"]),
                       layers, unembed_table)


def model_view(tree: dict, cfg: TransformerConfig) -> TreeView:
    """A view of the reference's tree that ``forward`` reads as a model: its
    ``layers`` are the leading dense layers' views, then one a scanned
    layer, whose leaves are ``torch.unbind`` views of the stacked leaves
    (gradients flow back into the stacked tensors)."""
    def unbind(node, n):
        if isinstance(node, dict):
            parts = {k: unbind(v, n) for k, v in node.items()}
            return [{k: parts[k][i] for k in parts} for i in range(n)]
        return list(torch.unbind(node, 0))

    layers = [TreeView(tree[f"dense_layer{i}"]) for i in range(cfg.first_dense)]
    layers += [TreeView(t) for t in unbind(tree["layers"], cfg.n_scanned)]
    return TreeView({"embed": tree["embed"], "final_norm": tree["final_norm"],
                     "unembed": tree.get("unembed"), "layers": layers})


def _as_model(params, cfg: TransformerConfig):
    return params if isinstance(params, (Transformer, TreeView)) else model_view(params, cfg)


def _chunk_nll(table, h, labels, mask, softcap: float) -> torch.Tensor:
    """The masked NLL sum of one sequence chunk: f32 logits (as
    ``logits_from_hidden``), log-sum-exp, the label's logit."""
    logits = unembed(table, h, softcap)                           # (B, c, V) f32
    logits = shard_activation(logits, DP, None, TP)
    lse = torch.logsumexp(logits, dim=-1)
    ll = take_last(logits, labels)
    return torch.sum((lse - ll) * mask)


def chunked_ce_loss(model, hidden, labels, mask, cfg: TransformerConfig):
    """The reference's sequence-chunked CE: hidden (B, S, D), labels (B, S)
    in [0, V), mask (B, S) f32 -> the masked mean NLL, an f32 scalar. S is
    padded to a multiple of ``min(loss_chunk, S)``; chunk sums are added in
    order. Under grad each chunk is a checkpoint, so only one chunk's
    logits live at a time, in the backward pass too."""
    model = _as_model(model, cfg)
    table = model.embed if cfg.tie_embeddings else model.unembed
    hidden = lay_out(hidden, DP)   # on a mesh: the sequence gathered
    b, s, _ = hidden.shape
    chunk = min(cfg.loss_chunk, s)
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    labels = labels.long()
    tot = torch.zeros((), device=hidden.device)
    n = torch.zeros((), device=hidden.device)
    for c0 in range(0, s + pad, chunk):
        args = (table, hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk], cfg.logit_softcap)
        if torch.is_grad_enabled():
            tot = tot + checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            tot = tot + _chunk_nll(*args)
        n = n + torch.sum(args[3])
    return tot / torch.clamp(n, min=1.0)


def loss_fn(params, batch: dict, cfg: TransformerConfig):
    """batch: tokens (B, S), labels (B, S) (< 0 masked), numpy or tensors ->
    (loss, {"ce", "aux_loss"}): ``ce + aux_loss_weight * aux``. ``params``
    is the reference's tree (or a ``Transformer``); GQA runs through
    ``sdpa``."""
    model = _as_model(params, cfg)
    dev = model.embed.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    mask = (labels >= 0).float()
    hidden, _, aux = forward(model, tokens, cfg, train=True)
    ce = chunked_ce_loss(model, hidden, torch.clamp(labels, min=0), mask, cfg)
    return ce + cfg.aux_loss_weight * aux, {"ce": ce, "aux_loss": aux}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def prefill(model: Transformer, tokens, cfg: TransformerConfig, max_len: int):
    """Process a prompt: (last-token logits (B, 1, V) f32, cache, kv_len),
    kv_len the prompt length as a Python int."""
    tokens = torch.as_tensor(tokens, device=model.embed.device)
    b, s = tokens.shape
    if is_dtensor(model.embed):   # on a mesh: batch over DP, heads (latent) over TP
        k, v = cache_shapes(cfg, b, max_len)
        cache = KVCache(*(zeros_on(t.shape, t.dtype, model.embed, None, DP, None, TP)
                          for t in (k, v)))
    else:
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
