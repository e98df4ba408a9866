"""Recsys feature-interaction ops: dot (DLRM), FM, and multi-head
self-attention over field embeddings (AutoInt), as the reference's
``layers/interactions.py``. Wide&Deep's concat interaction is a reshape in
``models/recsys.py``."""
from __future__ import annotations

import dataclasses

import torch

from ..dist.sharding import is_dtensor, on_local_rows
from ..utils import resolve_device
from .common import dense_init


def dot_interaction(feats: torch.Tensor, keep_self: bool = False) -> torch.Tensor:
    """DLRM's pairwise dots. feats (B, F, d) -> (B, F(F-1)/2), the upper
    triangle in row-major order (with the diagonal: ``keep_self``)."""
    if is_dtensor(feats):   # each row alone: on each rank's rows (DTensor's rules
        return on_local_rows(dot_interaction, feats, keep_self)   # for the gather fail)
    f = feats.shape[1]
    dots = torch.einsum("bfd,bgd->bfg", feats, feats)
    iu, ju = torch.triu_indices(f, f, offset=0 if keep_self else 1, device=feats.device)
    return dots[:, iu, ju]


def fm_interaction(feats: torch.Tensor) -> torch.Tensor:
    """The factorization machine's second-order term,
    0.5 * ((sum v)^2 - sum v^2) summed over d: (B, F, d) -> (B,)."""
    s = feats.sum(dim=1)
    s2 = (feats * feats).sum(dim=1)
    return 0.5 * torch.sum(s * s - s2, dim=-1)


@dataclasses.dataclass(frozen=True)
class FieldAttnConfig:
    n_fields: int
    d_embed: int
    n_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32  # total attention width (split across heads)


def init_field_attention(cfg: FieldAttnConfig, *, generator=None, device="cuda") -> dict:
    """The reference's tree, {"layer{i}": {"wq", "wk", "wv", "w_res"}}, each
    (d_in, d_attn) f32, fan-in truncated normal, drawn layer by layer in
    that order."""
    dev = resolve_device(device, meta=True)
    tree, d_in = {}, cfg.d_embed
    for i in range(cfg.n_layers):
        tree[f"layer{i}"] = {
            name: dense_init(torch.empty((d_in, cfg.d_attn), device=dev), d_in,
                             generator=generator)
            for name in ("wq", "wk", "wv", "w_res")}
        d_in = cfg.d_attn
    return tree


def field_attention(params, feats: torch.Tensor, cfg: FieldAttnConfig) -> torch.Tensor:
    """AutoInt's interacting layers: feats (B, F, d) -> (B, F * d_attn).
    ``params`` is the tree ({"layer{i}": {"wq", ...}}). Logits and the
    softmax in f32, the weights cast back to the input's dtype."""
    x = feats
    dh = cfg.d_attn // cfg.n_heads
    for i in range(cfg.n_layers):
        p = params[f"layer{i}"]
        dt = x.dtype
        shape = (*x.shape[:2], cfg.n_heads, dh)
        q = (x @ p["wq"].to(dt)).reshape(shape)
        k = (x @ p["wk"].to(dt)).reshape(shape)
        v = (x @ p["wv"].to(dt)).reshape(shape)
        logits = torch.einsum("bfhd,bghd->bhfg", q, k).float()
        a = torch.softmax(logits, dim=-1).to(dt)
        o = torch.einsum("bhfg,bghd->bfhd", a, v).reshape(*x.shape[:2], cfg.d_attn)
        x = torch.relu(o + x @ p["w_res"].to(dt))
    return x.reshape(x.shape[0], -1)
