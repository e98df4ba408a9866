"""GCN (Kipf & Welling) over edge lists, full batch and on sampled
subgraphs, as the reference's ``models/gcn.py``.

Message passing is ``layers.segment.gather_scatter`` over an edge index
(-1 padding edges add nothing); the symmetric normalization weights are
computed once a forward. The parameters are the reference's tree, a flat
dict ``{"w{i}": (d_in, d_out), "b{i}": (d_out,)}`` of f32 tensors, which
the trainer and the optimizer take as it is. ``gcn_batched_graphs`` runs
the single-graph forward on each graph in turn (the reference vmaps it).
"""
from __future__ import annotations

import dataclasses

import torch

from ..dist.sharding import take_last
from ..layers.common import dense_init
from ..layers.segment import gather_scatter, sym_norm_weights
from ..utils import resolve_device


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn"
    n_layers: int = 2
    d_feat: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    agg: str = "mean"       # the paper's aggregator (sym-normalized)
    sym_norm: bool = True
    dropout: float = 0.0    # kept 0 for determinism
    dtype: object = torch.float32


def init_gcn(cfg: GCNConfig, *, seed: int = 0, device="cuda") -> dict:
    """``w{i}`` fan-in truncated normal, drawn layer by layer from ``seed``,
    and ``b{i}`` zeros, all f32."""
    dev = resolve_device(device, meta=True)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    params = {f"w{i}": dense_init(torch.empty((dims[i], dims[i + 1]), device=dev), dims[i],
                                  generator=gen)
              for i in range(cfg.n_layers)}
    params.update({f"b{i}": torch.zeros((dims[i + 1],), device=dev)
                   for i in range(cfg.n_layers)})
    return params


def gcn_forward(params: dict, feats, edge_src, edge_dst, cfg: GCNConfig) -> torch.Tensor:
    """feats (N, d_feat), edges (E,) with -1 padding -> logits (N,
    n_classes) f32, on the parameters' device."""
    dev = params["w0"].device
    x = torch.as_tensor(feats, device=dev).to(cfg.dtype)
    n = x.shape[0]
    src = torch.as_tensor(edge_src, device=dev)
    dst = torch.as_tensor(edge_dst, device=dev)
    w = sym_norm_weights(src, dst, n) if cfg.sym_norm else None
    agg = "sum" if cfg.sym_norm else cfg.agg
    for i in range(cfg.n_layers):
        x = x @ params[f"w{i}"].to(cfg.dtype) + params[f"b{i}"].to(cfg.dtype)
        # the self loop, with sym norm, folds into + x
        x = gather_scatter(x, src, dst, n, agg=agg, edge_weight=w) + x * 1.0
        if i < cfg.n_layers - 1:
            x = torch.relu(x)
    return x.float()


def gcn_loss(params: dict, batch: dict, cfg: GCNConfig):
    """batch: feats (N, d), edge_src/edge_dst (E,), labels (N,) (< 0: no
    label), optional label_mask (N,) -> (masked mean NLL, {"acc"})."""
    logits = gcn_forward(params, batch["feats"], batch["edge_src"], batch["edge_dst"], cfg)
    raw = torch.as_tensor(batch["labels"], device=logits.device).long()
    labels = torch.clamp(raw, min=0)
    mask = (raw >= 0).float()
    if "label_mask" in batch:
        mask = mask * torch.as_tensor(batch["label_mask"], device=logits.device).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = take_last(logits, labels)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum((lse - ll) * mask) / denom
    acc = torch.sum((torch.argmax(logits, dim=-1) == labels) * mask) / denom
    return loss, {"acc": acc}


def gcn_batched_graphs(params: dict, feats, edge_src, edge_dst,
                       cfg: GCNConfig) -> torch.Tensor:
    """The molecule shape: feats (G, N, d), edges (G, E) -> graph logits
    (G, C), each graph's node logits mean-pooled."""
    dev = params["w0"].device
    feats = torch.as_tensor(feats, device=dev)
    src = torch.as_tensor(edge_src, device=dev)
    dst = torch.as_tensor(edge_dst, device=dev)
    return torch.stack([gcn_forward(params, feats[g], src[g], dst[g], cfg).mean(dim=0)
                        for g in range(feats.shape[0])])
