"""RecSys models: two-tower retrieval, Wide&Deep, DLRM-RM2, AutoInt.

Shared substrate, as the reference's: one (F, V, d) embedding table a model
(a row block per sparse field), a single-hot lookup per field
(``layers.embedding.multi_field_lookup``), the dense stack, and the
interaction ops of ``layers/interactions.py``.

The two-tower model's item tower outputs are the corpus the range engine
indexes; a user query is served by brute force (the rangescan kernel) or
through the graph engine. Its towers are ``Tower`` modules; the CTR kinds
are the reference's parameter tree itself (nested dicts of tensors with
its keys), as the GCN's is. Every function here (forward, losses) computes
on that tree, which ``recsys_tree`` gives for either form (the towers name
their parameters as its keys), so the trainer and the optimizer walk the
same leaves in the same order as the reference's. Parameters are frozen in
the towers; training differentiates the tree's tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import is_dtensor, replicate_like, take_last
from ..layers.common import embed_init
from ..layers.embedding import multi_field_lookup
from ..layers.interactions import (
    FieldAttnConfig, dot_interaction, field_attention, init_field_attention)
from ..layers.mlp import DenseStack, dense_stack, init_dense_stack
from ..utils import param_tree, resolve_device

KINDS = ("two_tower", "wide_deep", "dlrm", "autoint")
TEMPERATURE = 0.05   # the two-tower loss's softmax temperature
IN_BATCH_ROWS = 8192  # rows of the in-batch logits the two-tower loss makes at once


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str = "dlrm"
    kind: str = "dlrm"          # two_tower | wide_deep | dlrm | autoint
    n_dense: int = 0
    n_sparse: int = 26
    vocab: int = 100_000        # rows per field table
    d_embed: int = 64
    mlp_dims: tuple = (512, 256)          # deep/top tower hidden dims
    bot_mlp_dims: tuple = ()              # dlrm bottom mlp (dense features)
    # two-tower
    n_sparse_item: int = 0                # item-side fields (two_tower)
    d_out: int = 256                      # tower output dim
    # autoint
    attn_layers: int = 3
    attn_heads: int = 2
    d_attn: int = 32
    dtype: Any = torch.float32

    def field_attn_cfg(self) -> FieldAttnConfig:
        return FieldAttnConfig(n_fields=self.n_sparse, d_embed=self.d_embed,
                               n_layers=self.attn_layers, n_heads=self.attn_heads,
                               d_attn=self.d_attn)

    def tower_fields(self, side: str) -> int:
        if side == "user":
            return self.n_sparse
        if side == "item":
            return self.n_sparse_item or self.n_sparse
        raise ValueError(f"unknown tower {side!r}")

    def tower_dims(self, side: str) -> tuple:
        return ((self.tower_fields(side) * self.d_embed,) + tuple(self.mlp_dims)
                + (self.d_out,))


def _tables(f: int, v: int, d: int, gen, dev) -> torch.Tensor:
    """(F, V, d) f32 drawn one field at a time (no temporary of the table's
    size: at full width a table holds up to 1.07e10 values)."""
    tables = torch.empty((f, v, d), device=dev)
    for i in range(f):
        embed_init(tables[i], generator=gen)
    return tables


def tower(params: dict, sparse, dtype, n_mlp: int) -> torch.Tensor:
    """One tower on its tree ({"tables", "mlp"}): per-field lookup, flatten,
    the dense stack, then ``x / max(|x|, 1e-6)``."""
    e = multi_field_lookup(params["tables"], sparse, dtype)
    x = dense_stack(params["mlp"], e.reshape(e.shape[0], -1), n_mlp)
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-6)


class Tower(nn.Module):
    """One tower of a two-tower model: ``tables`` (F, V, d) and the dense
    stack ``mlp``; ``forward`` is ``tower``."""

    def __init__(self, tables: torch.Tensor, mlp: DenseStack, dtype=torch.float32):
        super().__init__()
        self.tables = nn.Parameter(tables, requires_grad=False)
        self.mlp = mlp
        self.dtype = dtype

    def forward(self, sparse: torch.Tensor) -> torch.Tensor:
        return tower(param_tree(self), sparse, self.dtype, self.mlp.n)


class TwoTower(nn.Module):
    def __init__(self, user: Tower, item: Tower):
        super().__init__()
        self.user = user
        self.item = item


def init_tower(cfg: RecsysConfig, side: str, *, seed: int = 0,
               device="cuda") -> Tower:
    """One tower of a two-tower model, drawn from ``seed``: the (F, V, d)
    table one field at a time, then the dense stack."""
    dev = resolve_device(device, meta=True)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    tables = _tables(cfg.tower_fields(side), cfg.vocab, cfg.d_embed, gen, dev)
    mlp = init_dense_stack(cfg.tower_dims(side), generator=gen, device=dev)
    return Tower(tables, mlp, cfg.dtype)


def init_recsys(cfg: RecsysConfig, *, seed: int = 0, device="cuda"):
    """A model drawn from ``seed``. Two-tower: the user tower from ``seed``,
    the item tower from ``seed + 1`` (at full width each tower's tables take
    40 GiB; build one at a time with ``init_tower`` where both do not fit).
    The CTR kinds, as the reference's tree: the tables, then in the
    reference's order Wide&Deep's wide (F, V, 1) table and deep stack,
    DLRM's bottom and top stacks, or AutoInt's attention layers and output
    layer, all f32."""
    if cfg.kind == "two_tower":
        return TwoTower(init_tower(cfg, "user", seed=seed, device=device),
                        init_tower(cfg, "item", seed=seed + 1, device=device))
    if cfg.kind not in KINDS:
        raise ValueError(f"unknown recsys kind {cfg.kind!r}")
    dev = resolve_device(device, meta=True)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)

    def stack(dims):
        return param_tree(init_dense_stack(dims, generator=gen, device=dev))

    f, d = cfg.n_sparse, cfg.d_embed
    tree = {"tables": _tables(f, cfg.vocab, d, gen, dev)}
    if cfg.kind == "wide_deep":
        tree["wide"] = _tables(f, cfg.vocab, 1, gen, dev)
        tree["deep"] = stack((f * d,) + tuple(cfg.mlp_dims) + (1,))
    elif cfg.kind == "dlrm":
        n_inter = (f + 1) * f // 2          # pairs, the dense vector included
        tree["bot"] = stack((cfg.n_dense,) + tuple(cfg.bot_mlp_dims))
        tree["top"] = stack((n_inter + cfg.bot_mlp_dims[-1],) + tuple(cfg.mlp_dims) + (1,))
    else:
        tree["attn"] = init_field_attention(cfg.field_attn_cfg(), generator=gen, device=dev)
        tree["out"] = stack((f * cfg.d_attn, 1))
    return tree


def recsys_tree(params) -> dict:
    """The reference's tree of a model: a ``TwoTower``'s parameters, or the
    CTR kinds' tree as it is."""
    return param_tree(params) if isinstance(params, nn.Module) else params


def recsys_forward(params, batch: dict, cfg: RecsysConfig):
    """CTR kinds -> logits (B,); two_tower -> (user_emb, item_emb).
    ``params`` is a ``TwoTower`` or a tree; the batch's arrays are numpy or
    tensors (ids in [0, vocab))."""
    if cfg.kind not in KINDS:
        raise ValueError(f"unknown recsys kind {cfg.kind!r}")
    p = recsys_tree(params)
    dt = cfg.dtype
    if cfg.kind == "two_tower":
        n_mlp = len(cfg.mlp_dims) + 1
        return (tower(p["user"], batch["user_sparse"], dt, n_mlp),
                tower(p["item"], batch["item_sparse"], dt, n_mlp))
    e = multi_field_lookup(p["tables"], batch["sparse"], dt)          # (B, F, d)
    if cfg.kind == "wide_deep":
        wide = torch.sum(multi_field_lookup(p["wide"], batch["sparse"], dt)[..., 0], dim=1)
        deep = dense_stack(p["deep"], e.reshape(e.shape[0], -1), len(cfg.mlp_dims) + 1)
        return wide + deep[:, 0]
    if cfg.kind == "dlrm":
        dense = torch.as_tensor(batch["dense"], device=e.device).to(dt)
        z = dense_stack(p["bot"], dense, len(cfg.bot_mlp_dims), final_act=True)
        inter = dot_interaction(torch.cat([z[:, None, :], e], dim=1))
        top_in = torch.cat([z, inter], dim=-1)
        return dense_stack(p["top"], top_in, len(cfg.mlp_dims) + 1)[:, 0]
    h = field_attention(p["attn"], e, cfg.field_attn_cfg())      # autoint
    return dense_stack(p["out"], h, 1)[:, 0]


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def bce_loss(params, batch: dict, cfg: RecsysConfig):
    """The stable logistic loss of the CTR logit against ``label`` ->
    (mean loss, {"mean_logit"})."""
    z = recsys_forward(params, batch, cfg).float()
    y = torch.as_tensor(batch["label"], device=z.device).float()
    loss = torch.mean(torch.maximum(z, torch.zeros_like(z)) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))
    return loss, {"mean_logit": torch.mean(z)}


def _in_batch_rows(u, i, logq, r0: int):
    """Rows ``r0 + arange(len(u))`` of the in-batch softmax: (the sum of
    their NLL, the count of rows whose argmax is their own item)."""
    logits = (u @ i.T).float() / TEMPERATURE
    if logq is not None:
        logits = logits - logq[None, :]
    labels = replicate_like(torch.arange(r0, r0 + u.shape[0], device=logits.device), logits)
    lse = torch.logsumexp(logits, dim=-1)
    ll = take_last(logits, labels)
    if is_dtensor(logits):   # a row's own item holds its max (ties aside): DTensor's
        hit = ll >= logits.amax(dim=-1)   # argmax over a sharded dim fails (2.11)
    else:
        hit = torch.argmax(logits, dim=-1) == labels
    return torch.sum(lse - ll), torch.sum(hit.float())


def two_tower_loss(params, batch: dict, cfg: RecsysConfig):
    """In-batch sampled softmax at temperature 0.05 with the logQ
    correction (``log_q``, (B,), when the batch has it) -> (loss,
    {"in_batch_acc"}). The (B, B) logits are made IN_BATCH_ROWS rows at a
    time, each block a checkpoint under grad (at train_batch's 65,536 rows
    the whole matrix is 17 GB in f32, and its softmax as much again); the
    row sums are added in order."""
    u, i = recsys_forward(params, batch, cfg)
    logq = batch.get("log_q")
    if logq is not None:
        logq = torch.as_tensor(logq, device=u.device)
    b = u.shape[0]
    nll = torch.zeros((), device=u.device)
    hits = torch.zeros((), device=u.device)
    for r0 in range(0, b, IN_BATCH_ROWS):
        args = (u[r0:r0 + IN_BATCH_ROWS], i, logq, r0)
        if torch.is_grad_enabled() and b > IN_BATCH_ROWS:
            part, hit = checkpoint(_in_batch_rows, *args, use_reentrant=False)
        else:
            part, hit = _in_batch_rows(*args)
        nll, hits = nll + part, hits + hit
    return nll / b, {"in_batch_acc": hits / b}


def recsys_loss(params, batch, cfg: RecsysConfig):
    if cfg.kind == "two_tower":
        return two_tower_loss(params, batch, cfg)
    return bce_loss(params, batch, cfg)


# ---------------------------------------------------------------------------
# Retrieval scoring (retrieval_cand shape)
# ---------------------------------------------------------------------------

def embed_items(model, item_sparse, cfg: RecsysConfig) -> torch.Tensor:
    return tower(recsys_tree(model)["item"], item_sparse, cfg.dtype, len(cfg.mlp_dims) + 1)


def retrieval_scores(query_emb: torch.Tensor, cand_emb: torch.Tensor) -> torch.Tensor:
    """(Q, d) x (N, d) -> (Q, N) inner-product scores, one product in full
    f32 (the rangescan kernel serves the same shape with a fused range
    test and top-k)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return query_emb @ cand_emb.T


def retrieval_topk(query_emb, cand_emb, k: int = 100):
    """(ids (Q, k) int32, scores (Q, k)), the highest scores first."""
    vals, idx = torch.topk(retrieval_scores(query_emb, cand_emb), k, dim=1)
    return idx.to(torch.int32), vals
