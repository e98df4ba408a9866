"""RecSys models: the two-tower retrieval model.

One (F, V, d) embedding table per tower (a row block per sparse field), a
single-hot lookup per field, the dense stack, and an L2 normalization. The
item tower's outputs are the corpus the range engine indexes; a user
query is served by brute force (the rangescan kernel) or through the graph
engine. The other kinds (Wide&Deep, DLRM, AutoInt) and the losses are not
ported yet: they raise ``NotImplementedError`` naming their ROADMAP item.

Serving only: parameters do not require gradients (the training slice,
ROADMAP.md §1 item 6, turns them on).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ..layers.common import embed_init
from ..layers.mlp import DenseStack, init_dense_stack
from ..utils import resolve_device

_OTHER_KINDS = "ROADMAP.md §1 item 8 (the rest of the recsys family)"
_TRAINING = "ROADMAP.md §1 item 6 (training)"


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    """The reference's fields that the two-tower model reads; the dense
    features, DLRM's bottom MLP and AutoInt's attention come with the kinds
    that read them (ROADMAP.md §1 item 8)."""
    name: str = "dlrm"
    kind: str = "dlrm"          # two_tower (wide_deep | dlrm | autoint raise)
    n_sparse: int = 26
    vocab: int = 100_000        # rows per field table
    d_embed: int = 64
    mlp_dims: tuple = (512, 256)          # tower hidden dims
    n_sparse_item: int = 0                # item-side fields (two_tower)
    d_out: int = 256                      # tower output dim
    dtype: Any = torch.float32

    def tower_fields(self, side: str) -> int:
        if side == "user":
            return self.n_sparse
        if side == "item":
            return self.n_sparse_item or self.n_sparse
        raise ValueError(f"unknown tower {side!r}")

    def tower_dims(self, side: str) -> tuple:
        return ((self.tower_fields(side) * self.d_embed,) + tuple(self.mlp_dims)
                + (self.d_out,))


def _lookup(tables: torch.Tensor, sparse: torch.Tensor, dtype) -> torch.Tensor:
    """(F, V, d) x (B, F) -> (B, F, d): one id per field, each in [0, V).
    The offsets into the flattened table are int64 (F * V may pass 2^31)."""
    f, v, d = tables.shape
    offs = torch.arange(f, dtype=torch.int64, device=tables.device) * v
    idx = sparse.to(device=tables.device, dtype=torch.int64) + offs
    return tables.reshape(f * v, d)[idx].to(dtype)


class Tower(nn.Module):
    """One tower: per-field lookup, flatten, the dense stack, then
    ``x / max(|x|, 1e-6)``."""

    def __init__(self, tables: torch.Tensor, mlp: DenseStack, dtype=torch.float32):
        super().__init__()
        self.tables = nn.Parameter(tables, requires_grad=False)
        self.mlp = mlp
        self.dtype = dtype

    def forward(self, sparse: torch.Tensor) -> torch.Tensor:
        e = _lookup(self.tables, sparse, self.dtype)
        x = self.mlp(e.reshape(e.shape[0], -1))
        return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-6)


class TwoTower(nn.Module):
    def __init__(self, user: Tower, item: Tower):
        super().__init__()
        self.user = user
        self.item = item


def init_tower(cfg: RecsysConfig, side: str, *, seed: int = 0,
               device="cuda") -> Tower:
    """One tower of a two-tower model, drawn from ``seed``: the (F, V, d)
    table one field at a time (no temporary of the table's size: at full
    width it holds 1.07e10 f32), then the dense stack."""
    dev = resolve_device(device, meta=True)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    f = cfg.tower_fields(side)
    tables = torch.empty((f, cfg.vocab, cfg.d_embed), device=dev)
    for i in range(f):
        embed_init(tables[i], generator=gen)
    mlp = init_dense_stack(cfg.tower_dims(side), generator=gen, device=dev)
    return Tower(tables, mlp, cfg.dtype)


def init_recsys(cfg: RecsysConfig, *, seed: int = 0, device="cuda") -> TwoTower:
    """A two-tower model: the user tower from ``seed``, the item tower from
    ``seed + 1``. At full width each tower's tables take 40 GiB; build one
    tower at a time with ``init_tower`` where both do not fit."""
    if cfg.kind != "two_tower":
        raise NotImplementedError(f"recsys kind {cfg.kind!r}: {_OTHER_KINDS}")
    return TwoTower(init_tower(cfg, "user", seed=seed, device=device),
                    init_tower(cfg, "item", seed=seed + 1, device=device))


def recsys_forward(model: TwoTower, batch: dict, cfg: RecsysConfig):
    """two_tower -> (user_emb, item_emb)."""
    if cfg.kind != "two_tower":
        raise NotImplementedError(f"recsys kind {cfg.kind!r}: {_OTHER_KINDS}")
    return model.user(batch["user_sparse"]), model.item(batch["item_sparse"])


def bce_loss(model, batch: dict, cfg: RecsysConfig):
    raise NotImplementedError(f"bce_loss: {_TRAINING}")


def two_tower_loss(model, batch: dict, cfg: RecsysConfig):
    raise NotImplementedError(f"two_tower_loss: {_TRAINING}")


def recsys_loss(model, batch: dict, cfg: RecsysConfig):
    raise NotImplementedError(f"recsys_loss: {_TRAINING}")


def embed_items(model: TwoTower, item_sparse: torch.Tensor,
                cfg: RecsysConfig) -> torch.Tensor:
    return model.item(item_sparse)


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
