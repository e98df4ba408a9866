"""Embeddings: the LM token table (init, lookup with gemma's sqrt(d_model)
scale, the tied or untied unembedding with the logit soft cap) and the
recsys EmbeddingBag and per-field lookup.

``embedding_bag`` is the reference's gather + segment sum: padded slots
(ids < 0) add nothing; the bag's rows are summed in slot order (one
reduction over the bag axis, no atomics). The gradient of any lookup is a
dense index-add into the table, with atomics on the card, so its sums are
not in a fixed order there.
"""
from __future__ import annotations

import dataclasses

import torch

from ..dist.sharding import is_dtensor, lookup_rows
from ..utils import resolve_device
from .common import embed_init

_CHUNK_ROWS = 32_768   # rows drawn at once: an f32 temporary of 32,768 x d


def init_token_embedding(vocab: int, d_model: int, *, generator=None,
                         device="cuda", dtype=torch.float32) -> torch.Tensor:
    """(vocab, d_model) in ``dtype``, drawn in f32 (σ = 0.02, cut at ±3σ)
    a block of rows at a time and cast, so no f32 temporary of the table's
    size is made (at gemma3-27b's width the table is 1.4e9 values)."""
    table = torch.empty((vocab, d_model), device=resolve_device(device, meta=True),
                        dtype=dtype)
    if table.device.type == "meta":
        return table
    for r0 in range(0, vocab, _CHUNK_ROWS):
        block = torch.empty((min(_CHUNK_ROWS, vocab - r0), d_model),
                            device=table.device)
        table[r0:r0 + block.shape[0]] = embed_init(block, generator=generator)
    return table


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, dtype,
                 scale: bool = False) -> torch.Tensor:
    """Rows of ``table`` by token id, in ``dtype``; ``scale`` multiplies by
    sqrt(d_model) rounded to ``dtype`` first, as the reference does (bf16:
    73.32 becomes 73.5)."""
    x = lookup_rows(table, tokens.long()).to(dtype)
    if scale:   # rounded on the host: a device tensor would cost a copy and a wait
        x = x * float(torch.tensor(table.shape[1] ** 0.5, dtype=dtype))
    return x


def unembed(table: torch.Tensor, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """(B, S, D) x (V, D) -> (B, S, V) f32 logits: the product in x's dtype
    (rounded to it, as the reference's einsum is), then widened and capped."""
    logits = torch.matmul(x, table.to(x.dtype).T).float()
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# ---------------------------------------------------------------------------
# EmbeddingBag (multi-hot gather-reduce)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BagConfig:
    mode: str = "sum"  # sum | mean


def embedding_bag(table: torch.Tensor, indices, cfg: BagConfig = BagConfig(),
                  dtype=torch.float32) -> torch.Tensor:
    """table (V, d), indices (B, L) ids padded with any id < 0 -> (B, d):
    each bag's rows summed (``mean``: divided by its count of real ids, at
    least 1)."""
    idx = torch.as_tensor(indices, device=table.device).long()
    valid = idx >= 0
    rows = table[torch.where(valid, idx, 0)].to(dtype)               # (B, L, d)
    out = torch.where(valid[..., None], rows, torch.zeros((), dtype=dtype,
                                                          device=table.device)).sum(dim=1)
    if cfg.mode == "mean":
        n = torch.clamp(valid.sum(dim=1, keepdim=True), min=1)
        out = out / n.to(dtype)
    return out


def multi_field_lookup(tables: torch.Tensor, indices, dtype=torch.float32) -> torch.Tensor:
    """tables (F, V, d), indices (B, F), one id a field in [0, V) -> (B, F, d)
    (the DLRM / AutoInt layout). The offsets into the flattened tables are
    int64 (F * V may pass 2^31). A DTensor's V is sharded (``RECSYS_RULES``),
    so it is looked up a field at a time, each a row-sharded table."""
    f, v, d = tables.shape
    idx = torch.as_tensor(indices, device=tables.device).long()
    if is_dtensor(tables):   # V is sharded: a lookup a field
        return torch.stack([lookup_rows(tables[i], idx[:, i]) for i in range(f)],
                           dim=1).to(dtype)
    offs = torch.arange(f, dtype=torch.int64, device=tables.device) * v
    return tables.reshape(f * v, d)[idx + offs].to(dtype)
