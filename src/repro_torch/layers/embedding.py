"""The LM token table: init, lookup (with gemma's sqrt(d_model) scale) and
the tied or untied unembedding (with the logit soft cap). The recsys
EmbeddingBag and ``multi_field_lookup`` are ROADMAP.md §1 item 9."""
from __future__ import annotations

import torch

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
    x = table[tokens.long()].to(dtype)
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
