"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936; qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]
"""
import torch

from ..dist.sharding import LM_RULES
from ..models.transformer import TransformerConfig
from ..optim.adamw import AdamWConfig
from .common import ArchSpec, lm_shapes


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-smoke", n_layers=4, d_model=64, n_heads=8, n_kv=2,
        d_head=16, d_ff=160, vocab=512, qk_norm=True, tie_embeddings=False,
        dtype=torch.float32, remat=False, loss_chunk=32)


ARCH = ArchSpec(
    arch_id="qwen3-14b",
    family="lm",
    model_cfg=TransformerConfig(
        name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40, n_kv=8,
        d_head=128, d_ff=17408, vocab=151_936, rope_theta=1_000_000.0,
        qk_norm=True, tie_embeddings=False, dtype=torch.bfloat16,
        attn_chunk=1024),
    shapes=lm_shapes(),
    rules=LM_RULES,
    opt_cfg=AdamWConfig(lr=3e-4, total_steps=100_000, warmup_steps=2_000),
    source="hf:Qwen/Qwen3 family (14b geometry); hf tier",
    technique_note=(
        "LM: technique inapplicable inside the model (full attention, "
        "no retrieval structure); long_500k lowered as decode (O(kv) per "
        "step) — pure-full-attention caveat noted in DESIGN.md §6."),
    reduced=reduced,
)
