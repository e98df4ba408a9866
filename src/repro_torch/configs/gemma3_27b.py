"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144; 5:1 local:global sliding window (1024), dual rope theta
(10k local / 1M global), qk-norm, sandwich norms, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

The LM serving slice of the port runs this configuration at full width and
depth on one card (54.0 GB of bf16 weights, drawn from a seed: the repo
ships no weights).
"""
import torch

from ..models.transformer import TransformerConfig
from .common import ArchSpec, lm_shapes


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="gemma3-smoke", n_layers=6, d_model=64, n_heads=4, n_kv=2,
        d_head=16, d_ff=128, vocab=512, window=16, local_ratio=5,
        rope_theta=1_000_000.0, rope_theta_local=10_000.0, qk_norm=True,
        sandwich_norm=True, embed_scale=True, dtype=torch.float32)


ARCH = ArchSpec(
    arch_id="gemma3-27b",
    family="lm",
    model_cfg=TransformerConfig(
        name="gemma3-27b", n_layers=62, d_model=5376, n_heads=32, n_kv=16,
        d_head=128, d_ff=21504, vocab=262_144, window=1024, local_ratio=5,
        rope_theta=1_000_000.0, rope_theta_local=10_000.0, qk_norm=True,
        sandwich_norm=True, embed_scale=True, tie_embeddings=True,
        dtype=torch.bfloat16, attn_chunk=1024),
    shapes=lm_shapes(),
    source="hf:google/gemma-3 family (27b geometry); unverified tier",
    technique_note=(
        "LM: range engine applies as downstream embedding consumer only "
        "(DESIGN.md §6); long_500k runs as decode with the 5:1 local:global "
        "sub-quadratic pattern."),
    reduced=reduced,
)
