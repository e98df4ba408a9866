"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152; GQA + RoPE, classic (non-gated) GELU FFN. [arXiv:2402.19173; hf]
"""
import torch

from ..models.transformer import TransformerConfig
from .common import ArchSpec, lm_shapes


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="starcoder2-smoke", n_layers=4, d_model=64, n_heads=4, n_kv=1,
        d_head=16, d_ff=256, ffn_gated=False, ffn_act="gelu", vocab=512,
        dtype=torch.float32)


ARCH = ArchSpec(
    arch_id="starcoder2-7b",
    family="lm",
    model_cfg=TransformerConfig(
        name="starcoder2-7b", n_layers=32, d_model=4608, n_heads=36, n_kv=4,
        d_head=128, d_ff=18432, ffn_gated=False, ffn_act="gelu",
        vocab=49_152, rope_theta=100_000.0, tie_embeddings=True,
        dtype=torch.bfloat16, attn_chunk=1024),
    shapes=lm_shapes(),
    source="arXiv:2402.19173 (StarCoder2-7B); hf tier",
    technique_note=(
        "LM: technique inapplicable inside the model; code-embedding "
        "outputs are natural range-engine corpora (duplicate detection "
        "is a headline range-retrieval application)."),
    reduced=reduced,
)
