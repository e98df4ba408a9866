"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) MoE 60 routed
top-4 + 4 shared (d_expert=1408), vocab=151936.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

The MoE serving slice of the port runs this configuration at full width and
depth on one card: 15.15 B parameters, 30.3 GB in bf16 (the routed experts
allocated 64 rows for 60 logical ones, as the reference pads them), drawn
from a seed.
"""
import torch

from ..models.transformer import TransformerConfig
from .common import ArchSpec, lm_shapes


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2moe-smoke", n_layers=3, d_model=48, n_heads=4, n_kv=4,
        d_head=12, d_ff=96, n_experts=10, n_shared=4, top_k=4, d_expert=24,
        vocab=512, capacity_factor=8.0,  # drop-free at smoke scale
        dtype=torch.float32, aux_loss_weight=0.001)


ARCH = ArchSpec(
    arch_id="qwen2-moe-a2.7b",
    family="lm",
    model_cfg=TransformerConfig(
        name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
        n_kv=16, d_head=128, d_ff=5632, n_experts=60, n_experts_alloc=64,
        moe_groups=32, n_shared=4, top_k=4,
        d_expert=1408, capacity_factor=1.25, vocab=151_936,
        rope_theta=1_000_000.0, tie_embeddings=False, dtype=torch.bfloat16,
        attn_chunk=1024),
    shapes=lm_shapes(),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf tier",
    technique_note="MoE LM: technique inapplicable inside the model "
                   "(DESIGN.md §6).",
    reduced=reduced,
)
