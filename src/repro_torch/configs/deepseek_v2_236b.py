"""deepseek-v2-236b [moe] — 60L d_model=5120 128H, MLA (kv_lora=512,
q_lora=1536, rope_dim=64), MoE 160 routed top-6 + 2 shared (d_expert=1536),
first layer dense (d_ff=12288), vocab=102400. [arXiv:2405.04434; hf]

``ARCH`` is the published geometry, 60 layers (~236 B parameters, ~472 GB
in bf16), which no single card holds. The port's card run serves it at
full width with its depth cut to 7 layers (``first_dense`` 1 plus 6 MoE
layers: 3.97 B parameters a MoE layer, ≈ 50.4 GB in all with the dense
layer and the untied embedding and unembedding), through
``dataclasses.replace(ARCH.model_cfg, n_layers=7)``.
"""
import torch

from ..dist.sharding import LM_RULES
from ..models.transformer import TransformerConfig
from ..optim.adamw import AdamWConfig
from .common import ArchSpec, lm_shapes


def reduced() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-smoke", n_layers=3, d_model=64, n_heads=4,
        attn_kind="mla", q_lora=32, kv_lora=16, qk_nope_dim=16,
        qk_rope_dim=8, v_head_dim=16, d_ff=128, n_experts=8, n_shared=2,
        top_k=2, d_expert=32, first_dense=1, vocab=512,
        capacity_factor=8.0,  # drop-free at smoke scale (decode parity)
        dtype=torch.float32, remat=False, loss_chunk=32)


ARCH = ArchSpec(
    arch_id="deepseek-v2-236b",
    family="lm",
    model_cfg=TransformerConfig(
        name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
        attn_kind="mla", q_lora=1536, kv_lora=512, qk_nope_dim=128,
        qk_rope_dim=64, v_head_dim=128, d_ff=12288, n_experts=160,
        n_shared=2, top_k=6, d_expert=1536, first_dense=1, moe_groups=32,
        capacity_factor=1.25, vocab=102_400, rope_theta=10_000.0,
        tie_embeddings=False, dtype=torch.bfloat16, attn_chunk=1024),
    shapes=lm_shapes(),
    rules=LM_RULES,
    param_dtype=torch.bfloat16,
    accum_steps=4,
    opt_cfg=AdamWConfig(lr=2.4e-4, total_steps=100_000, warmup_steps=2_000,
                        moment_dtype=torch.bfloat16, accum_dtype=torch.bfloat16),
    source="arXiv:2405.04434 (DeepSeek-V2); hf tier",
    technique_note=(
        "MoE LM: expert top-k routing is a selection over 160 experts — "
        "unrelated scale to ANNS; technique inapplicable inside the model "
        "(DESIGN.md §6). MLA cache (512+64 dims/token) is what makes the "
        "long_500k decode cell cheap."),
    reduced=reduced,
)
