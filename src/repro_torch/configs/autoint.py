"""autoint [recsys] — 39 sparse fields, embed_dim=16, 3 interacting
self-attention layers (2 heads, d_attn=32). [arXiv:1810.11921; paper]
"""
from ..dist.sharding import RECSYS_RULES
from ..models.recsys import RecsysConfig
from ..optim.adamw import AdamWConfig
from .common import ArchSpec, recsys_shapes


def reduced() -> RecsysConfig:
    return RecsysConfig(name="autoint-smoke", kind="autoint", n_sparse=6,
                        vocab=1_000, d_embed=8, attn_layers=2, attn_heads=2,
                        d_attn=16, mlp_dims=())


ARCH = ArchSpec(
    arch_id="autoint",
    family="recsys",
    model_cfg=RecsysConfig(
        name="autoint", kind="autoint", n_sparse=39, vocab=1_048_576,
        d_embed=16, attn_layers=3, attn_heads=2, d_attn=32, mlp_dims=()),
    shapes=recsys_shapes(),
    rules=RECSYS_RULES,
    opt_cfg=AdamWConfig(lr=1e-3, total_steps=50_000, warmup_steps=1_000),
    source="arXiv:1810.11921 (AutoInt); paper tier",
    technique_note="CTR scorer: technique inapplicable inside the model.",
    reduced=reduced,
)
