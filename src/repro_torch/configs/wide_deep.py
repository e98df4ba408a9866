"""wide-deep [recsys] — 40 sparse fields, embed_dim=32, deep MLP
1024-512-256, concat interaction + linear wide part. [arXiv:1606.07792; paper]
"""
from ..dist.sharding import RECSYS_RULES
from ..models.recsys import RecsysConfig
from ..optim.adamw import AdamWConfig
from .common import ArchSpec, recsys_shapes


def reduced() -> RecsysConfig:
    return RecsysConfig(name="wide-deep-smoke", kind="wide_deep",
                        n_sparse=6, vocab=1_000, d_embed=8,
                        mlp_dims=(32, 16))


ARCH = ArchSpec(
    arch_id="wide-deep",
    family="recsys",
    model_cfg=RecsysConfig(
        name="wide-deep", kind="wide_deep", n_sparse=40,
        vocab=2_097_152, d_embed=32, mlp_dims=(1024, 512, 256)),
    shapes=recsys_shapes(),
    rules=RECSYS_RULES,
    opt_cfg=AdamWConfig(lr=1e-3, total_steps=50_000, warmup_steps=1_000),
    source="arXiv:1606.07792 (Wide & Deep); paper tier",
    technique_note=(
        "CTR scorer: no ANN structure inside the model; retrieval_cand = "
        "bulk candidate scoring. Embedding-bag substrate is the "
        "system-relevant piece (DESIGN.md §6)."),
    reduced=reduced,
)
