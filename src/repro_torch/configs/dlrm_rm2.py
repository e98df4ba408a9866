"""dlrm-rm2 [recsys] — 13 dense + 26 sparse (embed_dim=64),
bot_mlp 13-512-256-64, top_mlp 512-512-256-1, dot interaction.
[arXiv:1906.00091; paper]
"""
from ..dist.sharding import RECSYS_RULES
from ..models.recsys import RecsysConfig
from ..optim.adamw import AdamWConfig
from .common import ArchSpec, recsys_shapes


def reduced() -> RecsysConfig:
    return RecsysConfig(name="dlrm-smoke", kind="dlrm", n_dense=4,
                        n_sparse=6, vocab=1_000, d_embed=8,
                        bot_mlp_dims=(16, 8), mlp_dims=(32, 16))


ARCH = ArchSpec(
    arch_id="dlrm-rm2",
    family="recsys",
    model_cfg=RecsysConfig(
        name="dlrm-rm2", kind="dlrm", n_dense=13, n_sparse=26,
        vocab=4_194_304, d_embed=64, bot_mlp_dims=(512, 256, 64),
        mlp_dims=(512, 512, 256)),
    shapes=recsys_shapes(),
    rules=RECSYS_RULES,
    opt_cfg=AdamWConfig(lr=1e-3, total_steps=50_000, warmup_steps=1_000),
    source="arXiv:1906.00091 (DLRM, RM2 geometry); paper tier",
    technique_note="CTR scorer: technique inapplicable inside the model; "
                   "row-sharded EmbeddingBag is the substrate exercised.",
    reduced=reduced,
)
