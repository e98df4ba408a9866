"""two-tower-retrieval [recsys] — embed_dim=256, tower_mlp=1024-512-256,
dot interaction, sampled-softmax retrieval. [RecSys'19 (YouTube); unverified]

The paper's home-turf architecture: the item tower's embeddings are the
corpus the range engine indexes; ``retrieval_cand`` is served both by brute
force (the rangescan kernel) and through the graph-based range engine.
"""
from ..models.recsys import RecsysConfig
from .common import ArchSpec, recsys_shapes


def reduced() -> RecsysConfig:
    return RecsysConfig(name="two-tower-smoke", kind="two_tower",
                        n_sparse=4, n_sparse_item=4, vocab=1_000,
                        d_embed=16, mlp_dims=(64, 32), d_out=32)


ARCH = ArchSpec(
    arch_id="two-tower-retrieval",
    family="recsys",
    model_cfg=RecsysConfig(
        name="two-tower-retrieval", kind="two_tower", n_sparse=16,
        n_sparse_item=16, vocab=10_485_760, d_embed=64,
        mlp_dims=(1024, 512), d_out=256),
    shapes=recsys_shapes(),
    source="Yi et al., RecSys'19 (YouTube two-tower); unverified tier",
    technique_note=(
        "DIRECT integration: item-tower output embeddings feed "
        "core.RangeSearchEngine; retrieval_cand = rangescan kernel "
        "(brute force) or graph engine (sub-linear)."),
    reduced=reduced,
)
