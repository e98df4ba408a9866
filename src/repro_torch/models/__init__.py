"""Models of the port. This slice has the two-tower retrieval model."""
from .recsys import (
    RecsysConfig,
    Tower,
    TwoTower,
    embed_items,
    init_recsys,
    init_tower,
    recsys_forward,
    retrieval_scores,
    retrieval_topk,
)

__all__ = ["RecsysConfig", "Tower", "TwoTower", "embed_items", "init_recsys",
           "init_tower", "recsys_forward", "retrieval_scores", "retrieval_topk"]
