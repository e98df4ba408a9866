"""Models of the port: the two-tower retrieval model and the dense LM."""
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
from .transformer import (
    Transformer,
    TransformerConfig,
    cache_shapes,
    decode_step,
    forward,
    greedy_token,
    init_cache,
    init_transformer,
    logits_from_hidden,
    prefill,
)

__all__ = ["RecsysConfig", "Tower", "Transformer", "TransformerConfig", "TwoTower",
           "cache_shapes", "decode_step", "embed_items", "forward", "greedy_token",
           "init_cache", "init_recsys", "init_tower", "init_transformer",
           "logits_from_hidden", "prefill", "recsys_forward", "retrieval_scores",
           "retrieval_topk"]
