"""Models of the port: the two-tower retrieval model and the CTR recsys
models (Wide&Deep, DLRM, AutoInt), the LM family (dense, MoE and MLA), the
GCN, and the serving layer's effort regressor; each with its loss."""
from .effort import (
    EffortConfig,
    EffortPredictor,
    effort_features,
    effort_forward,
    effort_loss,
    init_effort,
)
from .gcn import GCNConfig, gcn_batched_graphs, gcn_forward, gcn_loss, init_gcn
from .recsys import (
    RecsysConfig,
    Tower,
    TwoTower,
    bce_loss,
    embed_items,
    init_recsys,
    init_tower,
    recsys_forward,
    recsys_loss,
    recsys_tree,
    retrieval_scores,
    retrieval_topk,
    two_tower_loss,
)
from .transformer import (
    Transformer,
    TransformerConfig,
    cache_shapes,
    chunked_ce_loss,
    decode_step,
    forward,
    greedy_token,
    init_cache,
    init_transformer,
    logits_from_hidden,
    loss_fn,
    model_view,
    prefill,
    transformer_from_tree,
    transformer_tree,
)

__all__ = ["EffortConfig", "EffortPredictor", "GCNConfig", "RecsysConfig", "Tower",
           "Transformer", "TransformerConfig", "TwoTower", "bce_loss",
           "cache_shapes", "chunked_ce_loss", "decode_step", "effort_features",
           "effort_forward", "effort_loss", "embed_items", "forward", "gcn_batched_graphs",
           "gcn_forward", "gcn_loss", "greedy_token", "init_cache", "init_effort",
           "init_gcn", "init_recsys", "init_tower", "init_transformer",
           "logits_from_hidden", "loss_fn", "model_view", "prefill", "recsys_forward",
           "recsys_loss", "recsys_tree", "retrieval_scores", "retrieval_topk",
           "transformer_from_tree", "transformer_tree", "two_tower_loss"]
