"""Layers of the port's models: initializers, the dense stack, the LM's
norms, rotary embeddings, token embedding, MLP, MoE, and GQA and MLA
attention; the recsys embedding bag, per-field lookup and interactions; the
GNN's segment ops."""
from .attention import (
    GQA, MLA, GQAConfig, KVCache, MLAConfig, gqa_attention, init_gqa, init_mla,
    mla_attention, sdpa)
from .common import dense_init, embed_init
from .embedding import (
    BagConfig, embed_tokens, embedding_bag, init_token_embedding, multi_field_lookup,
    unembed)
from .interactions import (
    FieldAttnConfig, dot_interaction, field_attention, fm_interaction,
    init_field_attention)
from .mlp import ACTS, MLP, DenseStack, MLPConfig, dense_stack, init_dense_stack, init_mlp, mlp
from .moe import MoE, MoEConfig, init_moe, moe_layer
from .norm import layer_norm, rms_norm
from .rope import apply_rope, rope_freqs
from .segment import gather_scatter, sym_norm_weights

__all__ = ["ACTS", "BagConfig", "DenseStack", "FieldAttnConfig", "GQA", "GQAConfig",
           "KVCache", "MLA", "MLAConfig", "MLP", "MLPConfig", "MoE", "MoEConfig",
           "apply_rope", "dense_init", "dense_stack", "dot_interaction", "embed_init",
           "embed_tokens", "embedding_bag", "field_attention", "fm_interaction",
           "gather_scatter", "gqa_attention", "init_dense_stack", "init_field_attention",
           "init_gqa", "init_mla", "init_mlp", "init_moe", "init_token_embedding",
           "layer_norm", "mla_attention", "mlp", "moe_layer", "multi_field_lookup",
           "rms_norm", "rope_freqs", "sdpa", "sym_norm_weights", "unembed"]
