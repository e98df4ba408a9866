"""Layers of the port's models: initializers, the dense stack, and the LM's
norms, rotary embeddings, token embedding, MLP, MoE, and GQA and MLA
attention."""
from .attention import (
    GQA, MLA, GQAConfig, KVCache, MLAConfig, gqa_attention, init_gqa, init_mla,
    mla_attention, sdpa)
from .common import dense_init, embed_init
from .embedding import embed_tokens, init_token_embedding, unembed
from .mlp import ACTS, MLP, DenseStack, MLPConfig, dense_stack, init_dense_stack, init_mlp, mlp
from .moe import MoE, MoEConfig, init_moe, moe_layer
from .norm import layer_norm, rms_norm
from .rope import apply_rope, rope_freqs

__all__ = ["ACTS", "DenseStack", "GQA", "GQAConfig", "KVCache", "MLA", "MLAConfig", "MLP",
           "MLPConfig", "MoE", "MoEConfig",
           "apply_rope", "dense_init", "dense_stack", "embed_init", "embed_tokens", "gqa_attention",
           "init_dense_stack", "init_gqa", "init_mla", "init_mlp", "init_moe",
           "init_token_embedding", "layer_norm", "mla_attention", "mlp", "moe_layer",
           "rms_norm", "rope_freqs", "sdpa", "unembed"]
