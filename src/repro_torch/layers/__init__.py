"""Layers of the port's models: initializers, the dense stack, and the LM's
norms, rotary embeddings, token embedding, MLP and GQA attention."""
from .attention import GQA, GQAConfig, KVCache, gqa_attention, init_gqa, sdpa
from .common import dense_init, embed_init
from .embedding import embed_tokens, init_token_embedding, unembed
from .mlp import ACTS, MLP, DenseStack, MLPConfig, init_dense_stack, init_mlp, mlp
from .norm import layer_norm, rms_norm
from .rope import apply_rope, rope_freqs

__all__ = ["ACTS", "DenseStack", "GQA", "GQAConfig", "KVCache", "MLP", "MLPConfig",
           "apply_rope", "dense_init", "embed_init", "embed_tokens", "gqa_attention",
           "init_dense_stack", "init_gqa", "init_mlp", "init_token_embedding",
           "layer_norm", "mlp", "rms_norm", "rope_freqs", "sdpa", "unembed"]
