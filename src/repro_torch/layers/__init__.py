"""Layers of the port's models: initializers and the dense stack."""
from .common import dense_init, embed_init
from .mlp import DenseStack, init_dense_stack

__all__ = ["DenseStack", "dense_init", "embed_init", "init_dense_stack"]
