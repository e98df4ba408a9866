"""PyTorch port of the range-retrieval system, for NVIDIA Hopper.

Each module mirrors the module of the JAX package ``repro`` at the same
relative path. This package imports torch, numpy and the standard library
only. Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; the hand-written CUDA kernels live under ``kernels/``.
"""
