from .ops import flash_attention, flash_attention_cuda
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_cuda", "flash_attention_ref"]
