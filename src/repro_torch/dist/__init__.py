"""Quantization helpers of the distributed layer (the multi-device parts of
``repro.dist`` are a later slice of the port)."""
from .compression import (
    GUARD_SLACK,
    dequantize_int8,
    quantize_int8,
    quantize_int8_rows,
)

__all__ = ["GUARD_SLACK", "dequantize_int8", "quantize_int8",
           "quantize_int8_rows"]
