"""Scalar dtype conversion helpers (reference: src/utils/data_convert.cc,
include/utils/data_convert.h:1-14 — float<->fp16/bf16 bit-level converters).

The reference hand-rolls IEEE-754 bit surgery because its C++ core has no
half type; here numpy/ml_dtypes carry the formats, so these helpers are the
thin canonical spellings used by the dtype table, tensor save/load, and
tests. Round-trip semantics match the reference: fp16 via IEEE round-to-
nearest-even, bf16 via truncation-with-rounding of the mantissa.

Copy of infinitensor_tpu/utils/convert.py (numpy only; ml_dtypes stays
optional: without it the bf16 helpers do the bit surgery themselves).
"""

from __future__ import annotations

import numpy as np

try:  # optional
    import ml_dtypes

    _BF16 = np.dtype(ml_dtypes.bfloat16)
except Exception:  # pragma: no cover - ml_dtypes absent
    _BF16 = None


def float_to_fp16(x) -> np.ndarray:
    """float32 -> IEEE fp16 bit pattern (uint16), like float_to_fp16()."""
    return np.asarray(x, np.float32).astype(np.float16).view(np.uint16)


def fp16_to_float(bits) -> np.ndarray:
    """IEEE fp16 bit pattern (uint16) -> float32."""
    return np.asarray(bits, np.uint16).view(np.float16).astype(np.float32)


def float_to_bf16(x) -> np.ndarray:
    """float32 -> bfloat16 bit pattern (uint16), round-to-nearest-even."""
    x = np.asarray(x, np.float32)
    if _BF16 is not None:
        return x.astype(_BF16).view(np.uint16)
    u = x.view(np.uint32)
    rounded = u + 0x7FFF + ((u >> 16) & 1)  # RNE on the dropped mantissa
    return (rounded >> 16).astype(np.uint16)


def bf16_to_float(bits) -> np.ndarray:
    """bfloat16 bit pattern (uint16) -> float32 (exact: bf16 ⊂ f32)."""
    bits = np.asarray(bits, np.uint16)
    if _BF16 is not None:
        return bits.view(_BF16).astype(np.float32)
    return (bits.astype(np.uint32) << 16).view(np.float32)
