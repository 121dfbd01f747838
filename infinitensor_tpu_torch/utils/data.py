"""Data generation + validation utilities.

Reference analogs: DataGenerator (include/utils/data_generator.h:9-30,
Incremental/Random fill) and validation metrics (include/utils/validation.h).
Copy of infinitensor_tpu/utils/data.py (numpy only).
"""

from __future__ import annotations

import numpy as np


class DataGenerator:
    """Deterministic tensor fills for tests/benchmarks."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def incremental(self, shape, dtype=np.float32) -> np.ndarray:
        n = int(np.prod(shape))
        return np.arange(n, dtype=dtype).reshape(shape)

    def random(self, shape, dtype=np.float32, scale: float = 1.0
               ) -> np.ndarray:
        if np.issubdtype(np.dtype(dtype), np.floating):
            return (self.rng.standard_normal(shape) * scale).astype(dtype)
        info = np.iinfo(dtype)
        lo, hi = max(info.min, -128), min(info.max, 127)
        return self.rng.integers(lo, hi + 1, size=shape).astype(dtype)

    def one_hot(self, shape, index: int = 0, dtype=np.float32) -> np.ndarray:
        out = np.zeros(shape, dtype)
        out.reshape(-1)[index] = 1
        return out


# -- validation metrics (reference src/utils/validation.cc) -----------------

def abs_error(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def rel_error(a, b, eps: float = 1e-9) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b) + eps)))


def cosine_similarity(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / denom) if denom else 1.0


def token_mismatch_rate(a, b) -> float:
    """Per-token mismatch fraction (reference llama_kvcache_inference.py
    count_wrong / n_max_length accuracy metric)."""
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    return float(np.mean(a != b))
