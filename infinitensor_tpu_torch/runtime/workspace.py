"""Bump-pointer scratch workspace (counterpart of
infinitensor_tpu/runtime/workspace.py; reference include/core/workspace.h:
6-40, WorkspaceObj<T> -- a cursor over a pre-sized scratch region that
per-kernel code sub-allocates from and resets between ops).

The port's kernels take their scratch from PyTorch's caching allocator,
so the consumers are host-side staging paths (ONNX wire scanning, weight
quantization, tensor dump) that want one reusable numpy arena instead of
per-call allocations. Semantics mirror the reference: `take(size)` bumps
a cursor, `reset()` rewinds it after each op, over-allocation raises.

Copy of the JAX package's module (no jax code).
"""

from __future__ import annotations

import numpy as np


class Workspace:
    def __init__(self, size_bytes: int):
        if size_bytes <= 0:
            raise ValueError("workspace size must be positive")
        self._buf = np.empty(size_bytes, dtype=np.uint8)
        self._alloc = 0

    @property
    def size(self) -> int:
        return self._buf.nbytes

    @property
    def allocated(self) -> int:
        return self._alloc

    def take(self, size_bytes: int) -> np.ndarray:
        """Sub-allocate `size_bytes` from the arena (uint8 view, zero-copy)."""
        if self._alloc + size_bytes > self._buf.nbytes:
            raise MemoryError(
                f"workspace exhausted: want {size_bytes}, "
                f"free {self._buf.nbytes - self._alloc}")
        view = self._buf[self._alloc:self._alloc + size_bytes]
        self._alloc += size_bytes
        return view

    def take_as(self, shape, dtype) -> np.ndarray:
        """Typed sub-allocation: a `shape`/`dtype` view over fresh arena bytes."""
        dtype = np.dtype(dtype)
        n = int(np.prod(shape)) * dtype.itemsize
        return self.take(n).view(dtype).reshape(shape)

    def reset(self) -> None:
        self._alloc = 0
