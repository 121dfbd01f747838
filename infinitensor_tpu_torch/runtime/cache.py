"""Persistent kernel build cache (counterpart of
infinitensor_tpu/runtime/cache.py).

The JAX package points XLA's persistent compilation cache at a
directory. The port's compiled artifacts are the nvcc-built kernel
libraries (kernels/_build.py), kept under build/<hash of the sources and
flags>/ at the repository root; this points that root elsewhere, so a
cold start reuses libraries built by an earlier process with the same
sources.
"""

from __future__ import annotations

import os
from pathlib import Path

_DEFAULT_DIR = os.path.expanduser("~/.cache/infinitensor_tpu_torch/kernels")


def enable_compilation_cache(path: str = _DEFAULT_DIR) -> str:
    """Build and load the kernel libraries under `path`; returns it. Must
    be called before the first launch: a library already loaded stays
    where it was built."""
    from infinitensor_tpu_torch.kernels import _build

    if _build.library.cache_info().currsize:
        raise RuntimeError("enable_compilation_cache must be called before "
                           "the first kernel launch")
    os.makedirs(path, exist_ok=True)
    _build.BUILD_ROOT = Path(path).resolve()
    return path
