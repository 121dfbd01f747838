"""Row RMSNorm with an f32 weight product (counterpart of
infinitensor_tpu/kernels/norms.py).

rmsnorm launches the kernel in csrc/rmsnorm.cu, replacing _rmsnorm_kernel;
rmsnorm_plain, the counterpart of rmsnorm_ref, is its plain version. Both
compute out = x * rsqrt(mean(x^2) + eps) * w in f32, rounded once to x's
dtype: the graph IR's RMSNorm, not the model's norm (which rounds to bf16
before the weight product).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(x bf16 or f32, w bf16 or f32) or raises. The JAX wrapper takes
rmsnorm_ref below 8 rows or for a row count that is no multiple of its
256-row block (norms.py:48-52): a TPU sublane and tiling rule, dropped
here, so the kernel takes every row count. `launches` counts kernel
launches (captures, not CUDA-graph replays).

The kernel (csrc/rmsnorm.cu) takes a warp a row, with 16-byte loads and
the row held in registers, at every row count: a block a row read slower
at every row count on the H100 (PERF.md §6 row 14).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from infinitensor_tpu_torch.kernels import _build

launches = collections.Counter()
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


@functools.cache
def _lib() -> ctypes.CDLL:
    P, I, F = _build.P, _build.I, _build.F
    return _build.typed("rmsnorm", rmsnorm=[P, I, P, I, P, I, I, F, P])


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """rmsnorm_ref: f32 mean of squares over the last dim, x * rsqrt(ms +
    eps) * w in f32, rounded once to x's dtype."""
    x32 = x.float()
    ms = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x [..., d], w [d] (or any shape of d elements) -> x's shape and
    dtype."""
    d = x.shape[-1]
    if w.numel() != d:
        raise ValueError(f"rmsnorm: weight of {w.numel()} elements for "
                         f"rows of {d}")
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w.reshape(d), eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in KERNEL_DTYPES or w.dtype not in KERNEL_DTYPES:
        raise ValueError(f"rmsnorm kernel takes x and w in {KERNEL_DTYPES}, "
                         f"got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    x2 = x.reshape(-1, d).contiguous()
    w1 = w.reshape(d).contiguous()
    out = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return out.reshape(x.shape)
    lib, p = _lib(), _build.ptr
    err = lib.rmsnorm(p(x2), x2.dtype == torch.float32, p(w1),
                      w1.dtype == torch.float32, p(out), x2.shape[0], d,
                      float(eps), _build.stream())
    _build.raise_on(lib, err, "rmsnorm")
    launches["rmsnorm"] += 1
    return out.reshape(x.shape)
