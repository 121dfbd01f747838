"""Blockwise (flash) attention for prefill (counterpart of
infinitensor_tpu/kernels/flash_attention.py).

flash_attention launches the kernel in csrc/flash_attention.cu, replacing
_flash_kernel; mha_plain, the counterpart of mha_ref, is its plain version.
The JAX wrapper takes mha_ref when S is not a multiple of its block; the
kernel here masks the ragged tail itself, so every S takes it.

Two forms on the card: bf16 q, k, v at head dim 64 or 128 take the fast
kernel; q, k, v of one other float dtype (f16, f32) or any other head dim
(a multiple of 8 from 8 to 256) take the any-type form,
csrc/attention_any.cuh (flash_attention_any), as the TPU kernel takes any
float type and head dim and writes q's dtype. launches["flash_attention"]
counts both forms and launches["flash_attention_any"] the any-type one
again.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from infinitensor_tpu_torch.kernels import _build
from infinitensor_tpu_torch.kernels.attention import (
    FAST_HEAD_DIMS, KINDS, check_head_dim)

launches = collections.Counter()


@functools.cache
def _lib() -> ctypes.CDLL:
    P, I, F = _build.P, _build.I, _build.F
    return _build.typed("flash_attention",
                        flash_attention=[P] * 4 + [I] * 4 + [F, P],
                        flash_attention_any=[P] * 4 + [I] * 5 + [F, P])


def mha_plain(q, k, v, causal: bool = True) -> torch.Tensor:
    """q/k/v [B, H, S, D] -> [B, H, S, D] in q's dtype: f32 scores
    q . k / sqrt(D) (masked to key <= query when causal), softmax, p . v
    in f32."""
    S, D = q.shape[-2:]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """q/k/v [B, H, S, D] -> [B, H, S, D] in q's dtype. CPU tensors take
    the plain version; CUDA tensors launch a kernel or raise: contiguous,
    16-byte aligned q, k and v of one dtype, bf16, f16 or f32, D a
    multiple of 8 from 8 to 256 (the fast bf16 kernel at D 64 or 128, else
    the any-type form)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention: q, k and v must be [B, H, S, D] "
                         "of one shape")
    if q.device.type == "cpu":
        return mha_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, S, D = q.shape
    check_head_dim("flash_attention", D)
    if q.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"flash_attention takes bf16, f16 or f32, not "
                         f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned "
                             f"{q.dtype} on {q.device}")
    out = torch.empty_like(q)
    lib = _lib()
    p = _build.ptr
    fast = q.dtype == torch.bfloat16 and D in FAST_HEAD_DIMS
    if fast:
        err = lib.flash_attention(p(q), p(k), p(v), p(out), B * H, S, D,
                                  bool(causal), 1.0 / math.sqrt(D),
                                  _build.stream())
    else:
        err = lib.flash_attention_any(p(q), p(k), p(v), p(out),
                                      KINDS[q.dtype], B * H, S, D,
                                      bool(causal), 1.0 / math.sqrt(D),
                                      _build.stream())
    _build.raise_on(lib, err, "flash_attention")
    launches["flash_attention"] += 1
    if not fast:
        launches["flash_attention_any"] += 1
    return out
