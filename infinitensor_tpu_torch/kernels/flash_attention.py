"""Blockwise (flash) attention for prefill (counterpart of
infinitensor_tpu/kernels/flash_attention.py).

flash_attention launches the kernel in csrc/flash_attention.cu, replacing
_flash_kernel; mha_plain, the counterpart of mha_ref, is its plain version.
The JAX wrapper takes mha_ref when S is not a multiple of its block; the
kernel here masks the ragged tail itself, so every S takes it.
`launches` counts kernel launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from infinitensor_tpu_torch.kernels import _build

launches = collections.Counter()
KERNEL_HEAD_DIMS = (64, 128)     # instantiated in csrc/flash_attention.cu


@functools.cache
def _lib() -> ctypes.CDLL:
    P, I, F = _build.P, _build.I, _build.F
    return _build.typed("flash_attention",
                        flash_attention=[P] * 4 + [I] * 4 + [F, P])


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
    """q/k/v [B, H, S, D] -> [B, H, S, D]. CPU tensors take the plain
    version; CUDA tensors launch the kernel (contiguous bf16, D in
    KERNEL_HEAD_DIMS) or raise."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention: q, k and v must be [B, H, S, D] "
                         "of one shape")
    if q.device.type == "cpu":
        return mha_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, S, D = q.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in "
                         f"{KERNEL_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned "
                             f"bf16 on {q.device}")
    out = torch.empty_like(q)
    lib = _lib()
    p = _build.ptr
    err = lib.flash_attention(p(q), p(k), p(v), p(out), B * H, S, D,
                              bool(causal), 1.0 / math.sqrt(D),
                              _build.stream())
    _build.raise_on(lib, err, "flash_attention")
    launches["flash_attention"] += 1
    return out
