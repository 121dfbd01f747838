"""INT8-KV decode attention with cache append (counterpart of
infinitensor_tpu/kernels/attention.py:37-122,395-476).

The cache is a static [B, Hkv, S_max, D] int8 buffer with per-(b, h, s)
f32 scales. The append (quantize_kv_row + _append_kv) is plain PyTorch and
writes the new row IN PLACE with scatter_ at `pos` (the JAX package
donates the buffer instead); `pos` stays a device tensor throughout, so a
decode step can be captured in a CUDA graph. The read side is the
flash_decode_q8 kernel (csrc/flash_decode_q8.cu), replacing
_flash_decode_q8_hb_kernel; flash_decode_q8_plain is its plain version.
`launches` counts kernel launches (captures, not CUDA-graph replays).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from infinitensor_tpu_torch.kernels import _build

launches = collections.Counter()


@functools.cache
def _lib() -> ctypes.CDLL:
    P, I, F = _build.P, _build.I, _build.F
    return _build.typed("flash_decode_q8",
                        flash_decode_q8=[P] * 7 + [I] * 5 + [F, P])


def _normalize_pos(pos, batch: int) -> torch.Tensor:
    """pos (scalar or [B]) -> int32 [batch]; a length other than batch
    broadcasts its first entry."""
    pos = torch.as_tensor(pos).reshape(-1).to(torch.int32)
    if pos.shape[0] != batch:
        pos = pos[:1].expand(batch).contiguous()
    return pos


def quantize_kv_row(x: torch.Tensor):
    """Per-(batch, head) symmetric int8 quantization of one K/V row
    [B, Hkv, 1, D] -> (int8 row, scale [B, Hkv, 1]); scale =
    max(absmax / 127, 1e-8), round half to even."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(-1) / 127.0, min=1e-8)
    q = torch.round(x32 / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _append_kv(k_cache, v_cache, k, v, pos):
    """Write k/v [B, H, 1, D] at row pos[b] of each batch's cache, in
    place (scatter_), and return the caches."""
    idx = pos.to(torch.int64).view(-1, 1, 1, 1).expand(
        k.shape[0], k.shape[1], 1, k.shape[3])
    k_cache.scatter_(2, idx, k.to(k_cache.dtype))
    v_cache.scatter_(2, idx, v.to(v_cache.dtype))
    return k_cache, v_cache


def _append_scale(scale_cache, s, pos):
    idx = pos.to(torch.int64).view(-1, 1, 1).expand(s.shape[0], s.shape[1], 1)
    scale_cache.scatter_(2, idx, s.to(scale_cache.dtype))
    return scale_cache


def decode_attention_gqa_q8(k_cache, v_cache, k_scale, v_scale, q, k, v,
                            pos):
    """INT8-KV-cache decode attention: caches int8 [B, Hkv, S, D], scales
    f32 [B, Hkv, S]; q [B, H, 1, D] bf16; k/v [B, Hkv, 1, D]; pos [B]
    (the row the new k/v go to, attended inclusively). The caches are
    updated in place. Returns (out [B, H, 1, D], k_cache, v_cache,
    k_scale, v_scale)."""
    B = k_cache.shape[0]
    pos = _normalize_pos(pos, B).to(k_cache.device)
    kq, ks = quantize_kv_row(k)
    vq, vs = quantize_kv_row(v)
    _append_kv(k_cache, v_cache, kq, vq, pos)
    _append_scale(k_scale, ks, pos)
    _append_scale(v_scale, vs, pos)
    out = flash_decode_q8(q.contiguous(), k_cache, v_cache, k_scale,
                          v_scale, pos)
    return out, k_cache, v_cache, k_scale, v_scale


def flash_decode_q8_plain(q, k_cache, v_cache, k_scale, v_scale, pos):
    """The TPU kernel's function, dense: scores = q . K_int8 * (ks / sqrt(D))
    over rows s <= pos, softmax, (p * vs) . V_int8. Returns bf16 [B, H, 1,
    D]."""
    B, H, _, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, rep, D)
    s = torch.einsum("bgrd,bgsd->bgrs", qf, k_cache.float())
    s = s * (k_scale.float() * scale)[:, :, None, :]
    live = torch.arange(S, device=q.device)[None, :] <= \
        pos.to(q.device)[:, None]                               # [B, S]
    s = torch.where(live[:, None, None, :], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    pv = p * v_scale.float()[:, :, None, :]
    out = torch.einsum("bgrs,bgsd->bgrd", pv, v_cache.float())
    return out.reshape(B, H, 1, D).to(torch.bfloat16)


def flash_decode_q8(q, k_cache, v_cache, k_scale, v_scale, pos):
    """INT8-KV flash decode over caches already appended at pos [B] int32.
    q [B, H, 1, D] bf16 -> [B, H, 1, D] bf16. CPU tensors take the plain
    version; CUDA tensors launch the kernel (D = 128, H / Hkv <= 16)."""
    B, H, _, D = q.shape
    Bk, Hkv, S, Dk = k_cache.shape
    if (Bk, Dk) != (B, D) or H % Hkv or v_cache.shape != k_cache.shape \
            or k_scale.shape != (B, Hkv, S) or v_scale.shape != (B, Hkv, S):
        raise ValueError("flash_decode_q8: inconsistent shapes")
    if q.device.type == "cpu":
        return flash_decode_q8_plain(q, k_cache, v_cache, k_scale, v_scale,
                                     pos)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if D != 128 or H // Hkv > 16:
        raise ValueError("flash_decode_q8 kernel takes D=128, H/Hkv<=16")
    tensors = {"q": (q, torch.bfloat16), "k_cache": (k_cache, torch.int8),
               "v_cache": (v_cache, torch.int8),
               "k_scale": (k_scale, torch.float32),
               "v_scale": (v_scale, torch.float32), "pos": (pos, torch.int32)}
    for name, (t, dt) in tensors.items():
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {q.device}")
    if pos.shape != (B,):
        raise ValueError(f"pos must be [{B}]")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("k_cache and v_cache must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _lib()
    p = _build.ptr
    err = lib.flash_decode_q8(
        p(q), p(k_cache), p(v_cache), p(k_scale), p(v_scale), p(pos), p(out),
        B, H, Hkv, S, D, 1.0 / math.sqrt(D), _build.stream())
    _build.raise_on(lib, err, "flash_decode_q8")
    launches["flash_decode_q8"] += 1
    return out
