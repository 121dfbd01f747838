"""Weight-only INT8/INT4 quantization (counterpart of
infinitensor_tpu/quant/weight_only.py).

Reads and writes the same bytes as the JAX package (INT4_PACK_VERSION 2):
per-(group, out-channel) symmetric scales, groups along the contraction
axis; int4 is packed split-half, packed row i holding w[i] in the low
nibble, stored offset-binary (+8), and w[i + din/2] in the high nibble,
signed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

INT4_PACK_VERSION = 2


@dataclasses.dataclass
class QuantizedLinear:
    """Weight-only quantized [in, out] matrix.

    qweight: int8 [in, out_p] (bits=8) or packed int8 [in//2, out_p]
    scales:  f32/bf16 [n_groups, out_p]
    bits:    4 or 8
    group_size: contraction rows per scale group
    out_logical: logical output dim when the physical columns are padded
        (0 = unpadded); matmul wrappers slice the result back to
        out_features.
    """

    qweight: torch.Tensor
    scales: torch.Tensor
    bits: int
    group_size: int
    out_logical: int = 0

    @property
    def in_features(self) -> int:
        rows = self.qweight.shape[0]
        return rows * 2 if self.bits == 4 else rows

    @property
    def out_features(self) -> int:
        return self.out_logical or self.qweight.shape[-1]

    @property
    def out_physical(self) -> int:
        return self.qweight.shape[-1]

    @property
    def paired(self) -> bool:
        """True when one int4 scale row covers both split halves of a
        group (din/2g scale rows instead of din/g)."""
        return (self.bits == 4 and self.group_size > 0
                and self.scales.shape[0] * self.group_size * 2
                == self.in_features)

    def to(self, device) -> "QuantizedLinear":
        return dataclasses.replace(self, qweight=self.qweight.to(device),
                                   scales=self.scales.to(device))


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[din, dout] int values in [-8, 7] -> split-half packed int8."""
    half = q.shape[0] // 2
    lo = (q[:half].to(torch.int32) + 8) & 0xF
    hi = (q[half:].to(torch.int32) & 0xF) << 4
    return (lo | hi).to(torch.uint8).view(torch.int8)


def quantize_weight(w: torch.Tensor, bits: int = 8,
                    group_size: Optional[int] = None, clip: str = "auto",
                    pad_out: int = 0, paired: bool = False
                    ) -> QuantizedLinear:
    """Symmetric per-group-per-channel quantization of an [in, out] weight.

    clip: "none" = absmax scales; "mse" = per-group clip-ratio search
    minimizing the round-trip error; "auto" = mse for int4, none for int8.
    paired (int4 only): one scale row covers the paired split-half groups.
    Scales are f32; rounding is half-to-even, as jnp.round.
    """
    din, dout = w.shape
    out_logical = 0
    if pad_out and dout % pad_out:
        pad = pad_out - dout % pad_out
        w = torch.nn.functional.pad(w, (0, pad))
        out_logical, dout = dout, dout + pad
    if group_size is None:
        group_size = din
    while din % group_size:  # snap to a divisor (e.g. 11008-like dims)
        group_size //= 2
        if group_size == 0:
            group_size = din
            break
    if paired:
        if bits != 4 or din % 2:
            raise ValueError("paired needs int4 and an even din")
        while group_size >= 32 and (din // 2) % group_size:
            group_size //= 2
        if (din // 2) % group_size:
            paired = False
    if paired:
        half = din // 2
        ngh = half // group_size
        wp = torch.stack([w[:half].reshape(ngh, group_size, dout),
                          w[half:].reshape(ngh, group_size, dout)],
                         dim=1).reshape(ngh * 2 * group_size, dout)
        qp = quantize_weight(wp, bits=4, group_size=2 * group_size,
                             clip=clip)
        qv = _unpack_int4(qp.qweight).reshape(ngh, 2, group_size, dout)
        vals = torch.cat([qv[:, 0].reshape(half, dout),
                          qv[:, 1].reshape(half, dout)], dim=0)
        return QuantizedLinear(_pack_int4(vals), qp.scales, 4, group_size,
                               out_logical)
    ng = din // group_size
    wg = w.reshape(ng, group_size, dout).to(torch.float32)
    qmax = 127.0 if bits == 8 else 7.0
    absmax = wg.abs().amax(dim=1)                          # [ng, out]
    scales = torch.clamp(absmax / qmax, min=1e-8)
    if clip == "mse" or (clip == "auto" and bits == 4):
        best_err = None
        best_scales = scales
        for ratio in (1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7):
            s = torch.clamp(absmax * ratio / qmax, min=1e-8)
            qq = torch.clamp(torch.round(wg / s[:, None, :]), -qmax - 1,
                             qmax)
            err = torch.square(qq * s[:, None, :] - wg).sum(dim=1)
            if best_err is None:
                best_err = err
            else:
                pick = err < best_err
                best_scales = torch.where(pick, s, best_scales)
                best_err = torch.minimum(err, best_err)
        scales = best_scales
    q = torch.round(wg / scales[:, None, :])
    q = torch.clamp(q, -qmax - 1, qmax).to(torch.int8).reshape(din, dout)
    if bits == 4:
        q = _pack_int4(q)
    return QuantizedLinear(q, scales.to(torch.float32), bits, group_size,
                           out_logical)


def _unpack_nibbles(packed: torch.Tensor) -> tuple:
    """[in//2, out] packed -> (lo, hi) int32 in [-8, 7]; lo = w rows
    [0, in/2), hi = w rows [in/2, in)."""
    u = packed.to(torch.int32)
    lo = (u & 15) - 8
    hi = (u << 24) >> 28
    return lo, hi


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[in//2, out] packed -> [in, out] int8 in [-8, 7] (split-half)."""
    lo, hi = _unpack_nibbles(packed)
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def dequantize_weight(q: QuantizedLinear, dtype=torch.bfloat16
                      ) -> torch.Tensor:
    """[in, out_features] weight in `dtype`; the scale multiply runs in
    `dtype`, as in the JAX package."""
    w = _unpack_int4(q.qweight) if q.bits == 4 else q.qweight
    din, dout = w.shape
    ng = q.scales.shape[0]
    if q.bits == 4 and q.paired:
        half = din // 2
        wf = w.reshape(2, ng, half // ng, dout).to(dtype)
        wf = wf * q.scales[None, :, None, :].to(dtype)
    else:
        wf = w.reshape(ng, din // ng, dout).to(dtype)
        wf = wf * q.scales[:, None, :].to(dtype)
    out = wf.reshape(din, dout)
    return out[:, :q.out_logical] if q.out_logical else out


def concat_qlinear(*qs: QuantizedLinear) -> QuantizedLinear:
    """Concatenate quantized matrices along the output dim (fused QKV,
    gate+up). Requires unpadded operands with matching quantization."""
    first = qs[0]
    if not all(q.bits == first.bits and q.group_size == first.group_size
               and q.qweight.shape[0] == first.qweight.shape[0]
               and not q.out_logical for q in qs):
        raise ValueError("concat requires unpadded operands with matching "
                         "quantization")
    return QuantizedLinear(torch.cat([q.qweight for q in qs], dim=1),
                           torch.cat([q.scales for q in qs], dim=1),
                           first.bits, first.group_size)


def dequant_matmul(x: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    """x [..., in] @ dequantize_weight(q) in x's dtype, f32 accumulation:
    the JAX package's non-kernel product (quant_matmul_ref). On the card
    one cuBLAS product of the dequantized weight (bf16 operands accumulate
    in f32 there); on the CPU in f32, rounded once."""
    w = dequantize_weight(q, dtype=x.dtype)
    if x.device.type == "cuda":
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def wo_matmul(x: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    """x [..., in] @ quantized w -> [..., out].

    Same dispatch rule as the JAX package on its chip
    (weight_only.py:273-287): with INFINITPU_QMM_VARIANT=w4a8, quant_matmul
    on every shape (W4A8 changes the math, not only the kernel); else
    quant_matmul when in >= 512, and dequant_matmul below (small shapes
    were left to XLA there)."""
    if os.environ.get("INFINITPU_QMM_VARIANT") == "w4a8" \
            or x.shape[-1] >= 512:
        from infinitensor_tpu_torch.kernels.quant_matmul import quant_matmul
        return quant_matmul(x, q)
    return dequant_matmul(x, q)
