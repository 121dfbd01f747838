"""Fused weight-only dequant + matmul for decode (counterpart of
infinitensor_tpu/kernels/quant_matmul.py).

Three kernels, CUDA C++ in csrc/quant_matmul.cu:
  qmm_group       <- _kernel_group       (group-partial dots, scale per group)
  qmm_group_norm  <- _kernel_group_norm  (RMSNorm fused ahead of the dots)
  qmm_w4a8        <- _kernel_group_w4a8  (int8 activations, int8 dots)

Each has a plain PyTorch version here that computes the same function step
by step (`*_plain`). A wrapper given a CPU tensor runs the plain version;
given a CUDA tensor it launches the kernel or raises. `launches` counts
kernel launches per kernel; under CUDA-graph replay it counts the capture,
not the replays.

Above 256 rows (a long prompt) the JAX package takes no kernel: it
dequantizes the weight and runs one matmul (quant_matmul_ref,
quant_matmul.py:39-41,599-604,708-710), with the "group" semantics even
for a shape tuned to w4a8. The wrappers follow that rule on every device
(weight_only.dequant_matmul, after rmsnorm_bf16 for the fused-norm
wrapper) and count it in `launches` as "dequant_matmul", a route and not
a kernel of this package.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from infinitensor_tpu_torch.kernels import _build
from infinitensor_tpu_torch.quant.weight_only import (
    QuantizedLinear, dequant_matmul,
)

# The variant column of the JAX package's tuning table (docs/qmm_tune.json,
# keyed "din:dout:bits"); its TPU output tiles do not apply here. Shapes
# not listed take "group".
QMM_VARIANTS = {
    "4096:12288:4": "group",
    "4096:4096:4": "group",
    "4096:22016:4": "group",
    "11008:4096:4": "group",
    "4096:32000:4": "w4a8",
}

launches = collections.Counter()


def variant_for(din: int, q: QuantizedLinear) -> str:
    return QMM_VARIANTS.get(f"{din}:{q.out_features}:{q.bits}", "group")


KERNEL_MAX_ROWS = 256


def _rows(x: torch.Tensor) -> int:
    return x.numel() // max(x.shape[-1], 1)


def _check(x: torch.Tensor, q: QuantizedLinear) -> None:
    """Refuse the shapes the TPU kernels refuse
    (quant_matmul.py:596-604, :696-710); callers send more than
    KERNEL_MAX_ROWS rows to dequant_matmul instead."""
    pack = 2 if q.bits == 4 else 1
    din = x.shape[-1]
    if q.bits not in (4, 8):
        raise ValueError(f"bits={q.bits}: only 4 and 8")
    if din != q.in_features:
        raise ValueError(f"x has {din} features, weight {q.in_features}")
    if q.group_size % 128 or (din // pack) % q.group_size:
        raise ValueError(f"group_size={q.group_size} must be a multiple of "
                         f"128 dividing {din // pack} stored rows")
    if q.bits == 4 and (q.paired or q.scales.shape[0] % 2):
        raise ValueError("paired or odd-group int4 scales need the slab "
                         "kernel (not ported)")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bf16, got {x.dtype}")
    if q.out_physical % 4:
        raise ValueError("physical output columns must be a multiple of 4")


def _dequant_route(x: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    if x.shape[-1] != q.in_features:
        raise ValueError(f"x has {x.shape[-1]} features, weight "
                         f"{q.in_features}")
    launches["dequant_matmul"] += 1
    return dequant_matmul(x, q)


def _per_group(x2: torch.Tensor, q: QuantizedLinear, w_lo, w_hi):
    """Per-group partial dots of the split-half int4 layout:
    returns ([rows, ngh, dout_p] x_lo . w_lo, same for x_hi . w_hi, and
    sum(x_lo) per group [rows, ngh, 1]); inputs f32."""
    g = q.group_size
    half = q.qweight.shape[0]
    ngh = half // g
    rows = x2.shape[0]
    xl = x2[:, :half].reshape(rows, ngh, g)
    xh = x2[:, half:].reshape(rows, ngh, g)
    pd_lo = torch.einsum("rcg,cgo->rco", xl, w_lo.reshape(ngh, g, -1))
    pd_hi = torch.einsum("rcg,cgo->rco", xh, w_hi.reshape(ngh, g, -1))
    return pd_lo, pd_hi, xl.sum(-1, keepdim=True)


def qmm_group_plain(x2: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    """_group_dots step by step: x [rows, din] bf16 -> [rows, dout_p] bf16.
    int4: per group c, (x_lo . (u & 15) - 8 * sum(x_lo)) * s[c] +
    x_hi . (u & 0xF0) * s[ng/2 + c] / 16, f32 accumulation; int8:
    (x . w) * s[c]."""
    xf = x2.float()
    sc = q.scales.float()
    g = q.group_size
    if q.bits == 8:
        ng = q.qweight.shape[0] // g
        pd = torch.einsum("rcg,cgo->rco", xf.reshape(-1, ng, g),
                          q.qweight.float().reshape(ng, g, -1))
        return (pd * sc[None]).sum(1).to(torch.bfloat16)
    u = q.qweight
    lo8 = (u & 15).float()                 # lo + 8 (offset-binary)
    hi16 = (u & -16).float()               # 16 * hi
    pd_lo, pd_hi, sxl = _per_group(xf, q, lo8, hi16)
    ngh = pd_lo.shape[1]
    acc = (pd_lo - sxl * 8.0) * sc[None, :ngh] \
        + pd_hi * (sc[None, ngh:] * 0.0625)
    return acc.sum(1).to(torch.bfloat16)


def rmsnorm_bf16(x2: torch.Tensor, norm_w: torch.Tensor, eps: float
                 ) -> torch.Tensor:
    """The fused kernels' norm (quant_matmul.py:92-95): f32 mean of
    squares, x * rsqrt(ms + eps) rounded to bf16, times the bf16 weight."""
    x32 = x2.float()
    ms = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps)).to(torch.bfloat16) \
        * norm_w.to(torch.bfloat16)


def quantize_rows_i8(x2: torch.Tensor):
    """_quantize_rows_i8: per-row symmetric int8, sx = max(amax, 1e-30) *
    f32(1/127), round half to even, clip +-127. -> (xq int8, sx f32
    [rows, 1])."""
    x32 = x2.float()
    amax = x32.abs().amax(-1, keepdim=True)
    sx = torch.clamp(amax, min=1e-30) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    return xq, sx


def qmm_w4a8_plain(x2: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    """_group_dots_w4a8 step by step: exact integer group dots (held in
    f64, which is exact at these magnitudes), rescaled in f32 per group by
    s_lo and s_hi / 16, times sx."""
    xq, sx = quantize_rows_i8(x2)
    sc = q.scales.float()
    g = q.group_size
    xd = xq.double()
    if q.bits == 8:
        ng = q.qweight.shape[0] // g
        pd = torch.einsum("rcg,cgo->rco", xd.reshape(-1, ng, g),
                          q.qweight.double().reshape(ng, g, -1))
        acc = (pd.float() * sc[None]).sum(1)
        return (acc * sx).to(torch.bfloat16)
    u = q.qweight
    pd_lo, pd_hi, sxl = _per_group(xd, q, (u & 15).double(),
                                   (u & -16).double())
    ngh = pd_lo.shape[1]
    acc = (pd_lo - sxl * 8).float() * sc[None, :ngh] \
        + pd_hi.float() * (sc[None, ngh:] * 0.0625)
    return (acc.sum(1) * sx).to(torch.bfloat16)


@functools.cache
def _lib() -> ctypes.CDLL:
    P, I, F = _build.P, _build.I, _build.F
    return _build.typed(
        "quant_matmul",
        qmm_group=[P, P, P, P, I, P, I, I, I, I, I, I, F, P],
        qmm_w4a8=[P, P, P, I, P, I, I, I, I, I, P])


def _check_cuda(x2: torch.Tensor, q: QuantizedLinear) -> None:
    for name, t in (("x", x2), ("qweight", q.qweight), ("scales", q.scales)):
        if t.device != x2.device:
            raise ValueError(f"{name} on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.qweight.dtype != torch.int8 or q.qweight.data_ptr() % 16:
        raise ValueError("qweight must be 16-byte aligned int8")
    if q.scales.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"scales must be bf16 or f32, got {q.scales.dtype}")


def _launch_group(x2, norm_w, q, eps: float, name: str) -> torch.Tensor:
    _check_cuda(x2, q)
    rows, din = x2.shape
    out = torch.empty(rows, q.out_physical, dtype=torch.bfloat16,
                      device=x2.device)
    lib = _lib()
    p = _build.ptr
    err = lib.qmm_group(
        p(x2), p(norm_w), p(q.qweight), p(q.scales),
        q.scales.dtype == torch.bfloat16, p(out), rows, din, q.out_physical,
        q.bits, q.group_size, norm_w is not None, eps, _build.stream())
    _build.raise_on(lib, err, name)
    launches[name] += 1
    return out


def _launch_w4a8(x2, q) -> torch.Tensor:
    _check_cuda(x2, q)
    rows, din = x2.shape
    out = torch.empty(rows, q.out_physical, dtype=torch.bfloat16,
                      device=x2.device)
    lib = _lib()
    p = _build.ptr
    err = lib.qmm_w4a8(
        p(x2), p(q.qweight), p(q.scales), q.scales.dtype == torch.bfloat16,
        p(out), rows, din, q.out_physical, q.bits, q.group_size,
        _build.stream())
    _build.raise_on(lib, err, "qmm_w4a8")
    launches["qmm_w4a8"] += 1
    return out


def _dispatch(x2: torch.Tensor, plain, launch):
    if x2.device.type == "cpu":
        return plain()
    if x2.device.type == "cuda":
        return launch()
    raise ValueError(f"unsupported device {x2.device}")


def quant_matmul(x: torch.Tensor, q: QuantizedLinear,
                 variant: Optional[str] = None) -> torch.Tensor:
    """x [..., din] bf16 @ q -> [..., out_features] bf16.

    variant: "group" or "w4a8"; None takes the table entry for the shape
    (QMM_VARIANTS), else "group". Above KERNEL_MAX_ROWS rows every
    variant takes dequant_matmul."""
    *lead, din = x.shape
    if _rows(x) > KERNEL_MAX_ROWS:
        return _dequant_route(x, q)
    _check(x, q)
    variant = variant or variant_for(din, q)
    x2 = x.reshape(-1, din).contiguous()
    if variant == "group":
        out = _dispatch(x2, lambda: qmm_group_plain(x2, q),
                        lambda: _launch_group(x2, None, q, 0.0,
                                              "qmm_group"))
    elif variant == "w4a8":
        out = _dispatch(x2, lambda: qmm_w4a8_plain(x2, q),
                        lambda: _launch_w4a8(x2, q))
    else:
        raise ValueError(f"variant {variant!r}: 'group' or 'w4a8' (the "
                         "chunk, slab and group2d kernels are not ported)")
    return out[:, :q.out_features].reshape(*lead, q.out_features)


def quant_matmul_norm(x: torch.Tensor, norm_w: torch.Tensor,
                      q: QuantizedLinear, eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm(x) * norm_w @ q with the norm fused into the kernel; x is
    the raw residual stream [..., din] bf16."""
    *lead, din = x.shape
    if _rows(x) > KERNEL_MAX_ROWS:
        return _dequant_route(rmsnorm_bf16(x, norm_w, eps), q)
    _check(x, q)
    if variant_for(din, q) != "group":
        raise NotImplementedError(
            "fused norm + w4a8 (_kernel_group_norm_w4a8) is not ported "
            "(ROADMAP Queue 2)")
    x2 = x.reshape(-1, din).contiguous()
    nw = norm_w.to(torch.bfloat16).contiguous()
    out = _dispatch(
        x2, lambda: qmm_group_plain(rmsnorm_bf16(x2, nw, eps), q),
        lambda: _launch_group(x2, nw, q, eps, "qmm_group_norm"))
    return out[:, :q.out_features].reshape(*lead, q.out_features)
