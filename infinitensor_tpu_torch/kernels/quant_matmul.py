"""Fused weight-only dequant + matmul for decode (counterpart of
infinitensor_tpu/kernels/quant_matmul.py).

Six kernels, CUDA C++ over one group-dot body (csrc/quant_matmul.cuh):
  csrc/quant_matmul.cu
    qmm_group       <- _kernel_group       (group-partial dots, scale per group)
    qmm_group_norm  <- _kernel_group_norm  (RMSNorm fused ahead of the dots)
    qmm_w4a8        <- _kernel_group_w4a8  (int8 activations, int8 dots)
  csrc/quant_matmul_fused.cu
    qmm_group_ln    <- _kernel_group_ln    (LayerNorm ahead, bias behind)
    qmm_slab        <- _kernel_group_slab  (paired int4 scales)
    qmm_slab_norm   <- _kernel_group_norm_slab (RMSNorm ahead of qmm_slab)

Each has a plain PyTorch version here that computes the same function step
by step (`*_plain`). A wrapper given a CPU tensor runs the plain version;
given a CUDA tensor it launches the kernel or raises. `launches` counts
kernel launches per kernel; under CUDA-graph replay it counts the capture,
not the replays.

A paired int4 weight (quantize_weight(paired=True)) takes the slab kernels
whatever the variant table or the caller says, and "slab" asked for an
unpaired weight becomes "group", as in the JAX package
(quant_matmul.py:697-701).

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


def _refusal(x: torch.Tensor, q: QuantizedLinear) -> Optional[str]:
    """Why the kernels do not take (x, q), or None: the shapes the TPU
    kernels refuse (quant_matmul.py:596-604, :696-710). A paired int4
    weight has din / (2 * group) scale rows and goes to the slab kernels;
    an unpaired one needs an even number of scale rows."""
    pack = 2 if q.bits == 4 else 1
    din = x.shape[-1]
    if q.bits not in (4, 8):
        return f"bits={q.bits}: only 4 and 8"
    if din != q.in_features:
        return f"x has {din} features, weight {q.in_features}"
    if q.group_size % 128 or (din // pack) % q.group_size:
        return (f"group_size={q.group_size} must be a multiple of 128 "
                f"dividing {din // pack} stored rows")
    if q.scales.shape[0] * q.group_size * (2 if q.paired else 1) != din:
        return (f"{q.scales.shape[0]} scale rows do not cover {din} "
                f"features in groups of {q.group_size}")
    if q.bits == 4 and not q.paired and q.scales.shape[0] % 2:
        return "unpaired int4 scales need an even number of groups"
    if x.dtype != torch.bfloat16:
        return f"x must be bf16, got {x.dtype}"
    if q.out_physical % 4:
        return "physical output columns must be a multiple of 4"
    return None


def _check(x: torch.Tensor, q: QuantizedLinear) -> None:
    """Raise on what the kernels refuse; callers send more than
    KERNEL_MAX_ROWS rows to dequant_matmul instead."""
    why = _refusal(x, q)
    if why:
        raise ValueError(why)


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


def qmm_slab_plain(x2: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    """_group_dots_slab step by step, for a paired int4 weight: per packed
    group c one dot of [x_lo, x_hi / 16] (the /16 in bf16, exact) against
    [u & 15; u & 0xF0], minus 8 * sum(x_lo), times the one scale s[c]; f32
    accumulation. x [rows, din] bf16 -> [rows, dout_p] bf16."""
    sc = q.scales.float()
    u = q.qweight
    x_hi = (x2[:, q.qweight.shape[0]:] * 0.0625).float()
    xf = torch.cat([x2[:, :q.qweight.shape[0]].float(), x_hi], dim=1)
    pd_lo, pd_hi, sxl = _per_group(xf, q, (u & 15).float(),
                                   (u & -16).float())
    acc = (pd_lo + pd_hi - sxl * 8.0) * sc[None]
    return acc.sum(1).to(torch.bfloat16)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    """_kernel_group_ln's norm (quant_matmul.py:308-313; gpt2._ln is the
    same): f32 mean, f32 variance of x - mean, (x - mean) * rsqrt(var +
    eps) * gamma + beta in f32, rounded once to x's dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


def qmm_group_ln_plain(x2: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, q: QuantizedLinear,
                       bias: Optional[torch.Tensor], eps: float
                       ) -> torch.Tensor:
    """_kernel_group_ln step by step: LayerNorm rounded to bf16, the group
    dots rounded to bf16, then + bias (zero-padded to the physical
    columns) in f32, rounded again. -> [rows, dout_p] bf16."""
    out = qmm_group_plain(layer_norm(x2, gamma, beta, eps), q).float()
    if bias is not None:
        out[:, :bias.shape[-1]] += bias.float()
    return out.to(torch.bfloat16)


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


@functools.cache
def _lib_fused() -> ctypes.CDLL:
    P, I, F = _build.P, _build.I, _build.F
    return _build.typed(
        "quant_matmul_fused",
        qmm_group_ln=[P, P, P, I, P, P, I, P, I, I, P, I, I, I, I, I, F, P],
        qmm_slab=[P, P, P, P, I, P, I, I, I, I, I, F, P])


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


def _launch_slab(x2, norm_w, q, eps: float, name: str) -> torch.Tensor:
    _check_cuda(x2, q)
    rows, din = x2.shape
    out = torch.empty(rows, q.out_physical, dtype=torch.bfloat16,
                      device=x2.device)
    lib = _lib_fused()
    p = _build.ptr
    err = lib.qmm_slab(
        p(x2), p(norm_w), p(q.qweight), p(q.scales),
        q.scales.dtype == torch.bfloat16, p(out), rows, din, q.out_physical,
        q.group_size, norm_w is not None, eps, _build.stream())
    _build.raise_on(lib, err, name)
    launches[name] += 1
    return out


def _launch_group_ln(x2, gamma, beta, q, bias, eps: float) -> torch.Tensor:
    _check_cuda(x2, q)
    for name, t in (("gamma", gamma), ("beta", beta), ("bias", bias)):
        if t is not None and (t.device != x2.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {x2.device}")
    if bias is not None and (
            bias.dtype not in (torch.bfloat16, torch.float32)
            or bias.shape[-1] > q.out_physical):
        raise ValueError(f"bias {bias.dtype} {tuple(bias.shape)}: bf16 or "
                         f"f32, at most {q.out_physical} columns")
    rows, din = x2.shape
    out = torch.empty(rows, q.out_physical, dtype=torch.bfloat16,
                      device=x2.device)
    lib = _lib_fused()
    p = _build.ptr
    err = lib.qmm_group_ln(
        p(x2), p(gamma), p(beta), gamma.dtype == torch.bfloat16,
        p(q.qweight), p(q.scales),
        q.scales.dtype == torch.bfloat16, p(bias),
        bias is not None and bias.dtype == torch.bfloat16,
        0 if bias is None else bias.shape[-1], p(out), rows, din,
        q.out_physical, q.bits, q.group_size, eps, _build.stream())
    _build.raise_on(lib, err, "qmm_group_ln")
    launches["qmm_group_ln"] += 1
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

    variant: "group", "w4a8" or "slab"; None takes the table entry for
    the shape (QMM_VARIANTS), else "group". A paired int4 weight takes
    "slab" whatever was asked, and "slab" on an unpaired weight becomes
    "group". Above KERNEL_MAX_ROWS rows every variant takes
    dequant_matmul."""
    *lead, din = x.shape
    if _rows(x) > KERNEL_MAX_ROWS:
        return _dequant_route(x, q)
    _check(x, q)
    variant = variant or variant_for(din, q)
    if q.paired:
        variant = "slab"        # paired scales exist for the slab kernel
    elif variant == "slab":
        variant = "group"       # slab math needs the paired partition
    x2 = x.reshape(-1, din).contiguous()
    if variant == "slab":
        out = _dispatch(x2, lambda: qmm_slab_plain(x2, q),
                        lambda: _launch_slab(x2, None, q, 0.0, "qmm_slab"))
    elif variant == "group":
        out = _dispatch(x2, lambda: qmm_group_plain(x2, q),
                        lambda: _launch_group(x2, None, q, 0.0,
                                              "qmm_group"))
    elif variant == "w4a8":
        out = _dispatch(x2, lambda: qmm_w4a8_plain(x2, q),
                        lambda: _launch_w4a8(x2, q))
    else:
        raise ValueError(f"variant {variant!r}: 'group', 'w4a8' or 'slab' "
                         "(the chunk and group2d kernels are not ported)")
    return out[:, :q.out_features].reshape(*lead, q.out_features)


def quant_matmul_norm(x: torch.Tensor, norm_w: torch.Tensor,
                      q: QuantizedLinear, eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm(x) * norm_w @ q with the norm fused into the kernel; x is
    the raw residual stream [..., din] bf16."""
    *lead, din = x.shape
    if _rows(x) > KERNEL_MAX_ROWS:
        return _dequant_route(rmsnorm_bf16(x, norm_w, eps), q)
    _check(x, q)
    x2 = x.reshape(-1, din).contiguous()
    nw = norm_w.to(torch.bfloat16).contiguous()
    if q.paired:
        out = _dispatch(
            x2, lambda: qmm_slab_plain(rmsnorm_bf16(x2, nw, eps), q),
            lambda: _launch_slab(x2, nw, q, eps, "qmm_slab_norm"))
        return out[:, :q.out_features].reshape(*lead, q.out_features)
    if variant_for(din, q) != "group":
        raise NotImplementedError(
            "fused norm + w4a8 (_kernel_group_norm_w4a8) is not ported "
            "(ROADMAP Queue 2)")
    out = _dispatch(
        x2, lambda: qmm_group_plain(rmsnorm_bf16(x2, nw, eps), q),
        lambda: _launch_group(x2, nw, q, eps, "qmm_group_norm"))
    return out[:, :q.out_features].reshape(*lead, q.out_features)


def quant_matmul_ln(x: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, q: QuantizedLinear,
                    bias: Optional[torch.Tensor] = None,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm(x; gamma, beta) @ q + bias in one kernel (GPT-2 decode's
    pattern); x is the raw residual stream [..., din] bf16. gamma and beta
    are read as bf16 or f32 and used in f32, as the TPU kernel reads them.

    What _kernel_group_ln does not take (quant_matmul.py:359-365: more
    than KERNEL_MAX_ROWS rows, a paired int4 weight, what the group kernel
    refuses) runs the exact composition, as in the JAX package: layer_norm,
    then quant_matmul (qmm_group or qmm_slab on the card, the dequant route
    above KERNEL_MAX_ROWS rows), then + bias. Where quant_matmul refuses
    too (a group that is no multiple of 128 or a non-bf16 x: the JAX
    package's chunk kernel, ROADMAP Queue 2 item 12) a CPU tensor takes
    dequant_matmul as that kernel's plain version and a CUDA tensor
    raises."""
    *lead, din = x.shape
    kernel_rows = _rows(x) <= KERNEL_MAX_ROWS
    if not kernel_rows or q.paired or _refusal(x, q):
        xn = layer_norm(x, gamma, beta, eps)
        why = _refusal(xn, q) if kernel_rows else None
        if why and x.device.type == "cpu":
            out = _dequant_route(xn, q)
        elif why:
            raise NotImplementedError(
                f"{why}: LayerNorm + the chunk kernel is not ported "
                "(ROADMAP Queue 2 item 12)")
        else:
            out = quant_matmul(xn, q)
        return out if bias is None else out + bias
    x2 = x.reshape(-1, din).contiguous()
    if gamma.dtype != torch.bfloat16 or beta.dtype != torch.bfloat16:
        gamma, beta = gamma.float(), beta.float()     # exact; read as f32
    gamma, beta = gamma.contiguous(), beta.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = _dispatch(
        x2, lambda: qmm_group_ln_plain(x2, gamma, beta, q, bias, eps),
        lambda: _launch_group_ln(x2, gamma, beta, q, bias, eps))
    return out[:, :q.out_features].reshape(*lead, q.out_features)
