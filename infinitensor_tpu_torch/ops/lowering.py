"""Lowering: graph operators -> torch computations (counterpart of
infinitensor_tpu/ops/lowering.py).

One registry, op_type -> function(op, ins, ctx) -> output tensor(s). Every
op lowers to plain torch, run eagerly in topo order (runtime/executor.py
captures the whole sequence in a CUDA graph on the card). The hot LLM ops
call the port's kernel wrappers, selected by ``LowerCtx.use_kernels``
(true when the executor runs on a CUDA device):

* AttentionKVCache(Q8) -> kernels/attention.py decode_attention_gqa(_q8)
  (cache append in place + flash_decode(_q8));
* MatMulWOQ -> kernels/quant_matmul.py quant_matmul / quant_matmul_norm;
* RMSNorm, SkipRMSNorm -> kernels/norms.py rmsnorm;
* G2BMM, GBMM -> kernels/band.py g2bmm_band / gbmm_band at dilation 1; a
  dilated band takes the gather or shift-scan path in plain torch, as in
  the JAX package.

Dtypes follow the JAX package (x64 disabled): a 64-bit int or float
dtype computes as int32 / float32 (``canonical``), and the two operands
of a binary op are promoted as JAX promotes two arrays.

The cache-append lowerings write the new K/V rows INTO the cache tensors
they are given and return them (the JAX package returns new arrays from
donated buffers): a decode step copies no cache. The executor keeps the
caller's inputs unchanged (see runtime/executor.py).

Not ported here, each raising utils/errors.py Refused (a
NotImplementedError) with its ROADMAP.md item: the collectives
(AllReduce*, AllGather, ReduceScatterSum, AllToAll, Broadcast, Send,
Recv: a process group, Queue 1 item 14). An op type with no lowering and
an unknown Pad mode raise Refused too.

MemBound (the expression op) computes through nnet/evaluator.py
evaluate_expr, as in the JAX package: index grids and gathers in eager
torch, captured with the graph on the card.

Random ops (RandomNormal(Like), RandomUniform(Like), Bernoulli) draw from a
torch.Generator seeded with the op's seed; their bits differ from the JAX
package's threefry bits (the tests hold shape, dtype and moments). As in
the JAX package, an op's draw is the same on every call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import zlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from infinitensor_tpu_torch.core import dtype as dt
from infinitensor_tpu_torch.core.dtype import DataType
from infinitensor_tpu_torch.core.operator import Operator
from infinitensor_tpu_torch.kernels import norms
from infinitensor_tpu_torch.kernels.attention import (
    decode_attention_gqa, decode_attention_gqa_q8,
)
from infinitensor_tpu_torch.kernels.band import (
    band_kernels_usable, g2bmm_band, gbmm_band, shifted_rows,
)
from infinitensor_tpu_torch.kernels.quant_matmul import (
    quant_matmul, quant_matmul_norm,
)
from infinitensor_tpu_torch.quant.weight_only import QuantizedLinear
from infinitensor_tpu_torch.utils.errors import Refused

LOWERINGS: dict[str, Callable] = {}


@dataclasses.dataclass
class LowerCtx:
    """Per-executor lowering configuration."""

    use_kernels: bool = False         # route hot ops to the CUDA kernels
    device: Optional[torch.device] = None   # where ops with no input run
    # per-op constants made from host values (random draws, index lists,
    # shapes), keyed (guid, tag, device): made at an op's first, eager run,
    # so a CUDA-graph capture copies nothing from the host
    constants: dict = dataclasses.field(default_factory=dict)


DEFAULT_CTX = LowerCtx()


def register(*op_types):
    def deco(fn):
        for t in op_types:
            LOWERINGS[t] = fn
        return fn
    return deco


def _cached(op, ctx, tag, device, make) -> torch.Tensor:
    """An op's constant tensor on `device`, made once by make() on the
    CPU and kept in ctx.constants."""
    key = (op.guid, tag, str(device))
    if key not in ctx.constants:
        ctx.constants[key] = make().to(device)
    return ctx.constants[key]


def lower_op(op: Operator, ins: list, ctx: LowerCtx = DEFAULT_CTX) -> list:
    try:
        fn = LOWERINGS[op.op_type]
    except KeyError:
        raise Refused(
            f"no lowering for op type {op.op_type!r}") from None
    out = fn(op, ins, ctx)
    return list(out) if isinstance(out, (list, tuple)) else [out]


_CANON = {torch.int64: torch.int32, torch.float64: torch.float32}


def canonical(d: torch.dtype) -> torch.dtype:
    """The dtype the JAX package computes in for `d` (x64 disabled)."""
    return _CANON.get(d, d)


def torch_dtype(d: DataType) -> torch.dtype:
    """A graph DataType as the torch dtype the lowerings compute in."""
    return canonical(d.torch())


def _is_float(x: torch.Tensor) -> bool:
    return x.dtype.is_floating_point


def _promote(a: torch.Tensor, b: torch.Tensor):
    """Two arrays in their common dtype (torch's 0-dim tensors would
    otherwise promote as scalars do; JAX promotes them as arrays)."""
    d = canonical(torch.promote_types(a.dtype, b.dtype))
    return a.to(d), b.to(d)


# ---------------------------------------------------------------------------
# elementwise binary
# ---------------------------------------------------------------------------

_BINARY_FNS = {
    "Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
    "Div": torch.true_divide, "Pow": torch.pow, "Min": torch.minimum,
    "Max": torch.maximum, "Mod": torch.remainder,
    "Equal": torch.eq, "Greater": torch.gt,
    "GreaterOrEqual": torch.ge, "Less": torch.lt,
    "LessOrEqual": torch.le,
    "And": torch.logical_and, "Or": torch.logical_or,
    "Xor": torch.logical_xor,
    "BitwiseAnd": torch.bitwise_and, "BitwiseOr": torch.bitwise_or,
    "BitwiseXor": torch.bitwise_xor,
}


@register(*_BINARY_FNS)
def _binary(op, ins, ctx):
    a, b = _promote(*ins)
    out = _BINARY_FNS[op.op_type](a, b)
    if op.op_type == "Div" and a.dtype in (torch.int32, torch.int64,
                                           torch.int8):
        out = out.to(a.dtype)
    return out


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------

def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _hard_sigmoid(x):
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


_UNARY_FNS = {
    "Relu": torch.relu,
    "Gelu": lambda x: F.gelu(x),
    "Silu": F.silu,
    "Sigmoid": torch.sigmoid,
    "HardSigmoid": _hard_sigmoid,
    "HardSwish": lambda x: x * _hard_sigmoid(x),
    "Tanh": torch.tanh,
    "Erf": torch.erf,
    "Abs": torch.abs,
    "Sqrt": torch.sqrt,
    "Neg": torch.neg,
    "Exp": torch.exp,
    "Log": torch.log,
    "Reciprocal": torch.reciprocal,
    "Floor": torch.floor,
    "Ceil": torch.ceil,
    "Round": torch.round,
    "Not": torch.logical_not,
    "Softplus": _softplus,
    "Sin": torch.sin,
    "Cos": torch.cos,
}


@register(*_UNARY_FNS)
def _unary(op, ins, ctx):
    return _UNARY_FNS[op.op_type](ins[0])


@register("LeakyRelu")
def _leaky_relu(op, ins, ctx):
    alpha = op.attrs.get("alpha", 0.01)
    return torch.where(ins[0] >= 0, ins[0], ins[0] * alpha)


@register("Elu")
def _elu(op, ins, ctx):
    alpha = op.attrs.get("alpha", 1.0)
    x = ins[0]
    return torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))


@register("PRelu")
def _prelu(op, ins, ctx):
    x, slope = _promote(*ins)
    return torch.where(x >= 0, x, x * slope)


@register("Cast")
def _cast(op, ins, ctx):
    return ins[0].to(torch_dtype(DataType.from_onnx(int(op.attrs["to"]))))


@register("CastLike")
def _cast_like(op, ins, ctx):
    return ins[0].to(ins[1].dtype)


@register("Clip")
def _clip(op, ins, ctx):
    x = ins[0]
    lo = ins[1] if len(ins) > 1 and ins[1] is not None else op.attrs.get("min")
    hi = ins[2] if len(ins) > 2 and ins[2] is not None else op.attrs.get("max")
    for bound, fn in ((lo, torch.maximum), (hi, torch.minimum)):
        if bound is None:
            continue
        if isinstance(bound, torch.Tensor):
            x, bound = _promote(x, bound)
            x = fn(x, bound)
        else:
            x = torch.clamp(x, min=bound) if fn is torch.maximum \
                else torch.clamp(x, max=bound)
    return x


@register("Where")
def _where(op, ins, ctx):
    cond, x, y = ins
    x, y = _promote(x, y)
    return torch.where(cond.bool(), x, y)


@register("Dropout")
def _dropout(op, ins, ctx):
    # Inference mode: identity (+ all-true mask if requested).
    outs = [ins[0]]
    if len(op.outputs) > 1:
        outs.append(torch.ones(ins[0].shape, dtype=torch.bool,
                               device=ins[0].device))
    return outs


# ---------------------------------------------------------------------------
# matmul family
# ---------------------------------------------------------------------------

def _maybe_transpose_last2(x, do):
    return x.transpose(-1, -2) if do else x


def _int_matmul(a, b):
    """Exact integer product (CUDA has no integer matmul: f64 there, exact
    below 2^53)."""
    if a.device.type == "cpu":
        return torch.matmul(a.long(), b.long())
    return torch.matmul(a.double(), b.double()).round().long()


def _f32_matmul(a, b):
    """a @ b with f32 accumulation: f32 operands on the CPU; on the card
    bf16 / f16 operands go to cuBLAS as they are (it accumulates in f32)."""
    if a.device.type == "cuda" and a.dtype in (torch.bfloat16, torch.float16) \
            and b.dtype == a.dtype:
        return torch.matmul(a, b).float()
    return torch.matmul(a.float(), b.float())


@register("MatMul")
def _matmul(op, ins, ctx):
    a, b = ins
    a = _maybe_transpose_last2(a, op.attrs.get("transA", False))
    b = _maybe_transpose_last2(b, op.attrs.get("transB", False))
    if _is_float(a):
        return _f32_matmul(a, b).to(a.dtype)
    return _int_matmul(a, b).to(canonical(torch.promote_types(a.dtype,
                                                               b.dtype)))


@register("Gemm")
def _gemm(op, ins, ctx):
    a, b = ins[0], ins[1]
    a = _maybe_transpose_last2(a, op.attrs.get("transA", False))
    b = _maybe_transpose_last2(b, op.attrs.get("transB", False))
    y = _f32_matmul(a, b)
    y = y * op.attrs.get("alpha", 1.0)
    if len(ins) > 2 and ins[2] is not None:
        y = y + op.attrs.get("beta", 1.0) * ins[2].float()
    return y.to(ins[0].dtype)


@register("MatMulInteger")
def _matmul_integer(op, ins, ctx):
    a, b = ins[0].to(torch.int32), ins[1].to(torch.int32)
    if len(ins) > 2 and ins[2] is not None:
        a = a - ins[2].to(torch.int32)
    if len(ins) > 3 and ins[3] is not None:
        b = b - ins[3].to(torch.int32)
    return _int_matmul(a, b).to(torch.int32)


#: gathered band intermediate [b, m, 2w+1, k] larger than this switches to
#: the shift-scan formulation (the JAX package's threshold)
_BAND_GATHER_LIMIT = 1 << 24


def _band_index(m, w, d, device):
    """([m, 2w+1] source rows clipped into [0, m), [m, 2w+1] valid)."""
    offsets = torch.arange(-w, w + 1, device=device) * d
    idx = torch.arange(m, device=device)[:, None] + offsets[None, :]
    valid = (idx >= 0) & (idx < m)
    return idx.clamp(0, m - 1), valid


@register("G2BMM")
def _g2bmm(op, ins, ctx):
    # Band QK^T (Longformer local attention, reference G2BMM.cc): for each
    # row i, dot q_i against k_{i+d*j} for j in [-w, w], zero outside.
    a, b = ins
    w = int(op.attrs["width"])
    d = int(op.attrs.get("dilation", 1))
    bsz, m, k = a.shape
    if ctx.use_kernels and band_kernels_usable("g2bmm", a.dtype, b.dtype,
                                               bsz, m, k, w, d):
        return g2bmm_band(a, b, w, d)
    if bsz * m * (2 * w + 1) * k <= _BAND_GATHER_LIMIT:
        idx, valid = _band_index(m, w, d, a.device)
        bk = b[:, idx, :]                                   # [b, m, 2w+1, k]
        out = torch.einsum("bmk,bmnk->bmn", a.float(), bk.float()).to(a.dtype)
        return torch.where(valid[None], out, torch.zeros((), dtype=out.dtype,
                                                         device=out.device))
    af = a.float()
    cols = [(af * shifted_rows(b, j * d)).sum(-1) for j in range(-w, w + 1)]
    return torch.stack(cols, dim=2).to(a.dtype)


@register("GBMM")
def _gbmm(op, ins, ctx):
    # Band attention @ V: A [b,m,2w+1] band weights, B [b,m,k] values.
    a, b = ins
    n = a.shape[2]
    w = (n - 1) // 2
    d = int(op.attrs.get("dilation", 1))
    bsz, m, k = b.shape
    if ctx.use_kernels and band_kernels_usable("gbmm", a.dtype, b.dtype,
                                               bsz, m, k, w, d):
        return gbmm_band(a, b, w, d)
    if bsz * m * n * k <= _BAND_GATHER_LIMIT:
        idx, valid = _band_index(m, w, d, b.device)
        bv = b[:, idx, :]                                   # [b, m, 2w+1, k]
        aw = torch.where(valid[None], a, torch.zeros((), dtype=a.dtype,
                                                     device=a.device))
        return torch.einsum("bmn,bmnk->bmk", aw.float(), bv.float()).to(b.dtype)
    acc = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    for j in range(n):
        acc += a[:, :, j:j + 1].float() * shifted_rows(b, (j - w) * d)
    return acc.to(b.dtype)


# ---------------------------------------------------------------------------
# conv / pool
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _torch_pads(pads, nsp):
    """ONNX pads [b_0, .., b_n, e_0, .., e_n] as F.pad's (last dim first)."""
    out = []
    for i in reversed(range(nsp)):
        out += [pads[i], pads[nsp + i]]
    return out


@contextlib.contextmanager
def _exact_f32_conv(x):
    """cuDNN's f32 convolutions without TF32 for the block (its default
    allows TF32, whose 10-bit products put EfficientNet-Lite4's logits
    1.05e-3 of max|logit| from the CPU's at 224 x 224, past the vision
    parity bound of 1e-3; chip_smoke.py phase 17). Set around each call
    and restored, so no global setting changes."""
    if x.device.type != "cuda":
        yield
        return
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


@register("Conv")
def _conv(op, ins, ctx):
    x, w = ins[0], ins[1]
    nsp = x.ndim - 2
    strides = tuple(op.attrs.get("strides", [1] * nsp))
    dilations = tuple(op.attrs.get("dilations", [1] * nsp))
    pads = list(op.attrs.get("pads", [0] * (2 * nsp)))
    group = int(op.attrs.get("group", 1))
    xp = F.pad(x.float(), _torch_pads(pads, nsp)) if any(pads) else x.float()
    with _exact_f32_conv(x):
        out = _CONV[nsp](xp, w.float(), None, strides, 0, dilations,
                         group).to(x.dtype)
    if len(ins) > 2 and ins[2] is not None:  # fused bias
        out = out + ins[2].reshape((1, -1) + (1,) * nsp)
    act = op.attrs.get("act")
    if act:
        out = _UNARY_FNS[act](out)
    return out


@register("Im2colMatmulConv")
def _im2col_conv(op, ins, ctx):
    """Conv as im2col (unfold) + matmul (mutator-produced algorithm
    choice)."""
    x, w = ins[0], ins[1]
    n, c, ih, iw = x.shape
    f, _, kh, kw = w.shape
    strides = tuple(op.attrs.get("strides", [1, 1]))
    dilations = tuple(op.attrs.get("dilations", [1, 1]))
    pads = list(op.attrs.get("pads", [0, 0, 0, 0]))
    xp = F.pad(x.float(), _torch_pads(pads, 2)) if any(pads) else x.float()
    cols = F.unfold(xp, (kh, kw), dilation=dilations, stride=strides)
    eff = [(k - 1) * dl + 1 for k, dl in zip((kh, kw), dilations)]
    oh = (xp.shape[2] - eff[0]) // strides[0] + 1
    ow = (xp.shape[3] - eff[1]) // strides[1] + 1
    wf = w.reshape(f, c * kh * kw).float()
    out = torch.einsum("fk,nko->nfo", wf, cols).to(x.dtype)
    return out.reshape(n, f, oh, ow)


@register("ConvTranspose")
def _conv_transpose(op, ins, ctx):
    x, w = ins[0], ins[1]
    nsp = x.ndim - 2
    strides = list(op.attrs.get("strides", [1] * nsp))
    dilations = list(op.attrs.get("dilations", [1] * nsp))
    pads = list(op.attrs.get("pads", [0] * (2 * nsp)))
    opads = list(op.attrs.get("output_padding", [0] * nsp))
    group = int(op.attrs.get("group", 1))
    # the unpadded transpose, then crop pads[i] at the start and
    # pads[nsp + i] - output_padding[i] at the end (zeros past its end)
    with _exact_f32_conv(x):
        full = _CONV_T[nsp](x.float(), w.float(), None, tuple(strides), 0,
                            0, group, tuple(dilations))
    for i in range(nsp):
        dim = 2 + i
        size = full.shape[dim]
        end = size - pads[nsp + i] + opads[i]
        if end > size:
            padw = [0, 0] * (full.ndim - 1 - dim) + [0, end - size]
            full = F.pad(full, padw)
        full = full.narrow(dim, pads[i], end - pads[i])
    out = full.to(x.dtype)
    if len(ins) > 2 and ins[2] is not None:
        out = out + ins[2].reshape((1, -1) + (1,) * nsp)
    return out


def _reduce_window(x, reduce, init, window, strides, padding, dilation=None):
    """lax.reduce_window: pad every dim with `init` ([(lo, hi)] per dim),
    then reduce (torch.amax / torch.sum) each window of `window` elements
    at `strides`, dilated by `dilation`."""
    dilation = dilation or (1,) * x.ndim
    pads = []
    for lo, hi in reversed(padding):
        pads += [lo, hi]
    if any(pads):
        x = F.pad(x, pads, value=init)
    nd = x.ndim
    for dim in range(nd):
        eff = (window[dim] - 1) * dilation[dim] + 1
        x = x.unfold(dim, eff, strides[dim])
        if dilation[dim] > 1:
            x = x[..., ::dilation[dim]]
    return reduce(x, dim=tuple(range(nd, 2 * nd)))


def _pool_common(op, x):
    nsp = x.ndim - 2
    kernel = list(op.attrs["kernel_shape"])
    strides = list(op.attrs.get("strides", [1] * nsp))
    dilations = list(op.attrs.get("dilations", [1] * nsp))
    pads = list(op.attrs.get("pads", [0] * (2 * nsp)))
    ceil_mode = bool(op.attrs.get("ceil_mode", 0))
    padding = [(0, 0), (0, 0)]
    for i in range(nsp):
        pb, pe = pads[i], pads[nsp + i]
        if ceil_mode:
            # extend end padding so the windows cover the ceil window
            eff_k = (kernel[i] - 1) * dilations[i] + 1
            in_d = x.shape[2 + i]
            out_d = math.ceil((in_d + pb + pe - eff_k) / strides[i]) + 1
            need = (out_d - 1) * strides[i] + eff_k - in_d - pb
            pe = max(pe, need)
        padding.append((pb, pe))
    window = (1, 1, *kernel)
    strides_full = (1, 1, *strides)
    dil_full = (1, 1, *dilations)
    return window, strides_full, dil_full, padding


@register("MaxPool")
def _maxpool(op, ins, ctx):
    x = ins[0]
    window, strides, dils, padding = _pool_common(op, x)
    init = -math.inf if _is_float(x) else torch.iinfo(x.dtype).min
    return _reduce_window(x, torch.amax, init, window, strides, padding, dils)


@register("AveragePool")
def _avgpool(op, ins, ctx):
    x = ins[0]
    window, strides, dils, padding = _pool_common(op, x)
    summed = _reduce_window(x.float(), torch.sum, 0.0, window, strides,
                            padding, dils)
    if op.attrs.get("count_include_pad", 0):
        count = math.prod(op.attrs["kernel_shape"])
    else:
        ones = torch.ones(x.shape, dtype=torch.float32, device=x.device)
        count = _reduce_window(ones, torch.sum, 0.0, window, strides,
                               padding, dils)
    return (summed / count).to(x.dtype)


@register("GlobalAveragePool")
def _gap(op, ins, ctx):
    x = ins[0]
    axes = tuple(range(2, x.ndim))
    return x.float().mean(dim=axes, keepdim=True).to(x.dtype)


@register("GlobalMaxPool")
def _gmp(op, ins, ctx):
    x = ins[0]
    return torch.amax(x, dim=tuple(range(2, x.ndim)), keepdim=True)


# ---------------------------------------------------------------------------
# normalization / softmax
# ---------------------------------------------------------------------------

@register("BatchNormalization")
def _batchnorm(op, ins, ctx):
    x, scale, bias, mean, var = ins
    eps = op.attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    out = (x.float() - mean.float().reshape(shape)) * torch.rsqrt(
        var.float().reshape(shape) + eps)
    return (out * scale.reshape(shape) + bias.reshape(shape)).to(x.dtype)


@register("LayerNormalization")
def _layernorm(op, ins, ctx):
    x = ins[0]
    scale = ins[1] if len(ins) > 1 else None
    bias = ins[2] if len(ins) > 2 else None
    axis = op.attrs.get("axis", -1)
    axis = axis + x.ndim if axis < 0 else axis
    axes = tuple(range(axis, x.ndim))
    eps = op.attrs.get("epsilon", 1e-5)
    x32 = x.float()
    mean = x32.mean(dim=axes, keepdim=True)
    var = (x32 - mean).square().mean(dim=axes, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


@register("InstanceNormalization")
def _instancenorm(op, ins, ctx):
    x, scale, bias = ins
    eps = op.attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.ndim))
    x32 = x.float()
    mean = x32.mean(dim=axes, keepdim=True)
    var = x32.var(dim=axes, keepdim=True, unbiased=False)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * scale.reshape(shape) + bias.reshape(shape)).to(x.dtype)


@register("RMSNorm")
def _rmsnorm(op, ins, ctx):
    x, w = ins
    eps = op.attrs.get("epsilon", 1e-6)
    if ctx.use_kernels:
        return norms.rmsnorm(x, w, eps=eps)
    return norms.rmsnorm_plain(x, w, eps)


@register("LRN")
def _lrn(op, ins, ctx):
    x = ins[0]
    alpha = op.attrs.get("alpha", 1e-4)
    beta = op.attrs.get("beta", 0.75)
    bias = op.attrs.get("bias", 1.0)
    size = int(op.attrs["size"])
    x32 = x.float()
    pb = (size - 1) // 2
    pe = size - 1 - pb
    window = (1, size) + (1,) * (x.ndim - 2)
    padding = [(0, 0), (pb, pe)] + [(0, 0)] * (x.ndim - 2)
    sums = _reduce_window(x32.square(), torch.sum, 0.0, window,
                          (1,) * x.ndim, padding)
    return (x32 / torch.pow(bias + (alpha / size) * sums, beta)).to(x.dtype)


@register("Softmax")
def _softmax(op, ins, ctx):
    x = ins[0]
    return torch.softmax(x.float(), dim=op.attrs.get("axis", -1)).to(x.dtype)


@register("LogSoftmax")
def _log_softmax(op, ins, ctx):
    x = ins[0]
    return torch.log_softmax(x.float(),
                             dim=op.attrs.get("axis", -1)).to(x.dtype)


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------

@register("Reshape", "Flatten", "Squeeze", "Unsqueeze")
def _reshape(op, ins, ctx):
    return ins[0].reshape(op.outputs[0].shape)


@register("Identity")
def _identity_l(op, ins, ctx):
    return ins[0]


@register("Shape")
def _shape_l(op, ins, ctx):
    # int64 computes as int32, as in the JAX package (x64 disabled)
    x = ins[0]
    start = op.attrs.get("start", 0)
    end = op.attrs.get("end", x.ndim)
    return _cached(op, ctx, "shape", x.device, lambda: torch.tensor(
        x.shape[start:end], dtype=torch.int32))


@register("Transpose")
def _transpose_l(op, ins, ctx):
    perm = op.attrs.get("perm") or list(reversed(range(ins[0].ndim)))
    return ins[0].permute(*perm)


@register("Concat")
def _concat_l(op, ins, ctx):
    xs = [x for x in ins if x is not None]
    d = xs[0].dtype
    for x in xs[1:]:
        d = torch.promote_types(d, x.dtype)
    return torch.cat([x.to(canonical(d)) for x in xs], dim=op.attrs["axis"])


@register("Split")
def _split_l(op, ins, ctx):
    x = ins[0]
    axis = op.attrs["axis"]
    axis = axis if axis >= 0 else axis + x.ndim
    sizes = [o.shape[axis] for o in op.outputs]
    return list(torch.split(x, sizes, dim=axis))


@register("Slice")
def _slice_l(op, ins, ctx):
    x = ins[0]
    axes = op.attrs.get("axes") or list(range(len(op.attrs["starts"])))
    axes = [a + x.ndim if a < 0 else a for a in axes]
    starts = list(op.attrs["starts"])
    ends = list(op.attrs["ends"])
    steps = list(op.attrs.get("steps") or [1] * len(axes))
    for a, s, e, st in zip(axes, starts, ends, steps):
        d = x.shape[a]
        s = None if s is None else (max(s + d, 0) if s < 0 else min(s, d))
        if st > 0:
            e = None if e is None else (max(e + d, 0) if e < 0 else min(e, d))
            slicer = [slice(None)] * x.ndim
            slicer[a] = slice(s, e, st)
            x = x[tuple(slicer)]
            continue
        e = None if e <= -d - 1 else (e + d if e < 0 else min(e, d))
        if e is not None and e < 0:
            e = None
        # torch slices take no negative step: gather the rows numpy picks
        rows = list(range(d))[slice(s, e, st)]
        x = x.index_select(a, _cached(
            op, ctx, ("slice", a), x.device,
            lambda rows=rows: torch.tensor(rows, dtype=torch.long)))
    return x


def _pad_index(n, lo, hi, mode, device):
    """Source index of each of the lo + n + hi padded positions."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)                         # reflect, no edge repeat
    i = torch.remainder(i, period) if period else torch.zeros_like(i)
    return torch.where(i >= n, period - i, i)


@register("Pad")
def _pad_l(op, ins, ctx):
    x = ins[0]
    pads = list(op.attrs["pads"])
    r = x.ndim
    mode = op.attrs.get("mode", "constant")
    value = op.attrs.get("value", 0.0)
    pos = [(max(pads[i], 0), max(pads[r + i], 0)) for i in range(r)]
    neg = [(min(pads[i], 0), min(pads[r + i], 0)) for i in range(r)]
    if any(p != (0, 0) for p in pos):
        if mode == "constant":
            flat = []
            for lo, hi in reversed(pos):
                flat += [lo, hi]
            x = F.pad(x, flat, value=value)
        elif mode in ("reflect", "edge"):
            for a, (lo, hi) in enumerate(pos):
                if lo or hi:
                    x = x.index_select(a, _pad_index(x.shape[a], lo, hi,
                                                     mode, x.device))
        else:
            raise Refused(f"Pad mode {mode}")
    if any(n != (0, 0) for n in neg):
        slicer = tuple(slice(-nb, x.shape[i] + ne if ne < 0 else None)
                       for i, (nb, ne) in enumerate(neg))
        x = x[slicer]
    return x


def _keys_cubic(x):
    """Keys' cubic kernel, a = -0.5 (jax.image's)."""
    a = -0.5
    out = torch.where(x >= 1.0,
                      ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a,
                      ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in, n_out, kernel, device):
    """jax.image's scale_and_translate weight matrix [n_in, n_out]
    (half-pixel centers, antialiased when downsampling)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs() \
        / kernel_scale
    w = kernel(x)
    tot = w.sum(0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@register("Resize", "Upsample")
def _resize_l(op, ins, ctx):
    """jax.image.resize: nearest takes floor((i + 0.5) * in / out); linear
    and cubic are separable scale_and_translate weight matrices."""
    x = ins[0]
    out_shape = tuple(op.attrs["out_shape"])
    mode = op.attrs.get("mode", "nearest")
    if mode not in ("nearest", "linear", "cubic"):
        raise KeyError(mode)
    y = x if mode == "nearest" else x.float()
    for dim, (n_in, n_out) in enumerate(zip(x.shape, out_shape)):
        if n_in == n_out:
            continue
        if mode == "nearest":
            idx = _cached(op, ctx, ("nearest", dim), x.device, lambda n_in=(
                n_in), n_out=n_out: ((torch.arange(n_out, dtype=torch.float64)
                                      + 0.5) * (n_in / n_out)).floor()
                .long().clamp(max=n_in - 1))
            y = y.index_select(dim, idx)
            continue
        kernel = (lambda t: (1.0 - t).clamp(min=0.0)) if mode == "linear" \
            else _keys_cubic
        wm = _resize_weights(n_in, n_out, kernel, x.device)
        y = torch.tensordot(y, wm, dims=([dim], [0])).movedim(-1, dim)
    return y.to(x.dtype)


@register("Expand")
def _expand_l(op, ins, ctx):
    return ins[0].expand(op.outputs[0].shape)


@register("Tile")
def _tile_l(op, ins, ctx):
    return torch.tile(ins[0], tuple(op.attrs["repeats"]))


def _wrap_index(idx, n):
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


@register("Gather")
def _gather_l(op, ins, ctx):
    data, idx = ins
    axis = op.attrs.get("axis", 0)
    axis = axis + data.ndim if axis < 0 else axis
    flat = _wrap_index(idx, data.shape[axis]).reshape(-1)
    out = data.index_select(axis, flat)
    return out.reshape(data.shape[:axis] + idx.shape + data.shape[axis + 1:])


@register("GatherElements")
def _gather_elements_l(op, ins, ctx):
    data, idx = ins
    axis = op.attrs.get("axis", 0)
    return torch.gather(data, axis, _wrap_index(idx, data.shape[axis]))


@register("ScatterElements")
def _scatter_elements_l(op, ins, ctx):
    data, idx, updates = ins
    axis = op.attrs.get("axis", 0)
    return data.scatter(axis, _wrap_index(idx, data.shape[axis]),
                        updates.to(data.dtype))


def _axes(op, x):
    axes = op.attrs.get("axes")
    if not axes:
        return tuple(range(x.ndim))
    return tuple(a + x.ndim if a < 0 else a for a in axes)


def _sum(x, axes, keep):
    out = torch.sum(x, dim=axes, keepdim=keep)
    return out.to(torch.int32 if x.dtype == torch.bool else x.dtype)


def _prod(x, axes, keep):
    out = x
    for a in sorted(axes, reverse=True):
        out = torch.prod(out, dim=a, keepdim=keep)
    return out.to(torch.int32 if x.dtype == torch.bool else x.dtype)


_REDUCE_FNS = {
    "ReduceMean": lambda x, a, k: torch.mean(x, dim=a, keepdim=k),
    "ReduceSum": _sum,
    "ReduceMax": lambda x, a, k: torch.amax(x, dim=a, keepdim=k),
    "ReduceMin": lambda x, a, k: torch.amin(x, dim=a, keepdim=k),
    "ReduceProd": _prod,
}


@register(*_REDUCE_FNS, "ReduceL2")
def _reduce_l(op, ins, ctx):
    x = ins[0]
    axes = _axes(op, x)
    keep = bool(op.attrs.get("keepdims", 1))
    if op.op_type == "ReduceL2":
        return torch.sqrt(torch.sum(x.float().square(), dim=axes,
                                    keepdim=keep)).to(x.dtype)
    fn = _REDUCE_FNS[op.op_type]
    if op.op_type == "ReduceMean" and _is_float(x):
        return fn(x.float(), axes, keep).to(x.dtype)
    return fn(x, axes, keep)


@register("ArgMax", "ArgMin")
def _argmax_l(op, ins, ctx):
    x = ins[0]
    fn = torch.argmax if op.op_type == "ArgMax" else torch.argmin
    out = fn(x, dim=op.attrs.get("axis", 0),
             keepdim=bool(op.attrs.get("keepdims", 1)))
    return out.to(torch.int32)


@register("DepthToSpace")
def _depth_to_space_l(op, ins, ctx):
    x = ins[0]
    b = int(op.attrs["blocksize"])
    n, c, h, w = x.shape
    mode = op.attrs.get("mode", "DCR")
    if mode == "DCR":
        x = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    else:  # CRD
        x = x.reshape(n, c // (b * b), b, b, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("SpaceToDepth")
def _space_to_depth_l(op, ins, ctx):
    x = ins[0]
    b = int(op.attrs["blocksize"])
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


def _out_device(ins, ctx):
    for x in ins:
        if isinstance(x, torch.Tensor):
            return x.device
    return ctx.device or torch.device("cpu")


@register("ConstantOfShape")
def _constant_of_shape_l(op, ins, ctx):
    shape = tuple(op.attrs["shape"])
    dtype = DataType.from_onnx(int(op.attrs.get("dtype", dt.FLOAT32.onnx_id)))
    return torch.full(shape, op.attrs.get("value", 0),
                      dtype=torch_dtype(dtype), device=_out_device(ins, ctx))


@register("Range")
def _range_l(op, ins, ctx):
    dtype = DataType.from_onnx(int(op.attrs.get("dtype", dt.INT64.onnx_id)))
    return torch.arange(op.attrs["start"], op.attrs["limit"],
                        op.attrs.get("delta", 1),
                        device=_out_device(ins, ctx)).to(torch_dtype(dtype))


# ---------------------------------------------------------------------------
# LLM ops
# ---------------------------------------------------------------------------

@register("RoPE")
def _rope_l(op, ins, ctx):
    """Rotary position embedding, reference semantics
    (src/kernels/cuda/rope.cu:17-31): rotate-half with theta base 10000,
    freq computed per head of size dim_head over the last dim.

    pos: integer positions, broadcastable to x's leading dims.
    x: [..., dim_model] where dim_model = n_heads * dim_head.
    """
    pos, x = ins
    dim_head = int(op.attrs.get("dim_head", 64))
    *lead, dim_model = x.shape
    half = dim_head // 2
    xs = x.reshape(*lead, dim_model // dim_head, dim_head)
    x1 = xs[..., :half].float()
    x2 = xs[..., half:].float()
    base = float(op.attrs.get("theta", 10000.0))
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) * 2.0 / dim_head
    inv_freq = torch.pow(base, exponent)
    theta = pos.float()[..., None, None] * inv_freq
    cos, sin = torch.cos(theta), torch.sin(theta)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    return out.reshape(*lead, dim_model)


@register("AttentionKVCache")
def _attention_kvcache_l(op, ins, ctx):
    """Fused decode attention (reference attention_kvcache.cu semantics):
    append k/v at `position` IN PLACE into the cache tensors, causal
    attention of the single query over cache[0..position]. Returns
    (attn_out, k_cache, v_cache), the caches being the input tensors."""
    k_cache, v_cache, q, k, v, pos = ins
    out, kc, vc = decode_attention_gqa(k_cache, v_cache, q, k, v, pos)
    if len(op.outputs) >= 3:
        return [out, kc, vc]
    return [out]


@register("AttentionKVCacheQ8")
def _attention_kvcache_q8_l(op, ins, ctx):
    """INT8-KV-cache GQA decode attention (ops/shape_rules.py docstring):
    the row quantize and append in place, then flash_decode_q8 on the card
    (its plain version on the CPU)."""
    kc, vc, ks, vs, q, k, v, pos = ins
    return list(decode_attention_gqa_q8(kc, vc, ks, vs, q, k, v, pos))


@register("MatMulWOQ")
def _matmul_woq_l(op, ins, ctx):
    """Weight-only-quantized matmul; rebuilds the QuantizedLinear from the
    graph tensors + attrs and calls the port's matmul wrappers. With a 4th
    input the RMSNorm fuses into the kernel (quant_matmul_norm)."""
    x, qw, sc = ins[0], ins[1], ins[2]
    a = op.attrs
    q = QuantizedLinear(qw, sc, int(a["bits"]), int(a["group_size"]),
                        int(a.get("out_logical", 0)))
    if len(ins) > 3 and ins[3] is not None:
        return quant_matmul_norm(x, ins[3].reshape(-1), q,
                                 eps=float(a.get("eps", 1e-5)))
    return quant_matmul(x, q)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def _qdq_axis_reshape(scale, x_ndim, axis):
    if scale.ndim == 0:
        return scale
    shape = [1] * x_ndim
    shape[axis] = scale.shape[0]
    return scale.reshape(shape)


@register("QuantizeLinear")
def _quantize_linear_l(op, ins, ctx):
    x, scale = ins[0], ins[1]
    zp = ins[2] if len(ins) > 2 and ins[2] is not None else None
    axis = op.attrs.get("axis", 1)
    scale = _qdq_axis_reshape(scale, x.ndim, axis)
    q = torch.round(x / scale)
    if zp is not None:
        q = q + _qdq_axis_reshape(zp, x.ndim, axis).float()
        info = torch.iinfo(zp.dtype)
        return torch.clamp(q, info.min, info.max).to(zp.dtype)
    return torch.clamp(q, 0, 255).to(torch.uint8)


@register("DequantizeLinear")
def _dequantize_linear_l(op, ins, ctx):
    x, scale = ins[0], ins[1]
    zp = ins[2] if len(ins) > 2 and ins[2] is not None else None
    axis = op.attrs.get("axis", 1)
    xf = x.float()
    if zp is not None:
        xf = xf - _qdq_axis_reshape(zp, x.ndim, axis).float()
    return xf * _qdq_axis_reshape(scale, x.ndim, axis)


@register("DynamicQuantizeLinear")
def _dynamic_quantize_linear_l(op, ins, ctx):
    x = ins[0].float()
    xmin = torch.clamp(x.min(), max=0.0)
    xmax = torch.clamp(x.max(), min=0.0)
    scale = (xmax - xmin) / 255.0
    zp = torch.clamp(torch.round(-xmin / scale), 0, 255).to(torch.uint8)
    y = torch.clamp(torch.round(x / scale) + zp.float(), 0, 255)
    return [y.to(torch.uint8), scale, zp]


# ---------------------------------------------------------------------------
# collectives: not ported yet
# ---------------------------------------------------------------------------

@register("AllReduceSum", "AllReduceProd", "AllReduceMin", "AllReduceMax",
          "AllReduceAvg", "AllGather", "ReduceScatterSum", "AllToAll",
          "Broadcast", "Send", "Recv")
def _collective_l(op, ins, ctx):
    raise Refused(
        f"{op.op_type}: the collectives need a torch.distributed process "
        "group and are not ported yet (ROADMAP.md Queue 1 item 14)")


# ---------------------------------------------------------------------------
# expression op (EinNet analog)
# ---------------------------------------------------------------------------

@register("MemBound")
def _membound_l(op, ins, ctx):
    from infinitensor_tpu_torch.nnet.evaluator import evaluate_expr
    return evaluate_expr(op.attrs["expr"], ins, _out_device(ins, ctx))


# ---------------------------------------------------------------------------
# straggler ops from the reference enum
# ---------------------------------------------------------------------------

_UNARY_FNS.update({
    "Tan": torch.tan,
    "Asin": torch.asin,
    "Acos": torch.acos,
    "Atan": torch.atan,
    "Sinh": torch.sinh,
    "Cosh": torch.cosh,
    "Softsign": lambda x: x / (1.0 + torch.abs(x)),
    "Sign": torch.sign,
    "BitwiseNot": torch.bitwise_not,
})
for _n in ("Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh", "Softsign",
           "Sign", "BitwiseNot"):
    LOWERINGS[_n] = _unary


@register("Det")
def _det_l(op, ins, ctx):
    x = ins[0]
    mode = op.attrs.get("mode", 0)  # 0 = det, 1 = logdet (reference det.h:7)
    d = torch.linalg.det(x.float()).to(x.dtype)
    if mode == 1:
        d = torch.log(torch.abs(d))
    if x.ndim == 2:
        d = d.reshape(1)
    return [d]


@register("Extend")
def _extend_l(op, ins, ctx):
    x = ins[0]
    dim = int(op.attrs["dim"]) % x.ndim
    num = int(op.attrs.get("num", 1))
    return [torch.cat([x] * (num + 1), dim=dim)]


@register("TopK")
def _topk_l(op, ins, ctx):
    x = ins[0]
    k = int(op.attrs["k"])
    axis = int(op.attrs.get("axis", -1)) % x.ndim
    largest = bool(int(op.attrs.get("largest", 1)))
    vals, idx = torch.topk(x, k, dim=axis, largest=largest, sorted=True)
    return [vals, idx.to(torch.int32)]


def _scalar(t) -> int:
    return int(t.reshape(-1)[0].item()) if isinstance(t, torch.Tensor) \
        else int(t)


@register("CumSum")
def _cumsum_l(op, ins, ctx):
    x = ins[0]
    axis = int(op.attrs.get("axis", 0))
    if len(ins) > 1 and ins[1] is not None:
        axis = _scalar(ins[1])  # ONNX passes axis as an input tensor
    exclusive = int(op.attrs.get("exclusive", 0))
    reverse = int(op.attrs.get("reverse", 0))
    if reverse:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if exclusive:
        out = out - x
    if reverse:
        out = torch.flip(out, (axis,))
    return [out]


@register("Trilu")
def _trilu_l(op, ins, ctx):
    x = ins[0]
    k = _scalar(ins[1]) if len(ins) > 1 and ins[1] is not None else \
        int(op.attrs.get("k", 0))
    upper = int(op.attrs.get("upper", 1))
    return [torch.triu(x, k) if upper else torch.tril(x, k)]


@register("OneHot")
def _onehot_l(op, ins, ctx):
    idx = ins[0]
    depth = int(op.attrs["depth"])
    axis = int(op.attrs.get("axis", -1))
    off_v, on_v = op.attrs.get("off_value", 0.0), op.attrs.get("on_value", 1.0)
    oh = F.one_hot(torch.remainder(idx.long(), depth), depth).float()
    if axis != -1:
        oh = oh.movedim(-1, axis if axis >= 0 else axis)
    return [oh * (on_v - off_v) + off_v]


@register("ReduceL1")
def _reduce_l1_l(op, ins, ctx):
    axes = op.attrs.get("axes")
    keep = bool(op.attrs.get("keepdims", 1))
    x = ins[0]
    axes = tuple(int(a) for a in axes) if axes is not None \
        else tuple(range(x.ndim))
    return [_sum(torch.abs(x), axes, keep)]


@register("ReluBackward")
def _relu_backward_l(op, ins, ctx):
    y, dy, x = ins
    return [torch.where(x > 0, dy, torch.zeros_like(dy))]


@register("SigmoidBackward")
def _sigmoid_backward_l(op, ins, ctx):
    y, dy, x = ins
    return [dy * y * (1 - y)]


@register("TanhBackward")
def _tanh_backward_l(op, ins, ctx):
    y, dy, x = ins
    return [dy * (1 - y * y)]


@register("SkipRMSNorm")
def _skip_rmsnorm_l(op, ins, ctx):
    # Fused residual-add + RMSNorm (appears in optimized serving graphs):
    # outputs (normed, residual_sum).
    x, residual, g = ins[0], ins[1], ins[2]
    s = x + residual
    eps = float(op.attrs.get("epsilon", 1e-6))
    out = norms.rmsnorm(s, g, eps=eps) if ctx.use_kernels \
        else norms.rmsnorm_plain(s, g, eps)
    return [out, s] if len(op.outputs) > 1 else [out]


# ---------------------------------------------------------------------------
# ONNX coverage beyond the reference importer's 68 ops (widening pass)
# ---------------------------------------------------------------------------

_UNARY_FNS.update({
    "Asinh": torch.asinh,
    "Acosh": torch.acosh,
    "Atanh": torch.atanh,
    "Rsqrt": torch.rsqrt,
    "Square": torch.square,
    "Mish": lambda x: x * torch.tanh(_softplus(x)),
    "IsNaN": torch.isnan,
})
for _n in ("Asinh", "Acosh", "Atanh", "Rsqrt", "Square", "Mish", "IsNaN"):
    LOWERINGS[_n] = _unary


@register("IsInf")
def _isinf_l(op, ins, ctx):
    x = ins[0]
    neg = bool(op.attrs.get("detect_negative", 1))
    pos = bool(op.attrs.get("detect_positive", 1))
    out = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if pos:
        out = out | (x == math.inf)
    if neg:
        out = out | (x == -math.inf)
    return out


_BINARY_FNS.update({
    "FloorDiv": torch.floor_divide,
    "FloorMod": lambda a, b: a - torch.floor_divide(a, b) * b,
    "SquaredDifference": lambda a, b: torch.square(a - b),
})
for _n in ("FloorDiv", "FloorMod", "SquaredDifference"):
    LOWERINGS[_n] = _binary


@register("Selu")
def _selu_l(op, ins, ctx):
    a = float(op.attrs.get("alpha", 1.67326319217681884765625))
    g = float(op.attrs.get("gamma", 1.05070102214813232421875))
    x = ins[0]
    return g * torch.where(x > 0, x, a * (torch.exp(x) - 1.0))


@register("Celu")
def _celu_l(op, ins, ctx):
    a = float(op.attrs.get("alpha", 1.0))
    x = ins[0]
    return torch.clamp(x, min=0) + torch.clamp(a * (torch.exp(x / a) - 1.0),
                                               max=0)


@register("ThresholdedRelu")
def _thresholded_relu_l(op, ins, ctx):
    a = float(op.attrs.get("alpha", 1.0))
    return torch.where(ins[0] > a, ins[0], torch.zeros_like(ins[0]))


@register("Shrink")
def _shrink_l(op, ins, ctx):
    lambd = float(op.attrs.get("lambd", 0.5))
    bias = float(op.attrs.get("bias", 0.0))
    x = ins[0]
    zero = torch.zeros_like(x)
    return torch.where(x < -lambd, x + bias,
                       torch.where(x > lambd, x - bias, zero))


@register("Hardtanh")
def _hardtanh_l(op, ins, ctx):
    lo = float(op.attrs.get("min_val", -1.0))
    hi = float(op.attrs.get("max_val", 1.0))
    return torch.clamp(ins[0], lo, hi)


@register("Hardmax")
def _hardmax_l(op, ins, ctx):
    x = ins[0]
    axis = int(op.attrs.get("axis", -1))
    oh = F.one_hot(torch.argmax(x, dim=axis), x.shape[axis]).to(x.dtype)
    return oh.movedim(-1, axis)


@register("Sum", "MeanN")
def _variadic_l(op, ins, ctx):
    out = ins[0]
    for x in ins[1:]:
        out, x = _promote(out, x)
        out = out + x
    if op.op_type == "MeanN":
        out = out / len(ins)
    return out


@register("ReduceLogSum", "ReduceLogSumExp", "ReduceSumSquare")
def _reduce_more_l(op, ins, ctx):
    x = ins[0]
    axes = _axes(op, x)
    keep = bool(op.attrs.get("keepdims", 1))
    xf = x.float() if _is_float(x) else x
    if op.op_type == "ReduceLogSum":
        out = torch.log(torch.sum(xf, dim=axes, keepdim=keep))
    elif op.op_type == "ReduceLogSumExp":
        out = torch.logsumexp(xf, dim=axes, keepdim=keep)
    else:
        out = torch.sum(torch.square(xf), dim=axes, keepdim=keep)
    return out.to(x.dtype)


@register("Einsum")
def _einsum_l(op, ins, ctx):
    d = ins[0].dtype
    for x in ins[1:]:
        d = torch.promote_types(d, x.dtype)
    d = canonical(d)
    return torch.einsum(op.attrs["equation"], *[x.to(d) for x in ins])


def _coords(idx):
    return tuple(idx.long().movedim(-1, 0))


@register("GatherND")
def _gather_nd_l(op, ins, ctx):
    data, idx = ins[0], ins[1]
    b = int(op.attrs.get("batch_dims", 0))
    if b == 0:
        return data[_coords(idx)]
    # prepend broadcast batch index grids for the leading b dims
    grids = torch.meshgrid(*(torch.arange(d, device=idx.device)
                             for d in idx.shape[:-1]), indexing="ij")
    return data[tuple(grids[:b]) + _coords(idx)]


@register("ScatterND")
def _scatter_nd_l(op, ins, ctx):
    data, idx, updates = ins
    reduction = op.attrs.get("reduction", "none")
    coords = _coords(idx)
    updates = updates.to(data.dtype)
    if reduction == "add":
        return data.index_put(coords, updates, accumulate=True)
    # flatten the indexed leading dims
    n = len(coords)
    lead = data.shape[:n]
    lin = torch.zeros_like(coords[0])
    for c, size in zip(coords, lead):
        lin = lin * size + c
    lin = lin.reshape(-1)
    upd = updates.reshape(-1, *data.shape[n:])
    if reduction == "none":
        # duplicate indices: the last update wins on every device, the
        # JAX executor's order (CUDA's index_put leaves it unspecified):
        # each duplicate writes the last one's value (no host sync, so
        # the op can sit in a captured graph)
        at = torch.arange(lin.numel(), device=lin.device)
        last = torch.full((math.prod(lead),), -1, dtype=torch.long,
                          device=lin.device).scatter_reduce(0, lin, at,
                                                            "amax")
        return data.index_put(tuple(c.reshape(-1) for c in coords),
                              upd[last[lin]])
    flat = data.reshape(math.prod(lead), *data.shape[n:]).clone()
    red = {"mul": "prod", "max": "amax", "min": "amin"}[reduction]
    flat.index_reduce_(0, lin, upd, red)
    return flat.reshape(data.shape)


@register("GroupNormalization")
def _group_norm_l(op, ins, ctx):
    x, scale, bias = ins
    g = int(op.attrs["num_groups"])
    eps = float(op.attrs.get("epsilon", 1e-5))
    n, c = x.shape[0], x.shape[1]
    xf = x.float().reshape((n, g, c // g, *x.shape[2:]))
    axes = tuple(range(2, xf.ndim))
    mean = xf.mean(dim=axes, keepdim=True)
    var = xf.var(dim=axes, keepdim=True, unbiased=False)
    xn = ((xf - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    return (xn * scale.reshape(shape).float()
            + bias.reshape(shape).float()).to(x.dtype)


@register("MeanVarianceNormalization")
def _mvn_l(op, ins, ctx):
    x = ins[0]
    axes = tuple(op.attrs.get("axes", (0, 2, 3)))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    std = xf.std(dim=axes, keepdim=True, unbiased=False)
    return ((xf - mean) / (std + 1e-9)).to(x.dtype)


@register("LpNormalization")
def _lp_norm_l(op, ins, ctx):
    x = ins[0]
    axis = int(op.attrs.get("axis", -1))
    p = int(op.attrs.get("p", 2))
    xf = x.float()
    if p == 1:
        norm = torch.sum(torch.abs(xf), dim=axis, keepdim=True)
    else:
        norm = torch.sqrt(torch.sum(torch.square(xf), dim=axis,
                                    keepdim=True))
    return (xf / torch.clamp(norm, min=1e-12)).to(x.dtype)


@register("LpPool", "GlobalLpPool")
def _lp_pool_l(op, ins, ctx):
    x = ins[0]
    p = int(op.attrs.get("p", 2))
    xf = torch.abs(x.float()) ** p
    if op.op_type == "GlobalLpPool":
        s = torch.sum(xf, dim=tuple(range(2, x.ndim)), keepdim=True)
        return (s ** (1.0 / p)).to(x.dtype)
    nsp = x.ndim - 2
    kernel = list(op.attrs["kernel_shape"])
    strides = list(op.attrs.get("strides", [1] * nsp))
    pads = list(op.attrs.get("pads", [0] * 2 * nsp))
    padding = [(0, 0), (0, 0)] + [(pads[i], pads[nsp + i])
                                  for i in range(nsp)]
    s = _reduce_window(xf, torch.sum, 0.0, (1, 1, *kernel),
                       (1, 1, *strides), padding)
    return (s ** (1.0 / p)).to(x.dtype)


@register("EyeLike")
def _eye_like_l(op, ins, ctx):
    x = ins[0]
    k = int(op.attrs.get("k", 0))
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    cols = torch.arange(x.shape[1], device=x.device)[None, :]
    return (cols - rows == k).to(torch_dtype(op.outputs[0].dtype))


def _op_seed(op) -> int:
    seed = op.attrs.get("seed")
    if seed is None:
        # deterministic per-op fallback (ONNX leaves seedless behavior
        # implementation-defined); crc32, not hash(): stable across runs
        seed = zlib.crc32(str(op.attrs.get("_name", op.op_type)).encode())
    return int(seed) & 0x7FFFFFFF


def _draw(op, ctx, device, make):
    """The op's constant random tensor on `device`: made once from a
    torch.Generator seeded with the op's seed, on the CPU (so a captured
    CUDA graph replays the same draw, as the JAX package's static key gives
    the same bits every call)."""
    return _cached(op, ctx, "draw", device, lambda: make(
        torch.Generator().manual_seed(_op_seed(op))))


@register("RandomNormal", "RandomNormalLike")
def _random_normal_l(op, ins, ctx):
    shape = op.outputs[0].shape
    dtype = torch_dtype(op.outputs[0].dtype)
    mean = float(op.attrs.get("mean", 0.0))
    scale = float(op.attrs.get("scale", 1.0))
    return _draw(op, ctx, _out_device(ins, ctx), lambda g: (
        torch.randn(shape, generator=g) * scale + mean).to(dtype))


@register("RandomUniform", "RandomUniformLike")
def _random_uniform_l(op, ins, ctx):
    shape = op.outputs[0].shape
    dtype = torch_dtype(op.outputs[0].dtype)
    lo = float(op.attrs.get("low", 0.0))
    hi = float(op.attrs.get("high", 1.0))
    return _draw(op, ctx, _out_device(ins, ctx), lambda g: (
        torch.rand(shape, generator=g) * (hi - lo) + lo).to(dtype))


@register("Bernoulli")
def _bernoulli_l(op, ins, ctx):
    p = ins[0].float()
    dtype = torch_dtype(op.outputs[0].dtype)
    u = _draw(op, ctx, p.device,
              lambda g: torch.rand(tuple(p.shape), generator=g))
    return (u < p).to(dtype)
