"""Shape + dtype inference, one rule per op_type.

Replaces the reference's per-op ``inferShape``/``inferDataType`` virtuals
(reference src/operators/*.cc, include/core/operator.h:46-129) with a registry
keyed by op_type. Rules are pure: ``rule(op) -> [(shape, dtype), ...]`` for
each output, reading ``op.inputs`` metadata and ``op.attrs``.

All shapes are static: the JAX package compiles one XLA program per shape,
and this port captures one CUDA graph per input signature. Dynamic behaviors of
the reference (growing KV cache, dynamic batch) are static-shape equivalents
(preallocated cache + position scalar; a new signature via
Graph.change_shape + shape_infer).

Copy of infinitensor_tpu/ops/shape_rules.py (no jax code).
"""

from __future__ import annotations

import math
from typing import Callable

from infinitensor_tpu_torch.core import dtype as dt
from infinitensor_tpu_torch.core.dtype import DataType
from infinitensor_tpu_torch.core.operator import (
    Operator, UNARY_OPS, BINARY_OPS,
)

SHAPE_RULES: dict[str, Callable[[Operator], list]] = {}

COMPARE_OPS = {"Equal", "Greater", "GreaterOrEqual", "Less", "LessOrEqual"}
LOGICAL_OPS = {"And", "Or", "Xor"}


def register(*op_types):
    def deco(fn):
        for t in op_types:
            SHAPE_RULES[t] = fn
        return fn
    return deco


def infer_shapes(op: Operator) -> list:
    try:
        rule = SHAPE_RULES[op.op_type]
    except KeyError:
        raise NotImplementedError(
            f"no shape rule for op type {op.op_type!r}") from None
    return rule(op)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def broadcast_shapes(*shapes) -> tuple[int, ...]:
    """Numpy multidirectional broadcast (reference utils/operator_utils.h:13)."""
    rank = max(len(s) for s in shapes)
    out = []
    for i in range(rank):
        dim = 1
        for s in shapes:
            d = s[len(s) - rank + i] if len(s) - rank + i >= 0 else 1
            if d == 1:
                continue
            if dim == 1:
                dim = d
            elif dim != d:
                raise ValueError(f"cannot broadcast shapes {shapes}")
        out.append(dim)
    return tuple(out)


def _norm_axis(axis: int, rank: int) -> int:
    if axis < 0:
        axis += rank
    if not (0 <= axis < rank):
        raise ValueError(f"axis {axis} out of range for rank {rank}")
    return axis


def _in(op, i):
    t = op.inputs[i]
    if t is None:
        raise ValueError(f"{op.op_type}: required input {i} is missing")
    return t


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------

@register(*BINARY_OPS)
def _binary(op):
    a, b = _in(op, 0), _in(op, 1)
    shape = broadcast_shapes(a.shape, b.shape)
    if op.op_type in COMPARE_OPS:
        return [(shape, dt.BOOL)]
    if op.op_type in LOGICAL_OPS:
        return [(shape, dt.BOOL)]
    return [(shape, a.dtype)]


@register(*(UNARY_OPS - {"Not"}))
def _unary(op):
    x = _in(op, 0)
    return [(x.shape, x.dtype)]


@register("Not")
def _not(op):
    return [(_in(op, 0).shape, dt.BOOL)]


@register("Cast")
def _cast(op):
    x = _in(op, 0)
    return [(x.shape, DataType.from_onnx(int(op.attrs["to"])))]


@register("CastLike")
def _cast_like(op):
    return [(_in(op, 0).shape, _in(op, 1).dtype)]


@register("Clip")
def _clip(op):
    x = _in(op, 0)
    return [(x.shape, x.dtype)]


@register("Where")
def _where(op):
    # ONNX order: (condition, X, Y). (The reference handler flips argument
    # order, include/core/graph_handler.h:108; we keep ONNX order in the IR.)
    cond, x, y = _in(op, 0), _in(op, 1), _in(op, 2)
    return [(broadcast_shapes(cond.shape, x.shape, y.shape), x.dtype)]


@register("PRelu")
def _prelu(op):
    x, slope = _in(op, 0), _in(op, 1)
    return [(broadcast_shapes(x.shape, slope.shape), x.dtype)]


@register("Dropout")
def _dropout(op):
    x = _in(op, 0)
    outs = [(x.shape, x.dtype)]
    if len(op.outputs) > 1:
        outs.append((x.shape, dt.BOOL))
    return outs


# ---------------------------------------------------------------------------
# matmul family
# ---------------------------------------------------------------------------

@register("MatMul")
def _matmul(op):
    # Reference MatmulObj (include/operators/matmul.h:9-72): transA/B, batch
    # broadcast, optional bias via separate Add.
    a, b = _in(op, 0), _in(op, 1)
    ta = bool(op.attrs.get("transA", False))
    tb = bool(op.attrs.get("transB", False))
    sa, sb = list(a.shape), list(b.shape)
    if len(sa) == 1:
        sa = [1] + sa
    if len(sb) == 1:
        sb = sb + [1]
    m, ka = (sa[-1], sa[-2]) if ta else (sa[-2], sa[-1])
    kb, n = (sb[-1], sb[-2]) if tb else (sb[-2], sb[-1])
    if ka != kb:
        raise ValueError(
            f"MatMul contraction mismatch: {a.shape} x {b.shape} "
            f"(transA={ta}, transB={tb})")
    batch = broadcast_shapes(tuple(sa[:-2]), tuple(sb[:-2]))
    shape = tuple(batch) + (m, n)
    if len(a.shape) == 1:
        shape = tuple(batch) + (n,)
    if len(b.shape) == 1:
        shape = tuple(batch) + (m,)
    return [(shape, a.dtype)]


@register("Gemm")
def _gemm(op):
    a, b = _in(op, 0), _in(op, 1)
    ta = bool(op.attrs.get("transA", False))
    tb = bool(op.attrs.get("transB", False))
    m = a.shape[1] if ta else a.shape[0]
    n = b.shape[0] if tb else b.shape[1]
    return [((m, n), a.dtype)]


@register("MatMulInteger")
def _matmul_integer(op):
    a, b = _in(op, 0), _in(op, 1)
    batch = broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return [(tuple(batch) + (a.shape[-2], b.shape[-1]), dt.INT32)]


@register("G2BMM")
def _g2bmm(op):
    # Longformer band QK^T: A,B [b,m,k] -> [b,m,2w+1]
    # (reference src/operators/G2BMM.cc:24-37)
    a, b = _in(op, 0), _in(op, 1)
    assert a.rank == 3 and b.rank == 3 and a.shape == b.shape
    w = int(op.attrs["width"])
    return [((a.shape[0], a.shape[1], 2 * w + 1), a.dtype)]


@register("GBMM")
def _gbmm(op):
    # Band attn @ V: A [b,m,2w+1], B [b,m,k] -> [b,m,k]
    # (reference src/operators/GBMM.cc)
    a, b = _in(op, 0), _in(op, 1)
    assert a.rank == 3 and b.rank == 3
    return [((a.shape[0], a.shape[1], b.shape[2]), b.dtype)]


# ---------------------------------------------------------------------------
# conv / pool
# ---------------------------------------------------------------------------

def _conv_out_dim(x, k, pad_b, pad_e, stride, dilation, ceil_mode=False):
    eff_k = (k - 1) * dilation + 1
    num = x + pad_b + pad_e - eff_k
    if ceil_mode:
        return int(math.ceil(num / stride)) + 1
    return num // stride + 1


@register("Conv", "Im2colMatmulConv")
def _conv(op):
    x, w = _in(op, 0), _in(op, 1)
    spatial = x.shape[2:]
    nsp = len(spatial)
    strides = list(op.attrs.get("strides", [1] * nsp))
    dilations = list(op.attrs.get("dilations", [1] * nsp))
    pads = list(op.attrs.get("pads", [0] * (2 * nsp)))
    group = int(op.attrs.get("group", 1))
    if x.shape[1] != w.shape[1] * group:
        raise ValueError(
            f"Conv channel mismatch: x {x.shape}, w {w.shape}, group {group}")
    out_sp = [
        _conv_out_dim(spatial[i], w.shape[2 + i], pads[i], pads[nsp + i],
                      strides[i], dilations[i])
        for i in range(nsp)
    ]
    return [((x.shape[0], w.shape[0], *out_sp), x.dtype)]


@register("ConvTranspose")
def _conv_transpose(op):
    x, w = _in(op, 0), _in(op, 1)
    spatial = x.shape[2:]
    nsp = len(spatial)
    strides = list(op.attrs.get("strides", [1] * nsp))
    dilations = list(op.attrs.get("dilations", [1] * nsp))
    pads = list(op.attrs.get("pads", [0] * (2 * nsp)))
    opads = list(op.attrs.get("output_padding", [0] * nsp))
    group = int(op.attrs.get("group", 1))
    out_sp = [
        strides[i] * (spatial[i] - 1) + opads[i]
        + ((w.shape[2 + i] - 1) * dilations[i] + 1) - pads[i] - pads[nsp + i]
        for i in range(nsp)
    ]
    return [((x.shape[0], w.shape[1] * group, *out_sp), x.dtype)]


@register("MaxPool", "AveragePool")
def _pool(op):
    x = _in(op, 0)
    spatial = x.shape[2:]
    nsp = len(spatial)
    kernel = list(op.attrs["kernel_shape"])
    strides = list(op.attrs.get("strides", [1] * nsp))
    dilations = list(op.attrs.get("dilations", [1] * nsp))
    pads = list(op.attrs.get("pads", [0] * (2 * nsp)))
    ceil_mode = bool(op.attrs.get("ceil_mode", 0))
    out_sp = [
        _conv_out_dim(spatial[i], kernel[i], pads[i], pads[nsp + i],
                      strides[i], dilations[i], ceil_mode)
        for i in range(nsp)
    ]
    return [((x.shape[0], x.shape[1], *out_sp), x.dtype)]


@register("GlobalAveragePool", "GlobalMaxPool")
def _global_pool(op):
    x = _in(op, 0)
    return [((x.shape[0], x.shape[1]) + (1,) * (x.rank - 2), x.dtype)]


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

@register("BatchNormalization", "InstanceNormalization", "RMSNorm",
          "LayerNormalization", "Softmax", "LogSoftmax", "LRN",
          "SkipRMSNorm")
def _same_as_input(op):
    x = _in(op, 0)
    outs = [(x.shape, x.dtype)]
    for extra in op.outputs[1:]:
        outs.append((x.shape, x.dtype))  # e.g. SkipRMSNorm residual out
    return outs


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------

@register("Reshape")
def _reshape(op):
    x = _in(op, 0)
    target = list(op.attrs["shape"])
    out = []
    neg = -1
    known = 1
    for i, d in enumerate(target):
        if d == 0 and not op.attrs.get("allowzero", 0):
            d = x.shape[i]
        if d == -1:
            neg = i
            out.append(-1)
        else:
            out.append(int(d))
            known *= int(d)
    if neg >= 0:
        if known == 0 or x.size() % known:
            raise ValueError(f"Reshape {x.shape} -> {target} invalid")
        out[neg] = x.size() // known
    if math.prod(out) != x.size():
        raise ValueError(f"Reshape {x.shape} -> {target}: element count mismatch")
    return [(tuple(out), x.dtype)]


@register("Flatten")
def _flatten(op):
    x = _in(op, 0)
    axis = op.attrs.get("axis", 1)
    axis = axis + x.rank if axis < 0 else axis
    lead = math.prod(x.shape[:axis]) if axis > 0 else 1
    trail = math.prod(x.shape[axis:]) if axis < x.rank else 1
    return [((lead, trail), x.dtype)]


@register("Squeeze")
def _squeeze(op):
    x = _in(op, 0)
    axes = op.attrs.get("axes")
    if axes is None:
        shape = tuple(d for d in x.shape if d != 1)
    else:
        axes = {_norm_axis(a, x.rank) for a in axes}
        for a in axes:
            if x.shape[a] != 1:
                raise ValueError(f"Squeeze axis {a} has dim {x.shape[a]} != 1")
        shape = tuple(d for i, d in enumerate(x.shape) if i not in axes)
    return [(shape, x.dtype)]


@register("Unsqueeze")
def _unsqueeze(op):
    x = _in(op, 0)
    axes = list(op.attrs["axes"])
    out_rank = x.rank + len(axes)
    axes = sorted(_norm_axis(a, out_rank) for a in axes)
    shape = list(x.shape)
    for a in axes:
        shape.insert(a, 1)
    return [(tuple(shape), x.dtype)]


@register("Identity")
def _identity(op):
    x = _in(op, 0)
    return [(x.shape, x.dtype)]


@register("Shape")
def _shape(op):
    x = _in(op, 0)
    start = _norm_axis(op.attrs.get("start", 0), x.rank + 1)
    end = op.attrs.get("end", x.rank)
    end = end + x.rank if end < 0 else min(end, x.rank)
    return [((max(0, end - start),), dt.INT64)]


@register("Transpose")
def _transpose(op):
    x = _in(op, 0)
    perm = op.attrs.get("perm")
    if perm is None:
        perm = list(reversed(range(x.rank)))
    return [(tuple(x.shape[p] for p in perm), x.dtype)]


@register("Concat")
def _concat(op):
    xs = op.present_inputs()
    axis = _norm_axis(op.attrs["axis"], xs[0].rank)
    shape = list(xs[0].shape)
    shape[axis] = sum(t.shape[axis] for t in xs)
    for t in xs[1:]:
        for i, (a, b) in enumerate(zip(shape, t.shape)):
            if i != axis and a != b:
                raise ValueError(f"Concat mismatch at dim {i}: {xs}")
    return [(tuple(shape), xs[0].dtype)]


@register("Split")
def _split(op):
    x = _in(op, 0)
    axis = _norm_axis(op.attrs["axis"], x.rank)
    split = op.attrs.get("split")
    if split is None:
        num = int(op.attrs.get("num_outputs", len(op.outputs)))
        base = x.shape[axis] // num
        rem = x.shape[axis] - base * num
        split = [base + (1 if i < rem else 0) for i in range(num)]
    outs = []
    for s in split:
        shape = list(x.shape)
        shape[axis] = int(s)
        outs.append((tuple(shape), x.dtype))
    return outs


@register("Slice")
def _slice(op):
    x = _in(op, 0)
    axes = op.attrs.get("axes")
    if axes is None:
        axes = list(range(len(op.attrs["starts"])))
    axes = [_norm_axis(a, x.rank) for a in axes]
    starts = list(op.attrs["starts"])
    ends = list(op.attrs["ends"])
    steps = list(op.attrs.get("steps") or [1] * len(axes))
    shape = list(x.shape)
    for a, s, e, st in zip(axes, starts, ends, steps):
        d = x.shape[a]
        if st > 0:
            s = min(d, d + s) if s < 0 else min(s, d)
            e = min(d, d + e) if e < 0 else min(e, d)
            shape[a] = max(0, -(-(e - s) // st))
        else:
            s = d + s if s < 0 else min(s, d - 1)
            e = d + e if e < -d else (e if e >= -d and e < 0 else min(e, d))
            if e < 0:
                e = -1 if e == -d - 1 else e
            shape[a] = max(0, -(-(s - e) // (-st)))
    return [(tuple(shape), x.dtype)]


@register("Pad")
def _pad(op):
    x = _in(op, 0)
    pads = list(op.attrs["pads"])  # [b_0..b_r, e_0..e_r]
    r = x.rank
    shape = tuple(x.shape[i] + pads[i] + pads[r + i] for i in range(r))
    return [(shape, x.dtype)]


@register("Resize")
def _resize(op):
    # Importer normalizes scales/sizes into a concrete output shape.
    x = _in(op, 0)
    return [(tuple(op.attrs["out_shape"]), x.dtype)]


@register("Expand")
def _expand(op):
    x = _in(op, 0)
    return [(broadcast_shapes(x.shape, tuple(op.attrs["shape"])), x.dtype)]


@register("Tile")
def _tile(op):
    x = _in(op, 0)
    reps = list(op.attrs["repeats"])
    return [(tuple(d * r for d, r in zip(x.shape, reps)), x.dtype)]


@register("Gather")
def _gather(op):
    data, idx = _in(op, 0), _in(op, 1)
    axis = _norm_axis(op.attrs.get("axis", 0), data.rank)
    shape = data.shape[:axis] + idx.shape + data.shape[axis + 1:]
    return [(shape, data.dtype)]


@register("GatherElements")
def _gather_elements(op):
    data, idx = _in(op, 0), _in(op, 1)
    return [(idx.shape, data.dtype)]


@register("ScatterElements")
def _scatter_elements(op):
    data = _in(op, 0)
    return [(data.shape, data.dtype)]


@register("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd",
          "ReduceL2")
def _reduce(op):
    x = _in(op, 0)
    axes = op.attrs.get("axes")
    keepdims = bool(op.attrs.get("keepdims", 1))
    if axes is None or len(axes) == 0:
        axes = list(range(x.rank))
    axes = {_norm_axis(a, x.rank) for a in axes}
    if keepdims:
        shape = tuple(1 if i in axes else d for i, d in enumerate(x.shape))
    else:
        shape = tuple(d for i, d in enumerate(x.shape) if i not in axes)
    return [(shape, x.dtype)]


@register("ArgMax", "ArgMin")
def _argmax(op):
    x = _in(op, 0)
    axis = _norm_axis(op.attrs.get("axis", 0), x.rank)
    keepdims = bool(op.attrs.get("keepdims", 1))
    if keepdims:
        shape = tuple(1 if i == axis else d for i, d in enumerate(x.shape))
    else:
        shape = tuple(d for i, d in enumerate(x.shape) if i != axis)
    return [(shape, dt.INT64)]


@register("DepthToSpace")
def _depth_to_space(op):
    x = _in(op, 0)
    b = int(op.attrs["blocksize"])
    n, c, h, w = x.shape
    return [((n, c // (b * b), h * b, w * b), x.dtype)]


@register("SpaceToDepth")
def _space_to_depth(op):
    x = _in(op, 0)
    b = int(op.attrs["blocksize"])
    n, c, h, w = x.shape
    return [((n, c * b * b, h // b, w // b), x.dtype)]


@register("ConstantOfShape")
def _constant_of_shape(op):
    shape = tuple(int(d) for d in op.attrs["shape"])
    dtype = DataType.from_onnx(int(op.attrs.get("dtype", dt.FLOAT32.onnx_id)))
    return [(shape, dtype)]


@register("Range")
def _range(op):
    n = int(op.attrs["length"])
    dtype = DataType.from_onnx(int(op.attrs.get("dtype", dt.INT64.onnx_id)))
    return [((n,), dtype)]


# ---------------------------------------------------------------------------
# LLM ops
# ---------------------------------------------------------------------------

@register("AttentionKVCache")
def _attention_kvcache(op):
    """Fused decode attention with in-cache append.

    Reference semantics (src/operators/attention_kvcache.cc:20-27): inputs
    (k_cache, v_cache, q, k, v, position_id), output = q's shape; the cache is
    mutated in place by the kernel. TPU-native redesign: caches are
    *static-shape* ring buffers [B, H, S_max, D]; the op returns the attention
    output AND the updated caches as explicit outputs (functional form), which
    the executor donates/aliases so XLA updates them in place.
    """
    kc, vc, q = _in(op, 0), _in(op, 1), _in(op, 2)
    assert kc.rank == 4, f"k_cache must be [B,H,S,D], got {kc.shape}"
    outs = [(q.shape, q.dtype)]
    if len(op.outputs) >= 3:
        outs += [(kc.shape, kc.dtype), (vc.shape, vc.dtype)]
    return outs


@register("AttentionKVCacheQ8")
def _attention_kvcache_q8(op):
    """INT8-KV-cache fused decode attention (GQA-capable).

    TPU-native extension of the reference AttentionKVCache
    (src/operators/attention_kvcache.cc:20-27): caches are int8
    [B, Hkv, S, D] ring buffers with per-(b, h, s) fp32 scales
    [B, Hkv, S] — half the cache HBM traffic of bf16. Inputs
    (k_cache, v_cache, k_scale, v_scale, q, k, v, position_id); outputs
    (attn_out [q.shape], k_cache', v_cache', k_scale', v_scale') in
    functional form for donation-based in-place update."""
    kc, vc, ks, vs, q = (_in(op, i) for i in range(5))
    assert kc.rank == 4, f"k_cache must be [B,Hkv,S,D], got {kc.shape}"
    assert ks.rank == 3, f"k_scale must be [B,Hkv,S], got {ks.shape}"
    return [(q.shape, q.dtype), (kc.shape, kc.dtype), (vc.shape, vc.dtype),
            (ks.shape, ks.dtype), (vs.shape, vs.dtype)]


@register("MatMulWOQ")
def _matmul_woq(op):
    """Weight-only-quantized matmul: x [..., din] @ packed int weight.

    Inputs (x, qweight int8 [din(/2 for int4), out_p], scales [ng, out_p])
    + optional norm_weight (RMSNorm fused into the kernel, the decode
    pre-attention/pre-MLP pattern). Attrs: bits (4/8), group_size,
    out_logical (logical out dim when out_p is tile-padded; 0 = out_p),
    eps (fused-norm epsilon). The reference reaches weight-only INT4/INT8
    via MatMulInteger/DequantizeLinear chains; this op carries the
    quantized weight natively so the Pallas dequant-matmul kernels
    (kernels/quant_matmul.py) are reachable from the graph IR."""
    x, qw = _in(op, 0), _in(op, 1)
    nf = int(op.attrs.get("out_logical", 0)) or qw.shape[1]
    return [(tuple(x.shape[:-1]) + (nf,), x.dtype)]


@register("RoPE")
def _rope(op):
    # (pos, input) -> input shape (reference src/operators/rope.cc:9-14)
    x = _in(op, 1)
    return [(x.shape, x.dtype)]


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

@register("QuantizeLinear")
def _quantize_linear(op):
    x = _in(op, 0)
    zp = op.inputs[2] if len(op.inputs) > 2 else None
    dtype = zp.dtype if zp is not None else dt.UINT8
    return [(x.shape, dtype)]


@register("DequantizeLinear")
def _dequantize_linear(op):
    x, scale = _in(op, 0), _in(op, 1)
    return [(x.shape, scale.dtype)]


@register("DynamicQuantizeLinear")
def _dynamic_quantize_linear(op):
    x = _in(op, 0)
    return [(x.shape, dt.UINT8), ((), dt.FLOAT32), ((), dt.UINT8)]


# ---------------------------------------------------------------------------
# communication (first-class graph ops, reference include/operators/all_reduce.h
# etc.; lowered to XLA collectives inside shard_map)
# ---------------------------------------------------------------------------

@register("AllReduceSum", "AllReduceProd", "AllReduceMin", "AllReduceMax",
          "AllReduceAvg")
def _all_reduce(op):
    x = _in(op, 0)
    return [(x.shape, x.dtype)]


@register("AllGather")
def _all_gather(op):
    # Reference returns world_size separate outputs
    # (src/operators/all_gather.cc); world size from attr n.
    x = _in(op, 0)
    n = int(op.attrs["world_size"])
    return [(x.shape, x.dtype) for _ in range(n)]


@register("ReduceScatterSum")
def _reduce_scatter(op):
    x = _in(op, 0)
    n = int(op.attrs["world_size"])
    axis = _norm_axis(op.attrs.get("axis", 0), x.rank)
    shape = list(x.shape)
    assert shape[axis] % n == 0
    shape[axis] //= n
    return [(tuple(shape), x.dtype)]


@register("AllToAll")
def _all_to_all(op):
    x = _in(op, 0)
    n = int(op.attrs["world_size"])
    split_axis = _norm_axis(op.attrs["split_axis"], x.rank)
    concat_axis = _norm_axis(op.attrs["concat_axis"], x.rank)
    shape = list(x.shape)
    assert shape[split_axis] % n == 0
    shape[split_axis] //= n
    shape[concat_axis] *= n
    return [(tuple(shape), x.dtype)]


@register("Broadcast")
def _broadcast_comm(op):
    x = _in(op, 0)
    return [(x.shape, x.dtype)]


@register("Send")
def _send(op):
    x = _in(op, 0)
    return [(x.shape, x.dtype)] if op.outputs else []


@register("Recv")
def _recv(op):
    shape = tuple(int(d) for d in op.attrs["shape"])
    dtype = DataType.from_onnx(int(op.attrs["dtype"]))
    return [(shape, dtype)]


# ---------------------------------------------------------------------------
# expression op (EinNet analog; holds a fused tensor expression)
# ---------------------------------------------------------------------------

@register("MemBound")
def _membound(op):
    # Output spec is fixed when the expression is attached
    # (reference src/operators/membound.cc:10-30).
    return [(tuple(s), d) for s, d in op.attrs["out_specs"]]


# ---------------------------------------------------------------------------
# straggler ops from the reference enum (reference include/core/op_type.h)
# ---------------------------------------------------------------------------

@register("Det")
def _det(op):
    # [..., n, n] -> [...] ([1] for rank 2, reference src/operators/det.cc)
    x = _in(op, 0)
    if len(x.shape) == 2:
        return [((1,), x.dtype)]
    return [(x.shape[:-2], x.dtype)]


@register("Extend")
def _extend(op):
    # out[dim] = in[dim] * (num + 1)  (reference src/operators/extend.cc)
    x = _in(op, 0)
    dim = int(op.attrs["dim"]) % len(x.shape)
    num = int(op.attrs.get("num", 1))
    shape = list(x.shape)
    shape[dim] *= num + 1
    return [(tuple(shape), x.dtype)]


@register("TopK")
def _topk(op):
    x = _in(op, 0)
    k = int(op.attrs["k"])
    axis = int(op.attrs.get("axis", -1)) % len(x.shape)
    shape = list(x.shape)
    shape[axis] = k
    return [(tuple(shape), x.dtype), (tuple(shape), dt.INT64)]


@register("CumSum")
def _cumsum(op):
    x = _in(op, 0)
    return [(x.shape, x.dtype)]


@register("Trilu")
def _trilu(op):
    x = _in(op, 0)
    return [(x.shape, x.dtype)]


@register("OneHot")
def _onehot(op):
    x = _in(op, 0)
    depth = int(op.attrs["depth"])
    axis = int(op.attrs.get("axis", -1))
    shape = list(x.shape)
    if axis < 0:
        axis += len(shape) + 1
    shape.insert(axis, depth)
    return [(tuple(shape), op.attrs.get("values_dtype", dt.FLOAT32))]


@register("ReduceL1")
def _reduce_l1(op):
    return SHAPE_RULES["ReduceSum"](op)


@register("ReluBackward", "SigmoidBackward", "TanhBackward")
def _activation_backward(op):
    # inputs (y, diff_y, x) -> diff_x, all same shape
    # (reference src/operators/activation_backward.cc)
    return [(_in(op, 0).shape, _in(op, 0).dtype)]


# ---------------------------------------------------------------------------
# ONNX coverage beyond the reference importer's 68 ops (widening pass;
# reference include/core/op_type.h enumerates these but implements few)
# ---------------------------------------------------------------------------

@register("IsNaN", "IsInf")
def _is_pred(op):
    return [(_in(op, 0).shape, dt.BOOL)]


@register("Sum", "MeanN")
def _variadic_elementwise(op):
    # ONNX Sum/Mean: N inputs, multidirectional broadcast
    shape = broadcast_shapes(*(_in(op, i).shape
                               for i in range(len(op.inputs))))
    return [(shape, _in(op, 0).dtype)]


@register("ReduceLogSum", "ReduceLogSumExp", "ReduceSumSquare")
def _reduce_aliases(op):
    return SHAPE_RULES["ReduceSum"](op)


def _parse_einsum(eq: str, shapes: list) -> tuple:
    """Pure einsum output-shape inference (explicit + implicit + ellipsis)."""
    eq = eq.replace(" ", "")
    lhs, _, rhs = eq.partition("->")
    terms = lhs.split(",")
    if len(terms) != len(shapes):
        raise ValueError(f"einsum '{eq}': {len(terms)} terms, "
                         f"{len(shapes)} inputs")
    sizes: dict = {}
    ell_shape: tuple = ()
    counts: dict = {}
    for term, shape in zip(terms, shapes):
        if "..." in term:
            named = term.replace("...", "")
            n_ell = len(shape) - len(named)
            if n_ell < 0:
                raise ValueError(f"einsum '{eq}': term {term} too long")
            head = term.index("...")
            ell = shape[head:head + n_ell]
            # right-aligned broadcast of ellipsis dims across terms
            merged = list(ell_shape)
            for i in range(1, max(len(merged), len(ell)) + 1):
                a = merged[-i] if i <= len(merged) else 1
                b = ell[-i] if i <= len(ell) else 1
                v = max(a, b)
                if i <= len(merged):
                    merged[-i] = v
                else:
                    merged.insert(0, v)
            ell_shape = tuple(merged)
            dims = list(shape[:head]) + list(shape[head + n_ell:])
            labels = term[:head] + term[head + 3:]
        else:
            dims, labels = list(shape), term
        if len(labels) != len(dims):
            raise ValueError(f"einsum '{eq}': term {term} rank mismatch")
        for c, d in zip(labels, dims):
            if c in sizes and sizes[c] != d and 1 not in (sizes[c], d):
                raise ValueError(f"einsum '{eq}': size clash on {c}")
            sizes[c] = max(sizes.get(c, 1), d)
            counts[c] = counts.get(c, 0) + 1
    if not rhs and "->" not in eq:
        # implicit: ellipsis then labels appearing exactly once, sorted
        rhs = "..." + "".join(sorted(c for c, n in counts.items() if n == 1))
    out: list = []
    for i, c in enumerate(rhs):
        if rhs[i:i + 3] == "...":
            out.extend(ell_shape)
        elif c != ".":
            out.append(sizes[c])
    return tuple(out)


@register("Einsum")
def _einsum(op):
    eq = op.attrs["equation"]
    shapes = [list(_in(op, i).shape) for i in range(len(op.inputs))]
    return [(_parse_einsum(eq, shapes), _in(op, 0).dtype)]


@register("GatherND")
def _gather_nd(op):
    data, idx = _in(op, 0), _in(op, 1)
    b = int(op.attrs.get("batch_dims", 0))
    k = idx.shape[-1]
    shape = tuple(idx.shape[:-1]) + tuple(data.shape[b + k:])
    return [(shape, data.dtype)]


@register("ScatterND")
def _scatter_nd(op):
    data = _in(op, 0)
    return [(data.shape, data.dtype)]


@register("GroupNormalization", "MeanVarianceNormalization",
          "LpNormalization")
def _norm_same(op):
    x = _in(op, 0)
    return [(x.shape, x.dtype)]


@register("EyeLike")
def _eye_like(op):
    x = _in(op, 0)
    dtype = op.attrs.get("dtype")
    dtype = DataType.from_onnx(int(dtype)) if dtype is not None else x.dtype
    return [(x.shape, dtype)]


@register("RandomNormal", "RandomUniform")
def _random_gen(op):
    shape = tuple(int(d) for d in op.attrs["shape"])
    dtype = DataType.from_onnx(int(op.attrs.get("dtype",
                                                dt.FLOAT32.onnx_id)))
    return [(shape, dtype)]


@register("RandomNormalLike", "RandomUniformLike", "Bernoulli")
def _random_like(op):
    x = _in(op, 0)
    dtype = op.attrs.get("dtype")
    dtype = DataType.from_onnx(int(dtype)) if dtype is not None else x.dtype
    return [(x.shape, dtype)]


# LpPool/GlobalLpPool share the max/avg pooling geometry
SHAPE_RULES["LpPool"] = SHAPE_RULES["MaxPool"]
SHAPE_RULES["GlobalLpPool"] = SHAPE_RULES["GlobalAveragePool"]
# deprecated ONNX Upsample == Resize geometry (scales input)
SHAPE_RULES["Upsample"] = SHAPE_RULES["Resize"]
