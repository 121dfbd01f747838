"""ONNX importer: ModelProto -> graph IR.

Mirrors the reference OnnxStub (reference pyinfinitensor/src/pyinfinitensor/
onnx.py:41-1136): manual topo-sort with cycle diagnostics, initializers as
weights, per-node lowering to GraphHandler calls. Two departures:

* static shapes are mandatory (one captured CUDA graph per input
  signature), so unknown dims in graph inputs are bound at import via
  ``fixed_dims``/default 1, and
* shape arithmetic (Shape/Gather/Concat/... chains feeding Reshape & friends)
  is constant-folded at import instead of existing as runtime ops — the
  equivalent graphs the reference runs via onnx-simplifier's folding
  (onnx.py:50) happen here natively.

Copy of infinitensor_tpu/onnx/importer.py bound to this package's
GraphHandler, quant.weight_only, serving.kvcache and runtime.perf.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import numpy as np

from infinitensor_tpu_torch.core import dtype as dt
from infinitensor_tpu_torch.core.dtype import DataType
from infinitensor_tpu_torch.core.handler import GraphHandler
from infinitensor_tpu_torch.core.tensor import TensorObj, TensorRole
from infinitensor_tpu_torch.onnx import proto

_IMPORTERS: dict[str, Callable] = {}


def register_import(*op_types):
    def deco(fn):
        for t in op_types:
            _IMPORTERS[t] = fn
        return fn
    return deco


class ImportContext:
    def __init__(self, handler: GraphHandler, opset: int):
        self.h = handler
        self.opset = opset
        self.tensors: dict[str, TensorObj] = {}
        self.consts: dict[str, np.ndarray] = {}

    # -- operand helpers ---------------------------------------------------
    def get(self, name: str) -> Optional[TensorObj]:
        """Graph tensor for name, materializing constants as weights."""
        if not name:
            return None
        if name in self.tensors:
            return self.tensors[name]
        if name in self.consts:
            arr = self.consts[name]
            t = self.h.weight(_normalize_np(arr), name=name)
            self.tensors[name] = t
            return t
        raise KeyError(f"ONNX tensor {name!r} is not defined")

    def const(self, name: str, what: str) -> np.ndarray:
        if name in self.consts:
            return self.consts[name]
        t = self.tensors.get(name)
        if t is not None and t.has_data():
            return t.numpy()
        raise ValueError(
            f"{what} requires input {name!r} to be a compile-time constant")

    def const_or_none(self, name: str):
        if not name or name not in self.consts:
            return None
        return self.consts[name]

    def put(self, name: str, tensor: TensorObj):
        tensor.name = name
        self.tensors[name] = tensor


def _normalize_np(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return arr


# ---------------------------------------------------------------------------
# topo sort with diagnostics (reference onnx.py:83-117)
# ---------------------------------------------------------------------------

def topo_sort_nodes(nodes: list, known: set[str]) -> list:
    known = set(known)
    remaining = list(nodes)
    order = []
    while remaining:
        progressed = False
        still = []
        for node in remaining:
            if all((not i) or i in known for i in node.input):
                order.append(node)
                known.update(node.output)
                progressed = True
            else:
                still.append(node)
        remaining = still
        if not progressed:
            missing = {
                node.name or node.op_type: [i for i in node.input
                                            if i and i not in known]
                for node in remaining[:5]
            }
            raise ValueError(
                f"ONNX graph is not a DAG or has undefined inputs; "
                f"stuck nodes (first 5): {missing}")
    return order


# ---------------------------------------------------------------------------
# compile-time constant evaluation
# ---------------------------------------------------------------------------

_FOLDABLE = {
    "Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
    "Div": lambda a, b: a // b if np.issubdtype(np.asarray(a).dtype, np.integer)
    else a / b,
    "Neg": np.negative, "Sqrt": np.sqrt,
    "Equal": np.equal, "Greater": np.greater, "Less": np.less,
    "Floor": np.floor, "Ceil": np.ceil, "Min": np.minimum, "Max": np.maximum,
    "Pow": np.power, "Mod": np.mod,
}


def _try_constant_fold(ctx: ImportContext, node) -> bool:
    """Evaluate shape-arithmetic nodes whose inputs are all constants (or
    whose result depends only on static shapes, e.g. Shape)."""
    op = node.op_type
    attrs = node.attrs()
    ins = node.input
    if not ins and op != "Constant":
        return False      # attr-only form (e.g. exported Range): real op

    def all_const():
        return all((not i) or i in ctx.consts for i in ins)

    if op == "Constant":
        val = attrs.get("value")
        if val is None:
            for k in ("value_int", "value_float"):
                if k in attrs:
                    val = np.asarray(attrs[k])
            if val is None and "value_ints" in attrs:
                val = np.asarray(attrs["value_ints"], dtype=np.int64)
            if val is None and "value_floats" in attrs:
                val = np.asarray(attrs["value_floats"], dtype=np.float32)
        ctx.consts[node.output[0]] = np.asarray(val)
        return True

    if op == "Shape":
        src = ins[0]
        if src in ctx.consts:
            shape = np.asarray(ctx.consts[src].shape, dtype=np.int64)
        elif src in ctx.tensors:
            shape = np.asarray(ctx.tensors[src].shape, dtype=np.int64)
        else:
            return False
        start = attrs.get("start", 0)
        end = attrs.get("end", len(shape))
        ctx.consts[node.output[0]] = shape[start:end]
        return True

    if op == "Size":
        src = ins[0]
        if src in ctx.consts:
            n = ctx.consts[src].size
        elif src in ctx.tensors:
            n = ctx.tensors[src].size()
        else:
            return False
        ctx.consts[node.output[0]] = np.asarray(n, dtype=np.int64)
        return True

    if not all_const():
        return False

    vals = [ctx.consts[i] if i else None for i in ins]
    out = None
    if op in _FOLDABLE:
        out = _FOLDABLE[op](*vals[:2]) if len(vals) > 1 else _FOLDABLE[op](vals[0])
    elif op == "Cast":
        out = vals[0].astype(DataType.from_onnx(attrs["to"]).np())
    elif op == "Concat":
        out = np.concatenate([np.atleast_1d(v) for v in vals],
                             axis=attrs.get("axis", 0))
    elif op == "Gather":
        out = np.take(vals[0], vals[1].astype(np.int64),
                      axis=attrs.get("axis", 0))
    elif op == "Slice":
        starts = vals[1] if len(vals) > 1 else attrs["starts"]
        ends = vals[2] if len(vals) > 2 else attrs["ends"]
        axes = vals[3] if len(vals) > 3 and vals[3] is not None else None
        steps = vals[4] if len(vals) > 4 and vals[4] is not None else None
        out = _np_slice(vals[0], starts, ends, axes, steps)
    elif op == "Squeeze":
        axes = vals[1] if len(vals) > 1 and vals[1] is not None \
            else attrs.get("axes")
        out = np.squeeze(vals[0], axis=tuple(int(a) for a in axes)
                         if axes is not None else None)
    elif op == "Unsqueeze":
        axes = vals[1] if len(vals) > 1 and vals[1] is not None \
            else attrs.get("axes")
        out = vals[0]
        rank = out.ndim + len(list(axes))
        for a in sorted(int(a) % rank for a in axes):
            out = np.expand_dims(out, a)
    elif op == "Reshape":
        out = vals[0].reshape([int(d) for d in vals[1]]) \
            if -1 in vals[1] or 0 not in vals[1] else None
        if out is None:
            tgt = [vals[0].shape[i] if d == 0 else int(d)
                   for i, d in enumerate(vals[1])]
            out = vals[0].reshape(tgt)
    elif op == "Transpose":
        out = np.transpose(vals[0], attrs.get("perm"))
    elif op == "ConstantOfShape":
        value = attrs.get("value", np.zeros(1, np.float32))
        out = np.full([int(d) for d in vals[0]], np.asarray(value).reshape(-1)[0],
                      dtype=np.asarray(value).dtype)
    elif op == "Range":
        out = np.arange(int(vals[0]), int(vals[1]),
                        int(vals[2]) if vals[2] is not None else 1,
                        dtype=np.asarray(vals[0]).dtype)
    elif op == "Expand":
        out = np.broadcast_to(vals[0], _broadcast_with(vals[0].shape,
                                                       [int(d) for d in vals[1]])).copy()
    elif op == "Where":
        out = np.where(vals[0], vals[1], vals[2])
    elif op == "ReduceProd":
        axes = attrs.get("axes")
        out = np.prod(vals[0], axis=tuple(axes) if axes else None,
                      keepdims=bool(attrs.get("keepdims", 1)))
    elif op == "Identity":
        out = vals[0]
    else:
        return False
    ctx.consts[node.output[0]] = np.asarray(out)
    return True


def _broadcast_with(a, b):
    return np.broadcast_shapes(tuple(a), tuple(b))


def _np_slice(arr, starts, ends, axes, steps):
    starts = [int(s) for s in np.atleast_1d(starts)]
    ends = [int(e) for e in np.atleast_1d(ends)]
    axes = [int(a) for a in np.atleast_1d(axes)] if axes is not None \
        else list(range(len(starts)))
    steps = [int(s) for s in np.atleast_1d(steps)] if steps is not None \
        else [1] * len(starts)
    slicer = [slice(None)] * arr.ndim
    for a, s, e, st in zip(axes, starts, ends, steps):
        slicer[a] = slice(s if abs(s) < 2**31 else None,
                          e if abs(e) < 2**31 else None, st)
    return arr[tuple(slicer)]


# ---------------------------------------------------------------------------
# per-op importers
# ---------------------------------------------------------------------------

_DIRECT_UNARY = [
    "Relu", "Gelu", "Silu", "Sigmoid", "HardSigmoid", "HardSwish", "Tanh",
    "Erf", "Abs", "Sqrt", "Neg", "Exp", "Log", "Reciprocal", "Floor", "Ceil",
    "Round", "Not", "Softplus", "Sin", "Cos", "Identity",
]
_DIRECT_BINARY = [
    "Add", "Sub", "Mul", "Div", "Pow", "Min", "Max", "Mod", "Equal",
    "Greater", "GreaterOrEqual", "Less", "LessOrEqual", "And", "Or", "Xor",
]


@register_import(*_DIRECT_UNARY, *_DIRECT_BINARY, "PRelu", "Where")
def _imp_direct(ctx, node, attrs):
    ins = [ctx.get(i) for i in node.input]
    out = ctx.h._add(node.op_type, ins, {})
    ctx.put(node.output[0], out)


@register_import("LeakyRelu", "Elu")
def _imp_alpha_unary(ctx, node, attrs):
    out = ctx.h._add(node.op_type, [ctx.get(node.input[0])],
                     {"alpha": attrs.get("alpha",
                                         0.01 if node.op_type == "LeakyRelu" else 1.0)})
    ctx.put(node.output[0], out)


@register_import("Conv", "ConvTranspose")
def _imp_conv(ctx, node, attrs):
    x = ctx.get(node.input[0])
    w_ = ctx.get(node.input[1])
    bias = ctx.get(node.input[2]) if len(node.input) > 2 else None
    nsp = x.rank - 2
    strides = attrs.get("strides", [1] * nsp)
    dilations = attrs.get("dilations", [1] * nsp)
    pads = attrs.get("pads", [0] * (2 * nsp))
    auto_pad = attrs.get("auto_pad", "NOTSET")
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        pads = _same_pads(x.shape[2:], w_.shape[2:], strides, dilations,
                          auto_pad)
    elif auto_pad == "VALID":
        pads = [0] * (2 * nsp)
    a = {"pads": [int(p) for p in pads],
         "strides": [int(s) for s in strides],
         "dilations": [int(d) for d in dilations],
         "group": int(attrs.get("group", 1))}
    if node.op_type == "ConvTranspose":
        a["output_padding"] = [int(p) for p in
                               attrs.get("output_padding", [0] * nsp)]
    ins = [x, w_] + ([bias] if bias is not None else [])
    ctx.put(node.output[0], ctx.h._add(node.op_type, ins, a))


def _same_pads(spatial, kernel, strides, dilations, mode):
    nsp = len(spatial)
    begins, ends = [], []
    for i in range(nsp):
        eff_k = (kernel[i] - 1) * dilations[i] + 1
        out_d = -(-spatial[i] // strides[i])
        total = max(0, (out_d - 1) * strides[i] + eff_k - spatial[i])
        if mode == "SAME_UPPER":
            begins.append(total // 2)
            ends.append(total - total // 2)
        else:
            begins.append(total - total // 2)
            ends.append(total // 2)
    return begins + ends


@register_import("MatMul")
def _imp_matmul(ctx, node, attrs):
    out = ctx.h.matmul(ctx.get(node.input[0]), ctx.get(node.input[1]))
    ctx.put(node.output[0], out)


@register_import("Gemm")
def _imp_gemm(ctx, node, attrs):
    c = ctx.get(node.input[2]) if len(node.input) > 2 else None
    out = ctx.h.gemm(ctx.get(node.input[0]), ctx.get(node.input[1]), c,
                     alpha=attrs.get("alpha", 1.0),
                     beta=attrs.get("beta", 1.0),
                     trans_a=bool(attrs.get("transA", 0)),
                     trans_b=bool(attrs.get("transB", 0)))
    ctx.put(node.output[0], out)


@register_import("MaxPool", "AveragePool")
def _imp_pool(ctx, node, attrs):
    x = ctx.get(node.input[0])
    nsp = x.rank - 2
    kernel = attrs["kernel_shape"]
    strides = attrs.get("strides", [1] * nsp)
    dilations = attrs.get("dilations")
    pads = attrs.get("pads", [0] * 2 * nsp)
    auto_pad = attrs.get("auto_pad", "NOTSET")
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        pads = _same_pads(x.shape[2:], kernel, strides,
                          dilations or [1] * nsp, auto_pad)
    a = {"kernel_shape": [int(k) for k in kernel],
         "strides": [int(s) for s in strides],
         "pads": [int(p) for p in pads],
         "ceil_mode": int(attrs.get("ceil_mode", 0))}
    if dilations is not None:
        a["dilations"] = [int(d) for d in dilations]
    if node.op_type == "AveragePool":
        a["count_include_pad"] = int(attrs.get("count_include_pad", 0))
    ctx.put(node.output[0], ctx.h._add(node.op_type, [x], a))


@register_import("GlobalAveragePool", "GlobalMaxPool")
def _imp_gpool(ctx, node, attrs):
    ctx.put(node.output[0],
            ctx.h._add(node.op_type, [ctx.get(node.input[0])], {}))


@register_import("BatchNormalization")
def _imp_bn(ctx, node, attrs):
    ins = [ctx.get(i) for i in node.input[:5]]
    out = ctx.h._add("BatchNormalization", ins,
                     {"epsilon": attrs.get("epsilon", 1e-5)})
    ctx.put(node.output[0], out)


@register_import("LayerNormalization")
def _imp_ln(ctx, node, attrs):
    ins = [ctx.get(i) for i in node.input]
    out = ctx.h._add("LayerNormalization", ins,
                     {"axis": attrs.get("axis", -1),
                      "epsilon": attrs.get("epsilon", 1e-5)})
    ctx.put(node.output[0], out)


@register_import("InstanceNormalization")
def _imp_in(ctx, node, attrs):
    ins = [ctx.get(i) for i in node.input[:3]]
    out = ctx.h._add("InstanceNormalization", ins,
                     {"epsilon": attrs.get("epsilon", 1e-5)})
    ctx.put(node.output[0], out)


@register_import("RMSNorm", "SimplifiedLayerNormalization")
def _imp_rms(ctx, node, attrs):
    out = ctx.h.rms_norm(ctx.get(node.input[0]), ctx.get(node.input[1]),
                         epsilon=attrs.get("epsilon", 1e-6))
    ctx.put(node.output[0], out)


@register_import("LRN")
def _imp_lrn(ctx, node, attrs):
    out = ctx.h.lrn(ctx.get(node.input[0]), alpha=attrs.get("alpha", 1e-4),
                    beta=attrs.get("beta", 0.75),
                    bias=attrs.get("bias", 1.0), size=int(attrs["size"]))
    ctx.put(node.output[0], out)


@register_import("Softmax", "LogSoftmax")
def _imp_softmax(ctx, node, attrs):
    out = ctx.h._add(node.op_type, [ctx.get(node.input[0])],
                     {"axis": attrs.get("axis", -1)})
    ctx.put(node.output[0], out)


@register_import("Cast")
def _imp_cast(ctx, node, attrs):
    ctx.put(node.output[0], ctx.h.cast(ctx.get(node.input[0]),
                                       int(attrs["to"])))


@register_import("Clip")
def _imp_clip(ctx, node, attrs):
    lo = hi = None
    if ctx.opset >= 11:
        if len(node.input) > 1 and node.input[1]:
            lo = float(ctx.const(node.input[1], "Clip"))
        if len(node.input) > 2 and node.input[2]:
            hi = float(ctx.const(node.input[2], "Clip"))
    else:
        lo, hi = attrs.get("min"), attrs.get("max")
    ctx.put(node.output[0], ctx.h.clip(ctx.get(node.input[0]), lo, hi))


@register_import("Reshape")
def _imp_reshape(ctx, node, attrs):
    shape = [int(d) for d in ctx.const(node.input[1], "Reshape")]
    ctx.put(node.output[0], ctx.h.reshape(ctx.get(node.input[0]), shape))


@register_import("Flatten")
def _imp_flatten(ctx, node, attrs):
    ctx.put(node.output[0], ctx.h.flatten(ctx.get(node.input[0]),
                                          attrs.get("axis", 1)))


@register_import("Squeeze", "Unsqueeze")
def _imp_squeeze(ctx, node, attrs):
    axes = attrs.get("axes")
    if len(node.input) > 1 and node.input[1]:
        axes = [int(a) for a in ctx.const(node.input[1], node.op_type)]
    out = ctx.h._add(node.op_type, [ctx.get(node.input[0])],
                     {"axes": list(axes) if axes is not None else None})
    ctx.put(node.output[0], out)


@register_import("Transpose")
def _imp_transpose(ctx, node, attrs):
    ctx.put(node.output[0], ctx.h.transpose(ctx.get(node.input[0]),
                                            attrs.get("perm")))


@register_import("Concat")
def _imp_concat(ctx, node, attrs):
    ins = [ctx.get(i) for i in node.input]
    ctx.put(node.output[0], ctx.h.concat(ins, attrs["axis"]))


@register_import("Split")
def _imp_split(ctx, node, attrs):
    split = attrs.get("split")
    if len(node.input) > 1 and node.input[1]:
        split = [int(s) for s in ctx.const(node.input[1], "Split")]
    if split is not None:
        outs = ctx.h.split(ctx.get(node.input[0]), attrs.get("axis", 0), split)
    else:
        outs = ctx.h.split(ctx.get(node.input[0]), attrs.get("axis", 0),
                           attrs.get("num_outputs", len(node.output)))
    for name, t in zip(node.output, outs):
        ctx.put(name, t)


@register_import("Slice")
def _imp_slice(ctx, node, attrs):
    if ctx.opset >= 10 and len(node.input) > 1:
        starts = [int(v) for v in ctx.const(node.input[1], "Slice")]
        ends = [int(v) for v in ctx.const(node.input[2], "Slice")]
        axes = steps = None
        if len(node.input) > 3 and node.input[3]:
            axes = [int(v) for v in ctx.const(node.input[3], "Slice")]
        if len(node.input) > 4 and node.input[4]:
            steps = [int(v) for v in ctx.const(node.input[4], "Slice")]
    else:
        starts, ends = attrs["starts"], attrs["ends"]
        axes, steps = attrs.get("axes"), None
    ctx.put(node.output[0], ctx.h.slice(ctx.get(node.input[0]), starts, ends,
                                        axes, steps))


@register_import("Pad")
def _imp_pad(ctx, node, attrs):
    if ctx.opset >= 11 and len(node.input) > 1:
        pads = [int(p) for p in ctx.const(node.input[1], "Pad")]
        value = 0.0
        if len(node.input) > 2 and node.input[2]:
            value = float(ctx.const(node.input[2], "Pad").reshape(-1)[0])
    else:
        pads = attrs["pads"]
        value = attrs.get("value", 0.0)
    ctx.put(node.output[0],
            ctx.h.pad(ctx.get(node.input[0]), pads,
                      mode=attrs.get("mode", "constant"), value=value))


@register_import("Resize", "Upsample")
def _imp_resize(ctx, node, attrs):
    x = ctx.get(node.input[0])
    sizes = None
    # Resize inputs: X, roi, scales, sizes
    if len(node.input) > 3 and node.input[3]:
        sizes = [int(s) for s in ctx.const(node.input[3], "Resize")]
    elif len(node.input) > 2 and node.input[2]:
        scales = np.asarray(ctx.const(node.input[2], "Resize"), np.float64)
        if scales.size:
            sizes = [int(math.floor(d * s)) for d, s in zip(x.shape, scales)]
    elif len(node.input) > 1 and node.input[1] and node.op_type == "Upsample":
        scales = np.asarray(ctx.const(node.input[1], "Upsample"), np.float64)
        sizes = [int(math.floor(d * s)) for d, s in zip(x.shape, scales)]
    if sizes is None and "out_shape" in attrs:
        sizes = [int(s) for s in attrs["out_shape"]]   # our own export form
    if sizes is None:
        raise ValueError("Resize requires constant scales or sizes")
    mode = attrs.get("mode", "nearest")
    ctx.put(node.output[0], ctx.h.resize(x, sizes, mode=mode))


@register_import("Expand")
def _imp_expand(ctx, node, attrs):
    shape = [int(d) for d in ctx.const(node.input[1], "Expand")]
    ctx.put(node.output[0], ctx.h.expand(ctx.get(node.input[0]), shape))


@register_import("Tile")
def _imp_tile(ctx, node, attrs):
    reps = [int(d) for d in ctx.const(node.input[1], "Tile")]
    ctx.put(node.output[0], ctx.h.tile(ctx.get(node.input[0]), reps))


@register_import("Gather", "GatherElements")
def _imp_gather(ctx, node, attrs):
    out = ctx.h._add(node.op_type,
                     [ctx.get(node.input[0]), ctx.get(node.input[1])],
                     {"axis": attrs.get("axis", 0)})
    ctx.put(node.output[0], out)


@register_import("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
                 "ReduceProd", "ReduceL2")
def _imp_reduce(ctx, node, attrs):
    axes = attrs.get("axes")
    if len(node.input) > 1 and node.input[1]:  # opset 13+ axes input
        axes = [int(a) for a in ctx.const(node.input[1], node.op_type)]
    out = ctx.h._add(node.op_type, [ctx.get(node.input[0])],
                     {"axes": list(axes) if axes is not None else None,
                      "keepdims": int(attrs.get("keepdims", 1))})
    ctx.put(node.output[0], out)


@register_import("ArgMax", "ArgMin")
def _imp_argmax(ctx, node, attrs):
    out = ctx.h._add(node.op_type, [ctx.get(node.input[0])],
                     {"axis": attrs.get("axis", 0),
                      "keepdims": int(attrs.get("keepdims", 1))})
    ctx.put(node.output[0], out)


@register_import("Dropout")
def _imp_dropout(ctx, node, attrs):
    out = ctx.h._add("Dropout", [ctx.get(node.input[0])], {})
    ctx.put(node.output[0], out)
    # mask output (rare) unsupported: reference also ignores it


@register_import("DepthToSpace")
def _imp_d2s(ctx, node, attrs):
    ctx.put(node.output[0],
            ctx.h.depth_to_space(ctx.get(node.input[0]),
                                 int(attrs["blocksize"]),
                                 attrs.get("mode", "DCR")))


@register_import("SpaceToDepth")
def _imp_s2d(ctx, node, attrs):
    out = ctx.h._add("SpaceToDepth", [ctx.get(node.input[0])],
                     {"blocksize": int(attrs["blocksize"])})
    ctx.put(node.output[0], out)


@register_import("Shape")
def _imp_shape(ctx, node, attrs):
    # Should normally be constant-folded; keep runtime fallback.
    out = ctx.h._add("Shape", [ctx.get(node.input[0])],
                     {"start": attrs.get("start", 0),
                      "end": attrs.get("end")})
    ctx.put(node.output[0], out)


@register_import("AttentionKVCache")
def _imp_attn_kv(ctx, node, attrs):
    ins = [ctx.get(i) for i in node.input[:6]]
    outs = ctx.h.attention_kvcache(*ins)
    ctx.put(node.output[0], outs[0] if isinstance(outs, list) else outs)
    if isinstance(outs, list) and len(node.output) >= 3:
        ctx.put(node.output[1], outs[1])
        ctx.put(node.output[2], outs[2])


@register_import("AttentionKVCacheQ8")
def _imp_attn_kv_q8(ctx, node, attrs):
    ins = [ctx.get(i) for i in node.input[:8]]
    outs = ctx.h.attention_kvcache_q8(*ins)
    for name, t in zip(node.output, outs):
        ctx.put(name, t)


@register_import("MatMulWOQ")
def _imp_matmul_woq(ctx, node, attrs):
    ins = [ctx.get(i) for i in node.input]
    if int(attrs.get("bits", 8)) == 4 and "pack_version" in attrs:
        from infinitensor_tpu_torch.quant.weight_only import INT4_PACK_VERSION
        pv = int(attrs["pack_version"])
        if pv != INT4_PACK_VERSION:
            raise ValueError(
                f"MatMulWOQ '{node.name}' was serialized with int4 "
                f"pack_version {pv}; this build decodes version "
                f"{INT4_PACK_VERSION} — re-quantize the model "
                f"(quant/weight_only.py packing changed)")
    out = ctx.h.matmul_woq(
        ins[0], ins[1], ins[2], bits=int(attrs["bits"]),
        group_size=int(attrs["group_size"]),
        norm_weight=ins[3] if len(ins) > 3 else None,
        eps=float(attrs.get("eps", 1e-5)),
        out_logical=int(attrs.get("out_logical", 0)))
    ctx.put(node.output[0], out)


@register_import("RoPE")
def _imp_rope(ctx, node, attrs):
    out = ctx.h.rope(ctx.get(node.input[0]), ctx.get(node.input[1]),
                     dim_head=int(attrs.get("dim_head", 64)),
                     theta=float(attrs.get("theta", 10000.0)))
    ctx.put(node.output[0], out)


@register_import("QuantizeLinear", "DequantizeLinear")
def _imp_qdq(ctx, node, attrs):
    ins = [ctx.get(i) for i in node.input]
    out = ctx.h._add(node.op_type, ins, {"axis": attrs.get("axis", 1)})
    ctx.put(node.output[0], out)


@register_import("DynamicQuantizeLinear")
def _imp_dql(ctx, node, attrs):
    outs = ctx.h._add("DynamicQuantizeLinear", [ctx.get(node.input[0])], {},
                      n_outputs=3)
    for name, t in zip(node.output, outs):
        ctx.put(name, t)


@register_import("MatMulInteger")
def _imp_mmi(ctx, node, attrs):
    ins = [ctx.get(i) for i in node.input]
    ctx.put(node.output[0], ctx.h._add("MatMulInteger", ins, {}))


@register_import("AllReduceSum", "AllReduceProd", "AllReduceMin",
                 "AllReduceMax", "AllReduceAvg", "Broadcast")
def _imp_comm(ctx, node, attrs):
    a = {}
    if node.op_type == "Broadcast":
        a["root"] = int(attrs.get("root", 0))
    ctx.put(node.output[0],
            ctx.h._add(node.op_type, [ctx.get(node.input[0])], a))


@register_import("AllGather")
def _imp_allgather(ctx, node, attrs):
    outs = ctx.h.all_gather(ctx.get(node.input[0]), len(node.output))
    for name, t in zip(node.output, outs):
        ctx.put(name, t)


@register_import("Send")
def _imp_send(ctx, node, attrs):
    out = ctx.h.send(ctx.get(node.input[0]), int(attrs["source"]),
                     int(attrs["destination"]))
    if node.output:
        ctx.put(node.output[0], out)


@register_import("Recv")
def _imp_recv(ctx, node, attrs):
    out = ctx.h.recv(int(attrs["source"]), int(attrs["destination"]),
                     [int(d) for d in attrs["shape"]], int(attrs["dataType"]))
    ctx.put(node.output[0], out)


# ---------------------------------------------------------------------------
# widened coverage beyond the reference importer's 68 op types
# (reference pyinfinitensor onnx.py:137-1130 stops at its kernel zoo;
# here every graph op lowers to torch so the importer can be broader)
# ---------------------------------------------------------------------------

_WIDE_UNARY = [
    "Asinh", "Acosh", "Atanh", "Mish", "IsNaN",
    "Sign", "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh", "Softsign",
]


@register_import(*_WIDE_UNARY)
def _imp_wide_unary(ctx, node, attrs):
    ctx.put(node.output[0],
            ctx.h._add(node.op_type, [ctx.get(node.input[0])], {}))


@register_import("IsInf")
def _imp_isinf(ctx, node, attrs):
    ctx.put(node.output[0],
            ctx.h._add("IsInf", [ctx.get(node.input[0])],
                       {"detect_negative": int(attrs.get("detect_negative", 1)),
                        "detect_positive": int(attrs.get("detect_positive", 1))}))


@register_import("Selu", "Celu", "ThresholdedRelu", "Shrink", "Hardmax")
def _imp_attr_unary(ctx, node, attrs):
    ctx.put(node.output[0],
            ctx.h._add(node.op_type, [ctx.get(node.input[0])], dict(attrs)))


@register_import("Sum", "Mean")
def _imp_variadic(ctx, node, attrs):
    op = "Sum" if node.op_type == "Sum" else "MeanN"
    ctx.put(node.output[0],
            ctx.h._add(op, [ctx.get(i) for i in node.input], {}))


@register_import("ReduceLogSum", "ReduceLogSumExp", "ReduceSumSquare",
                 "ReduceL1")
def _imp_reduce_wide(ctx, node, attrs):
    return _imp_reduce(ctx, node, attrs)


@register_import("Einsum")
def _imp_einsum(ctx, node, attrs):
    ctx.put(node.output[0],
            ctx.h._add("Einsum", [ctx.get(i) for i in node.input],
                       {"equation": attrs["equation"]}))


@register_import("GatherND")
def _imp_gather_nd(ctx, node, attrs):
    ctx.put(node.output[0],
            ctx.h._add("GatherND",
                       [ctx.get(node.input[0]), ctx.get(node.input[1])],
                       {"batch_dims": int(attrs.get("batch_dims", 0))}))


@register_import("ScatterND")
def _imp_scatter_nd(ctx, node, attrs):
    ctx.put(node.output[0],
            ctx.h._add("ScatterND", [ctx.get(i) for i in node.input[:3]],
                       {"reduction": attrs.get("reduction", "none")}))


@register_import("GroupNormalization")
def _imp_group_norm(ctx, node, attrs):
    ctx.put(node.output[0],
            ctx.h._add("GroupNormalization",
                       [ctx.get(i) for i in node.input[:3]],
                       {"num_groups": int(attrs["num_groups"]),
                        "epsilon": float(attrs.get("epsilon", 1e-5))}))


@register_import("MeanVarianceNormalization")
def _imp_mvn(ctx, node, attrs):
    ctx.put(node.output[0],
            ctx.h._add("MeanVarianceNormalization",
                       [ctx.get(node.input[0])],
                       {"axes": list(attrs.get("axes", [0, 2, 3]))}))


@register_import("LpNormalization")
def _imp_lp_norm(ctx, node, attrs):
    ctx.put(node.output[0],
            ctx.h._add("LpNormalization", [ctx.get(node.input[0])],
                       {"axis": int(attrs.get("axis", -1)),
                        "p": int(attrs.get("p", 2))}))


@register_import("LpPool", "GlobalLpPool")
def _imp_lp_pool(ctx, node, attrs):
    a = {"p": int(attrs.get("p", 2))}
    if node.op_type == "LpPool":
        a.update({"kernel_shape": list(attrs["kernel_shape"]),
                  "strides": list(attrs.get("strides",
                                            [1] * len(attrs["kernel_shape"]))),
                  "pads": list(attrs.get("pads",
                                         [0] * 2 * len(attrs["kernel_shape"])))})
    ctx.put(node.output[0],
            ctx.h._add(node.op_type, [ctx.get(node.input[0])], a))


@register_import("EyeLike")
def _imp_eye_like(ctx, node, attrs):
    a = {"k": int(attrs.get("k", 0))}
    if "dtype" in attrs:
        a["dtype"] = int(attrs["dtype"])
    ctx.put(node.output[0],
            ctx.h._add("EyeLike", [ctx.get(node.input[0])], a))


@register_import("RandomNormal", "RandomUniform")
def _imp_random(ctx, node, attrs):
    a = {"shape": [int(d) for d in attrs["shape"]],
         "dtype": int(attrs.get("dtype", 1))}
    for k in ("mean", "scale", "low", "high", "seed"):
        if k in attrs:
            a[k] = float(attrs[k])
    ctx.put(node.output[0], ctx.h._add(node.op_type, [], a))


@register_import("RandomNormalLike", "RandomUniformLike", "Bernoulli")
def _imp_random_like(ctx, node, attrs):
    a = {}
    if "dtype" in attrs:
        a["dtype"] = int(attrs["dtype"])
    for k in ("mean", "scale", "low", "high", "seed"):
        if k in attrs:
            a[k] = float(attrs[k])
    ctx.put(node.output[0],
            ctx.h._add(node.op_type, [ctx.get(node.input[0])], a))


@register_import("PRelu")
def _imp_prelu(ctx, node, attrs):
    ctx.put(node.output[0],
            ctx.h._add("PRelu",
                       [ctx.get(node.input[0]), ctx.get(node.input[1])], {}))


@register_import("BitwiseAnd", "BitwiseOr", "BitwiseXor")
def _imp_bitwise_bin(ctx, node, attrs):
    ctx.put(node.output[0],
            ctx.h._add(node.op_type,
                       [ctx.get(node.input[0]), ctx.get(node.input[1])], {}))


@register_import("BitwiseNot", "Det")
def _imp_plain_unary(ctx, node, attrs):
    ctx.put(node.output[0],
            ctx.h._add(node.op_type, [ctx.get(node.input[0])], {}))


@register_import("CastLike")
def _imp_cast_like(ctx, node, attrs):
    ctx.put(node.output[0],
            ctx.h._add("CastLike",
                       [ctx.get(node.input[0]), ctx.get(node.input[1])], {}))


@register_import("ConstantOfShape")
def _imp_constant_of_shape(ctx, node, attrs):
    if node.input and node.input[0]:
        shape = [int(d) for d in ctx.const(node.input[0], "shape")]
    else:
        shape = [int(d) for d in attrs["shape"]]
    a = {"shape": shape}
    val = attrs.get("value")
    if val is not None:
        arr = val.to_numpy() if hasattr(val, "to_numpy") else np.asarray(val)
        a["value"] = arr.reshape(-1)[0].item()
        a["dtype"] = int(getattr(val, "data_type", 0)) or None
        if a["dtype"] is None:
            del a["dtype"]
    if "dtype" in attrs:
        a["dtype"] = int(attrs["dtype"])
    ctx.put(node.output[0], ctx.h._add("ConstantOfShape", [], a))


@register_import("CumSum")
def _imp_cumsum(ctx, node, attrs):
    a = {"exclusive": int(attrs.get("exclusive", 0)),
         "reverse": int(attrs.get("reverse", 0))}
    if len(node.input) > 1 and node.input[1]:
        a["axis"] = int(ctx.const(node.input[1], "axis").reshape(-1)[0])
    else:
        a["axis"] = int(attrs.get("axis", 0))
    ctx.put(node.output[0],
            ctx.h._add("CumSum", [ctx.get(node.input[0])], a))


@register_import("OneHot")
def _imp_onehot(ctx, node, attrs):
    a = {"axis": int(attrs.get("axis", -1))}
    if len(node.input) >= 3:
        a["depth"] = int(ctx.const(node.input[1], "depth").reshape(-1)[0])
        vals = ctx.const(node.input[2], "values").reshape(-1)
        a["off_value"], a["on_value"] = float(vals[0]), float(vals[1])
    else:
        a["depth"] = int(attrs["depth"])
        for k in ("off_value", "on_value"):
            if k in attrs:
                a[k] = float(attrs[k])
    ctx.put(node.output[0],
            ctx.h._add("OneHot", [ctx.get(node.input[0])], a))


@register_import("Range")
def _imp_range(ctx, node, attrs):
    if len(node.input) >= 3:
        start = ctx.const(node.input[0], "start").reshape(-1)[0]
        limit = ctx.const(node.input[1], "limit").reshape(-1)[0]
        delta = ctx.const(node.input[2], "delta").reshape(-1)[0]
        a = {"start": start.item(), "limit": limit.item(),
             "delta": delta.item(),
             "dtype": DataType.from_numpy(start.dtype).onnx_id}
    else:
        a = {k: attrs[k] for k in ("start", "limit", "delta") if k in attrs}
        if "dtype" in attrs:
            a["dtype"] = int(attrs["dtype"])
    import math
    a["length"] = int(attrs.get("length",
                                max(0, math.ceil((a["limit"] - a["start"])
                                                 / a["delta"]))))
    ctx.put(node.output[0], ctx.h._add("Range", [], a))


@register_import("ScatterElements")
def _imp_scatter_elements(ctx, node, attrs):
    ctx.put(node.output[0],
            ctx.h._add("ScatterElements",
                       [ctx.get(i) for i in node.input[:3]],
                       {"axis": int(attrs.get("axis", 0))}))


@register_import("TopK")
def _imp_topk(ctx, node, attrs):
    a = {"axis": int(attrs.get("axis", -1)),
         "largest": int(attrs.get("largest", 1))}
    if len(node.input) > 1 and node.input[1]:
        a["k"] = int(ctx.const(node.input[1], "k").reshape(-1)[0])
    else:
        a["k"] = int(attrs["k"])
    outs = ctx.h._add("TopK", [ctx.get(node.input[0])], a)
    for name, t in zip(node.output, outs):
        ctx.put(name, t)


@register_import("Trilu")
def _imp_trilu(ctx, node, attrs):
    a = {"upper": int(attrs.get("upper", 1))}
    if len(node.input) > 1 and node.input[1]:
        a["k"] = int(ctx.const(node.input[1], "k").reshape(-1)[0])
    elif "k" in attrs:
        a["k"] = int(attrs["k"])
    ctx.put(node.output[0],
            ctx.h._add("Trilu", [ctx.get(node.input[0])], a))


@register_import("Extend", "G2BMM", "GBMM", "Im2colMatmulConv",
                 "SkipRMSNorm", "ReluBackward", "SigmoidBackward",
                 "TanhBackward", "FloorDiv", "FloorMod",
                 "SquaredDifference", "Rsqrt", "Square", "Hardtanh",
                 "AllToAll", "ReduceScatterSum")
def _imp_custom_generic(ctx, node, attrs):
    """Custom-domain round-trip: internal ops export attrs verbatim
    (exporter.py CUSTOM_DOMAIN_OPS), so a generic rebuild suffices."""
    outs = ctx.h._add(node.op_type,
                      [ctx.get(i) for i in node.input], dict(attrs))
    if not isinstance(outs, list):
        outs = [outs]
    for name, t in zip(node.output, outs):
        ctx.put(name, t)


# ---------------------------------------------------------------------------
# OnnxStub
# ---------------------------------------------------------------------------

class OnnxStub:
    """Importer facade mirroring the reference OnnxStub API
    (onnx.py:41-1533): .inputs/.outputs/.tensors dicts, .run/.optimize/
    .to_onnx, dynamic shapes via .set_input."""

    def __init__(self, model: Union[str, bytes, proto.ModelProto],
                 runtime=None, fixed_dims: Optional[dict] = None,
                 default_dim: int = 1):
        if not isinstance(model, proto.ModelProto):
            model = proto.load_model(model)
        self.model = model
        self.handler = GraphHandler(runtime, name=model.graph.name or "onnx")
        opset = model.opset_version()
        ctx = ImportContext(self.handler, opset)
        self._ctx = ctx
        g = model.graph

        init_names = set()
        for init in g.initializer:
            ctx.consts[init.name] = init.to_numpy()
            init_names.add(init.name)

        self.inputs: dict[str, TensorObj] = {}
        for vi in g.input:
            if vi.name in init_names:
                continue
            shape = [d if isinstance(d, int) and d > 0 else
                     (fixed_dims or {}).get(vi.name, default_dim)
                     for d in vi.np_shape()]
            elem = vi.tensor_type.elem_type if vi.tensor_type else 1
            t = self.handler.input(shape, int(elem), name=vi.name)
            ctx.put(vi.name, t)
            self.inputs[vi.name] = t

        known = set(ctx.consts) | set(ctx.tensors)
        nodes = topo_sort_nodes(g.node, known)

        for node in nodes:
            if _try_constant_fold(ctx, node):
                continue
            fn = _IMPORTERS.get(node.op_type)
            if fn is None:
                raise NotImplementedError(
                    f"unsupported ONNX op {node.op_type!r} "
                    f"(node {node.name!r})")
            fn(ctx, node, node.attrs())

        self.outputs: dict[str, TensorObj] = {}
        for vi in g.output:
            t = ctx.tensors.get(vi.name)
            if t is None and vi.name in ctx.consts:
                t = ctx.get(vi.name)
            if t is None:
                raise ValueError(f"graph output {vi.name!r} was never produced")
            t.role = TensorRole.OUTPUT
            self.outputs[vi.name] = t

        self.handler.graph.topo_sort()

    # -- reference-API conveniences ---------------------------------------
    @property
    def tensors(self) -> dict[str, TensorObj]:
        return dict(self._ctx.tensors)

    def run(self, inputs: Optional[dict] = None, **kw) -> dict:
        return self.handler.run(inputs, **kw)

    def optimize(self, level: int = 2) -> None:
        self.handler.optimize(level)

    def tune(self) -> None:
        from infinitensor_tpu_torch.runtime.perf import PerfEngine
        self.handler.executor().profile(perf_engine=PerfEngine.instance())

    def get_perf_time(self) -> float:
        return self.handler.get_perf_time()

    def set_input(self, shapes: dict[str, Sequence[int]]) -> None:
        """Dynamic-shape rebind (reference set_input -> change_shape +
        shape_infer + re-malloc; here: re-infer + executor cache miss)."""
        for name, shape in shapes.items():
            self.handler.change_shape(self.inputs[name], shape)
        self.handler.shape_infer()

    # -- reference API aliases (OnnxStub surface parity) -----------------
    def init(self) -> None:
        """Weight restore + malloc (reference onnx.py:1484); memory is
        PyTorch's allocator's, so this just (re)materializes the executor's
        weight tensors."""
        self.handler._executor = None

    def run_with_cudagraph(self, inputs=None, **kw):
        """Capture-replay alias: the executor cache IS the capture cache."""
        return self.run(inputs, **kw)

    def clone_KV(self, cache, src: int, dst: int):
        from infinitensor_tpu_torch.serving.kvcache import clone_kv_slot
        return clone_kv_slot(cache, src, dst)

    def free_heap(self, cache, slot: int):
        from infinitensor_tpu_torch.serving.kvcache import clear_kv_slot
        return clear_kv_slot(cache, slot)

    def trim_memory(self) -> None:
        """Drop cached executables/weight arrays (reference trim_memory)."""
        ex = self.handler._executor
        if ex is not None:
            ex._cache.clear()
            ex._weight_vals = None

    def to_onnx(self, name: str = "graph") -> proto.ModelProto:
        from infinitensor_tpu_torch.onnx.exporter import export_onnx
        return export_onnx(self.handler.graph, name=name)


def import_onnx(model, runtime=None, **kw) -> OnnxStub:
    return OnnxStub(model, runtime, **kw)
