"""The graph corpus: builders of small graphs that cover the op families
of the graph IR, each taking a GraphHandler (the JAX package's or the
port's) and a seeded numpy Generator, and returning the input feeds.

No jax import here: tests/test_torch_graph.py holds the port against the
JAX package on the CPU with these builders, and tests/test_torch_gpu.py
runs them on the card (where there is no jax) against the CPU.
"""

import importlib

import numpy as np
import torch

from infinitensor_tpu_torch.quant.weight_only import quantize_weight


def _dt(h):
    """The dtype module of the handler's package."""
    pkg = type(h).__module__.split(".")[0]
    return importlib.import_module(pkg + ".core.dtype")


def _in(h, rng, shape, name, dtype=np.float32, lo=None, hi=None):
    if np.issubdtype(dtype, np.integer):
        a = rng.integers(lo or 0, hi or 5, shape).astype(dtype)
    else:
        a = rng.standard_normal(shape).astype(dtype)
    t = h.input(shape, dtype=_dt(h).DataType.from_numpy(a.dtype), name=name)
    return t, a


def _w(h, a):
    return h.weight(np.asarray(a))


def _op(h, op_type, ins, attrs=None, n_out=None):
    return h._add(op_type, ins, attrs or {}, n_outputs=n_out)


# -- cases ------------------------------------------------------------------

def case_matmul(h, rng):
    a, an = _in(h, rng, (3, 4, 5), "a")
    h.matmul(a, _w(h, rng.standard_normal((5, 6)).astype(np.float32)))
    b, bn = _in(h, rng, (5, 4), "b")
    h.matmul(b, _w(h, rng.standard_normal((6, 5)).astype(np.float32)),
             trans_a=True, trans_b=True)
    c, cn = _in(h, rng, (4, 3), "c")
    h.gemm(c, _w(h, rng.standard_normal((3, 2)).astype(np.float32)),
           _w(h, rng.standard_normal((2,)).astype(np.float32)),
           alpha=0.5, beta=2.0)
    return {"a": an, "b": bn, "c": cn}


def case_conv(h, rng):
    x, xn = _in(h, rng, (2, 3, 16, 16), "x")
    h.conv(x, _w(h, rng.standard_normal((8, 3, 3, 3)).astype(np.float32)),
           pads=(1, 1), strides=(2, 2))
    _op(h, "Conv", [x, _w(h, rng.standard_normal((4, 3, 3, 2)).astype(
        np.float32))], {"pads": [1, 0, 2, 1], "strides": [1, 2],
                        "dilations": [2, 1], "group": 1})
    return {"x": xn}


def case_grouped_conv(h, rng):
    x, xn = _in(h, rng, (1, 8, 10, 10), "x")
    h.conv(x, _w(h, rng.standard_normal((8, 1, 3, 3)).astype(np.float32)),
           pads=(1, 1), group=8)
    h.conv(x, _w(h, rng.standard_normal((4, 4, 3, 3)).astype(np.float32)),
           bias=_w(h, rng.standard_normal(4).astype(np.float32)),
           pads=(2, 2), dilations=(2, 2), group=2)
    return {"x": xn}


def case_conv_1d_3d(h, rng):
    x, xn = _in(h, rng, (2, 3, 12), "x")
    h.conv(x, _w(h, rng.standard_normal((5, 3, 3)).astype(np.float32)),
           pads=(1,), strides=(2,), dilations=(1,))
    y, yn = _in(h, rng, (1, 2, 5, 6, 4), "y")
    h.conv(y, _w(h, rng.standard_normal((3, 2, 2, 3, 1)).astype(np.float32)),
           pads=(1, 1, 0), strides=(1, 2, 1), dilations=(1, 1, 1))
    return {"x": xn, "y": yn}


def case_conv_transpose(h, rng):
    x, xn = _in(h, rng, (1, 4, 7, 7), "x")
    h.conv_transpose(x, _w(h, rng.standard_normal((4, 6, 3, 3)).astype(
        np.float32)), strides=(2, 2), pads=(1, 1), output_padding=(1, 1))
    h.conv_transpose(x, _w(h, rng.standard_normal((4, 3, 2, 3)).astype(
        np.float32)), bias=_w(h, rng.standard_normal(6).astype(np.float32)),
        strides=(2, 1), pads=(0, 1, 1, 0), dilations=(1, 2), group=2)
    return {"x": xn}


def case_im2col_conv(h, rng):
    x, xn = _in(h, rng, (2, 3, 9, 9), "x")
    _op(h, "Im2colMatmulConv", [x, _w(h, rng.standard_normal(
        (5, 3, 3, 3)).astype(np.float32))],
        {"pads": [1, 1, 0, 0], "strides": [2, 1], "dilations": [1, 2]})
    return {"x": xn}


def case_pools(h, rng):
    x, xn = _in(h, rng, (2, 4, 9, 9), "x")
    h.max_pool(x, kernel=(3, 3), strides=(2, 2), pads=(1, 1))
    h.avg_pool(x, kernel=(3, 3), strides=(2, 2), pads=(1, 1))
    h.avg_pool(x, kernel=(2, 3), strides=(2, 2), pads=(1, 0),
               count_include_pad=1)
    h.max_pool(x, kernel=(2, 2), strides=(2, 2), ceil_mode=1)
    h.max_pool(x, kernel=(2, 2), strides=(1, 1), dilations=(2, 2))
    h.global_avg_pool(x)
    _op(h, "GlobalMaxPool", [x])
    _op(h, "LpPool", [x], {"kernel_shape": [2, 2], "strides": [2, 2],
                           "pads": [0, 0, 1, 1], "p": 2})
    _op(h, "GlobalLpPool", [x], {"p": 1})
    return {"x": xn}


def case_norms(h, rng):
    x, xn = _in(h, rng, (2, 4, 5, 5), "x")
    f = lambda *s: _w(h, rng.standard_normal(s).astype(np.float32))  # noqa
    var = _w(h, (np.abs(rng.standard_normal(4)) + 0.5).astype(np.float32))
    h.batch_normalization(x, f(4), f(4), f(4), var)
    h.instance_normalization(x, f(4), f(4))
    _op(h, "GroupNormalization", [x, f(4), f(4)], {"num_groups": 2})
    h.lrn(x, size=3, alpha=1e-2)
    _op(h, "MeanVarianceNormalization", [x])
    _op(h, "LpNormalization", [x], {"axis": 1, "p": 2})
    _op(h, "LpNormalization", [x], {"axis": -1, "p": 1})
    y, yn = _in(h, rng, (3, 7, 16), "y")
    h.layer_normalization(y, f(16), f(16), axis=-1)
    h.layer_normalization(y, f(7, 16), axis=1)
    h.rms_norm(y, f(16))
    r, rn = _in(h, rng, (3, 7, 16), "r")
    _op(h, "SkipRMSNorm", [y, r, f(16)], {"epsilon": 1e-5}, n_out=2)
    return {"x": xn, "y": yn, "r": rn}


def case_activations(h, rng):
    x, xn = _in(h, rng, (4, 10), "x")
    h.softmax(x, axis=1)
    _op(h, "LogSoftmax", [x], {"axis": 0})
    for fn in (h.gelu, h.silu, h.hard_swish, h.hard_sigmoid, h.sigmoid,
               h.tanh, h.erf, h.abs, h.neg, h.exp, h.relu):
        fn(x)
    h.leaky_relu(x, alpha=0.2)
    h.elu(x, alpha=0.7)
    h.clip(x, min=-0.5, max=0.7)
    h.p_relu(x, _w(h, rng.standard_normal(10).astype(np.float32)))
    for name in ("Softplus", "Mish", "Softsign", "Selu", "Celu",
                 "ThresholdedRelu", "Shrink", "Hardtanh", "Sign", "Floor",
                 "Ceil", "Round", "Square", "Sin", "Cos", "Atan", "Sinh",
                 "Asinh", "IsNaN"):
        _op(h, name, [x])
    _op(h, "Hardmax", [x], {"axis": 1})
    p, pn = _in(h, rng, (4, 10), "p")
    pn = np.abs(pn) + 0.1
    for name in ("Sqrt", "Log", "Reciprocal", "Rsqrt", "Acosh"):
        _op(h, name, [p] if name != "Acosh" else [h.add(p, _w(
            h, np.ones((1,), np.float32)))])
    u, un = _in(h, rng, (4, 10), "u")
    un = np.clip(un, -0.9, 0.9)
    for name in ("Asin", "Acos", "Atanh", "Tan", "Cosh"):
        _op(h, name, [u])
    return {"x": xn, "p": pn, "u": un}


def case_binary(h, rng):
    a, an = _in(h, rng, (3, 4), "a")
    b, bn = _in(h, rng, (1, 4), "b")
    bn = np.where(np.abs(bn) < 0.3, 0.5, bn).astype(np.float32)
    for fn in (h.add, h.sub, h.mul, h.div, h.min, h.max):
        fn(a, b)
    for name in ("Mod", "FloorDiv", "FloorMod", "SquaredDifference",
                 "Equal", "Greater", "GreaterOrEqual", "Less",
                 "LessOrEqual"):
        _op(h, name, [a, b])
    h.pow(h.abs(a), b)
    i, in_ = _in(h, rng, (3, 4), "i", np.int32, -9, 9)
    j, jn = _in(h, rng, (3, 4), "j", np.int32, 1, 5)
    for name in ("Div", "Mod", "BitwiseAnd", "BitwiseOr", "BitwiseXor",
                 "FloorDiv"):
        _op(h, name, [i, j])
    _op(h, "BitwiseNot", [i])
    c = _op(h, "Greater", [a, b])
    d = _op(h, "Less", [a, b])
    for name in ("And", "Or", "Xor"):
        _op(h, name, [c, d])
    _op(h, "Not", [c])
    h.where(c, a, b)
    _op(h, "Clip", [a, _w(h, np.array(-0.2, np.float32)),
                    _w(h, np.array(0.4, np.float32))])
    _op(h, "Sum", [a, b, a])
    _op(h, "MeanN", [a, b])
    h.cast(a, _dt(h).INT32)
    h.cast(i, _dt(h).FLOAT32)
    _op(h, "CastLike", [i, a])
    _op(h, "IsInf", [h.div(a, h.sub(b, b))])
    return {"a": an, "b": bn, "i": in_, "j": jn}


def case_shape_ops(h, rng):
    x, xn = _in(h, rng, (2, 3, 4), "x")
    y = h.transpose(x, perm=[2, 0, 1])
    z = h.reshape(y, (4, 6))
    h.slice(z, starts=[1], ends=[4], axes=[0])
    h.slice(z, starts=[-1, 5], ends=[-5, 0], axes=[0, 1], steps=[-1, -2])
    h.slice(x, starts=[0, 1], ends=[100, -1], axes=[2, 1], steps=[2, 1])
    h.concat([x, x], axis=1)
    h.split(x, 2, [1, 3])
    h.pad(x, [0, 1, 2, 0, 2, 1])
    h.pad(x, [0, 2, 1, 0, 1, 3], mode="reflect")
    h.pad(x, [1, 0, 3, 0, 2, 1], mode="edge")
    h.pad(x, [0, -1, 1, 0, 0, -2], value=1.5)
    h.expand(h.reshape(x, (2, 1, 3, 4)), (2, 5, 3, 4))
    h.tile(x, (1, 2, 3))
    h.squeeze(h.unsqueeze(x, [0, 3]), [0])
    h.flatten(x, axis=2)
    h.transpose(x)
    h.identity(x)
    h.shape(x)
    _op(h, "Extend", [x], {"dim": 1, "num": 2})
    _op(h, "Trilu", [z], {"upper": 0, "k": 1})
    _op(h, "Trilu", [z], {"upper": 1})
    d, dn = _in(h, rng, (1, 8, 2, 3), "d")
    h.depth_to_space(d, 2)
    h.depth_to_space(d, 2, mode="CRD")
    _op(h, "SpaceToDepth", [h.depth_to_space(d, 2)], {"blocksize": 2})
    h.dropout(x)
    return {"x": xn, "d": dn}


def case_gather_reduce(h, rng):
    data, dn = _in(h, rng, (5, 7), "data")
    idx = _w(h, np.array([[0, 2], [4, -1]], np.int64))
    g = h.gather(data, idx, axis=0)
    h.reduce_sum(g, axes=[2], keepdims=0)
    h.gather(data, _w(h, np.array([6, 0, 3], np.int32)), axis=1)
    ge = _w(h, rng.integers(0, 7, (5, 3)).astype(np.int64))
    h.gather_elements(data, ge, axis=1)
    _op(h, "ScatterElements", [data, _w(h, np.array([[1, 3], [0, 6]],
                                                    np.int64)),
                               _w(h, np.ones((2, 2), np.float32))],
        {"axis": 1})
    h.reduce_mean(data, axes=[1])
    h.reduce_mean(data)
    for name in ("ReduceMax", "ReduceMin", "ReduceProd", "ReduceL2",
                 "ReduceL1", "ReduceLogSumExp", "ReduceSumSquare"):
        _op(h, name, [data], {"axes": [0], "keepdims": 0})
    _op(h, "ReduceLogSum", [h.abs(data)], {"axes": [1]})
    _op(h, "ArgMax", [data], {"axis": 1, "keepdims": 0})
    _op(h, "ArgMin", [data], {"axis": 0})
    _op(h, "TopK", [data], {"k": 3, "axis": -1}, n_out=2)
    _op(h, "TopK", [data], {"k": 2, "axis": 0, "largest": 0}, n_out=2)
    _op(h, "CumSum", [data], {"axis": 1})
    _op(h, "CumSum", [data], {"axis": 0, "exclusive": 1, "reverse": 1})
    t3, tn = _in(h, rng, (2, 3, 4), "t3")
    _op(h, "GatherND", [t3, _w(h, np.array([[0, 1], [1, 2]], np.int64))])
    _op(h, "GatherND", [t3, _w(h, np.array([[1], [0]], np.int64))],
        {"batch_dims": 1})
    for red in ("none", "add", "mul", "max", "min"):
        _op(h, "ScatterND", [t3, _w(h, np.array([[0, 1], [1, 2], [0, 1]],
                                                np.int64)),
                             _w(h, rng.standard_normal((3, 4)).astype(
                                 np.float32))], {"reduction": red})
    _op(h, "Einsum", [t3, t3], {"equation": "bij,bkj->bik"})
    i, in_ = _in(h, rng, (2, 4), "i", np.int32, 0, 5)
    _op(h, "OneHot", [i], {"depth": 5})
    _op(h, "OneHot", [i], {"depth": 6, "axis": 1, "on_value": 3.0,
                           "off_value": -1.0})
    return {"data": dn, "t3": tn, "i": in_}


def case_resize(h, rng):
    x, xn = _in(h, rng, (1, 2, 5, 6), "x")
    for mode in ("nearest", "linear", "cubic"):
        h.resize(x, (1, 2, 10, 9), mode=mode)
        h.resize(x, (1, 2, 3, 4), mode=mode)
    _op(h, "Upsample", [x], {"out_shape": [1, 2, 7, 6], "mode": "linear"})
    return {"x": xn}


def case_attention_kvcache(h, rng):
    B, H, S, D = 2, 4, 32, 16
    names = ("kc", "vc", "q", "k", "v")
    shapes = ((B, H, S, D),) * 2 + ((B, H, 1, D),) * 3
    ts, feeds = [], {}
    for n, s in zip(names, shapes):
        t, a = _in(h, rng, s, n)
        ts.append(t)
        feeds[n] = a
    pos = _w(h, np.array([7, 3], np.int32))
    h.attention_kvcache(*ts, pos)
    # INT8 cache, GQA: 4 query heads over 2 kv heads
    kq, kqn = _in(h, rng, (B, 2, S, D), "kq", np.int8, -127, 127)
    vq, vqn = _in(h, rng, (B, 2, S, D), "vq", np.int8, -127, 127)
    ks, ksn = _in(h, rng, (B, 2, S), "ks")
    vs, vsn = _in(h, rng, (B, 2, S), "vs")
    k2, k2n = _in(h, rng, (B, 2, 1, D), "k2")
    v2, v2n = _in(h, rng, (B, 2, 1, D), "v2")
    h.attention_kvcache_q8(kq, vq, ks, vs, ts[2], k2, v2, pos)
    feeds.update(kq=kqn, vq=vqn, ks=np.abs(ksn) * 0.01 + 0.001,
                 vs=np.abs(vsn) * 0.01 + 0.001, k2=k2n, v2=v2n)
    p2 = h.reshape(pos, (B, 1))
    _op(h, "RoPE", [p2, h.reshape(ts[2], (B, 1, H * D))],
        {"dim_head": D, "theta": 500.0})
    return feeds


def case_quant(h, rng):
    x, xn = _in(h, rng, (4, 8), "x")
    scale = _w(h, np.array(0.05, np.float32))
    zp = _w(h, np.array(0, np.int8))
    q = h.quantize_linear(x, scale, zp)
    h.dequantize_linear(q, scale, zp)
    sc = _w(h, np.array([0.1, 0.2, 0.05, 0.3], np.float32))
    zu = _w(h, np.array([3, 0, 10, 128], np.uint8))
    h.dequantize_linear(h.quantize_linear(x, sc, zu, axis=0), sc, zu, axis=0)
    h.quantize_linear(x, scale)
    _op(h, "DynamicQuantizeLinear", [x], n_out=3)
    a, an = _in(h, rng, (3, 5), "a", np.int8, -100, 100)
    b, bn = _in(h, rng, (5, 2), "b", np.int8, -100, 100)
    _op(h, "MatMulInteger", [a, b, _w(h, np.array(3, np.int8)),
                             _w(h, np.array(-2, np.int8))])
    return {"x": xn, "a": an, "b": bn}


def case_matmul_woq(h, rng):
    # the port's quantize_weight writes the JAX package's bytes bit for
    # bit (tests/test_torch_quant.py), so both handlers get the same
    # weight
    x, xn = _in(h, rng, (2, 512), "x")
    w = rng.standard_normal((512, 256)).astype(np.float32)
    for bits in (4, 8):
        q = quantize_weight(torch.from_numpy(w), bits=bits, group_size=128)
        qw, sc = _w(h, q.qweight.numpy()), _w(h, q.scales.numpy())
        h.matmul_woq(x, qw, sc, bits=bits, group_size=128)
        h.matmul_woq(x, qw, sc, bits=bits, group_size=128,
                     norm_weight=_w(h, np.ones(512, np.float32)))
    return {"x": xn}


def case_small_cnn(h, rng):
    x, xn = _in(h, rng, (1, 3, 8, 8), "x")
    c = h.conv(x, _w(h, rng.standard_normal((4, 3, 3, 3)).astype(np.float32)),
               bias=_w(h, rng.standard_normal(4).astype(np.float32)),
               pads=(1, 1), strides=(2, 2))
    f = h.flatten(h.relu(c), axis=1)
    h.matmul(f, _w(h, rng.standard_normal((64, 10)).astype(np.float32)))
    return {"x": xn}


def case_straggler(h, rng):
    x, xn = _in(h, rng, (2, 3, 3), "x")
    _op(h, "Det", [x])
    _op(h, "Det", [h.slice(h.reshape(x, (6, 3)), [0], [3], [0])],
        {"mode": 1})
    y, yn = _in(h, rng, (3, 5), "y")
    dy, dyn = _in(h, rng, (3, 5), "dy")
    for name in ("ReluBackward", "SigmoidBackward", "TanhBackward"):
        _op(h, name, [h.sigmoid(y), dy, y])
    _op(h, "EyeLike", [y], {"k": 1})
    h.add(_op(h, "Range", [], {"start": 0, "limit": 5, "delta": 1,
                               "length": 5, "dtype": 1}),
          h.reduce_sum(y, axes=[0], keepdims=0))
    h.add(_op(h, "ConstantOfShape", [], {"shape": [3, 5], "value": 2.5,
                                         "dtype": 1}), y)
    return {"x": xn, "y": yn, "dy": dyn}


CASES = {n[5:]: f for n, f in dict(globals()).items()
         if n.startswith("case_")}
LOOSE_CASES = {"conv", "grouped_conv", "conv_1d_3d", "conv_transpose",
               "im2col_conv", "resize", "norms", "small_cnn", "straggler",
               "matmul_woq"}
