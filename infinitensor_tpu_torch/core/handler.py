"""GraphHandler: procedural graph-building façade.

One method per op, mirroring the reference GraphHandlerObj API surface
(reference include/core/graph_handler.h:15-159, src/core/graph_handler.cc):
each call validates inputs, runs shape/dtype inference, creates the output
tensor(s), and wires the op into the graph. ``run``/``tune``/``get_perf_time``
forward to the executor (runtime/executor.py): eager per-op dispatch on the
CPU, and on the card one captured CUDA graph per input signature, in an LRU
(the reference's CUDA-Graph replay cache).

Copy of infinitensor_tpu/core/handler.py, but the executor runs on the
handler's runtime's device when it has one (GraphHandler(runtime=
cpu_runtime()) runs on the CPU), else on the card.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Union

import numpy as np

from infinitensor_tpu_torch.core import dtype as dt
from infinitensor_tpu_torch.core.dtype import DataType
from infinitensor_tpu_torch.core.graph import Graph
from infinitensor_tpu_torch.core.operator import Operator
from infinitensor_tpu_torch.core.tensor import TensorObj, TensorRole
from infinitensor_tpu_torch.ops.shape_rules import infer_shapes

DTypeLike = Union[DataType, int, str]


def _as_dtype(d: DTypeLike) -> DataType:
    if isinstance(d, DataType):
        return d
    if isinstance(d, int):
        return DataType.from_onnx(d)
    return DataType.from_name(d)


class GraphHandler:
    def __init__(self, runtime=None, name: str = "graph"):
        self.graph = Graph(name)
        self.runtime = runtime
        self._executor = None

    # ------------------------------------------------------------------
    # tensor creation
    # ------------------------------------------------------------------
    def tensor(self, shape: Sequence[int], dtype: DTypeLike = dt.FLOAT32,
               name: Optional[str] = None,
               role: TensorRole = TensorRole.OTHERS) -> TensorObj:
        t = TensorObj(shape, _as_dtype(dtype), name=name, role=role)
        return self.graph.add_tensor(t)

    def input(self, shape, dtype: DTypeLike = dt.FLOAT32, name=None):
        return self.tensor(shape, dtype, name, TensorRole.INPUT)

    def weight(self, data: np.ndarray, name=None, dtype: Optional[DTypeLike] = None):
        d = _as_dtype(dtype) if dtype is not None else DataType.from_numpy(data.dtype)
        t = self.tensor(data.shape, d, name, TensorRole.WEIGHT)
        t.set_data(np.asarray(data))
        return t

    def weight_placeholder(self, shape, dtype: DTypeLike, name=None):
        """WEIGHT tensor with no host data: the value is supplied later via
        GraphExecutor.set_weight (typically an on-device array — avoids
        hauling large weights through host memory; the reference reaches
        the same with Tensor::setDataBlob on device blobs,
        include/core/tensor.h:20-163)."""
        return self.tensor(tuple(shape), _as_dtype(dtype), name,
                           TensorRole.WEIGHT)

    # ------------------------------------------------------------------
    # generic op insertion
    # ------------------------------------------------------------------
    def _add(self, op_type: str, inputs: Sequence[Optional[TensorObj]],
             attrs: Optional[dict] = None,
             outputs: Optional[Sequence[Optional[TensorObj]]] = None,
             n_outputs: Optional[int] = None, name: Optional[str] = None):
        probe = Operator(op_type, inputs, [], attrs, name=name)
        if n_outputs is not None and "num_outputs" not in probe.attrs:
            probe.attrs.setdefault("num_outputs", n_outputs)
        if outputs:
            probe.outputs = [o for o in outputs if o is not None]
        specs = infer_shapes(probe)
        outs: list[TensorObj] = []
        for i, (shape, dtype) in enumerate(specs):
            given = outputs[i] if outputs and i < len(outputs) else None
            if given is not None:
                # Reference behavior: caller-specified output tensor must match
                # the inferred spec (checkValid).
                if tuple(given.shape) != tuple(shape) or given.dtype != dtype:
                    raise ValueError(
                        f"{op_type}: declared output {given} mismatches "
                        f"inferred ({shape}, {dtype})")
                outs.append(given)
            else:
                outs.append(self.tensor(shape, dtype))
        op = Operator(op_type, inputs, outs, probe.attrs, name=name)
        self.graph.add_op(op)
        return outs if len(outs) != 1 else outs[0]

    # ------------------------------------------------------------------
    # op methods (reference include/core/graph_handler.h parity)
    # ------------------------------------------------------------------
    def conv(self, x, w, bias=None, pads=(0, 0), strides=(1, 1),
             dilations=(1, 1), group=1, output=None):
        nsp = len(x.shape) - 2
        pads = list(pads)
        if len(pads) == nsp:
            pads = pads + pads
        return self._add("Conv", [x, w] + ([bias] if bias is not None else []),
                         {"pads": pads, "strides": list(strides),
                          "dilations": list(dilations), "group": group},
                         outputs=[output])

    def conv_transpose(self, x, w, bias=None, pads=(0, 0), strides=(1, 1),
                       dilations=(1, 1), output_padding=(0, 0), group=1,
                       output=None):
        nsp = len(x.shape) - 2
        pads = list(pads)
        if len(pads) == nsp:
            pads = pads + pads
        ins = [x, w] + ([bias] if bias is not None else [])
        return self._add("ConvTranspose", ins,
                         {"pads": pads, "strides": list(strides),
                          "dilations": list(dilations),
                          "output_padding": list(output_padding),
                          "group": group}, outputs=[output])

    def matmul(self, a, b, trans_a=False, trans_b=False, output=None,
               compute_type: Optional[str] = None):
        attrs = {"transA": trans_a, "transB": trans_b}
        if compute_type:
            attrs["compute_type"] = compute_type
        return self._add("MatMul", [a, b], attrs, outputs=[output])

    def gemm(self, a, b, c=None, alpha=1.0, beta=1.0, trans_a=False,
             trans_b=False, output=None):
        return self._add("Gemm", [a, b] + ([c] if c is not None else []),
                         {"alpha": alpha, "beta": beta, "transA": trans_a,
                          "transB": trans_b}, outputs=[output])

    def batch_normalization(self, x, scale, bias, mean, var, epsilon=1e-5,
                            output=None):
        return self._add("BatchNormalization", [x, scale, bias, mean, var],
                         {"epsilon": epsilon}, outputs=[output])

    def layer_normalization(self, x, scale, bias=None, axis=-1, epsilon=1e-5,
                            output=None):
        ins = [x, scale] + ([bias] if bias is not None else [])
        return self._add("LayerNormalization", ins,
                         {"axis": axis, "epsilon": epsilon}, outputs=[output])

    def instance_normalization(self, x, scale, bias, epsilon=1e-5, output=None):
        return self._add("InstanceNormalization", [x, scale, bias],
                         {"epsilon": epsilon}, outputs=[output])

    def rms_norm(self, x, weight, epsilon=1e-6, output=None):
        return self._add("RMSNorm", [x, weight], {"epsilon": epsilon},
                         outputs=[output])

    def lrn(self, x, alpha=1e-4, beta=0.75, bias=1.0, size=1, output=None):
        return self._add("LRN", [x], {"alpha": alpha, "beta": beta,
                                      "bias": bias, "size": size},
                         outputs=[output])

    def max_pool(self, x, kernel, strides=None, pads=None, dilations=None,
                 ceil_mode=0, output=None):
        return self._pool("MaxPool", x, kernel, strides, pads, dilations,
                          ceil_mode, output)

    def avg_pool(self, x, kernel, strides=None, pads=None, dilations=None,
                 ceil_mode=0, count_include_pad=0, output=None):
        return self._pool("AveragePool", x, kernel, strides, pads, dilations,
                          ceil_mode, output, count_include_pad)

    def _pool(self, kind, x, kernel, strides, pads, dilations, ceil_mode,
              output, count_include_pad=None):
        nsp = len(x.shape) - 2
        attrs = {
            "kernel_shape": list(kernel),
            "strides": list(strides or [1] * nsp),
            "pads": list(pads or [0] * (2 * nsp)),
            "ceil_mode": ceil_mode,
        }
        if len(attrs["pads"]) == nsp:
            attrs["pads"] = attrs["pads"] + attrs["pads"]
        if dilations is not None:
            attrs["dilations"] = list(dilations)
        if count_include_pad is not None:
            attrs["count_include_pad"] = count_include_pad
        return self._add(kind, [x], attrs, outputs=[output])

    def global_avg_pool(self, x, output=None):
        return self._add("GlobalAveragePool", [x], {}, outputs=[output])

    # elementwise binary / unary -----------------------------------------
    def _binary(self, kind, a, b, output=None):
        return self._add(kind, [a, b], {}, outputs=[output])

    def add(self, a, b, output=None): return self._binary("Add", a, b, output)
    def sub(self, a, b, output=None): return self._binary("Sub", a, b, output)
    def mul(self, a, b, output=None): return self._binary("Mul", a, b, output)
    def div(self, a, b, output=None): return self._binary("Div", a, b, output)
    def pow(self, a, b, output=None): return self._binary("Pow", a, b, output)
    def min(self, a, b, output=None): return self._binary("Min", a, b, output)
    def max(self, a, b, output=None): return self._binary("Max", a, b, output)

    def _unary(self, kind, x, output=None, **attrs):
        return self._add(kind, [x], attrs, outputs=[output])

    def relu(self, x, output=None): return self._unary("Relu", x, output)
    def silu(self, x, output=None): return self._unary("Silu", x, output)
    def gelu(self, x, output=None): return self._unary("Gelu", x, output)
    def sigmoid(self, x, output=None): return self._unary("Sigmoid", x, output)
    def tanh(self, x, output=None): return self._unary("Tanh", x, output)
    def erf(self, x, output=None): return self._unary("Erf", x, output)
    def abs(self, x, output=None): return self._unary("Abs", x, output)
    def sqrt(self, x, output=None): return self._unary("Sqrt", x, output)
    def neg(self, x, output=None): return self._unary("Neg", x, output)
    def exp(self, x, output=None): return self._unary("Exp", x, output)
    def log(self, x, output=None): return self._unary("Log", x, output)

    def leaky_relu(self, x, alpha=0.01, output=None):
        return self._unary("LeakyRelu", x, output, alpha=alpha)

    def elu(self, x, alpha=1.0, output=None):
        return self._unary("Elu", x, output, alpha=alpha)

    def hard_sigmoid(self, x, output=None):
        return self._unary("HardSigmoid", x, output)

    def hard_swish(self, x, output=None):
        return self._unary("HardSwish", x, output)

    def p_relu(self, x, slope, output=None):
        return self._add("PRelu", [x, slope], {}, outputs=[output])

    def clip(self, x, min=None, max=None, output=None):
        attrs = {}
        if min is not None:
            attrs["min"] = float(min)
        if max is not None:
            attrs["max"] = float(max)
        return self._add("Clip", [x], attrs, outputs=[output])

    def softmax(self, x, axis=-1, output=None):
        return self._add("Softmax", [x], {"axis": axis}, outputs=[output])

    # shape ops ----------------------------------------------------------
    def shape(self, x, output=None):
        return self._add("Shape", [x], {}, outputs=[output])

    def identity(self, x, output=None):
        return self._add("Identity", [x], {}, outputs=[output])

    def flatten(self, x, axis=1, output=None):
        return self._add("Flatten", [x], {"axis": axis}, outputs=[output])

    def reshape(self, x, shape: Iterable[int], output=None):
        return self._add("Reshape", [x], {"shape": list(shape)},
                         outputs=[output])

    def transpose(self, x, perm=None, output=None):
        return self._add("Transpose", [x], {"perm": list(perm) if perm else None},
                         outputs=[output])

    def squeeze(self, x, axes=None, output=None):
        return self._add("Squeeze", [x],
                         {"axes": list(axes) if axes is not None else None},
                         outputs=[output])

    def unsqueeze(self, x, axes, output=None):
        return self._add("Unsqueeze", [x], {"axes": list(axes)},
                         outputs=[output])

    def concat(self, xs: Sequence[TensorObj], axis, output=None):
        return self._add("Concat", list(xs), {"axis": axis}, outputs=[output])

    def split(self, x, axis, num_or_sizes, outputs=None):
        attrs = {"axis": axis}
        if isinstance(num_or_sizes, int):
            attrs["num_outputs"] = num_or_sizes
        else:
            attrs["split"] = list(num_or_sizes)
        out = self._add("Split", [x], attrs, outputs=outputs)
        return out if isinstance(out, list) else [out]

    def slice(self, x, starts, ends, axes=None, steps=None, output=None):
        return self._add("Slice", [x], {
            "starts": list(starts), "ends": list(ends),
            "axes": list(axes) if axes is not None else None,
            "steps": list(steps) if steps is not None else None,
        }, outputs=[output])

    def pad(self, x, pads, mode="constant", value=0.0, output=None):
        return self._add("Pad", [x], {"pads": list(pads), "mode": mode,
                                      "value": value}, outputs=[output])

    def resize(self, x, out_shape, mode="nearest", output=None):
        return self._add("Resize", [x], {"out_shape": list(out_shape),
                                         "mode": mode}, outputs=[output])

    def expand(self, x, shape, output=None):
        return self._add("Expand", [x], {"shape": list(shape)},
                         outputs=[output])

    def tile(self, x, repeats, output=None):
        return self._add("Tile", [x], {"repeats": list(repeats)},
                         outputs=[output])

    def cast(self, x, to: DTypeLike, output=None):
        return self._add("Cast", [x], {"to": _as_dtype(to).onnx_id},
                         outputs=[output])

    def where(self, condition, x, y, output=None):
        return self._add("Where", [condition, x, y], {}, outputs=[output])

    def gather(self, data, indices, axis=0, output=None):
        return self._add("Gather", [data, indices], {"axis": axis},
                         outputs=[output])

    def gather_elements(self, data, indices, axis=0, output=None):
        return self._add("GatherElements", [data, indices], {"axis": axis},
                         outputs=[output])

    def reduce_mean(self, x, axes=None, keepdims=1, output=None):
        return self._add("ReduceMean", [x],
                         {"axes": list(axes) if axes is not None else None,
                          "keepdims": keepdims}, outputs=[output])

    def reduce_sum(self, x, axes=None, keepdims=1, output=None):
        return self._add("ReduceSum", [x],
                         {"axes": list(axes) if axes is not None else None,
                          "keepdims": keepdims}, outputs=[output])

    def depth_to_space(self, x, blocksize, mode="DCR", output=None):
        return self._add("DepthToSpace", [x], {"blocksize": blocksize,
                                               "mode": mode}, outputs=[output])

    def dropout(self, x, output=None):
        return self._add("Dropout", [x], {}, outputs=[output])

    # LLM ops ------------------------------------------------------------
    def attention_kvcache(self, k_cache, v_cache, q, k, v, position_id,
                          output=None, functional_cache=True):
        """6-input fused decode attention (reference graph_handler.h:89-91).

        functional_cache=True adds the updated caches as outputs 1 and 2
        (TPU-native form; the executor aliases them onto the inputs).
        """
        n_out = 3 if functional_cache else 1
        ins = [k_cache, v_cache, q, k, v, position_id]
        probe = Operator("AttentionKVCache", ins,
                         [TensorObj((1,), dt.FLOAT32) for _ in range(n_out)], {})
        specs = infer_shapes(probe)
        created = []
        for i, (shape, dtype) in enumerate(specs):
            if i == 0 and output is not None:
                created.append(output)
            else:
                created.append(self.tensor(shape, dtype))
        self.graph.add_op(Operator("AttentionKVCache", ins, created, {}))
        return created if n_out > 1 else created[0]

    def attention_kvcache_q8(self, k_cache, v_cache, k_scale, v_scale,
                             q, k, v, position_id):
        """INT8-KV-cache fused decode attention, GQA-capable (TPU-native
        extension of attention_kvcache; see ops/shape_rules.py). Returns
        [attn_out, k_cache', v_cache', k_scale', v_scale']."""
        return self._add("AttentionKVCacheQ8",
                         [k_cache, v_cache, k_scale, v_scale, q, k, v,
                          position_id], {})

    def matmul_woq(self, x, qweight, scales, bits, group_size,
                   norm_weight=None, eps=1e-5, out_logical=0, output=None):
        """Weight-only-quantized matmul (int8 / packed int4 weight +
        per-group scales); norm_weight fuses an input RMSNorm into the
        kernel. See ops/shape_rules.py MatMulWOQ."""
        ins = [x, qweight, scales] + \
            ([norm_weight] if norm_weight is not None else [])
        attrs = {"bits": int(bits), "group_size": int(group_size),
                 "out_logical": int(out_logical), "eps": float(eps)}
        if int(bits) == 4:
            # stamp the packed-byte layout so serialized graphs from an
            # older packing fail loudly at import (quant/weight_only.py)
            from infinitensor_tpu_torch.quant.weight_only import INT4_PACK_VERSION
            attrs["pack_version"] = INT4_PACK_VERSION
        return self._add("MatMulWOQ", ins, attrs, outputs=[output])

    def rope(self, pos, x, dim_head=64, theta=10000.0, output=None):
        return self._add("RoPE", [pos, x], {"dim_head": dim_head,
                                            "theta": float(theta)},
                         outputs=[output])

    def g2bmm(self, a, b, width, dilation=1, output=None):
        return self._add("G2BMM", [a, b], {"width": width,
                                           "dilation": dilation},
                         outputs=[output])

    def gbmm(self, a, b, dilation=1, output=None):
        return self._add("GBMM", [a, b], {"dilation": dilation},
                         outputs=[output])

    # quantization -------------------------------------------------------
    def quantize_linear(self, x, scale, zero_point=None, axis=1, output=None):
        ins = [x, scale] + ([zero_point] if zero_point is not None else [])
        return self._add("QuantizeLinear", ins, {"axis": axis},
                         outputs=[output])

    def dequantize_linear(self, x, scale, zero_point=None, axis=1, output=None):
        ins = [x, scale] + ([zero_point] if zero_point is not None else [])
        return self._add("DequantizeLinear", ins, {"axis": axis},
                         outputs=[output])

    # collectives --------------------------------------------------------
    def all_reduce_sum(self, x, output=None):
        return self._add("AllReduceSum", [x], {}, outputs=[output])

    def all_reduce_prod(self, x, output=None):
        return self._add("AllReduceProd", [x], {}, outputs=[output])

    def all_reduce_min(self, x, output=None):
        return self._add("AllReduceMin", [x], {}, outputs=[output])

    def all_reduce_max(self, x, output=None):
        return self._add("AllReduceMax", [x], {}, outputs=[output])

    def all_reduce_avg(self, x, output=None):
        return self._add("AllReduceAvg", [x], {}, outputs=[output])

    def all_gather(self, x, world_size, outputs=None):
        out = self._add("AllGather", [x], {"world_size": world_size},
                        outputs=outputs)
        return out if isinstance(out, list) else [out]

    def broadcast(self, x, root=0, output=None):
        return self._add("Broadcast", [x], {"root": root}, outputs=[output])

    def send(self, x, source, destination, output=None):
        return self._add("Send", [x], {"source": source,
                                       "destination": destination},
                         outputs=[output])

    def recv(self, source, destination, shape, dtype: DTypeLike, output=None):
        return self._add("Recv", [], {"source": source,
                                      "destination": destination,
                                      "shape": list(shape),
                                      "dtype": _as_dtype(dtype).onnx_id},
                         outputs=[output])

    # ------------------------------------------------------------------
    # graph-level (reference graph_handler.h:129-159)
    # ------------------------------------------------------------------
    def topo_sort(self) -> bool:
        return self.graph.topo_sort()

    def shape_infer(self) -> None:
        self.graph.shape_infer()

    def change_shape(self, tensor: TensorObj, shape) -> None:
        self.graph.change_shape(tensor, shape)
        self._executor = None

    def optimize(self, level: int = 1) -> None:
        from infinitensor_tpu_torch.optimizer.rewrite import optimize_graph
        self.graph = optimize_graph(self.graph, level=level)
        self._executor = None

    def data_malloc(self) -> None:
        # The executor allocates each op's outputs with the caching
        # allocator (or a captured graph's private pool); kept for API
        # parity (no-op beyond marking outputs).
        self.graph.infer_output_roles()

    def executor(self, **kwargs):
        from infinitensor_tpu_torch.runtime.executor import GraphExecutor
        if self._executor is None:
            self.graph.infer_output_roles()
            if self.runtime is not None:
                kwargs.setdefault("device", self.runtime.device)
            self._executor = GraphExecutor(self.graph, **kwargs)
        return self._executor

    def run(self, inputs: Optional[dict] = None, **kwargs) -> dict:
        return self.executor().run(inputs or {}, **kwargs)

    def get_perf_time(self) -> float:
        return self.executor().time_ms()
