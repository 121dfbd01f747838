"""ONNX exporter: graph IR -> ModelProto.

Mirrors the reference's ``OnnxStub.to_onnx`` (reference onnx.py:1138-1482):
walks ops in topo order, reconstructs canonical ONNX nodes (shape-carrying
attrs become constant inputs where the ONNX spec demands: Reshape shape,
Slice starts/ends/axes/steps, Squeeze/Unsqueeze axes, Pad pads, Split split),
weights become initializers. Custom ops (RMSNorm/RoPE/AttentionKVCache/comm)
export under the reference's custom domain so round-trips work.

Copy of infinitensor_tpu/onnx/exporter.py over this package's graph IR:
weights are numpy in both IRs, so a graph exports to the same bytes.
"""

from __future__ import annotations

import numpy as np

from infinitensor_tpu_torch.core.graph import Graph
from infinitensor_tpu_torch.core.operator import Operator
from infinitensor_tpu_torch.core.tensor import TensorRole
from infinitensor_tpu_torch.onnx import proto

CUSTOM_DOMAIN_OPS = {
    "RMSNorm", "RoPE", "AttentionKVCache", "AttentionKVCacheQ8",
    "MatMulWOQ", "AllReduceSum", "AllReduceProd",
    "AllReduceMin", "AllReduceMax", "AllReduceAvg", "AllGather", "Broadcast",
    "Send", "Recv", "G2BMM", "GBMM", "MemBound", "ReduceScatterSum",
    "AllToAll",
    # internal ops with no ONNX-standard spelling: exported with attrs
    # verbatim, re-imported by the generic custom importer
    "Extend", "Im2colMatmulConv", "SkipRMSNorm", "ReluBackward",
    "SigmoidBackward", "TanhBackward", "FloorDiv", "FloorMod",
    "SquaredDifference", "Rsqrt", "Square", "Hardtanh",
}


def export_onnx(graph: Graph, name: str = "graph") -> proto.ModelProto:
    graph.require_sorted()
    g = proto.GraphProto(name=name)
    extra_inits: list[proto.TensorProto] = []
    counter = [0]

    def const_input(arr: np.ndarray, hint: str) -> str:
        counter[0] += 1
        nm = f"{hint}_c{counter[0]}"
        extra_inits.append(proto.TensorProto.from_numpy(
            np.ascontiguousarray(arr), nm))
        return nm

    for op in graph.operators:
        node = _export_op(op, const_input)
        g.node.append(node)

    for t in graph.weights():
        arr = t.numpy()
        tp = proto.TensorProto.from_numpy(np.ascontiguousarray(arr), t.name)
        tp.data_type = t.dtype.onnx_id
        g.initializer.append(tp)
    g.initializer.extend(extra_inits)

    for t in graph.inputs():
        g.input.append(proto.ValueInfoProto.make(t.name, t.dtype.onnx_id,
                                                 t.shape))
    outs = graph.outputs()
    if not outs:
        # no tensor explicitly marked OUTPUT (handler-built graphs often
        # skip it): ONNX requires graph outputs, so export the leaves —
        # produced tensors nobody consumes (same rule GraphHandler.run uses)
        outs = [t for t in graph.tensors
                if t.source is not None and not t.targets]
    out_names = {t.name for t in outs}
    for t in outs:
        g.output.append(proto.ValueInfoProto.make(t.name, t.dtype.onnx_id,
                                                  t.shape))
    for t in graph.tensors:
        if t.role == TensorRole.OTHERS and t.source is not None \
                and t.name not in out_names:
            g.value_info.append(
                proto.ValueInfoProto.make(t.name, t.dtype.onnx_id, t.shape))

    model = proto.ModelProto(graph=g)
    model.opset_import = [proto.OperatorSetId(domain="", version=17)]
    if any(n.domain for n in g.node):
        model.opset_import.append(
            proto.OperatorSetId(domain="infini", version=1))
    return model


def _attr_list(attrs: dict, *names) -> list[proto.AttributeProto]:
    out = []
    for n in names:
        v = attrs.get(n)
        if v is not None:
            out.append(proto.AttributeProto.make(n, v))
    return out


def _export_op(op: Operator, const_input) -> proto.NodeProto:
    ins = [t.name if t is not None else "" for t in op.inputs]
    outs = [t.name for t in op.outputs]
    a = op.attrs
    node = proto.NodeProto(input=ins, output=outs, name=op.name,
                           op_type=op.op_type)
    if op.op_type == "MeanN":   # internal name avoids Min/Max-style clash
        node.op_type = "Mean"
    if op.op_type in CUSTOM_DOMAIN_OPS:
        node.domain = "infini"

    t = op.op_type
    if t == "Reshape":
        node.input.append(const_input(
            np.asarray(a["shape"], np.int64), op.name))
    elif t == "Slice":
        node.input.append(const_input(np.asarray(a["starts"], np.int64), op.name))
        node.input.append(const_input(np.asarray(a["ends"], np.int64), op.name))
        if a.get("axes") is not None:
            node.input.append(const_input(np.asarray(a["axes"], np.int64), op.name))
            if a.get("steps") is not None:
                node.input.append(const_input(np.asarray(a["steps"], np.int64), op.name))
    elif t in ("Squeeze", "Unsqueeze"):
        if a.get("axes") is not None:
            node.input.append(const_input(np.asarray(a["axes"], np.int64), op.name))
    elif t == "Pad":
        node.input.append(const_input(np.asarray(a["pads"], np.int64), op.name))
        node.attribute.extend(_attr_list(a, "mode"))
        if a.get("value"):
            node.input.append(const_input(
                np.asarray(a["value"], np.float32), op.name))
    elif t == "Split":
        if a.get("split") is not None:
            node.input.append(const_input(np.asarray(a["split"], np.int64), op.name))
        node.attribute.extend(_attr_list(a, "axis"))
    elif t == "Resize":
        # emit sizes input (roi/scales empty)
        node.input.append("")
        node.input.append("")
        node.input.append(const_input(np.asarray(a["out_shape"], np.int64), op.name))
        node.attribute.extend(_attr_list(a, "mode"))
    elif t == "Expand":
        node.input.append(const_input(np.asarray(a["shape"], np.int64), op.name))
    elif t == "Tile":
        node.input.append(const_input(np.asarray(a["repeats"], np.int64), op.name))
    elif t == "Clip":
        if a.get("min") is not None:
            node.input.append(const_input(np.float32(a["min"]), op.name))
        if a.get("max") is not None:
            if a.get("min") is None:
                node.input.append("")
            node.input.append(const_input(np.float32(a["max"]), op.name))
    elif t == "MatMul":
        # ONNX MatMul has no transpose attrs; re-materialize transposes.
        # (They only arise from optimizer rewrites.)
        if a.get("transA") or a.get("transB"):
            node.domain = "infini"
            node.attribute.extend(_attr_list(a, "transA", "transB"))
    elif t == "Cast":
        node.attribute.append(proto.AttributeProto.make("to", int(a["to"])))
    elif t == "Recv":
        node.attribute.append(
            proto.AttributeProto.make("dataType", int(a["dtype"])))
        node.attribute.extend(_attr_list(a, "source", "destination", "shape"))
    else:
        skip = {"out_specs", "expr", "act", "num_outputs", "compute_type"}
        for k, v in a.items():
            if v is None or k in skip:
                continue
            node.attribute.append(proto.AttributeProto.make(k, v))
    return node
