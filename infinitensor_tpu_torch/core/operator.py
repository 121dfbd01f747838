"""Graph operators.

A single generic ``Operator`` class (op_type string + attrs dict) replaces the
reference's 39 ``<Op>Obj`` C++ subclasses (reference src/operators/*,
include/core/operator.h:9-141). Per-op behavior — validation, shape/dtype
inference, lowering to torch — lives in registries keyed by op_type
(infinitensor_tpu_torch/ops/*): the op set is data, not a class hierarchy.
Copy of infinitensor_tpu/core/operator.py (no jax code).

Op identity for the tuning/compile cache mirrors the reference's
``getOpPerfKey`` (include/core/operator.h:118): a hash over op_type, attrs and
input shapes/dtypes.
"""

from __future__ import annotations

import itertools
from typing import Any, Optional, Sequence

from infinitensor_tpu_torch.core.tensor import TensorObj

_op_guid = itertools.count(1)

# ---------------------------------------------------------------------------
# Op-type taxonomy (reference include/core/op_type.h predicates)
# ---------------------------------------------------------------------------

UNARY_OPS = {
    "Relu", "LeakyRelu", "PRelu", "Elu", "Gelu", "Silu", "Sigmoid",
    "HardSigmoid", "HardSwish", "Tanh", "Erf", "Abs", "Sqrt", "Neg", "Exp",
    "Log", "Reciprocal", "Floor", "Ceil", "Round", "Not", "Softplus", "Sin",
    "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh", "Softsign",
    "Sign", "BitwiseNot",
    # attr-carrying activations (alpha/gamma/lambd read from op.attrs with
    # ONNX defaults); shape/dtype-preserving so they share the unary rule
    "Asinh", "Acosh", "Atanh", "Rsqrt", "Square", "Mish", "Selu", "Celu",
    "ThresholdedRelu", "Shrink", "Hardtanh", "Hardmax",
}
BINARY_OPS = {
    "Add", "Sub", "Mul", "Div", "Pow", "Min", "Max", "Mod",
    "Equal", "Greater", "GreaterOrEqual", "Less", "LessOrEqual",
    "And", "Or", "Xor", "BitwiseAnd", "BitwiseOr", "BitwiseXor",
    "FloorDiv", "FloorMod", "SquaredDifference",
}
COMM_OPS = {
    "AllReduceSum", "AllReduceProd", "AllReduceMin", "AllReduceMax",
    "AllReduceAvg", "AllGather", "Broadcast", "Send", "Recv", "AllToAll",
    "ReduceScatterSum",
}
MATMUL_OR_CONV_OPS = {"MatMul", "Conv", "ConvTranspose", "Gemm", "G2BMM", "GBMM"}


def is_unary(op_type: str) -> bool:
    return op_type in UNARY_OPS


def is_binary(op_type: str) -> bool:
    return op_type in BINARY_OPS


def is_comm(op_type: str) -> bool:
    return op_type in COMM_OPS


def is_matmul_or_conv(op_type: str) -> bool:
    return op_type in MATMUL_OR_CONV_OPS


class Operator:
    __slots__ = ("guid", "op_type", "inputs", "outputs", "attrs", "name")

    def __init__(
        self,
        op_type: str,
        inputs: Sequence[Optional[TensorObj]],
        outputs: Sequence[TensorObj],
        attrs: Optional[dict[str, Any]] = None,
        name: Optional[str] = None,
    ):
        self.guid: int = next(_op_guid)
        self.op_type: str = op_type
        # An input slot may be None for optional ONNX inputs (e.g. Clip min/max).
        self.inputs: list[Optional[TensorObj]] = list(inputs)
        self.outputs: list[TensorObj] = list(outputs)
        self.attrs: dict[str, Any] = dict(attrs or {})
        self.name: str = name or f"{op_type}_{self.guid}"

    # -- graph traversal ---------------------------------------------------
    def predecessors(self) -> list["Operator"]:
        preds = []
        for t in self.inputs:
            if t is not None and t.source is not None:
                preds.append(t.source)
        return preds

    def successors(self) -> list["Operator"]:
        succs = []
        for t in self.outputs:
            succs.extend(t.targets)
        return succs

    def present_inputs(self) -> list[TensorObj]:
        return [t for t in self.inputs if t is not None]

    # -- identity for tuning / compile caches ------------------------------
    def workload_key(self) -> tuple:
        """Analog of getOpPerfKey: hashable identity of the computation."""
        sig_in = tuple(
            (t.shape, t.dtype.onnx_id) if t is not None else None for t in self.inputs
        )
        sig_attr = tuple(sorted((k, _freeze(v)) for k, v in self.attrs.items()))
        return (self.op_type, sig_in, sig_attr)

    def __repr__(self) -> str:
        ins = ", ".join(t.name if t else "·" for t in self.inputs)
        outs = ", ".join(t.name for t in self.outputs)
        return f"{self.op_type}({ins}) -> ({outs})"


def _freeze(v: Any):
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if hasattr(v, "tobytes"):  # numpy array attr (rare)
        return (getattr(v, "shape", None), v.tobytes())
    return v
