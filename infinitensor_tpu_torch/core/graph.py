"""Graph container: operators + tensors, topo sort, shape re-inference.

Mirrors the reference GraphObj (reference include/core/graph.h:10-206,
src/core/graph.cc): Kahn topo-sort (graph.cc:152-182), shape_infer
re-propagation (graph.cc:202-219), clone with Fuid preservation. Memory
planning (dataMalloc/LazyAllocator) is absent at this layer: the executor
(runtime/executor.py) allocates through PyTorch's caching allocator, or a
captured CUDA graph's memory pool.

Copy of infinitensor_tpu/core/graph.py (no jax code); the native topo sort
is this package's binding, native/graph_core.py.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from infinitensor_tpu_torch.core.operator import Operator
from infinitensor_tpu_torch.core.tensor import TensorObj, TensorRole


class Graph:
    def __init__(self, name: str = "graph"):
        self.name = name
        self.operators: list[Operator] = []
        self.tensors: list[TensorObj] = []
        self._sorted = False
        # Capture-state epoch: bumped on any mutation; executor caches key on
        # it (the analog of GraphCaptureStateObj generation/epoch tracking,
        # reference src/core/graph.cc:9-53).
        self.version: int = 0

    # -- construction ------------------------------------------------------
    def add_tensor(self, tensor: TensorObj) -> TensorObj:
        self.tensors.append(tensor)
        self._mutated()
        return tensor

    def add_op(self, op: Operator) -> Operator:
        """Insert op and wire tensor edges (reference graph.cc:106-130)."""
        for t in op.inputs:
            if t is not None:
                t.add_target(op)
        for t in op.outputs:
            if t.source is not None:
                raise ValueError(
                    f"tensor {t.name} already produced by {t.source.name}")
            t.source = op
        self.operators.append(op)
        self._mutated()
        return op

    def remove_op(self, op: Operator) -> None:
        for t in op.inputs:
            if t is not None:
                t.remove_target(op)
        for t in op.outputs:
            t.source = None
        self.operators.remove(op)
        self._mutated()

    def remove_tensor(self, tensor: TensorObj) -> None:
        self.tensors.remove(tensor)
        self._mutated()

    def _mutated(self) -> None:
        self._sorted = False
        self.version += 1

    # -- queries -----------------------------------------------------------
    def inputs(self) -> list[TensorObj]:
        return [t for t in self.tensors if t.role == TensorRole.INPUT]

    def outputs(self) -> list[TensorObj]:
        return [t for t in self.tensors if t.role == TensorRole.OUTPUT]

    def weights(self) -> list[TensorObj]:
        return [t for t in self.tensors if t.role == TensorRole.WEIGHT]

    def tensor_by_name(self, name: str) -> Optional[TensorObj]:
        for t in self.tensors:
            if t.name == name:
                return t
        return None

    def infer_output_roles(self) -> None:
        """Mark tensors nobody consumes as graph outputs (importer helper)."""
        for t in self.tensors:
            if not t.targets and t.source is not None and t.role == TensorRole.OTHERS:
                t.role = TensorRole.OUTPUT

    # -- topological sort (Kahn; reference graph.cc:152-182) ---------------
    #: graphs at least this large route through the native C++ scheduler
    NATIVE_TOPO_THRESHOLD = 64

    def topo_sort(self) -> bool:
        if self._sorted:
            return True
        n = len(self.operators)
        if n >= self.NATIVE_TOPO_THRESHOLD:
            try:
                from infinitensor_tpu_torch.native import graph_core
                order = graph_core.topo_sort(self)
                if order is None:
                    return False  # cycle
                self.operators = order
                self._sorted = True
                return True
            except RuntimeError:
                pass  # native lib unavailable: Python fallback below
        indegree: dict[int, int] = {}
        waiting: dict[int, list[Operator]] = {}
        for op in self.operators:
            preds = {p.guid for p in op.predecessors()}
            indegree[op.guid] = len(preds)
            for p in preds:
                waiting.setdefault(p, []).append(op)
        ready = [op for op in self.operators if indegree[op.guid] == 0]
        order: list[Operator] = []
        while ready:
            op = ready.pop()
            order.append(op)
            for succ in waiting.get(op.guid, ()):  # unique preds counted once
                indegree[succ.guid] -= 1
                if indegree[succ.guid] == 0:
                    ready.append(succ)
        if len(order) != n:
            return False  # cycle
        self.operators = order
        self._sorted = True
        return True

    def require_sorted(self) -> None:
        if not self.topo_sort():
            cyclic = [op.name for op in self.operators]
            raise ValueError(f"graph has a cycle among operators: {cyclic[:10]}")

    # -- shape re-inference (reference graph.cc:202-219) -------------------
    def shape_infer(self) -> None:
        """Re-propagate shapes/dtypes through the graph in topo order.

        Used after ``change_shape`` on an input (dynamic-batch support,
        reference GraphHandlerObj::change_shape + shape_infer).
        """
        from infinitensor_tpu_torch.ops.shape_rules import infer_shapes

        self.require_sorted()
        for op in self.operators:
            specs = infer_shapes(op)
            if len(specs) != len(op.outputs):
                raise ValueError(
                    f"{op.op_type}: inferred {len(specs)} outputs, op has "
                    f"{len(op.outputs)}")
            for t, (shape, dtype) in zip(op.outputs, specs):
                t.shape = tuple(shape)
                t.dtype = dtype

    def change_shape(self, tensor: TensorObj, shape: Iterable[int]) -> None:
        tensor.shape = tuple(int(d) for d in shape)
        self._mutated()

    # -- clone -------------------------------------------------------------
    def clone(self) -> "Graph":
        g = Graph(self.name)
        mapping: dict[int, TensorObj] = {}
        for t in self.tensors:
            nt = TensorObj(t.shape, t.dtype, name=t.name, role=t.role, data=t.data)
            nt.fuid = t.fuid
            mapping[t.guid] = nt
            g.tensors.append(nt)
        for op in self.operators:
            nop = Operator(
                op.op_type,
                [mapping[t.guid] if t is not None else None for t in op.inputs],
                [mapping[t.guid] for t in op.outputs],
                attrs=dict(op.attrs),
                name=op.name,
            )
            for t in nop.inputs:
                if t is not None:
                    t.add_target(nop)
            for t in nop.outputs:
                t.source = nop
            g.operators.append(nop)
        return g

    # -- debug -------------------------------------------------------------
    def __repr__(self) -> str:
        lines = [f"Graph({self.name}: {len(self.operators)} ops, "
                 f"{len(self.tensors)} tensors)"]
        for op in self.operators:
            lines.append("  " + repr(op))
        return "\n".join(lines)

    def stats(self) -> dict:
        from collections import Counter
        return {
            "ops": len(self.operators),
            "tensors": len(self.tensors),
            "op_types": dict(Counter(op.op_type for op in self.operators)),
            "weight_bytes": sum(t.bytes() for t in self.weights()),
            "activation_bytes": sum(
                t.bytes() for t in self.tensors if t.role == TensorRole.OTHERS),
        }
