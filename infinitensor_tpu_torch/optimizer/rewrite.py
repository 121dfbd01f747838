"""Deterministic graph rewrites (counterpart of
infinitensor_tpu/optimizer/rewrite.py).

Level 1: cheap always-wins cleanups (identity elimination, dead code).
Level 2+: algebraic rewrites (constant folding, transpose-into-matmul
folding, Conv+Add(bias) fusion, activation fusion into conv). The
search-based optimizer (PET/EinNet analog) lives in optimizer/search.py
and calls these as normal-form steps, mirroring reference
SearchEngine::run's partition + mutate flow
(src/core/search_engine.cc:31-90).

Copy of the JAX package's module; fold_constants evaluates through this
package's lower_op on CPU tensors (the plain versions), where the JAX
module evaluates jax arrays through its own lowering.
"""

from __future__ import annotations

from infinitensor_tpu_torch.core.graph import Graph
from infinitensor_tpu_torch.core.tensor import TensorRole


def optimize_graph(graph: Graph, level: int = 1) -> Graph:
    graph.require_sorted()
    changed = True
    while changed:
        changed = False
        changed |= eliminate_identity(graph)
        changed |= eliminate_dead_ops(graph)
        if level >= 2:
            changed |= fold_constants(graph)
            changed |= fold_transpose_into_matmul(graph)
            changed |= fuse_bias_into_conv(graph)
            changed |= fuse_act_into_conv(graph)
    graph.topo_sort()
    return graph


def fold_constants(graph: Graph, max_elems: int = 1 << 27) -> bool:
    """Evaluate ops whose every input carries constant data (weights or
    previously folded constants) and splice the result in as a weight.

    The ONNX importer folds at import time; this pass folds constants
    CREATED BY REWRITES — e.g. the Concat of sibling weights a searchMerge
    introduces — so the merged graph doesn't re-concatenate its weights on
    every execution. (Reference analog: the merged graph the reference
    mutator emits references a fused weight tensor directly,
    dummy_mutator.cc:26-45.)"""
    import numpy as np
    import torch
    from infinitensor_tpu_torch.core.tensor import TensorRole
    from infinitensor_tpu_torch.ops.lowering import LowerCtx, lower_op
    from infinitensor_tpu_torch.runtime.executor import to_device, to_numpy

    ctx = LowerCtx()
    cpu = torch.device("cpu")
    changed = False
    for op in list(graph.operators):
        if op.op_type in ("RandomNormal", "RandomUniform"):
            continue
        if not op.inputs or any(
                t is None or not t.has_data() or t.source is not None
                for t in op.inputs):
            continue
        if sum(int(np.prod(t.shape)) for t in op.outputs) > max_elems:
            continue
        try:
            outs = lower_op(op, [to_device(t.numpy(), t, cpu)
                                 for t in op.inputs], ctx)
        except Exception:
            continue
        graph.remove_op(op)
        for t, v in zip(op.outputs, outs):
            t.set_data(to_numpy(v))
            if t.role == TensorRole.OTHERS:
                t.role = TensorRole.WEIGHT
        changed = True
    return changed


def _replace_uses(graph: Graph, old, new) -> None:
    """Rewire all consumers of `old` to read `new`; preserve output role."""
    for op in list(old.targets):
        op.inputs = [new if t is old else t for t in op.inputs]
        new.add_target(op)
    old.targets = []
    if old.role == TensorRole.OUTPUT:
        # keep graph output identity: make `new` the output tensor
        if new.role == TensorRole.OTHERS:
            new.role = TensorRole.OUTPUT
            new.name = old.name


def eliminate_identity(graph: Graph) -> bool:
    """Drop Identity / inference-mode Dropout single-output ops."""
    changed = False
    for op in list(graph.operators):
        if op.op_type in ("Identity", "Dropout") and len(op.outputs) == 1:
            src = op.inputs[0]
            dst = op.outputs[0]
            if dst.role == TensorRole.OUTPUT and src.role != TensorRole.OTHERS:
                continue  # can't merge (e.g. input aliased straight to output)
            graph.remove_op(op)
            _replace_uses(graph, dst, src)
            graph.remove_tensor(dst)
            changed = True
    return changed


def eliminate_dead_ops(graph: Graph) -> bool:
    """Remove ops whose outputs nobody consumes and aren't graph outputs."""
    changed = False
    for op in list(reversed(graph.operators)):
        if all(not t.targets and t.role != TensorRole.OUTPUT
               for t in op.outputs):
            graph.remove_op(op)
            for t in op.outputs:
                graph.remove_tensor(t)
            changed = True
    return changed


def fold_transpose_into_matmul(graph: Graph) -> bool:
    """Transpose(last two dims) feeding MatMul -> flip transA/transB
    (the reference reaches the same form via its mutation search)."""
    changed = False
    for op in list(graph.operators):
        if op.op_type != "MatMul":
            continue
        for slot in (0, 1):
            t = op.inputs[slot]
            src = t.source
            if src is None or src.op_type != "Transpose":
                continue
            if len(t.targets) != 1 or t.role == TensorRole.OUTPUT:
                continue
            perm = src.attrs.get("perm")
            rank = src.inputs[0].rank
            want = list(range(rank))
            want[-1], want[-2] = want[-2], want[-1]
            if perm is None:
                perm = list(reversed(range(rank)))
            if list(perm) != want:
                continue
            orig = src.inputs[0]
            graph.remove_op(src)
            graph.remove_tensor(t)
            op.inputs[slot] = orig
            orig.add_target(op)
            key = "transA" if slot == 0 else "transB"
            op.attrs[key] = not op.attrs.get(key, False)
            graph._mutated()
            changed = True
    return changed


def fuse_bias_into_conv(graph: Graph) -> bool:
    """Conv -> Add(bias broadcast over channel) => Conv with fused bias."""
    changed = False
    for op in list(graph.operators):
        if op.op_type != "Conv" or len(op.inputs) != 2:
            continue
        out = op.outputs[0]
        if len(out.targets) != 1 or out.role == TensorRole.OUTPUT:
            continue
        add = out.targets[0]
        if add.op_type != "Add":
            continue
        other = add.inputs[1] if add.inputs[0] is out else add.inputs[0]
        # bias must be [1, C, 1, ...] or [C] constant-shaped broadcast
        c = out.shape[1]
        bshape = tuple(d for d in other.shape if d != 1)
        if bshape != (c,):
            continue
        reshaped = other
        if other.shape != (c,):
            from infinitensor_tpu_torch.core.operator import Operator
            from infinitensor_tpu_torch.core.tensor import TensorObj
            flat = TensorObj((c,), other.dtype, name=other.name + "_flat")
            graph.add_tensor(flat)
            graph.add_op(Operator("Reshape", [other], [flat], {"shape": [c]}))
            reshaped = flat
        op.inputs.append(reshaped)
        reshaped.add_target(op)
        add_out = add.outputs[0]
        graph.remove_op(add)
        # conv now produces what add produced
        op.outputs[0].remove_target(add)
        _replace_uses(graph, add_out, out)
        if add_out.role == TensorRole.OUTPUT:
            out.role = TensorRole.OUTPUT
            out.name = add_out.name
        graph.remove_tensor(add_out)
        graph._mutated()
        changed = True
    return changed


def fuse_act_into_conv(graph: Graph) -> bool:
    """Conv -> Relu/Gelu/Silu => Conv with act attr (epilogue fusion; the
    reference's DummyMutator demonstrates the same Conv+Relu fusion,
    src/core/dummy_mutator.cc:10-45). Folding in the IR keeps graph-level
    cost models honest."""
    changed = False
    for op in list(graph.operators):
        if op.op_type != "Conv" or op.attrs.get("act"):
            continue
        out = op.outputs[0]
        if len(out.targets) != 1 or out.role == TensorRole.OUTPUT:
            continue
        act = out.targets[0]
        if act.op_type not in ("Relu", "Gelu", "Silu"):
            continue
        act_out = act.outputs[0]
        op.attrs["act"] = act.op_type
        graph.remove_op(act)
        _replace_uses(graph, act_out, out)
        if act_out.role == TensorRole.OUTPUT:
            out.role = TensorRole.OUTPUT
            out.name = act_out.name
        graph.remove_tensor(act_out)
        graph._mutated()
        changed = True
    return changed
