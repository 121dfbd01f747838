"""NMutator: expression-derivation-based graph mutator.

The analog of the reference NMutator (reference include/nnet/nmutator.h:7-57,
src/nnet/nmutator.cc): bridges the graph IR and the expression IR — convert
an op to a comprehension (opToExpression), run the Derivator, and lower each
candidate program back to a graph (expressionToGraph): routine-matched stages
become library ops (MatMul), data-movement/DLT stages become MemBound ops
whose "kernel" is the expression evaluator (torch gathers and products,
captured with the graph on the card, replacing the reference's TVM JIT,
src/kernels/cuda/membound_tvm_packed_function.cc).

Every candidate is validated numerically against the evaluator oracle inside
the Derivator before being offered as a mutant (the reference's
Interpreter-check pattern).

Copy of infinitensor_tpu/nnet/nmutator.py (no jax code), bound to this
package's modules, with one addition: ``device`` is the Derivator
oracle's (None: the card, or an error where there is none).
"""

from __future__ import annotations

from typing import Optional

from infinitensor_tpu_torch.core.graph import Graph
from infinitensor_tpu_torch.core.operator import Operator
from infinitensor_tpu_torch.core.tensor import TensorObj
from infinitensor_tpu_torch.nnet.derivation import op_to_expr
from infinitensor_tpu_torch.nnet.derivator import Derivator
from infinitensor_tpu_torch.nnet.rules import Program, Stage
from infinitensor_tpu_torch.optimizer.mutator import Mutator

#: comprehension input names in op-input order (matches op_to_expr naming)
OP_INPUT_NAMES = {
    "Conv": ["X", "W"],
    "MatMul": ["A", "B"],
    "G2BMM": ["A", "B"],
}


class NMutator(Mutator):
    """Rule-guided expression derivation over single ops (the reference's
    Mode::RuleBased runSingleOp path)."""

    def __init__(self, verify: bool = True, max_depth: int = 2,
                 max_candidates: int = 2, device=None):
        self.verify = verify
        self.device = device
        self.max_depth = max_depth
        self.max_candidates = max_candidates

    def run(self, graph: Graph) -> list[Graph]:
        out = []
        for op in list(graph.operators):
            out.extend(self._mutate_op(graph, op))
        return out

    def _mutate_op(self, graph: Graph, op: Operator) -> list[Graph]:
        expr = op_to_expr(op)
        if expr is None or op.op_type not in OP_INPUT_NAMES:
            return []
        derivator = Derivator(max_depth=self.max_depth, verify=self.verify,
                              device=self.device)
        candidates = derivator.derive(Program([Stage("out", expr)]))
        picked = list(candidates[: self.max_candidates])
        # algorithm-substitution candidates (e.g. conv->gemm via the
        # iterator-table match) score behind trivial re-matches on the
        # membound-size metric but are the transforms worth offering —
        # always include the best one
        def has_dlt(c):
            return any(s.routine and s.routine.get("kind") == "MatMulDLT"
                       for s in c.program.stages)
        if not any(has_dlt(c) for c in picked):
            best_dlt = next((c for c in candidates if has_dlt(c)), None)
            if best_dlt is not None:
                picked.append(best_dlt)
        results = []
        for cand in picked:
            if cand.n_routines == 0:
                continue  # pure-membound rewrite: no algorithmic gain
            g = program_to_graph(graph, op, cand.program)
            if g is not None:
                results.append(g)
        return results


def program_to_graph(graph: Graph, op: Operator, program: Program
                     ) -> Optional[Graph]:
    """expressionToGraph (reference nmutator.cc): splice a derived program
    into a clone of the graph in place of ``op``."""
    g = graph.clone()
    target = next((o for o in g.operators if o.name == op.name), None)
    if target is None or len(target.outputs) != 1:
        return None
    names = OP_INPUT_NAMES[op.op_type]
    env = dict(zip(names, target.inputs))
    out = target.outputs[0]
    if program.stages[-1].shape != tuple(out.shape):
        return None
    g.remove_op(target)

    for stage in program.stages:
        is_last = stage is program.stages[-1]
        if is_last:
            result = out
        else:
            result = g.add_tensor(TensorObj(stage.shape, out.dtype))
        routine = stage.routine or {}
        if routine.get("kind") == "MatMul":
            a = env.get(routine["A"].name)
            b = env.get(routine["B"].name)
            if a is None or b is None:
                return None
            g.add_op(Operator("MatMul", [a, b], [result], {
                "transA": int(routine["transA"]),
                "transB": int(routine["transB"]),
            }))
        elif routine.get("kind") == "MatMulDLT":
            # iterator-table match: matmul wrapped in layout transforms
            # (nnet/iterator_table.py), emitted as the Transpose/Reshape
            # ops of the JAX package's mutants
            a = env.get(routine["A"].name)
            b = env.get(routine["B"].name)
            if a is None or b is None:
                return None

            def prod(group):
                r = 1
                for _, e in group:
                    r *= e
                return r

            P, Q, K = (prod(routine["row"]), prod(routine["col"]),
                       prod(routine["k"]))

            def to2d(src, perm, groups, shape2d):
                cur = src
                if perm != list(range(len(perm))):
                    t = g.add_tensor(TensorObj(
                        tuple(cur.shape[p] for p in perm), cur.dtype))
                    g.add_op(Operator("Transpose", [cur], [t],
                                      {"perm": list(perm)}))
                    cur = t
                # range-magnified groups (rule 9) expect zero-padded
                # operands: pad the real tensor up to the group extents
                expect = tuple(e for _, e in groups)
                if tuple(cur.shape) != expect:
                    if len(cur.shape) != len(expect) or any(
                            c > e for c, e in zip(cur.shape, expect)):
                        return None
                    r = len(expect)
                    pads = [0] * r + [e - c
                                      for c, e in zip(cur.shape, expect)]
                    t = g.add_tensor(TensorObj(expect, cur.dtype))
                    g.add_op(Operator("Pad", [cur], [t], {"pads": pads}))
                    cur = t
                if tuple(cur.shape) != shape2d:
                    t2 = g.add_tensor(TensorObj(shape2d, cur.dtype))
                    g.add_op(Operator("Reshape", [cur], [t2],
                                      {"shape": list(shape2d)}))
                    cur = t2
                return cur

            a_groups = routine["row"] + routine["k"]
            b_groups = routine["k"] + routine["col"]
            a2 = to2d(a, routine["a_perm"], a_groups, (P, K))
            b2 = to2d(b, routine["b_perm"], b_groups, (K, Q))
            if a2 is None or b2 is None:
                return None
            rc_shape = tuple(e for _, e in routine["row"]) + \
                tuple(e for _, e in routine["col"])
            out_perm = routine["out_perm"]
            mm = g.add_tensor(TensorObj((P, Q), result.dtype))
            g.add_op(Operator("MatMul", [a2, b2], [mm], {}))
            if out_perm != list(range(len(out_perm))):
                t3 = g.add_tensor(TensorObj(rc_shape, result.dtype))
                g.add_op(Operator("Reshape", [mm], [t3],
                                  {"shape": list(rc_shape)}))
                g.add_op(Operator("Transpose", [t3], [result],
                                  {"perm": list(out_perm)}))
            else:
                g.add_op(Operator("Reshape", [mm], [result],
                                  {"shape": list(result.shape)}))
        elif routine.get("kind") == "Conv":
            x = env.get(routine["X"].name)
            w = env.get(routine["W"].name)
            if x is None or w is None:
                return None
            p = routine["pads"]
            g.add_op(Operator("Conv", [x, w], [result], {
                "strides": list(routine["strides"]),
                "dilations": list(routine["dilations"]),
                "pads": [p[0], p[1], p[0], p[1]],
            }))
        else:
            try:
                inputs = [env[t.name] for t in stage.comp.inputs()]
            except KeyError:
                return None
            g.add_op(Operator("MemBound", inputs, [result], {
                "expr": stage.comp,
                "out_specs": [(stage.shape, out.dtype)],
            }))
        env[stage.name] = result
    g.topo_sort()
    return g
