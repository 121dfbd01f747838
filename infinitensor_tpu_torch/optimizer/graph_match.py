"""Subgraph pattern matching and replacement.

Mirrors the reference SubGraphRewriter (reference include/core/graph_match.h:
5-107, src/core/graph_match.cc): a pattern is itself a small Graph with
designated boundary inputs/outputs; matches are found by anchored DFS over
op types + attrs, checked for overlap, and replaced by splicing a
replacement subgraph onto the matched boundary tensors.

Copy of infinitensor_tpu/optimizer/graph_match.py (no jax code).
"""

from __future__ import annotations

from typing import Callable, Optional

from infinitensor_tpu_torch.core.graph import Graph
from infinitensor_tpu_torch.core.operator import Operator
from infinitensor_tpu_torch.core.tensor import TensorObj, TensorRole


class Match:
    """Mapping from pattern ops/tensors to graph ops/tensors."""

    def __init__(self):
        self.op_map: dict[int, Operator] = {}      # pattern op guid -> graph op
        self.tensor_map: dict[int, TensorObj] = {}

    def ops(self) -> list[Operator]:
        return list(self.op_map.values())


def _attrs_match(pattern_op: Operator, op: Operator) -> bool:
    for k, v in pattern_op.attrs.items():
        if v is None:
            continue
        if op.attrs.get(k) != v:
            return False
    return True


class SubGraphRewriter:
    def __init__(self, graph: Graph):
        self.graph = graph

    # -- matching ----------------------------------------------------------
    def find_matches(self, pattern: Graph,
                     extra_check: Optional[Callable[[Match], bool]] = None
                     ) -> list[Match]:
        pattern.require_sorted()
        self.graph.require_sorted()
        if not pattern.operators:
            return []
        anchor = pattern.operators[0]
        matches = []
        used_ops: set[int] = set()   # overlap check (graph_match.cc)
        for op in self.graph.operators:
            if op.op_type != anchor.op_type:
                continue
            m = Match()
            if self._try_match(pattern, anchor, op, m) and \
                    not (set(o.guid for o in m.ops()) & used_ops):
                if extra_check is None or extra_check(m):
                    matches.append(m)
                    used_ops.update(o.guid for o in m.ops())
        return matches

    def _try_match(self, pattern: Graph, p_op: Operator, g_op: Operator,
                   m: Match) -> bool:
        if p_op.guid in m.op_map:
            return m.op_map[p_op.guid] is g_op
        if p_op.op_type != g_op.op_type or not _attrs_match(p_op, g_op):
            return False
        if len(p_op.present_inputs()) != len(g_op.present_inputs()) or \
                len(p_op.outputs) != len(g_op.outputs):
            return False
        m.op_map[p_op.guid] = g_op
        for pt, gt in zip(p_op.inputs, g_op.inputs):
            if pt is None:
                continue
            if pt.guid in m.tensor_map and m.tensor_map[pt.guid] is not gt:
                return False
            m.tensor_map[pt.guid] = gt
            if pt.source is not None:  # interior edge: producer must match
                if gt.source is None or \
                        not self._try_match(pattern, pt.source, gt.source, m):
                    return False
        for pt, gt in zip(p_op.outputs, g_op.outputs):
            if pt.guid in m.tensor_map and m.tensor_map[pt.guid] is not gt:
                return False
            m.tensor_map[pt.guid] = gt
            # interior output consumed inside the pattern: consumers match
            if pt.targets:
                if len(pt.targets) > len(gt.targets):
                    return False
                for p_cons in pt.targets:
                    matched = False
                    for g_cons in gt.targets:
                        if g_cons.op_type != p_cons.op_type:
                            continue
                        snap = (dict(m.op_map), dict(m.tensor_map))
                        if self._try_match(pattern, p_cons, g_cons, m):
                            matched = True
                            break
                        m.op_map, m.tensor_map = snap
                    if not matched:
                        return False
        return True

    # -- replacement -------------------------------------------------------
    def replace(self, match: Match, pattern: Graph,
                build: Callable[..., TensorObj | list[TensorObj]],
                pattern_inputs: list[TensorObj],
                pattern_outputs: list[TensorObj]) -> None:
        """Replace a matched region. `build(handler_graph, *mapped_inputs)`
        must create replacement ops in self.graph and return tensors
        standing for each pattern output."""
        g = self.graph
        mapped_in = [match.tensor_map[t.guid] for t in pattern_inputs]
        mapped_out = [match.tensor_map[t.guid] for t in pattern_outputs]
        # remove matched ops
        for op in match.ops():
            g.remove_op(op)
        new_outs = build(g, *mapped_in)
        if isinstance(new_outs, TensorObj):
            new_outs = [new_outs]
        for old, new in zip(mapped_out, new_outs):
            for cons in list(old.targets):
                cons.inputs = [new if x is old else x for x in cons.inputs]
                old.remove_target(cons)
                new.add_target(cons)
            if old.role == TensorRole.OUTPUT:
                new.role = TensorRole.OUTPUT
                old.role = TensorRole.OTHERS
                new.name, old.name = old.name, old.name + "_replaced"
            if old in g.tensors and not old.targets and old.source is None:
                g.remove_tensor(old)
        g.topo_sort()
