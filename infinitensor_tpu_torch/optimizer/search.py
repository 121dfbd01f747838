"""PET-style search engine over graph partitions (counterpart of
infinitensor_tpu/optimizer/search.py).

Mirrors the reference SearchEngine (reference include/core/search_engine.h:
10-79, src/core/search_engine.cc:31-90): partition the graph at high-degree
nodes, enumerate mutants of each partition (Mutator), keep a beam of the best
candidates scored by a cost model, and stitch the winners back together.

Cost model: cached per-op timings from PerfEngine (reference getPerfTime),
timed on demand by running each candidate partition's ops one by one on
`device` (GraphExecutor.profile: on the card each op captured in a CUDA
graph on cold copies of its inputs, so the host's launch cost stays out),
the per-op sum the reference uses. Op keys carry no device, so a search
for the card takes a PerfEngine that no CPU timing filled.

A candidate the lowering refuses (utils/errors.py Refused: an op type,
attribute or launch it does not offer) scores inf. Any other error
propagates: a kernel that fails to build or launch (RuntimeError), and a
wrapper's shape check (ValueError), which the JAX package's search would
score inf. The band lowerings only launch at shapes band_kernels_usable
passes, so such a ValueError is a bug, and a band candidate cannot lose
quietly to the dense form. ``history`` keeps every
scored candidate and variant (op-type counts and cost).
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

from infinitensor_tpu_torch.core.graph import Graph
from infinitensor_tpu_torch.core.operator import Operator
from infinitensor_tpu_torch.core.tensor import TensorObj, TensorRole
from infinitensor_tpu_torch.optimizer.mutator import Mutator, RuleBasedMutator
from infinitensor_tpu_torch.utils.errors import Refused
from infinitensor_tpu_torch.runtime.perf import PerfEngine
from infinitensor_tpu_torch.utils.logging import get_logger
from infinitensor_tpu_torch.utils.platform import resolve_device

BEAM_SIZE = 16   # reference GRAPH_SIZE

_log = get_logger("search")


class SearchEngine:
    def __init__(self, mutator: Optional[Mutator] = None,
                 perf: Optional[PerfEngine] = None,
                 beam_size: int = BEAM_SIZE, device=None):
        self.mutator = mutator or RuleBasedMutator()
        # `is None`, not `or`: an empty engine is falsy (__len__), and a
        # fresh one must not be swapped for the process singleton
        self.perf = PerfEngine.instance() if perf is None else perf
        self.beam = beam_size
        self.device = resolve_device(device)
        self.history: list[dict] = []

    # ------------------------------------------------------------------
    def run(self, graph: Graph) -> Graph:
        """Full search: horizontal multi-branch merge variants (reference
        searchMerge, search_engine.cc:206-316) x per-partition mutation
        beam, winner picked by the perf-cache cost model."""
        graph.require_sorted()
        from infinitensor_tpu_torch.optimizer.merge import search_merge
        variants = [graph] + search_merge(graph)
        _log.info("search_start", ops=len(graph.operators),
                  merge_variants=len(variants) - 1)
        # the original graph is the fallback winner: if every variant
        # scores inf (profiling failed), return it unchanged instead of
        # crashing on best=None
        best, best_cost = graph, float("inf")
        for i, variant in enumerate(variants):
            out = self._run_partitions(variant)
            cost = self._score(out)
            self.history.append({"kind": "variant", "index": i,
                                 "cost_ms": cost, "ops": _op_counts(out)})
            _log.info("variant_scored", variant=i, cost_ms=round(cost, 4),
                      ops=len(out.operators))
            if cost < best_cost:
                best, best_cost = out, cost
        _log.info("search_done", best_cost_ms=round(best_cost, 4),
                  ops=len(best.operators))
        return best

    def _run_partitions(self, graph: Graph) -> Graph:
        graph.require_sorted()
        partitions = self.partition(graph)
        best_ops: list[Operator] = []
        for part in partitions:
            if not self._mutable(part):
                best_ops.extend(part)
                continue
            sub = _extract_subgraph(graph, part)
            candidates = [sub] + self.mutator.run(sub)
            costs = {id(c): self._score(c) for c in candidates}
            for c in candidates:
                self.history.append({"kind": "candidate",
                                     "cost_ms": costs[id(c)],
                                     "ops": _op_counts(c)})
            scored = sorted(candidates, key=lambda c: costs[id(c)])[
                : self.beam]
            winner = scored[0]
            best_ops.append(("sub", winner, part))
        return _stitch(graph, best_ops)

    def _mutable(self, part: list[Operator]) -> bool:
        return any(op.op_type in ("Conv", "MatMul", "Gemm") for op in part)

    # ------------------------------------------------------------------
    # partitioning (reference partitionGraph: cut at nodes with >=3 edges)
    # ------------------------------------------------------------------
    def partition(self, graph: Graph) -> list[list[Operator]]:
        parts: list[list[Operator]] = []
        cur: list[Operator] = []
        for op in graph.operators:
            degree = len(op.predecessors()) + len(op.successors())
            if degree >= 3 and cur:
                parts.append(cur)
                cur = []
            cur.append(op)
            if degree >= 3:
                parts.append(cur)
                cur = []
        if cur:
            parts.append(cur)
        return parts

    # ------------------------------------------------------------------
    # cost model
    # ------------------------------------------------------------------
    def _score(self, sub: Graph) -> float:
        total = 0.0
        missing = []
        for op in sub.operators:
            t = self.perf.get(op.workload_key())
            if t is None:
                missing.append(op)
            else:
                total += t
        if missing:
            from infinitensor_tpu_torch.runtime.executor import GraphExecutor
            try:
                ex = GraphExecutor(sub, device=self.device)
                ex.profile(perf_engine=self.perf)
            except Refused as e:
                _log.info("candidate_refused", error=repr(e))
                return float("inf")
            del ex              # free the candidate's tensors
            total = sum(self.perf.get(op.workload_key(), 0.0)
                        for op in sub.operators)
        return total


def _op_counts(graph: Graph) -> dict:
    return dict(Counter(op.op_type for op in graph.operators))


def _extract_subgraph(graph: Graph, part: list[Operator]) -> Graph:
    """Clone a partition into a standalone graph with boundary tensors as
    inputs (weights keep data)."""
    sub = Graph(f"{graph.name}_part")
    part_set = {op.guid for op in part}
    tmap: dict[int, TensorObj] = {}

    def map_tensor(t: TensorObj) -> TensorObj:
        if t.guid in tmap:
            return tmap[t.guid]
        nt = TensorObj(t.shape, t.dtype, name=t.name, role=t.role,
                       data=t.data)
        if (t.source is None or t.source.guid not in part_set) and \
                t.role != TensorRole.WEIGHT:
            nt.role = TensorRole.INPUT
        tmap[t.guid] = nt
        sub.tensors.append(nt)
        return nt

    for op in part:
        nins = [map_tensor(t) if t is not None else None for t in op.inputs]
        nouts = []
        for t in op.outputs:
            nt = map_tensor(t)
            consumed_outside = t.role == TensorRole.OUTPUT or any(
                c.guid not in part_set for c in t.targets)
            if consumed_outside:
                nt.role = TensorRole.OUTPUT
            nouts.append(nt)
        nop = Operator(op.op_type, nins, nouts, dict(op.attrs), name=op.name)
        for t in nins:
            if t is not None:
                t.add_target(nop)
        for t in nouts:
            t.source = nop
        sub.operators.append(nop)
    sub.topo_sort()
    return sub


def _stitch(graph: Graph, pieces) -> Graph:
    """Rebuild the full graph from chosen partition winners."""
    out = Graph(graph.name)
    by_name: dict[str, TensorObj] = {}

    def intern(t: TensorObj) -> TensorObj:
        key = t.name
        if key in by_name:
            return by_name[key]
        nt = TensorObj(t.shape, t.dtype, name=t.name, role=t.role,
                       data=t.data)
        by_name[key] = nt
        out.tensors.append(nt)
        return nt

    def add_ops(ops):
        for op in ops:
            nins = [intern(t) if t is not None else None for t in op.inputs]
            nouts = [intern(t) for t in op.outputs]
            nop = Operator(op.op_type, nins, nouts, dict(op.attrs),
                           name=op.name)
            for t in nins:
                if t is not None:
                    t.add_target(nop)
            for t in nouts:
                t.source = nop
            out.operators.append(nop)

    for piece in pieces:
        if isinstance(piece, Operator):
            add_ops([piece])
        else:
            _, winner, _ = piece
            # boundary tensors in the winner keep original names; interior
            # OUTPUT markers only matter at the true graph boundary
            for t in winner.tensors:
                if t.role == TensorRole.OUTPUT and \
                        graph.tensor_by_name(t.name) is not None and \
                        graph.tensor_by_name(t.name).role != TensorRole.OUTPUT:
                    t.role = TensorRole.OTHERS
                if t.role == TensorRole.INPUT and \
                        graph.tensor_by_name(t.name) is not None and \
                        graph.tensor_by_name(t.name).role != TensorRole.INPUT:
                    t.role = TensorRole.OTHERS
            add_ops(winner.operators)
    out.topo_sort()
    return out
