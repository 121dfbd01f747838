"""Derivator: rule-guided search over multi-stage expression programs.

The analog of the reference Derivator (include/nnet/derivator.h:42-154,
src/nnet/derivator.cc): BFS over derivation states with hash-based visited
pruning, a depth limit, and a goal predicate — every stage either matches a
library routine (Rule 6) or is pure data movement (a sum-free gather, which
lowers as a MemBound/DLT kernel). Candidates are optionally validated
numerically against the interpreter oracle (reference intermediate-state
equivalence checking via Interpreter).

The valuable derivations are *algorithm substitutions* — conv -> im2col
matmul, 1x1 conv -> matmul, band attention -> G2BMM — plus the membound
residue evaluator that turns any unmatched comprehension into torch
gathers and products (evaluator.py doubles as the TVM-JIT analog).

Copy of infinitensor_tpu/nnet/derivator.py (no jax code), bound to this
package's modules, with one addition: the oracle evaluates on the
Derivator's ``device`` (None: utils/platform.py resolve_device, the card
or an error), resolved when it first runs, so a search with
``verify=False`` needs no device. Its feeds are the JAX package's (numpy
``default_rng(rng_seed)``), so both packages verify the same candidates.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from infinitensor_tpu_torch.nnet import rules
from infinitensor_tpu_torch.nnet.expr import Comprehension
from infinitensor_tpu_torch.nnet.rules import Program, Stage, match_routine
from infinitensor_tpu_torch.nnet.visitors import check_oob


@dataclasses.dataclass
class Candidate:
    program: Program
    depth: int
    n_routines: int
    n_membound_elems: int

    def score(self) -> tuple:
        """Lower is better: fewer unmatched elements, then fewer stages."""
        return (self.n_membound_elems, len(self.program.stages), self.depth)


class Derivator:
    """BFS with hash pruning (reference Derivator::search / guided mode)."""

    #: rules eligible as search moves; tests disable rule 8 to prove the
    #: rule-3 + iterator-table path finds conv->gemm on its own
    ALL_RULES = frozenset({1, 2, 3, 4, 5, 8, 9, 90, 91})

    def __init__(self, max_depth: int = 4, max_states: int = 256,
                 verify: bool = True, rng_seed: int = 0,
                 enabled_rules=None, max_verified: int = 8, device=None):
        self.max_depth = max_depth
        self.device = device
        self.max_states = max_states
        self.verify = verify
        self.max_verified = max_verified
        self.enabled = frozenset(enabled_rules) if enabled_rules is not None \
            else self.ALL_RULES
        self.rng = np.random.default_rng(rng_seed)
        self.n_states_visited = 0
        self.intermediate_states: list[Program] = []  # derivator.h:150 analog

    # -- moves --------------------------------------------------------------
    @staticmethod
    def _divisor_factors(ext: int, cap: int = 3) -> list:
        """Bounded factor set from the dim's divisors (reference Rule 1's
        enumeration, bounded for search tractability)."""
        return [f for f in range(2, min(ext, 65)) if ext % f == 0][:cap]

    def _moves(self, prog: Program):
        on = self.enabled
        for s in prog.stages:
            if 8 in on:
                out = rules.rule8_guided_dlt(prog, s.name)
                if out is not None:
                    yield ("rule8_guided_dlt", out)
            if 90 in on:
                out = rules.rule90_merge_elementwise(prog, s.name)
                if out is not None:
                    yield ("rule90_elementwise", out)
        for s in prog.stages[:-1]:
            if 4 in on:
                out = rules.rule4_stage_merge(prog, s.name)
                if out is not None:
                    yield ("rule4_stage_merge", out)
            if 91 in on:
                out = rules.rule91_merge_stage_with_sum(prog, s.name)
                if out is not None:
                    yield ("rule91_merge_sum", out)
        # Rule 3: materialize non-plain (strided/dilated/padded) accesses
        # as gather producer stages — the move that, composed with the
        # iterator-table matmul match, finds conv->gemm by search.
        if 3 in on:
            for s in prog.stages:
                if not s.comp.sum_vars:
                    continue
                from infinitensor_tpu_torch.nnet.expr import Var as _Var
                for acc in rules.collect_accesses(s.comp.body):
                    plain = all(isinstance(i, _Var) for i in acc.indices)
                    if plain and not acc.tensor.paddings:
                        continue
                    out = rules.rule3_stage_split(prog, s.name, acc)
                    if out is not None:
                        yield ("rule3_stage_split", out)
        # Rule 1: variable splits over bounded divisor factor sets
        if 1 in on:
            for s in prog.stages:
                for v, ext in s.comp.sum_vars:
                    for f in self._divisor_factors(ext):
                        out = rules.rule1_program(prog, s.name, v.name, f)
                        if out is not None:
                            yield ("rule1_sum_split", out)
                for v, ext in s.comp.loop_vars:
                    for f in self._divisor_factors(ext, cap=1):
                        out = rules.rule1_loop_program(prog, s.name,
                                                       v.name, f)
                        if out is not None:
                            yield ("rule1_loop_split", out)
        # Rule 2: adjacent sum-var merges
        if 2 in on:
            for s in prog.stages:
                sums = s.comp.sum_vars
                for (v1, _), (v2, _) in zip(sums, sums[1:]):
                    out = rules.rule2_program(prog, s.name, v1.name, v2.name)
                    if out is not None:
                        yield ("rule2_sum_merge", out)
        # Rules 5/9: round extents up to a tile quantum of 8 (the JAX
        # package's TPU sublanes; kept so both packages search alike)
        for s in prog.stages:
            if 5 in on:
                for v, ext in s.comp.loop_vars:
                    if ext % 8:
                        out = rules.rule5_program(prog, s.name, v.name, 8)
                        if out is not None:
                            yield ("rule5_range_relax", out)
            if 9 in on:
                for v, ext in s.comp.sum_vars:
                    if ext % 8:
                        out = rules.rule9_program(prog, s.name, v.name, 8)
                        if out is not None:
                            yield ("rule9_range_magnify", out)

    # -- goal ---------------------------------------------------------------
    @staticmethod
    def classify(prog: Program) -> Optional[Candidate]:
        """Annotate routines; None if some stage is neither a routine nor
        pure data movement."""
        n_routines = 0
        n_membound = 0
        for s in prog.stages:
            r = match_routine(s.comp)
            if r is not None:
                s.routine = r
                n_routines += 1
            elif not s.comp.sum_vars:
                size = 1
                for e in s.comp.shape:
                    size *= e
                n_membound += size
            else:
                return None
        return Candidate(prog, 0, n_routines, n_membound)

    # -- search -------------------------------------------------------------
    def derive(self, program: Program) -> list[Candidate]:
        frontier = [program]
        visited = {program.hash()}
        results: list[Candidate] = []
        # a single-stage candidate re-matching the input's own routine kind
        # (e.g. a range-relaxed conv still matching Conv) is not a
        # derivation — exclude it so real substitutions rank
        base_kind = None
        if len(program.stages) == 1:
            base = match_routine(program.stages[0].comp)
            base_kind = base["kind"] if base else None
        for depth in range(self.max_depth):
            nxt: list[Program] = []
            for prog in frontier:
                for _, out in self._moves(prog):
                    h = out.hash()
                    if h in visited or len(visited) > self.max_states:
                        continue
                    visited.add(h)
                    self.n_states_visited += 1
                    self.intermediate_states.append(out)
                    cand = self.classify(out.clone())
                    if cand is not None:
                        # trivial = the only routine stage re-matches the
                        # input's own kind (range-relaxed conv + restore
                        # slice, etc.) — no algorithm substitution
                        kinds = [s.routine.get("kind")
                                 for s in cand.program.stages if s.routine]
                        trivial = (base_kind is not None
                                   and kinds == [base_kind])
                        if not trivial:
                            cand.depth = depth + 1
                            results.append(cand)
                    nxt.append(out)
            frontier = nxt
            if not frontier:
                break
        results.sort(key=Candidate.score)
        if not self.verify:
            return results
        # verify lazily, best-first: the oracle evaluates real arrays (two
        # programs per candidate), so bound it to the candidates anyone
        # will consume (reference checks equivalence on demand too)
        verified: list[Candidate] = []
        for cand in results:
            if len(verified) >= self.max_verified:
                break
            if self._equivalent(program, cand.program):
                verified.append(cand)

        def has_dlt(c):
            return any(s.routine and s.routine.get("kind") == "MatMulDLT"
                       for s in c.program.stages)
        if not any(has_dlt(c) for c in verified):
            # always surface the best algorithm-substitution candidate —
            # its membound gather makes it score behind cheap rewrites
            extra = next((c for c in results
                          if has_dlt(c) and c not in verified), None)
            if extra is not None and self._equivalent(program, extra.program):
                verified.append(extra)
        return verified

    # -- oracle -------------------------------------------------------------
    def _equivalent(self, a: Program, b: Program) -> bool:
        from infinitensor_tpu_torch.nnet.evaluator import evaluate_program
        from infinitensor_tpu_torch.utils.platform import resolve_device
        dev = resolve_device(self.device)
        for s in a.stages + b.stages:
            if check_oob(s.comp):
                return False
        feeds = {}
        for t in a.external_inputs():
            feeds[t.name] = self.rng.standard_normal(t.shape).astype(
                np.float32)
        for t in b.external_inputs():
            if t.name not in feeds:
                return False  # derivation invented an input — reject
        va = evaluate_program(a, feeds, device=dev).cpu().numpy()
        vb = evaluate_program(b, feeds, device=dev).cpu().numpy()
        return va.shape == vb.shape and np.allclose(va, vb, rtol=1e-4,
                                                    atol=1e-4)


def derive_op_program(comp: Comprehension, out_name: str = "out",
                      **kw) -> list[Candidate]:
    """Convenience: derive equivalents of a single-op comprehension."""
    return Derivator(**kw).derive(Program([Stage(out_name, comp)]))
