"""Derivation rules over comprehensions and multi-stage programs.

The analog of the reference's Pass rules (src/nnet/Pass/*.cc, rules 1-9, 90,
91 — ~2.2k LoC). States are ``Program``s — ordered lists of ``Stage``s, each
a named comprehension whose output later stages may access as a TensorRef
(the reference's nested-RangeOp/stage structure, include/nnet/expr.h:97-380).

Rule map (reference -> here):
  Rule 1  variable split        -> rule1_sum_var_split / rule1_loop_var_split
  Rule 2  variable merge        -> rule2_var_merge
  Rule 3  stage split           -> rule3_stage_split
  Rule 4  stage merge           -> rule4_stage_merge (inline)
  Rule 5  range relaxation      -> rule5_range_relax (loop-extent round-up
                                   with output padding)
  Rule 6  kernel matching       -> match_routine (matmul / conv / g2bmm)
  Rule 7  DLT                   -> dlt_stage (explicit layout-transform stage)
  Rule 8  guided DLT            -> rule8_guided_dlt (build DLT stages that
                                   make the main stage an exact matmul; the
                                   im2col family)
  Rule 9  range magnify         -> rule9_sum_range_magnify (sum-extent
                                   round-up with zero-padding contract)
  Rule 90 two-stage elementwise -> rule90_merge_elementwise
  Rule 91 merge stage with sum  -> rule91_merge_stage_with_sum (distribute
                                   a product over a sum-carrying producer;
                                   sum-free producers inline via rule4)

Copy of infinitensor_tpu/nnet/rules.py (no jax code), bound to this
package's modules.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from infinitensor_tpu_torch.nnet.expr import (
    Access, BinOp, Comprehension, Const, Expr, Func, TensorRef, Var,
    fresh_var,
)
from infinitensor_tpu_torch.nnet.visitors import (
    collect_vars, comp_hash, serialize_expr, simplify, simplify_comp,
    substitute, transform,
)


def collect_accesses(e: Expr) -> list:
    out: list = []

    def fn(node):
        if isinstance(node, Access):
            out.append(node)
        return None
    transform(e, fn)
    return out


def _same_access(a: Access, b: Access) -> bool:
    """Structural equality (Expr nodes compare by identity; transform
    rebuilds composite indices, so identity comparison misses them)."""
    return a.tensor is b.tensor and \
        serialize_expr(a) == serialize_expr(b)


@dataclasses.dataclass
class Stage:
    """One named comprehension; ``routine`` is set by Rule-6 matching
    (reference Routine annotation, include/nnet/routine.h:18-60)."""
    name: str
    comp: Comprehension
    routine: Optional[dict] = None

    @property
    def shape(self) -> tuple:
        return self.comp.shape

    def out_ref(self) -> TensorRef:
        return TensorRef(self.name, self.shape)


@dataclasses.dataclass
class Program:
    """Topologically ordered stages; the last stage is the program output."""
    stages: list

    def stage(self, name: str) -> Stage:
        return next(s for s in self.stages if s.name == name)

    def stage_names(self) -> set:
        return {s.name for s in self.stages}

    def external_inputs(self) -> list:
        names = self.stage_names()
        seen: dict = {}
        for s in self.stages:
            for t in s.comp.inputs():
                if t.name not in names:
                    seen.setdefault(t.name, t)
        return list(seen.values())

    def hash(self) -> int:
        h = 0xCBF29CE484222325
        for s in self.stages:
            h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
            h ^= comp_hash(s.comp)
        return h

    def clone(self) -> "Program":
        return Program([Stage(s.name, s.comp, s.routine)
                        for s in self.stages])


_stage_counter = itertools.count()


def _fresh_stage_name(prefix="T"):
    return f"{prefix}{next(_stage_counter)}"


# ---------------------------------------------------------------------------
# Rule 1: variable split
# ---------------------------------------------------------------------------

def rule1_sum_var_split(comp: Comprehension, var: Var, factor: int
                        ) -> Optional[Comprehension]:
    """k < N  ->  ko < N/factor, ki < factor with k := ko*factor + ki.
    Sum splits never change the output shape (reference Rule1VariableSplit,
    src/nnet/Pass/Rule1VariableSplit.cc)."""
    for idx, (v, ext) in enumerate(comp.sum_vars):
        if v is var or v.name == getattr(var, "name", var):
            if ext % factor != 0 or factor <= 1 or factor >= ext:
                return None
            ko, ki = fresh_var(v.name + "o"), fresh_var(v.name + "i")
            body = substitute(comp.body, {v.name: ko * factor + ki})
            sums = list(comp.sum_vars)
            sums[idx:idx + 1] = [(ko, ext // factor), (ki, factor)]
            return Comprehension(list(comp.loop_vars), sums, body)
    return None


def rule1_loop_var_split(comp: Comprehension, var: Var, factor: int
                         ) -> Optional[Comprehension]:
    """Loop split changes the output rank (the split dims appear in the
    output); callers must pair it with a layout transform downstream."""
    for idx, (v, ext) in enumerate(comp.loop_vars):
        if v is var or v.name == getattr(var, "name", var):
            if ext % factor != 0 or factor <= 1 or factor >= ext:
                return None
            ko, ki = fresh_var(v.name + "o"), fresh_var(v.name + "i")
            body = substitute(comp.body, {v.name: ko * factor + ki})
            loops = list(comp.loop_vars)
            loops[idx:idx + 1] = [(ko, ext // factor), (ki, factor)]
            return Comprehension(loops, list(comp.sum_vars), body)
    return None


# ---------------------------------------------------------------------------
# Rule 2: variable merge
# ---------------------------------------------------------------------------

def rule2_var_merge(comp: Comprehension, v1: Var, v2: Var,
                    kind: str = "loop") -> Optional[Comprehension]:
    """Adjacent vars (i < M, j < N) -> p < M*N with i := p//N, j := p%N
    (reference Rule2VariableMerging)."""
    pairs = comp.loop_vars if kind == "loop" else comp.sum_vars
    names = [v.name for v, _ in pairs]
    n1 = v1.name if isinstance(v1, Var) else v1
    n2 = v2.name if isinstance(v2, Var) else v2
    if n1 not in names or n2 not in names:
        return None
    i1, i2 = names.index(n1), names.index(n2)
    if i2 != i1 + 1:
        return None
    (va, ea), (vb, eb) = pairs[i1], pairs[i2]
    p = fresh_var(va.name + vb.name)
    body = substitute(comp.body, {va.name: p // eb, vb.name: p % eb})
    new_pairs = list(pairs)
    new_pairs[i1:i1 + 2] = [(p, ea * eb)]
    if kind == "loop":
        return Comprehension(new_pairs, list(comp.sum_vars), body)
    return Comprehension(list(comp.loop_vars), new_pairs, body)


def merge_all(comp: Comprehension, kind: str, count: int
              ) -> Optional[Comprehension]:
    """Fold the first ``count`` vars of a kind into one via repeated Rule 2."""
    out = comp
    for _ in range(count - 1):
        pairs = out.loop_vars if kind == "loop" else out.sum_vars
        out = rule2_var_merge(out, pairs[0][0], pairs[1][0], kind)
        if out is None:
            return None
    return out


# ---------------------------------------------------------------------------
# Rule 3 / 4: stage split & merge
# ---------------------------------------------------------------------------

def rule3_stage_split(program: Program, stage_name: str, access: Access
                      ) -> Optional[Program]:
    """Materialize one access's gather into its own producer stage: the
    consumer then reads the producer at plain loop/sum vars (reference
    Rule3StageSplit). The producer is a pure data-movement (DLT) stage."""
    prog = program.clone()
    stage = prog.stage(stage_name)
    comp = stage.comp
    used = [(v, e) for v, e in comp.loop_vars + comp.sum_vars
            if any(u.name == v.name
                   for i in access.indices for u in collect_vars(i))]
    if not used:
        return None
    new_name = _fresh_stage_name(access.tensor.name + "_dlt")
    producer_vars = [(fresh_var(v.name), e) for v, e in used]
    mapping = {v.name: pv for (v, _), (pv, _) in zip(used, producer_vars)}
    producer_body = Access(
        access.tensor,
        tuple(substitute(i, mapping) for i in access.indices))
    producer = Stage(new_name,
                     Comprehension(producer_vars, [], producer_body))
    new_ref = TensorRef(new_name, producer.shape)
    replacement = Access(new_ref, tuple(v for v, _ in used))

    def fn(node):
        if node is access or (isinstance(node, Access)
                              and _same_access(node, access)):
            return replacement
        return None
    stage.comp = Comprehension(list(comp.loop_vars), list(comp.sum_vars),
                               transform(comp.body, fn))
    idx = prog.stages.index(stage)
    prog.stages.insert(idx, producer)
    return prog


def rule4_stage_merge(program: Program, producer_name: str
                      ) -> Optional[Program]:
    """Inline a sum-free producer stage into all consumers (reference
    Rule4StageMerging; the sum-carrying case is Rule 91 — sound here only in
    multiplicative positions, so restricted to sum-free producers)."""
    prog = program.clone()
    producer = prog.stage(producer_name)
    if producer.comp.sum_vars or prog.stages[-1] is producer:
        return None

    def inline_into(comp: Comprehension) -> Comprehension:
        def fn(node):
            if isinstance(node, Access) and node.tensor.name == producer_name:
                mapping = {v.name: idx for (v, _), idx in
                           zip(producer.comp.loop_vars, node.indices)}
                return substitute(producer.comp.body, mapping)
            return None
        return Comprehension(list(comp.loop_vars), list(comp.sum_vars),
                             simplify(transform(comp.body, fn)))

    for s in prog.stages:
        if s is not producer:
            s.comp = inline_into(s.comp)
    prog.stages.remove(producer)
    return prog


# ---------------------------------------------------------------------------
# Rule 5/9: range relaxation (round a loop extent up, recording padding)
# ---------------------------------------------------------------------------

def rule5_range_relax(comp: Comprehension, var: Var, multiple: int
                      ) -> Optional[tuple]:
    """Return (new_comp, pad) where the var's extent is rounded up to a
    multiple; the caller slices off the padded tail after evaluation
    (reference Rule5RangeRelaxation + Rule9RangeMagnify record the same
    information as RangeOp paddings)."""
    for idx, (v, ext) in enumerate(comp.loop_vars):
        if v is var or v.name == getattr(var, "name", var):
            new_ext = -(-ext // multiple) * multiple
            if new_ext == ext:
                return None
            loops = list(comp.loop_vars)
            loops[idx] = (v, new_ext)
            return (Comprehension(loops, list(comp.sum_vars), comp.body),
                    new_ext - ext)
    return None


def rule9_sum_range_magnify(comp: Comprehension, var: Var, multiple: int
                            ) -> Optional[tuple]:
    """Round a SUM extent up to a multiple (to hit a library kernel's tile
    size). Returns (new_comp, pad) — the extra iterations must contribute
    zero, so the caller zero-pads every input dimension the var indexes by
    ``pad`` before evaluating (the reference records this as RangeOp
    paddings, Rule9RangeMagnify, src/nnet/Pass/Rule9RangeMagnify.cc)."""
    for idx, (v, ext) in enumerate(comp.sum_vars):
        if v is var or v.name == getattr(var, "name", var):
            new_ext = -(-ext // multiple) * multiple
            if new_ext == ext:
                return None
            sums = list(comp.sum_vars)
            sums[idx] = (v, new_ext)
            return (Comprehension(list(comp.loop_vars), sums, comp.body),
                    new_ext - ext)
    return None


def _product_factors(e: Expr) -> Optional[list]:
    """Flatten a pure product tree into factors; None if any node is not
    a multiplication (the positions where distributing a sum is unsound)."""
    if isinstance(e, BinOp) and e.op == "*":
        l = _product_factors(e.lhs)
        r = _product_factors(e.rhs)
        if l is None or r is None:
            return None
        return l + r
    return [e]


def rule91_merge_stage_with_sum(program: Program, producer_name: str
                                ) -> Optional[Program]:
    """Inline a SUM-carrying producer into its single consumer when the
    access sits in a multiplicative position, distributing the product over
    the inner sum (reference Rule91MergeStagesWithSum):

        P[x]      = sum_j B(x, j)
        out[...]  = sum_k f(k) * P(g(k))
                 -> sum_k sum_j f(k) * B(g(k), j)
    """
    prog = program.clone()
    producer = prog.stage(producer_name)
    if not producer.comp.sum_vars or prog.stages[-1] is producer:
        return None
    consumers = [s for s in prog.stages if s is not producer and any(
        t.name == producer_name for t in s.comp.inputs())]
    if len(consumers) != 1:
        return None
    consumer = consumers[0]
    factors = _product_factors(simplify(consumer.comp.body))
    if factors is None:
        return None
    hits = [f for f in factors
            if isinstance(f, Access) and f.tensor.name == producer_name]
    if len(hits) != 1:
        return None
    acc = hits[0]
    # freshen the producer's sum vars, then substitute its loop vars by the
    # consumer's access indices
    mapping = {v.name: idx
               for (v, _), idx in zip(producer.comp.loop_vars, acc.indices)}
    fresh_sums = []
    for v, e in producer.comp.sum_vars:
        nv = fresh_var(v.name)
        mapping[v.name] = nv
        fresh_sums.append((nv, e))
    inlined = substitute(producer.comp.body, mapping)

    def fn(node):
        if node is acc or (isinstance(node, Access)
                           and node.tensor.name == producer_name
                           and node.indices == acc.indices):
            return inlined
        return None

    consumer.comp = Comprehension(
        list(consumer.comp.loop_vars),
        list(consumer.comp.sum_vars) + fresh_sums,
        simplify(transform(consumer.comp.body, fn)))
    prog.stages.remove(producer)
    return prog


# ---------------------------------------------------------------------------
# Program-level wrappers for rules 1/2/5/9 — the Derivator's search moves.
# Shape-changing transforms pair with a layout-restore stage so the program
# output is invariant (the reference tracks this via nested RangeOps).
# ---------------------------------------------------------------------------

def _swap_stage_comp(program: Program, stage_name: str,
                     new_comp: Comprehension) -> Program:
    prog = program.clone()
    prog.stage(stage_name).comp = new_comp
    return prog


def _pad_accesses_for(comp: Comprehension, var_name: str, pad: int
                      ) -> Comprehension:
    """Bump tensor paddings (zero-read contract, see evaluator.py) on every
    dim whose index expression involves ``var_name`` — the soundness side
    of range relaxation/magnification (reference RangeOp paddings)."""
    def fn(node):
        if isinstance(node, Access):
            dims = [d for d, i in enumerate(node.indices)
                    if any(v.name == var_name for v in collect_vars(i))]
            if dims:
                pads = list(node.tensor.paddings
                            or (0,) * len(node.tensor.shape))
                pads += [0] * (len(node.tensor.shape) - len(pads))
                for d in dims:
                    pads[d] += pad
                ref = TensorRef(node.tensor.name, node.tensor.shape,
                                tuple(pads))
                return Access(ref, node.indices)
        return None
    return Comprehension(list(comp.loop_vars), list(comp.sum_vars),
                         transform(comp.body, fn))


def rule1_program(program: Program, stage_name: str, var_name: str,
                  factor: int) -> Optional[Program]:
    """Sum-var split in place (shape-preserving)."""
    st = program.stage(stage_name)
    out = rule1_sum_var_split(st.comp, var_name, factor)
    return None if out is None else \
        _swap_stage_comp(program, stage_name, out)


def rule1_loop_program(program: Program, stage_name: str, var_name: str,
                       factor: int) -> Optional[Program]:
    """Loop-var split + layout-restore stage (output shape preserved)."""
    prog = program.clone()
    st = prog.stage(stage_name)
    new_comp = rule1_loop_var_split(st.comp, var_name, factor)
    if new_comp is None:
        return None
    fresh_name = _fresh_stage_name(st.name + "_ls")
    restore_vars = [(fresh_var(v.name), e) for v, e in st.comp.loop_vars]
    indices: list = []
    for (v, _), (nv, _) in zip(st.comp.loop_vars, restore_vars):
        if v.name == var_name:
            indices.extend([nv // factor, nv % factor])
        else:
            indices.append(nv)
    ref = TensorRef(fresh_name, new_comp.shape)
    restore = Comprehension(
        restore_vars, [],
        Access(ref, tuple(simplify(i) for i in indices)))
    idx = prog.stages.index(st)
    prog.stages[idx:idx + 1] = [Stage(fresh_name, new_comp),
                                Stage(st.name, restore)]
    return prog


def rule2_program(program: Program, stage_name: str, v1_name: str,
                  v2_name: str) -> Optional[Program]:
    """Adjacent sum-var merge in place (shape-preserving)."""
    st = program.stage(stage_name)
    out = rule2_var_merge(st.comp, v1_name, v2_name, kind="sum")
    return None if out is None else \
        _swap_stage_comp(program, stage_name, out)


def rule5_program(program: Program, stage_name: str, var_name: str,
                  multiple: int) -> Optional[Program]:
    """Loop-range relax + restore slice: the relaxed rows compute on
    zero-padded reads and are never read back."""
    prog = program.clone()
    st = prog.stage(stage_name)
    got = rule5_range_relax(st.comp, var_name, multiple)
    if got is None:
        return None
    new_comp, pad = got
    new_comp = _pad_accesses_for(new_comp, var_name, pad)
    fresh_name = _fresh_stage_name(st.name + "_rx")
    restore_vars = [(fresh_var(v.name), e) for v, e in st.comp.loop_vars]
    ref = TensorRef(fresh_name, new_comp.shape)
    restore = Comprehension(restore_vars, [],
                            Access(ref, tuple(v for v, _ in restore_vars)))
    idx = prog.stages.index(st)
    prog.stages[idx:idx + 1] = [Stage(fresh_name, new_comp),
                                Stage(st.name, restore)]
    return prog


def rule9_program(program: Program, stage_name: str, var_name: str,
                  multiple: int) -> Optional[Program]:
    """Sum-range magnify in place: extra iterations read zero-padded
    tensors, so the value is unchanged (reference Rule9RangeMagnify)."""
    st = program.stage(stage_name)
    got = rule9_sum_range_magnify(st.comp, var_name, multiple)
    if got is None:
        return None
    new_comp, pad = got
    return _swap_stage_comp(program, stage_name,
                            _pad_accesses_for(new_comp, var_name, pad))


# ---------------------------------------------------------------------------
# Rule 8: guided DLT — the im2col derivation family
# ---------------------------------------------------------------------------

def _decode(p: Var, group: list) -> dict:
    """Invert row-major flattening: for group [(v1,e1),(v2,e2),(v3,e3)] and
    p < e1*e2*e3, produce {v1: p//(e2*e3), v2: (p//e3)%e2, v3: p%e3}."""
    mapping = {}
    entries = []
    stride = 1
    for v, e in reversed(group):
        entries.append((v, e, stride))
        stride *= e
    for i, (v, e, st) in enumerate(entries):
        idx: Expr = p // st if st > 1 else p
        if i != len(entries) - 1:  # most-significant digit needs no modulo
            idx = idx % e
        mapping[v.name] = simplify(idx)
    return mapping


def _encode(group: list) -> Expr:
    """Row-major flatten: v1*e2*e3 + v2*e3 + v3."""
    out: Expr = Const(0)
    for v, e in group:
        out = out * e + v
    return simplify(out)


def rule8_guided_dlt(program: Program, stage_name: str) -> Optional[Program]:
    """Make a product-of-two-accesses stage an exact matmul by constructing
    DLT (gather) stages for both operands, guided by the matmul iterator
    table: loop vars used only by A form the row group, loop vars used only
    by B the column group, sum vars the contraction (reference
    Rule8GuidedDLT, src/nnet/Pass/Rule8GuidedDLT.cc — DLT construction
    driven by the Rule-6 match target). Produces:

        A_dlt[p, k] = A[...decode(p), decode(k)...]   (gather / im2col)
        B_dlt[q, k] = B[...]
        mm[p, q]    = sum_k A_dlt[p, k] * B_dlt[q, k]     <- exact matmul
        out[orig loop vars] = mm[encode_row, encode_col]  <- layout restore
    """
    prog = program.clone()
    stage = prog.stage(stage_name)
    comp = stage.comp
    body = simplify(comp.body)
    if not (isinstance(body, BinOp) and body.op == "*"
            and isinstance(body.lhs, Access) and isinstance(body.rhs, Access)
            and comp.sum_vars and comp.loop_vars):
        return None
    a_acc, b_acc = body.lhs, body.rhs
    a_vars = {v.name for i in a_acc.indices for v in collect_vars(i)}
    b_vars = {v.name for i in b_acc.indices for v in collect_vars(i)}

    row, col = [], []
    for v, e in comp.loop_vars:
        in_a, in_b = v.name in a_vars, v.name in b_vars
        if in_a and in_b:
            return None  # batched dim — not a plain matmul target
        (col if in_b else row).append((v, e))
    if not row or not col:
        return None
    contraction = list(comp.sum_vars)
    if any(v.name not in a_vars or v.name not in b_vars
           for v, _ in contraction):
        return None

    def prod(group):
        out = 1
        for _, e in group:
            out *= e
        return out

    p, q, k = fresh_var("p"), fresh_var("q"), fresh_var("k")
    P, Q, K = prod(row), prod(col), prod(contraction)

    def dlt_stage(acc: Access, outer_var, outer_group, prefix):
        mapping = dict(_decode(outer_var, outer_group))
        mapping.update(_decode(k, contraction))
        stage_body = Access(acc.tensor,
                            tuple(simplify(substitute(i, mapping))
                                  for i in acc.indices))
        name = _fresh_stage_name(prefix)
        ext = prod(outer_group)
        return Stage(name, Comprehension([(outer_var, ext), (k, K)], [],
                                         stage_body))

    a_stage = dlt_stage(a_acc, p, row, a_acc.tensor.name + "_dlt")
    b_stage = dlt_stage(b_acc, q, col, b_acc.tensor.name + "_dlt")
    p2, q2, k2 = fresh_var("p"), fresh_var("q"), fresh_var("k")
    mm = Stage(_fresh_stage_name("mm"), Comprehension(
        [(p2, P), (q2, Q)], [(k2, K)],
        Access(a_stage.out_ref(), (p2, k2)) *
        Access(b_stage.out_ref(), (q2, k2))))
    # layout-restore stage in the original loop order
    restore_body = Access(mm.out_ref(), (_encode(row), _encode(col)))
    restore = Stage(stage.name, Comprehension(list(comp.loop_vars), [],
                                              restore_body))
    idx = prog.stages.index(stage)
    prog.stages[idx:idx + 1] = [a_stage, b_stage, mm, restore]
    return prog


# ---------------------------------------------------------------------------
# Rule 90: two-stage elementwise merge
# ---------------------------------------------------------------------------

def rule90_merge_elementwise(program: Program, fn_stage: str
                             ) -> Optional[Program]:
    """f(stage(x)) where f is a pure elementwise stage -> fuse f into the
    producer (reference Rule90TwoStageElementWise)."""
    prog = program.clone()
    stage = prog.stage(fn_stage)
    comp = stage.comp
    if comp.sum_vars or not isinstance(comp.body, Func):
        return None
    inner = comp.body.arg
    if not isinstance(inner, Access):
        return None
    if inner.tensor.name not in prog.stage_names():
        return None
    producer = prog.stage(inner.tensor.name)
    consumers = sum(
        1 for s in prog.stages if s is not producer
        for t in s.comp.inputs() if t.name == producer.name)
    if consumers != 1:
        return None
    mapping = {pv.name: idx for (pv, _), idx in
               zip(producer.comp.loop_vars, inner.indices)}
    # fuse: producer's body wrapped in Func, renamed to the fn stage's slot
    if producer.comp.sum_vars:
        # relu(sum ...) cannot swap with the sum — keep as nested program
        return None
    fused = Comprehension(
        list(comp.loop_vars), [],
        Func(comp.body.fn, substitute(producer.comp.body, mapping)))
    stage.comp = simplify_comp(fused)
    prog.stages.remove(producer)
    return prog


# ---------------------------------------------------------------------------
# Rule 6: routine matching
# ---------------------------------------------------------------------------

def _plain_two_var_access(acc: Access):
    if len(acc.indices) == 2 and all(isinstance(i, Var)
                                     for i in acc.indices):
        return acc.indices
    return None


def match_routine(comp: Comprehension) -> Optional[dict]:
    """Rule-6 kernel matching: recognize matmul, conv, and G2BMM forms,
    then fall back to the iterator-table matcher which handles PERMUTED /
    flattened access orders (reference IteratorTable matching,
    include/nnet/iterator_table.h + MatchTableVisitor)."""
    from infinitensor_tpu_torch.nnet.derivation import match_matmul
    m = match_matmul(comp)
    if m is not None:
        m["kind"] = "MatMul"
        return m
    m = match_conv(comp)
    if m is not None:
        return m
    m = match_g2bmm(comp)
    if m is not None:
        return m
    from infinitensor_tpu_torch.nnet.iterator_table import match_matmul_table
    m = match_matmul_table(comp)
    if m is not None:
        return m
    return None


def match_conv(comp: Comprehension) -> Optional[dict]:
    """Recognize out[n,f,i,j] = sum_{c,r,s} X[n,c,i*st+r*dil-p,j*...]*W[f,c,r,s]."""
    if len(comp.loop_vars) != 4 or len(comp.sum_vars) != 3:
        return None
    body = simplify(comp.body)
    if not (isinstance(body, BinOp) and body.op == "*"
            and isinstance(body.lhs, Access) and isinstance(body.rhs, Access)):
        return None
    a, b = body.lhs, body.rhs
    if len(a.indices) != 4 or len(b.indices) != 4:
        return None
    (nn, _), (ff, _), (i, _), (j, _) = comp.loop_vars
    (cc, _), (rr, _), (ss, _) = comp.sum_vars
    # weight access must be exactly [f, c, r, s]
    def is_w(acc):
        return all(isinstance(x, Var) for x in acc.indices) and \
            [x.name for x in acc.indices] == [ff.name, cc.name, rr.name,
                                              ss.name]
    if is_w(b):
        x_acc, w_acc = a, b
    elif is_w(a):
        x_acc, w_acc = b, a
    else:
        return None

    def affine(e, var):
        """index == var*stride + other*dil - pad? return (stride, dil, pad)"""
        coeffs = _linear_coeffs(e)
        if coeffs is None:
            return None
        return coeffs
    hx = _linear_coeffs(x_acc.indices[2])
    wx = _linear_coeffs(x_acc.indices[3])
    if hx is None or wx is None:
        return None
    if not (isinstance(x_acc.indices[0], Var)
            and x_acc.indices[0].name == nn.name
            and isinstance(x_acc.indices[1], Var)
            and x_acc.indices[1].name == cc.name):
        return None
    st_h, dil_h = hx.get(i.name, 0), hx.get(rr.name, 0)
    st_w, dil_w = wx.get(j.name, 0), wx.get(ss.name, 0)
    if not (st_h and dil_h and st_w and dil_w):
        return None
    return {"kind": "Conv", "X": x_acc.tensor, "W": w_acc.tensor,
            "strides": [st_h, st_w], "dilations": [dil_h, dil_w],
            "pads": [-hx.get("_const", 0), -wx.get("_const", 0)]}


def match_g2bmm(comp: Comprehension) -> Optional[dict]:
    """Recognize the Longformer band matmul
    out[b, i, w] = sum_k A[b, i, k] * B[b, i + w - W, k]
    (reference G2BMM, include/operators/G2BMM.h:5-30)."""
    if len(comp.loop_vars) != 3 or len(comp.sum_vars) != 1:
        return None
    body = simplify(comp.body)
    if not (isinstance(body, BinOp) and body.op == "*"
            and isinstance(body.lhs, Access)
            and isinstance(body.rhs, Access)):
        return None
    (b, _), (i, _), (w, wext) = comp.loop_vars
    (k, _) = comp.sum_vars[0]
    a, c = body.lhs, body.rhs

    def is_plain(acc):
        return [x.name for x in acc.indices
                if isinstance(x, Var)] == [b.name, i.name, k.name] and \
            len(acc.indices) == 3
    if is_plain(c):
        a, c = c, a
    if not is_plain(a) or len(c.indices) != 3:
        return None
    band = _linear_coeffs(c.indices[1])
    if band is None:
        return None
    if band.get(i.name) == 1 and band.get(w.name) == 1:
        width = -band.get("_const", 0)
        return {"kind": "G2BMM", "A": a.tensor, "B": c.tensor,
                "width": width, "window": wext}
    return None


def _linear_coeffs(e: Expr) -> Optional[dict]:
    """Decompose an affine expression into {var_name: coeff, _const: c}."""
    e = simplify(e)
    if isinstance(e, Const):
        return {"_const": e.value}
    if isinstance(e, Var):
        return {e.name: 1}
    if isinstance(e, BinOp):
        l = _linear_coeffs(e.lhs)
        r = _linear_coeffs(e.rhs)
        if l is None or r is None:
            return None
        if e.op == "+":
            out = dict(l)
            for n, c in r.items():
                out[n] = out.get(n, 0) + c
            return out
        if e.op == "-":
            out = dict(l)
            for n, c in r.items():
                out[n] = out.get(n, 0) - c
            return out
        if e.op == "*":
            if list(r) == ["_const"]:
                return {n: c * r["_const"] for n, c in l.items()}
            if list(l) == ["_const"]:
                return {n: c * l["_const"] for n, c in r.items()}
            return None
        return None
    return None
