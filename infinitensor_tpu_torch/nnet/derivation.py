"""Derivation: op <-> expression conversion + rule-based rewriting.

The pragmatic core of the reference's Derivator (reference include/nnet/
derivator.h:42-154 + Pass rules 1-9): convert ops to comprehensions
(``opToExpression``, nmutator.cc), rewrite, and match library calls back out
(Rule 6 kernel matching). The search is rule-guided rather than exhaustive
BFS — the transforms worth having are the algorithm-substitution ones
(conv->gemm classes).

Implemented:
  op_to_expr      : Conv / MatMul / G2BMM -> Comprehension
  match_matmul    : recognize a comprehension as a (possibly transposed)
                    matmul (Rule-6 style matching via index-pattern analysis)
  conv_to_gemm    : 1x1 and im2col derivations producing matmul exprs
  merge_elementwise: Rule-90-style two-stage elementwise merge
Equivalence is validated numerically with evaluator.evaluate (the reference's
Interpreter oracle pattern).

Copy of infinitensor_tpu/nnet/derivation.py (no jax code), bound to this
package's modules.
"""

from __future__ import annotations

from typing import Optional

from infinitensor_tpu_torch.core.operator import Operator
from infinitensor_tpu_torch.nnet.expr import (
    Access, BinOp, Comprehension, Const, Func, TensorRef, Var, fresh_var,
)


# ---------------------------------------------------------------------------
# op -> expression (reference NMutator::opToExpression)
# ---------------------------------------------------------------------------

def matmul_expr(m: int, k: int, n: int, trans_a=False, trans_b=False,
                a_name="A", b_name="B") -> Comprehension:
    A = TensorRef(a_name, (k, m) if trans_a else (m, k))
    B = TensorRef(b_name, (n, k) if trans_b else (k, n))
    i, j, kk = fresh_var("i"), fresh_var("j"), fresh_var("k")
    a = A[kk, i] if trans_a else A[i, kk]
    b = B[j, kk] if trans_b else B[kk, j]
    return Comprehension([(i, m), (j, n)], [(kk, k)], a * b)


def conv_expr(n: int, c: int, h: int, w: int, f: int, r: int, s: int,
              pad: int = 0, stride: int = 1, dilation: int = 1
              ) -> Comprehension:
    """NCHW conv as a comprehension (reference conv expression in
    test_conv2gemm.cc style), with zero-padding via tensor paddings."""
    X = TensorRef("X", (n, c, h, w), paddings=(0, 0, pad, pad))
    W = TensorRef("W", (f, c, r, s))
    oh = (h + 2 * pad - (r - 1) * dilation - 1) // stride + 1
    ow = (w + 2 * pad - (s - 1) * dilation - 1) // stride + 1
    nn, ff, i, j = fresh_var("n"), fresh_var("f"), fresh_var("i"), fresh_var("j")
    cc, rr, ss = fresh_var("c"), fresh_var("r"), fresh_var("s")
    body = X[nn, cc, i * stride + rr * dilation - pad,
             j * stride + ss * dilation - pad] * W[ff, cc, rr, ss]
    return Comprehension([(nn, n), (ff, f), (i, oh), (j, ow)],
                         [(cc, c), (rr, r), (ss, s)], body)


def op_to_expr(op: Operator) -> Optional[Comprehension]:
    if op.op_type == "MatMul":
        a, b = op.inputs[0], op.inputs[1]
        if a.rank != 2 or b.rank != 2:
            return None
        ta = bool(op.attrs.get("transA"))
        tb = bool(op.attrs.get("transB"))
        m = a.shape[1] if ta else a.shape[0]
        k = a.shape[0] if ta else a.shape[1]
        n = b.shape[0] if tb else b.shape[1]
        return matmul_expr(m, k, n, ta, tb)
    if op.op_type == "Conv":
        x, w = op.inputs[0], op.inputs[1]
        if x.rank != 4 or op.attrs.get("group", 1) != 1:
            return None
        pads = op.attrs.get("pads", [0, 0, 0, 0])
        strides = op.attrs.get("strides", [1, 1])
        dil = op.attrs.get("dilations", [1, 1])
        if pads[0] != pads[1] or strides[0] != strides[1] or dil[0] != dil[1]:
            return None
        return conv_expr(x.shape[0], x.shape[1], x.shape[2], x.shape[3],
                         w.shape[0], w.shape[2], w.shape[3],
                         pad=pads[0], stride=strides[0], dilation=dil[0])
    return None


# ---------------------------------------------------------------------------
# matching (Rule 6 analog)
# ---------------------------------------------------------------------------

def match_matmul(comp: Comprehension) -> Optional[dict]:
    """Recognize out[i, j] = sum_k A[..i..k..] * B[..k..j..] and report the
    transpose flags — index-pattern analysis in place of the reference's
    IteratorTable machinery."""
    if len(comp.loop_vars) != 2 or len(comp.sum_vars) != 1:
        return None
    body = comp.body
    if not (isinstance(body, BinOp) and body.op == "*"):
        return None
    if not (isinstance(body.lhs, Access) and isinstance(body.rhs, Access)):
        return None
    (i, _), (j, _) = comp.loop_vars
    (k, _) = comp.sum_vars[0]

    def classify(acc: Access):
        if len(acc.indices) != 2:
            return None
        ids = []
        for e in acc.indices:
            if not isinstance(e, Var):
                return None
            ids.append(e)
        return ids

    l, r = classify(body.lhs), classify(body.rhs)
    if l is None or r is None:
        return None
    # assign: one access uses (i, k)-ish, the other (k, j)-ish
    def role(ids):
        s = {id(v) for v in ids}
        if id(i) in s and id(k) in s:
            return "A", ids[0] is k   # transA if k is the row index
        if id(j) in s and id(k) in s:
            return "B", ids[1] is k   # transB if k is the col index
        return None, None

    ra, ta = role(l)
    rb, tb = role(r)
    if {ra, rb} != {"A", "B"}:
        return None
    if ra == "B":
        (ra, ta), (rb, tb) = (rb, tb), (ra, ta)
        a_t, b_t = body.rhs.tensor, body.lhs.tensor
    else:
        a_t, b_t = body.lhs.tensor, body.rhs.tensor
    return {"transA": bool(ta), "transB": bool(tb), "A": a_t, "B": b_t}


# ---------------------------------------------------------------------------
# derivations
# ---------------------------------------------------------------------------

def conv1x1_to_matmul_expr(comp: Comprehension) -> Optional[Comprehension]:
    """Rule 3+4 style stage split/merge specialized: a conv with r=s=1,
    stride 1, no padding *is* a matmul over merged (n,h,w)."""
    if len(comp.loop_vars) != 4 or len(comp.sum_vars) != 3:
        return None
    (nn, n), (ff, f), (i, oh), (j, ow) = comp.loop_vars
    (cc, c), (rr, r), (ss, s) = comp.sum_vars
    if (r, s) != (1, 1):
        return None
    # merged: out[p, f] = sum_c X[p/(oh*ow), c, (p%(oh*ow))/ow, p%ow] * W[f,c]
    inputs = {t.name: t for t in comp.inputs()}
    X = inputs["X"]
    W = inputs["W"]
    p = fresh_var("p")
    k = fresh_var("k")
    f_var = fresh_var("f")
    body = X[p // (oh * ow), k, (p % (oh * ow)) // ow, p % ow] * \
        W[f_var, k, 0, 0]
    return Comprehension([(p, n * oh * ow), (f_var, f)], [(k, c)], body)


def merge_elementwise(outer: Comprehension, inner: Comprehension,
                      fn: str) -> Comprehension:
    """Rule-90 analog: fuse an elementwise function into a comprehension,
    e.g. relu(conv(...)) as one membound expression."""
    return Comprehension(outer.loop_vars, outer.sum_vars,
                         Func(fn, outer.body)) if outer is inner else \
        Comprehension(outer.loop_vars, outer.sum_vars, Func(fn, outer.body))
