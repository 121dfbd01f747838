"""Iterator-table routine matching.

The analog of the reference's MatchTableVisitor/IteratorTable (reference
include/nnet/iterator_table.h, src/nnet/Visitor/MatchTableVisitor.cc): build
a table of which operand uses each iterator, classify iterators into
row/column/contraction groups, and match library routines structurally —
which generalizes the plain pattern matcher to PERMUTED and FLATTENED
access orders. A stage like

    out[n, f, i, j] = sum_{c,r,s} Xg[n, i, j, c, r, s] * W[f, c, r, s]

(the post-stage-split form of any strided/dilated conv) is recognized as a
matmul with layout wrappers: A = reshape(transpose(Xg)), B likewise, out =
transpose(reshape(mm)). The ``MatMulDLT`` routine carries the permutations;
nnet/nmutator.py lowers it to Transpose/Reshape/MatMul graph ops.

Copy of infinitensor_tpu/nnet/iterator_table.py (no jax code), bound to this
package's modules.
"""

from __future__ import annotations

from typing import Optional

from infinitensor_tpu_torch.nnet.expr import (
    Access, BinOp, Comprehension, Var,
)
from infinitensor_tpu_torch.nnet.visitors import simplify


def build_iterator_table(comp: Comprehension) -> Optional[dict]:
    """For a product-of-two-accesses body with all-plain-Var indices,
    return the iterator table:
      {"a": Access, "b": Access,
       "row": [(name, ext)], "col": [...], "k": [...],
       "a_dims": [names], "b_dims": [names]}
    row = loop vars used only by A, col = only by B, k = sum vars used by
    both. None when the structure doesn't fit (batch vars, non-plain
    indices, diagonal accesses, unused loop vars)."""
    body = simplify(comp.body)
    if not (isinstance(body, BinOp) and body.op == "*"
            and isinstance(body.lhs, Access)
            and isinstance(body.rhs, Access)):
        return None
    l_acc, r_acc = body.lhs, body.rhs

    def dims(acc: Access) -> Optional[list]:
        names = []
        for i in acc.indices:
            if not isinstance(i, Var) or i.name in names:   # diagonal
                return None
            names.append(i.name)
        return names

    l_dims, r_dims = dims(l_acc), dims(r_acc)
    if l_dims is None or r_dims is None:
        return None
    lset, rset = set(l_dims), set(r_dims)

    loop_names = [v.name for v, _ in comp.loop_vars]
    sum_names = [v.name for v, _ in comp.sum_vars]
    ext = {v.name: e for v, e in comp.loop_vars + comp.sum_vars}
    # operand dims must be exactly the comp's iterators
    if not (lset | rset) <= set(loop_names) | set(sum_names):
        return None

    l_only = [n for n in loop_names if n in lset and n not in rset]
    r_only = [n for n in loop_names if n in rset and n not in lset]
    both_loop = [n for n in loop_names if n in lset and n in rset]
    unused = [n for n in loop_names if n not in lset and n not in rset]
    if both_loop or unused or not l_only or not r_only:
        return None              # batch/broadcast dims: not a plain matmul
    if any(n not in lset or n not in rset for n in sum_names) \
            or not sum_names:
        return None              # every contraction var hits both operands
    # operand dims = its groups exactly
    if lset != set(l_only) | set(sum_names) or \
            rset != set(r_only) | set(sum_names):
        return None
    return {
        "a": l_acc, "b": r_acc,
        "row": [(n, ext[n]) for n in l_only],
        "col": [(n, ext[n]) for n in r_only],
        "k": [(n, ext[n]) for n in sum_names],
        "a_dims": l_dims, "b_dims": r_dims,
    }


def match_matmul_table(comp: Comprehension) -> Optional[dict]:
    """Iterator-table matmul match: returns a ``MatMulDLT`` routine with
    the layout recipe, or None."""
    table = build_iterator_table(comp)
    if table is None:
        return None
    row_names = [n for n, _ in table["row"]]
    col_names = [n for n, _ in table["col"]]
    k_names = [n for n, _ in table["k"]]

    def perm_to(dims: list, target: list) -> Optional[list]:
        try:
            return [dims.index(n) for n in target]
        except ValueError:
            return None

    a_perm = perm_to(table["a_dims"], row_names + k_names)
    b_perm = perm_to(table["b_dims"], k_names + col_names)
    if a_perm is None or b_perm is None:
        return None
    loop_names = [n for n, _ in
                  [(v.name, e) for v, e in comp.loop_vars]]
    out_perm = perm_to(row_names + col_names, loop_names)
    return {
        "kind": "MatMulDLT",
        "A": table["a"].tensor, "B": table["b"].tensor,
        "a_perm": a_perm, "b_perm": b_perm, "out_perm": out_perm,
        "row": table["row"], "col": table["col"], "k": table["k"],
    }
