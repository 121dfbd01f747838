"""Structural visitors over the expression IR.

The analog of the reference's visitor zoo (src/nnet/Visitor/ — 23 visitors,
~2.5k LoC). The ones that carry the derivation engine are implemented here:

* ``substitute``      — variable replacement (ReplaceVariable / ReplaceKit)
* ``simplify``        — affine/constant simplification (SimplifyExprVisitor)
* ``expr_hash``       — alpha-renaming-invariant structural hash
                        (HashVisitor, include/nnet/Visitor/HashVisitor.h);
                        the Derivator's visited-state pruning key
* ``serialize`` /
  ``deserialize``     — JSON round-trip (Serializer,
                        src/nnet/Visitor/Serializer.cc)
* ``check_oob``       — interval analysis of access indices against tensor
                        shape + paddings (CheckOOBVisitor)
* ``rename_tensor``, ``collect_vars``, ``count_nodes`` — small helpers the
  reference spreads across GetTensorsVisitor / CountRoutineVisitor etc.

Copy of infinitensor_tpu/nnet/visitors.py (no jax code), bound to this
package's modules.
"""

from __future__ import annotations

from typing import Callable, Optional

from infinitensor_tpu_torch.nnet.expr import (
    Access, BinOp, Comprehension, Const, Expr, Func, TensorRef, Var,
)


# ---------------------------------------------------------------------------
# generic bottom-up transform
# ---------------------------------------------------------------------------

def transform(e: Expr, fn: Callable[[Expr], Optional[Expr]]) -> Expr:
    """Rebuild ``e`` bottom-up; ``fn`` may return a replacement node."""
    if isinstance(e, BinOp):
        e2 = BinOp(e.op, transform(e.lhs, fn), transform(e.rhs, fn))
    elif isinstance(e, Func):
        e2 = Func(e.fn, transform(e.arg, fn))
    elif isinstance(e, Access):
        e2 = Access(e.tensor, tuple(transform(i, fn) for i in e.indices))
    else:
        e2 = e
    r = fn(e2)
    return e2 if r is None else r


def substitute(e: Expr, mapping: dict) -> Expr:
    """Replace Vars (keyed by identity or name) with expressions."""
    def fn(node):
        if isinstance(node, Var):
            if node in mapping:
                return mapping[node]
            if node.name in mapping:
                return mapping[node.name]
        return None
    return transform(e, fn)


def collect_vars(e: Expr) -> list[Var]:
    out: dict[str, Var] = {}

    def fn(node):
        if isinstance(node, Var):
            out.setdefault(node.name, node)
        return None
    transform(e, fn)
    return list(out.values())


def count_nodes(e: Expr) -> int:
    n = 0

    def fn(node):
        nonlocal n
        n += 1
        return None
    transform(e, fn)
    return n


def rename_tensor(e: Expr, old: str, new_ref: TensorRef) -> Expr:
    def fn(node):
        if isinstance(node, Access) and node.tensor.name == old:
            return Access(new_ref, node.indices)
        return None
    return transform(e, fn)


# ---------------------------------------------------------------------------
# simplification (SimplifyExprVisitor analog)
# ---------------------------------------------------------------------------

def simplify(e: Expr) -> Expr:
    """Constant folding + affine identities: x*1, x*0, x+0, x-0, x//1, x%1,
    const-const folding. Keeps the IR small so hashing/matching see through
    derivation noise."""
    def fn(node):
        if not isinstance(node, BinOp):
            return None
        l, r = node.lhs, node.rhs
        lc = l.value if isinstance(l, Const) else None
        rc = r.value if isinstance(r, Const) else None
        if lc is not None and rc is not None:
            try:
                return Const({"+": lc + rc, "-": lc - rc, "*": lc * rc,
                              "/": lc / rc if rc else 0,
                              "//": lc // rc if rc else 0,
                              "%": lc % rc if rc else 0}[node.op])
            except ZeroDivisionError:
                return None
        if node.op == "+":
            if lc == 0:
                return r
            if rc == 0:
                return l
        if node.op == "-" and rc == 0:
            return l
        if node.op == "*":
            if lc == 1:
                return r
            if rc == 1:
                return l
            if lc == 0 or rc == 0:
                return Const(0)
        if node.op in ("//", "/") and rc == 1:
            return l
        if node.op == "%" and rc == 1:
            return Const(0)
        return None
    return transform(e, fn)


def simplify_comp(c: Comprehension) -> Comprehension:
    return Comprehension(list(c.loop_vars), list(c.sum_vars),
                         simplify(c.body))


# ---------------------------------------------------------------------------
# hashing (HashVisitor analog — FNV-style, alpha-invariant)
# ---------------------------------------------------------------------------

_FNV_PRIME = 0x100000001B3
_FNV_BASIS = 0xCBF29CE484222325


def _mix(h: int, v: int) -> int:
    return ((h ^ (v & 0xFFFFFFFFFFFFFFFF)) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF


def expr_hash(e: Expr, var_ids: Optional[dict] = None) -> int:
    """Structural hash; vars hash by their de-Bruijn-style slot in var_ids
    (filled by comp_hash) so renamed-but-identical derivations collide."""
    var_ids = var_ids if var_ids is not None else {}

    def h(node) -> int:
        if isinstance(node, Const):
            return _mix(_FNV_BASIS, hash(("const", node.value)))
        if isinstance(node, Var):
            slot = var_ids.setdefault(node.name, len(var_ids))
            return _mix(_FNV_BASIS, hash(("var", slot)))
        if isinstance(node, BinOp):
            x = _mix(_FNV_BASIS, hash(("bin", node.op)))
            x = _mix(x, h(node.lhs))
            return _mix(x, h(node.rhs))
        if isinstance(node, Func):
            return _mix(_mix(_FNV_BASIS, hash(("fn", node.fn))), h(node.arg))
        if isinstance(node, Access):
            x = _mix(_FNV_BASIS, hash(("acc", node.tensor.name,
                                       node.tensor.shape,
                                       node.tensor.paddings)))
            for i in node.indices:
                x = _mix(x, h(i))
            return x
        raise TypeError(type(node))
    return h(e)


def comp_hash(c: Comprehension) -> int:
    var_ids: dict = {}
    x = _FNV_BASIS
    for v, ext in c.loop_vars:
        var_ids.setdefault(v.name, len(var_ids))
        x = _mix(x, hash(("loop", ext)))
    for v, ext in c.sum_vars:
        var_ids.setdefault(v.name, len(var_ids))
        x = _mix(x, hash(("sum", ext)))
    return _mix(x, expr_hash(simplify(c.body), var_ids))


# ---------------------------------------------------------------------------
# serialization (Serializer analog — JSON-able dicts)
# ---------------------------------------------------------------------------

def serialize_expr(e: Expr) -> dict:
    if isinstance(e, Const):
        return {"t": "const", "v": e.value}
    if isinstance(e, Var):
        return {"t": "var", "name": e.name}
    if isinstance(e, BinOp):
        return {"t": "bin", "op": e.op, "lhs": serialize_expr(e.lhs),
                "rhs": serialize_expr(e.rhs)}
    if isinstance(e, Func):
        return {"t": "func", "fn": e.fn, "arg": serialize_expr(e.arg)}
    if isinstance(e, Access):
        return {"t": "access", "tensor": e.tensor.name,
                "shape": list(e.tensor.shape),
                "paddings": list(e.tensor.paddings or ()),
                "indices": [serialize_expr(i) for i in e.indices]}
    raise TypeError(type(e))


def serialize(c: Comprehension) -> dict:
    return {"loop": [[v.name, ext] for v, ext in c.loop_vars],
            "sum": [[v.name, ext] for v, ext in c.sum_vars],
            "body": serialize_expr(c.body)}


def deserialize_expr(d: dict, env: dict) -> Expr:
    t = d["t"]
    if t == "const":
        return Const(d["v"])
    if t == "var":
        return env.setdefault(d["name"], Var(d["name"]))
    if t == "bin":
        return BinOp(d["op"], deserialize_expr(d["lhs"], env),
                     deserialize_expr(d["rhs"], env))
    if t == "func":
        return Func(d["fn"], deserialize_expr(d["arg"], env))
    if t == "access":
        key = ("tensor", d["tensor"])
        ref = env.setdefault(key, TensorRef(d["tensor"], tuple(d["shape"]),
                                            tuple(d["paddings"])))
        return Access(ref, tuple(deserialize_expr(i, env)
                                 for i in d["indices"]))
    raise ValueError(t)


def deserialize(d: dict) -> Comprehension:
    env: dict = {}
    body = deserialize_expr(d["body"], env)
    def var_of(name):
        return env.setdefault(name, Var(name))
    return Comprehension([(var_of(n), e) for n, e in d["loop"]],
                         [(var_of(n), e) for n, e in d["sum"]], body)


# ---------------------------------------------------------------------------
# OOB checking (CheckOOBVisitor analog — interval arithmetic)
# ---------------------------------------------------------------------------

def _interval(e: Expr, ranges: dict) -> Optional[tuple]:
    """[lo, hi] bounds of an index expression over the iteration domain."""
    if isinstance(e, Const):
        return (e.value, e.value)
    if isinstance(e, Var):
        return ranges.get(e.name)
    if isinstance(e, BinOp):
        l, r = _interval(e.lhs, ranges), _interval(e.rhs, ranges)
        if l is None or r is None:
            return None
        if e.op == "+":
            return (l[0] + r[0], l[1] + r[1])
        if e.op == "-":
            return (l[0] - r[1], l[1] - r[0])
        if e.op == "*":
            cands = [a * b for a in l for b in r]
            return (min(cands), max(cands))
        if e.op == "//" and r[0] == r[1] and r[0] > 0:
            return (l[0] // r[0], l[1] // r[0])
        if e.op == "%" and r[0] == r[1] and r[0] > 0:
            if l[0] >= 0:
                return (0, min(l[1], r[0] - 1))
            return (-(r[0] - 1), r[0] - 1)
        return None
    return None


def check_oob(c: Comprehension) -> list[str]:
    """Return a list of violation strings; empty means every access stays
    within shape + paddings over the whole iteration domain."""
    ranges = {v.name: (0, ext - 1) for v, ext in c.loop_vars + c.sum_vars}
    issues: list[str] = []

    def fn(node):
        if isinstance(node, Access):
            pads = node.tensor.paddings or (0,) * len(node.tensor.shape)
            if len(node.indices) != len(node.tensor.shape):
                issues.append(f"{node!r}: rank mismatch")
                return None
            for d, (idx, dim, p) in enumerate(
                    zip(node.indices, node.tensor.shape, pads)):
                iv = _interval(simplify(idx), ranges)
                if iv is None:
                    continue  # non-affine: cannot prove, stay silent
                if iv[0] < -p or iv[1] > dim - 1 + p:
                    issues.append(
                        f"{node.tensor.name} dim {d}: index range {iv} "
                        f"outside [-{p}, {dim - 1 + p}]")
        return None
    transform(c.body, fn)
    return issues
