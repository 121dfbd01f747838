"""Tensor-comprehension expression IR.

The analog of the reference's NNET expression AST (reference
include/nnet/expr.h:97-380): a ``Comprehension`` is the RangeOp — output loop
vars with ranges (+ output paddings), summation vars with ranges, and a body
of tensor accesses combined by arithmetic. Affine index arithmetic is plain
Expr composition. ``Routine`` markers (matched library calls) become plain
graph ops at expressionToGraph time (nnet/derivation.py).

Example — a matmul:
    i, j, k = Var("i"), Var("j"), Var("k")
    C = Comprehension([(i, 4), (j, 8)], [(k, 16)],
                      Access(A, [i, k]) * Access(B, [k, j]))

Copy of infinitensor_tpu/nnet/expr.py (no jax code), bound to this
package's modules.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence, Union

_counter = itertools.count()


class Expr:
    def __add__(self, o): return BinOp("+", self, _wrap(o))
    def __radd__(self, o): return BinOp("+", _wrap(o), self)
    def __sub__(self, o): return BinOp("-", self, _wrap(o))
    def __rsub__(self, o): return BinOp("-", _wrap(o), self)
    def __mul__(self, o): return BinOp("*", self, _wrap(o))
    def __rmul__(self, o): return BinOp("*", _wrap(o), self)
    def __truediv__(self, o): return BinOp("/", self, _wrap(o))
    def __floordiv__(self, o): return BinOp("//", self, _wrap(o))
    def __mod__(self, o): return BinOp("%", self, _wrap(o))
    def __neg__(self): return BinOp("-", Const(0), self)


def _wrap(v) -> "Expr":
    return v if isinstance(v, Expr) else Const(v)


@dataclasses.dataclass(frozen=True, eq=False)
class Var(Expr):
    name: str

    def __repr__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    value: Union[int, float]

    def __repr__(self):
        return str(self.value)


@dataclasses.dataclass(frozen=True, eq=False)
class TensorRef(Expr):
    """Named input tensor with shape and optional zero-padding per dim
    (reference nnet Tensor paddings)."""
    name: str
    shape: tuple
    paddings: tuple = ()

    def __repr__(self):
        return f"{self.name}{list(self.shape)}"

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        return Access(self, tuple(_wrap(i) for i in idx))


@dataclasses.dataclass(frozen=True, eq=False)
class Access(Expr):
    tensor: TensorRef
    indices: tuple

    def __repr__(self):
        return f"{self.tensor.name}[{', '.join(map(repr, self.indices))}]"


@dataclasses.dataclass(frozen=True, eq=False)
class BinOp(Expr):
    op: str
    lhs: Expr
    rhs: Expr

    def __repr__(self):
        return f"({self.lhs!r} {self.op} {self.rhs!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class Func(Expr):
    """Unary function node (reference FuncNode: relu/tanh/...)."""
    fn: str
    arg: Expr

    def __repr__(self):
        return f"{self.fn}({self.arg!r})"


@dataclasses.dataclass(eq=False)
class Comprehension:
    """out[i0, i1, ...] = sum_{s0, s1, ...} body  (reference RangeOp)."""
    loop_vars: list          # [(Var, extent)]
    sum_vars: list           # [(Var, extent)]
    body: Expr

    @property
    def shape(self) -> tuple:
        return tuple(ext for _, ext in self.loop_vars)

    def __repr__(self):
        lv = ", ".join(f"{v!r}<{e}" for v, e in self.loop_vars)
        sv = ", ".join(f"{v!r}<{e}" for v, e in self.sum_vars)
        return f"L[{lv}] Sum[{sv}] {self.body!r}"

    def inputs(self) -> list[TensorRef]:
        seen: dict[int, TensorRef] = {}

        def walk(e: Expr):
            if isinstance(e, Access):
                seen.setdefault(id(e.tensor), e.tensor)
                for i in e.indices:
                    walk(i)
            elif isinstance(e, BinOp):
                walk(e.lhs)
                walk(e.rhs)
            elif isinstance(e, Func):
                walk(e.arg)
        walk(self.body)
        return list(seen.values())


def fresh_var(prefix: str = "v") -> Var:
    return Var(f"{prefix}{next(_counter)}")
