"""Expression evaluator: comprehension -> torch computation (counterpart of
infinitensor_tpu/nnet/evaluator.py).

Plays both reference roles at once:
* the NNET ``Interpreter`` (reference src/nnet/Visitor/Interpreter.*) — the
  numeric oracle used to validate derivations;
* the MemBound kernel backend — the reference JIT-compiles unmatched
  expression residue via TVM (src/kernels/cuda/membound_tvm_packed_function
  .cc); here the same evaluation runs as eager torch ops, which the
  executor captures with the rest of the graph in one CUDA graph.

Strategy: loop/sum variables become broadcasted index grids; tensor accesses
become (possibly padded) advanced indexing; the whole computation is
vectorized — no per-element Python.

Where this port differs from the JAX evaluator, and why:

* Out-of-range indices. JAX's gather wraps a negative index once and
  clamps to the dim; torch raises (a device-side assert on the card). On a
  dim with a padding the zero mask comes from the raw index, then the
  index is clipped (no wrap), as in the JAX module; on a dim without one
  the index wraps once if negative, then clamps to [0, dim-1], JAX's rule.
* Memory. XLA fuses broadcast x broadcast -> sum without materialising the
  grid; eager torch does materialise it. A comprehension with sum vars
  whose full grid passes ``ELEMENT_BUDGET`` elements is evaluated in
  chunks along its leading loop vars, each chunk summing its own axes
  into a slice of the output (equal to the unchunked value up to f32
  summation order). Loop-only comprehensions never chunk.
* Types. Index grids are int64 (JAX: int32); an integer result is cast to
  int32, JAX's dtype with x64 off. Float results keep the feeds' dtype as
  JAX promotes it (f32 feeds give f32, bf16 feeds give bf16).
* Capture. Grids come from ``torch.arange(..., device=...)``, constants
  stay Python scalars, and nothing reads back to the host, so a MemBound
  lowering is capturable.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from infinitensor_tpu_torch.nnet.expr import (
    Access, BinOp, Comprehension, Const, Expr, Func, Var,
)
from infinitensor_tpu_torch.utils.platform import resolve_device

#: most elements of a comprehension's full (loop x sum) grid evaluated at
#: once; a larger one with sum vars is evaluated in chunks
ELEMENT_BUDGET = 1 << 28

_FUNCS = {
    "relu": lambda x: torch.clamp(x, min=0),
    "tanh": torch.tanh,
    "exp": torch.exp,
    "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
}

_BINOPS = {
    "+": lambda l, r: l + r, "-": lambda l, r: l - r,
    "*": lambda l, r: l * r, "/": lambda l, r: l / r,
    "//": lambda l, r: l // r, "%": lambda l, r: l % r,
}


#: host arrays take JAX's dtypes with x64 off
_CANONICAL = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def _as_tensor(v, dev: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v if v.device == dev else v.to(dev)
    v = np.asarray(v)
    v = v.astype(_CANONICAL.get(v.dtype, v.dtype), copy=False)
    return torch.from_numpy(np.ascontiguousarray(v)).to(dev)


def _index(i, size: int, padded: bool):
    """One access index under JAX's rules; returns (index, in-range mask or
    None). Python ints stay Python ints."""
    if isinstance(i, torch.Tensor):
        if padded:
            ok = (i >= 0) & (i < size)
            return torch.clamp(i, 0, size - 1), ok
        i = torch.where(i < 0, i + size, i)
        return torch.clamp(i, 0, size - 1), None
    if padded:
        return min(max(i, 0), size - 1), (0 <= i < size)
    if i < 0:
        i += size
    return min(max(i, 0), size - 1), None


def _block(comp: Comprehension, feeds: dict, dev: torch.device,
           ranges: list):
    """Evaluate comp over loop-var ranges [(start, stop)] (sum vars whole):
    the value of out[start0:stop0, ...]."""
    all_vars = comp.loop_vars + comp.sum_vars
    spans = list(ranges) + [(0, e) for _, e in comp.sum_vars]
    n = len(all_vars)
    grids = {}
    for axis, ((v, _), (lo, hi)) in enumerate(zip(all_vars, spans)):
        shape = [1] * n
        shape[axis] = hi - lo
        grids[v.name] = torch.arange(lo, hi, device=dev).reshape(shape)

    def ev(e: Expr):
        if isinstance(e, Const):
            return e.value
        if isinstance(e, Var):
            return grids[e.name]
        if isinstance(e, BinOp):
            return _BINOPS[e.op](ev(e.lhs), ev(e.rhs))
        if isinstance(e, Func):
            a = ev(e.arg)
            if not isinstance(a, torch.Tensor):
                a = torch.full((), a, device=dev)
            return _FUNCS[e.fn](a)
        if isinstance(e, Access):
            arr = feeds[e.tensor.name]
            pads = e.tensor.paddings or (0,) * arr.ndim
            # out-of-range w/ paddings reads zero (reference RangeOp padding)
            idx, masks = [], []
            for d, (i, p) in enumerate(zip(e.indices, pads)):
                i, ok = _index(ev(i), arr.shape[d], bool(p))
                idx.append(i)
                if ok is not None:
                    masks.append(ok)
            out = arr[tuple(idx)]
            if any(m is False for m in masks):
                return torch.zeros_like(out)
            masks = [m for m in masks if isinstance(m, torch.Tensor)]
            if masks:
                valid = masks[0]
                for m in masks[1:]:
                    valid = valid & m
                out = out.masked_fill(~valid, 0)
            return out
        raise TypeError(f"cannot evaluate {e!r}")

    val = ev(comp.body)
    if not isinstance(val, torch.Tensor):
        val = torch.full((), val, device=dev)
    # broadcast to the full grid then sum out the sum axes
    full = tuple(hi - lo for lo, hi in spans)
    val = val.broadcast_to(torch.broadcast_shapes(val.shape, full))
    if comp.sum_vars:
        val = val.sum(dim=tuple(range(len(comp.loop_vars), n)))
    return val


def _chunks(loop_ext: list, inner: int, budget: int):
    """Ranges over the loop vars, leading vars first, each covering at most
    ``budget`` elements of the grid (one index of every loop var when
    ``inner``, the sum grid's size, alone passes it)."""
    d = 0
    while d < len(loop_ext) - 1 and \
            math.prod(loop_ext[d + 1:]) * inner > budget:
        d += 1
    step = max(1, budget // (math.prod(loop_ext[d + 1:]) * inner))

    def walk(axis, prefix):
        if axis < d:
            for k in range(loop_ext[axis]):
                yield from walk(axis + 1, prefix + [(k, k + 1)])
            return
        for lo in range(0, loop_ext[d], step):
            yield prefix + [(lo, min(lo + step, loop_ext[d]))] + \
                [(0, e) for e in loop_ext[d + 1:]]
    yield from walk(0, [])


def _evaluate(comp: Comprehension, feeds: dict,
              dev: torch.device) -> torch.Tensor:
    loop_ext = [e for _, e in comp.loop_vars]
    inner = math.prod(e for _, e in comp.sum_vars)
    if not comp.sum_vars or math.prod(loop_ext) * inner <= ELEMENT_BUDGET:
        val = _block(comp, feeds, dev, [(0, e) for e in loop_ext])
    else:
        val = None
        for ranges in _chunks(loop_ext, inner, ELEMENT_BUDGET):
            part = _block(comp, feeds, dev, ranges)
            if val is None:
                val = torch.empty(tuple(loop_ext), dtype=part.dtype,
                                  device=dev)
            val[tuple(slice(lo, hi) for lo, hi in ranges)] = part
    if val.dtype == torch.int64:
        val = val.to(torch.int32)
    return val.contiguous()


def evaluate(comp: Comprehension, feeds: dict, device=None) -> torch.Tensor:
    """feeds: {tensor_name: array or tensor}, moved to ``device`` (None:
    the card, or an error where there is none). Returns a tensor of
    comp.shape on that device."""
    dev = resolve_device(device)
    feeds = {k: _as_tensor(v, dev) for k, v in feeds.items()}
    return _evaluate(comp, feeds, dev)


def evaluate_expr(comp: Comprehension, arrays: list,
                  device: torch.device) -> list:
    """MemBound-op lowering entry: positional inputs (on ``device``) in
    comp.inputs() order."""
    names = [t.name for t in comp.inputs()]
    return [_evaluate(comp, dict(zip(names, arrays)), device)]


def evaluate_program(program, feeds: dict, device=None) -> torch.Tensor:
    """Evaluate a multi-stage Program (nnet/rules.py) stage by stage; each
    stage's output becomes a feed for later stages. Returns the last stage's
    value (the reference evaluates nested RangeOps the same way)."""
    dev = resolve_device(device)
    env = {k: _as_tensor(v, dev) for k, v in feeds.items()}
    val = None
    for stage in program.stages:
        val = _evaluate(stage.comp, env, dev)
        env[stage.name] = val
    return val
