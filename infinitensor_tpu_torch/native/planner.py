"""ctypes bindings for the native memory planner (native/allocator.cc).

The C++ planner mirrors the reference's LazyAllocator + dataMalloc simulation
(reference src/core/lazy_allocator.cc, src/core/graph.cc:341-560). Built on
demand with g++ (no pybind11 in this environment); the .so is cached next to
the sources and rebuilt when allocator.cc changes.

Copy of infinitensor_tpu/native/planner.py bound to this package's graph
IR and config. It sits at the same depth below the repo root, so it binds
the same native/allocator.cc and the same library (native/_load.py builds
and loads it). The plan is of the graph IR's tensors: the
executor itself allocates through PyTorch's caching allocator (or a
captured CUDA graph's pool), so the plan is a report, not the layout.
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import Optional

import numpy as np

from infinitensor_tpu_torch.core.tensor import TensorRole
from infinitensor_tpu_torch.native._load import load, source
from infinitensor_tpu_torch.utils.config import config

_SRC = source("allocator.cc")
_LIB: Optional[ctypes.CDLL] = None
_LIB_ERR: Optional[str] = None


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    try:
        lib = load(_SRC, "allocator")
        lib.planner_create.restype = ctypes.c_int64
        for fn in ("planner_alloc", "planner_alloc_weight", "planner_peak",
                   "planner_used", "planner_arena_size",
                   "planner_weight_size", "planner_free_block_count"):
            getattr(lib, fn).restype = ctypes.c_int64
        lib.planner_alloc.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.planner_alloc_weight.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.planner_free.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.plan_graph_memory.restype = ctypes.c_int
        _LIB = lib
    except (OSError, subprocess.CalledProcessError) as e:
        _LIB_ERR = str(e)
    return _LIB


def native_available() -> bool:
    return _lib() is not None


class MemoryPlanner:
    """Best-fit offset-simulation allocator (native)."""

    def __init__(self):
        lib = _lib()
        if lib is None:
            raise RuntimeError(f"native planner unavailable: {_LIB_ERR}")
        self._lib = lib
        self._id = lib.planner_create()

    def __del__(self):
        try:
            self._lib.planner_destroy(ctypes.c_int64(self._id))
        except Exception:
            pass

    def alloc(self, size: int) -> int:
        return self._lib.planner_alloc(self._id, size)

    def free(self, addr: int) -> None:
        self._lib.planner_free(self._id, addr)

    def alloc_weight(self, size: int) -> int:
        return self._lib.planner_alloc_weight(self._id, size)

    @property
    def peak(self) -> int:
        return self._lib.planner_peak(self._id)

    @property
    def used(self) -> int:
        return self._lib.planner_used(self._id)

    @property
    def arena_size(self) -> int:
        return self._lib.planner_arena_size(self._id)

    @property
    def free_block_count(self) -> int:
        return self._lib.planner_free_block_count(self._id)


def _liveness(graph):
    """Per-activation live interval [def_step, last_use_step] over the
    topo order (inputs/outputs/weights live forever)."""
    n_ops = len(graph.operators)
    live = {}
    for step, op in enumerate(graph.operators):
        for t in op.outputs:
            if t.role == TensorRole.OTHERS:
                live.setdefault(t.guid, [step, step])
        for t in op.present_inputs():
            if t.guid in live:
                live[t.guid][1] = step
    for t in graph.tensors:
        if t.role == TensorRole.OTHERS and t.guid in live and not t.targets:
            live[t.guid][1] = n_ops  # produced-but-unconsumed: pin to end
    return live


def validate_memory_plan(graph, plan: dict) -> list:
    """Reference validateMemory analog (graph.cc:605-622): two activations
    whose live intervals overlap must not share bytes. Returns a list of
    violation strings (empty = plan is sound)."""
    live = _liveness(graph)
    acts = [t for t in graph.tensors
            if t.role == TensorRole.OTHERS and t.name in plan["offsets"]
            and t.guid in live]
    issues = []
    for i, a in enumerate(acts):
        ao, ab = plan["offsets"][a.name], a.bytes()
        for b in acts[i + 1:]:
            la, lb = live[a.guid], live[b.guid]
            if la[0] <= lb[1] and lb[0] <= la[1]:       # intervals overlap
                bo, bb = plan["offsets"][b.name], b.bytes()
                if ao < bo + bb and bo < ao + ab:       # bytes overlap
                    issues.append(
                        f"{a.name}[{ao},{ao + ab}) overlaps "
                        f"{b.name}[{bo},{bo + bb}) while both live "
                        f"(steps {la} vs {lb})")
    return issues


def _plan_naive(graph) -> dict:
    """Debug allocator: every activation gets its own region, no reuse
    (reference naive-allocator mode, graph.cc:371-380) — planted bugs in
    reuse logic disappear under this mode, which is how you bisect them."""
    offsets, cursor, weight_bytes = {}, 0, 0
    align = 256
    for t in graph.tensors:
        if t.role == TensorRole.WEIGHT:
            weight_bytes += t.bytes()
        elif t.role == TensorRole.OTHERS and t.source is not None:
            offsets[t.name] = cursor
            cursor += -(-t.bytes() // align) * align
    return {"offsets": offsets, "peak_bytes": cursor,
            "arena_bytes": cursor, "weight_bytes": weight_bytes,
            "naive": True}


def plan_graph_memory(graph, naive: Optional[bool] = None,
                      validate: Optional[bool] = None) -> dict:
    """Plan activation memory for a Graph; returns offsets + stats
    (engine-level peak-memory report, reference LazyAllocator::info).
    ``naive`` disables reuse (debug mode); ``validate`` cross-checks the
    plan against liveness. Both default from utils/config.py."""
    if naive is None:
        naive = config.naive_allocator
    if validate is None:
        validate = config.validate_memory

    graph.require_sorted()
    if naive:
        plan = _plan_naive(graph)
        issues = validate_memory_plan(graph, plan) if validate else []
        if issues:
            raise RuntimeError("naive plan overlap (impossible): "
                               + "; ".join(issues))
        return plan
    plan = _plan_native(graph)
    if validate:
        issues = validate_memory_plan(graph, plan)
        if issues:
            raise RuntimeError("memory plan violates liveness: "
                               + "; ".join(issues[:5]))
    return plan


def _plan_native(graph) -> dict:
    graph.require_sorted()
    tensors = list(graph.tensors)
    tidx = {t.guid: i for i, t in enumerate(tensors)}
    sizes = np.asarray([t.bytes() for t in tensors], np.int64)
    kind_map = {TensorRole.OTHERS: 0, TensorRole.WEIGHT: 1,
                TensorRole.INPUT: 2, TensorRole.OUTPUT: 3}
    kinds = np.asarray([kind_map[t.role] for t in tensors], np.int32)

    in_ptr, in_idx, out_ptr, out_idx = [0], [], [0], []
    for op in graph.operators:
        for t in op.present_inputs():
            in_idx.append(tidx[t.guid])
        in_ptr.append(len(in_idx))
        for t in op.outputs:
            out_idx.append(tidx[t.guid])
        out_ptr.append(len(out_idx))

    lib = _lib()
    if lib is None:
        raise RuntimeError(f"native planner unavailable: {_LIB_ERR}")
    offsets = np.zeros(len(tensors), np.int64)
    stats = np.zeros(3, np.int64)

    def p64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    in_ptr = np.asarray(in_ptr, np.int64)
    in_idx = np.asarray(in_idx, np.int64)
    out_ptr = np.asarray(out_ptr, np.int64)
    out_idx = np.asarray(out_idx, np.int64)
    rc = lib.plan_graph_memory(
        ctypes.c_int64(len(tensors)), p64(sizes),
        kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(len(graph.operators)),
        p64(in_ptr), p64(in_idx), p64(out_ptr), p64(out_idx),
        p64(offsets), p64(stats))
    if rc != 0:
        raise RuntimeError("plan_graph_memory failed")
    return {
        "offsets": {t.name: int(o) for t, o in zip(tensors, offsets)
                    if o >= 0},
        "peak_bytes": int(stats[0]),
        "arena_bytes": int(stats[1]),
        "weight_bytes": int(stats[2]),
    }
