"""ctypes bindings for the native graph scheduler (native/graph_core.cc).

Mirrors the reference's C++ graph core (reference src/core/graph.cc:152-182
topo_sort, graph.cc:341-560 liveness): Kahn topological sort and tensor
first-def/last-use analysis over op->tensor CSR arrays. Built on demand with
g++ (no pybind11 needed); the .so is cached next to the source, at the
repository root's native/, shared with the JAX package's binding. Where it
cannot be built or loaded, topo_sort raises RuntimeError and Graph.topo_sort
takes its Python sort. Copy of infinitensor_tpu/native/graph_core.py.
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import Optional

import numpy as np

from infinitensor_tpu_torch.native._load import load, source

_SRC = source("graph_core.cc")
_LIB: Optional[ctypes.CDLL] = None
_LIB_ERR: Optional[str] = None


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    try:
        lib = load(_SRC, "graphcore")
        lib.graph_topo_sort.restype = ctypes.c_int64
        lib.workload_hash.restype = ctypes.c_uint64
        _LIB = lib
    except (OSError, subprocess.CalledProcessError) as e:
        _LIB_ERR = str(e)
    return _LIB


def native_available() -> bool:
    return _lib() is not None


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _graph_csr(graph):
    """op->tensor CSR arrays + the tensor list (guid-indexed)."""
    tensors = list(graph.tensors)
    tidx = {t.guid: i for i, t in enumerate(tensors)}
    in_ptr, in_idx, out_ptr, out_idx = [0], [], [0], []
    for op in graph.operators:
        for t in op.inputs:
            if t is not None and t.guid in tidx:
                in_idx.append(tidx[t.guid])
        in_ptr.append(len(in_idx))
        for t in op.outputs:
            out_idx.append(tidx[t.guid])
        out_ptr.append(len(out_idx))
    return (tensors,
            np.asarray(in_ptr, np.int64), np.asarray(in_idx, np.int64),
            np.asarray(out_ptr, np.int64), np.asarray(out_idx, np.int64))


def topo_sort(graph) -> Optional[list]:
    """Return the ops of ``graph`` in topological order, or None on a cycle.
    Raises RuntimeError if the native library is unavailable."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(f"native graph core unavailable: {_LIB_ERR}")
    n_ops = len(graph.operators)
    tensors, in_ptr, in_idx, out_ptr, out_idx = _graph_csr(graph)
    order = np.empty(n_ops, np.int64)
    n_sorted = lib.graph_topo_sort(
        ctypes.c_int64(n_ops), ctypes.c_int64(len(tensors)),
        _p64(in_ptr), _p64(in_idx), _p64(out_ptr), _p64(out_idx),
        _p64(order))
    if n_sorted != n_ops:
        return None
    ops = graph.operators
    return [ops[i] for i in order]


def liveness(graph) -> dict:
    """first-def / last-use schedule positions per tensor name (-1 = not
    defined / never consumed). Requires a sorted graph."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(f"native graph core unavailable: {_LIB_ERR}")
    graph.require_sorted()
    n_ops = len(graph.operators)
    tensors, in_ptr, in_idx, out_ptr, out_idx = _graph_csr(graph)
    order = np.arange(n_ops, dtype=np.int64)
    first = np.empty(len(tensors), np.int64)
    last = np.empty(len(tensors), np.int64)
    lib.graph_liveness(
        ctypes.c_int64(n_ops), ctypes.c_int64(len(tensors)), _p64(order),
        _p64(in_ptr), _p64(in_idx), _p64(out_ptr), _p64(out_idx),
        _p64(first), _p64(last))
    return {t.name: (int(f), int(l))
            for t, f, l in zip(tensors, first, last)}


def workload_hash(vec) -> int:
    """FNV-1a over an int64 workload vector (reference getOpPerfKey hash)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(f"native graph core unavailable: {_LIB_ERR}")
    arr = np.ascontiguousarray(vec, np.int64)
    return int(lib.workload_hash(_p64(arr), ctypes.c_int64(arr.size)))
