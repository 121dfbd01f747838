"""ctypes bindings for the native ONNX wire scanner (native/onnx_wire.cc).

The scanner is the weight-ingestion fast path: it indexes every initializer
(name / dtype / dims / payload span) in one native pass over the serialized
model, so multi-GB weight blobs are mapped with zero-copy ``numpy.frombuffer``
views instead of being sliced byte-by-byte through the Python wire codec
(reference keeps this entire path native behind pybind11:
src/ffi/ffi_infinitensor.cc:478-541). Built on demand with g++; the .so is
cached next to the source.

Copy of infinitensor_tpu/native/onnx_wire.py. It sits at the same depth
below the repo root, so it binds the same native/onnx_wire.cc and the same
library (native/_load.py builds and loads it).
"""

from __future__ import annotations

import ctypes
import dataclasses
import subprocess
from typing import Optional

import numpy as np

from infinitensor_tpu_torch.native._load import load, source

_SRC = source("onnx_wire.cc")
_LIB: Optional[ctypes.CDLL] = None
_LIB_ERR: Optional[str] = None

MAX_DIMS = 12

# TensorProto payload-field numbers double as data-kind codes
KIND_NONE = 0
KIND_IRREGULAR = -1
KIND_FLOAT = 4      # packed float_data
KIND_INT32 = 5      # packed varints
KIND_INT64 = 7      # packed varints
KIND_RAW = 9        # raw_data bytes
KIND_DOUBLE = 10    # packed double_data
KIND_UINT64 = 11    # packed varints


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    try:
        lib = load(_SRC, "onnxwire")
        lib.onnx_locate_graph.restype = ctypes.c_int
        lib.onnx_count_initializers.restype = ctypes.c_int64
        lib.onnx_scan_initializers.restype = ctypes.c_int64
        _LIB = lib
    except (OSError, subprocess.CalledProcessError) as e:
        _LIB_ERR = str(e)
    return _LIB


def native_available() -> bool:
    return _lib() is not None


@dataclasses.dataclass
class InitDesc:
    """Descriptor of one initializer within the model buffer (all offsets
    absolute)."""
    msg_off: int
    msg_len: int
    name: str
    data_type: int
    dims: tuple
    data_kind: int
    data_off: int
    data_len: int


@dataclasses.dataclass
class ModelScan:
    graph_off: int
    graph_len: int
    initializers: list


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _p32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def scan_model(data: bytes) -> Optional[ModelScan]:
    """Locate the GraphProto and index all initializers in one native pass.
    Returns None when the native library is unavailable or the buffer does
    not scan cleanly (caller falls back to the pure-Python parser)."""
    lib = _lib()
    if lib is None:
        return None
    buf = (ctypes.c_char * len(data)).from_buffer_copy(data) \
        if isinstance(data, bytearray) else data
    goff = ctypes.c_int64()
    glen = ctypes.c_int64()
    rc = lib.onnx_locate_graph(buf, ctypes.c_int64(len(data)),
                               ctypes.byref(goff), ctypes.byref(glen))
    if rc != 0:
        return None
    n = lib.onnx_count_initializers(buf, goff, glen)
    if n < 0:
        return None
    if n == 0:
        return ModelScan(goff.value, glen.value, [])
    msg_off = np.empty(n, np.int64)
    msg_len = np.empty(n, np.int64)
    name_off = np.empty(n, np.int64)
    name_len = np.empty(n, np.int64)
    data_type = np.empty(n, np.int32)
    n_dims = np.empty(n, np.int32)
    dims = np.empty(n * MAX_DIMS, np.int64)
    data_kind = np.empty(n, np.int32)
    data_off = np.empty(n, np.int64)
    data_len = np.empty(n, np.int64)
    filled = lib.onnx_scan_initializers(
        buf, goff, glen, ctypes.c_int64(n),
        _p64(msg_off), _p64(msg_len), _p64(name_off), _p64(name_len),
        _p32(data_type), _p32(n_dims), _p64(dims), _p32(data_kind),
        _p64(data_off), _p64(data_len))
    if filled != n:
        return None
    inits = []
    for i in range(n):
        nd = int(n_dims[i])
        inits.append(InitDesc(
            msg_off=int(msg_off[i]), msg_len=int(msg_len[i]),
            name=bytes(data[name_off[i]:name_off[i] + name_len[i]])
            .decode("utf-8"),
            data_type=int(data_type[i]),
            dims=tuple(int(d) for d in
                       dims[i * MAX_DIMS:i * MAX_DIMS + max(nd, 0)]),
            data_kind=int(data_kind[i]),
            data_off=int(data_off[i]), data_len=int(data_len[i])))
    return ModelScan(goff.value, glen.value, inits)
