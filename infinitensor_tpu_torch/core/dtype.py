"""Data types, ONNX-indexed, with numpy/torch mappings.

Copy of infinitensor_tpu/core/dtype.py with DataType.jnp() replaced by
DataType.torch() (and from_jnp by from_torch).

Mirrors the capability of the reference's ONNX-indexed dtype table
(reference include/core/data_type.h:6-50) but adds the TPU-relevant
low-precision types (bf16 first-class, fp8, int4) since quantized
serving is the north star.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class _DTypeInfo:
    name: str
    onnx_id: int
    size_bits: int  # per element; int4 is sub-byte
    np_dtype: Optional[np.dtype]  # None for types numpy can't hold natively
    is_float: bool
    is_int: bool


class DataType:
    """ONNX-indexed dtype registry. Instances are interned singletons."""

    _by_onnx: dict[int, "DataType"] = {}
    _by_name: dict[str, "DataType"] = {}

    def __init__(self, info: _DTypeInfo):
        self._info = info
        DataType._by_onnx[info.onnx_id] = self
        DataType._by_name[info.name] = self

    # -- identity ----------------------------------------------------------
    @property
    def name(self) -> str:
        return self._info.name

    @property
    def onnx_id(self) -> int:
        return self._info.onnx_id

    @property
    def size_bits(self) -> int:
        return self._info.size_bits

    @property
    def size(self) -> int:
        """Bytes per element (rounded up for sub-byte types)."""
        return max(1, self._info.size_bits // 8)

    @property
    def is_float(self) -> bool:
        return self._info.is_float

    @property
    def is_int(self) -> bool:
        return self._info.is_int

    def np(self) -> np.dtype:
        if self._info.np_dtype is None:
            raise TypeError(f"dtype {self.name} has no numpy equivalent")
        return self._info.np_dtype

    def torch(self):
        """The torch dtype for this DataType (lazy import). torch has no
        int4 or uint4 element type: those raise TypeError, as np() does
        for a type numpy cannot hold."""
        import torch

        table = {
            "float32": torch.float32,
            "float16": torch.float16,
            "bfloat16": torch.bfloat16,
            "float64": torch.float64,
            "int8": torch.int8,
            "int16": torch.int16,
            "int32": torch.int32,
            "int64": torch.int64,
            "uint8": torch.uint8,
            "uint16": torch.uint16,
            "uint32": torch.uint32,
            "uint64": torch.uint64,
            "bool": torch.bool,
            "float8_e4m3fn": torch.float8_e4m3fn,
            "float8_e5m2": torch.float8_e5m2,
        }
        if self.name not in table:
            raise TypeError(f"dtype {self.name} has no torch equivalent")
        return table[self.name]

    def __repr__(self) -> str:
        return f"DataType.{self.name}"

    def __hash__(self) -> int:
        return hash(self._info.onnx_id)

    def __eq__(self, other) -> bool:
        return isinstance(other, DataType) and other._info.onnx_id == self._info.onnx_id

    # -- lookups -----------------------------------------------------------
    @staticmethod
    def from_onnx(onnx_id: int) -> "DataType":
        try:
            return DataType._by_onnx[onnx_id]
        except KeyError:
            raise ValueError(f"unsupported ONNX dtype id {onnx_id}") from None

    @staticmethod
    def from_name(name: str) -> "DataType":
        return DataType._by_name[name]

    @staticmethod
    def from_numpy(dt) -> "DataType":
        dt = np.dtype(dt)
        for d in DataType._by_onnx.values():
            if d._info.np_dtype is not None and d._info.np_dtype == dt:
                return d
        raise ValueError(f"no DataType for numpy dtype {dt}")

    @staticmethod
    def from_torch(dt) -> "DataType":
        name = str(dt).removeprefix("torch.")
        if name in DataType._by_name:
            return DataType._by_name[name]
        raise ValueError(f"no DataType for torch dtype {dt}")


def _mk(name, onnx_id, bits, np_dtype, is_float=False, is_int=False):
    return DataType(_DTypeInfo(name, onnx_id, bits, np.dtype(np_dtype) if np_dtype else None, is_float, is_int))


# ONNX TensorProto.DataType indices.
FLOAT32 = _mk("float32", 1, 32, np.float32, is_float=True)
UINT8 = _mk("uint8", 2, 8, np.uint8, is_int=True)
INT8 = _mk("int8", 3, 8, np.int8, is_int=True)
UINT16 = _mk("uint16", 4, 16, np.uint16, is_int=True)
INT16 = _mk("int16", 5, 16, np.int16, is_int=True)
INT32 = _mk("int32", 6, 32, np.int32, is_int=True)
INT64 = _mk("int64", 7, 64, np.int64, is_int=True)
BOOL = _mk("bool", 9, 8, np.bool_)
FLOAT16 = _mk("float16", 10, 16, np.float16, is_float=True)
FLOAT64 = _mk("float64", 11, 64, np.float64, is_float=True)
UINT32 = _mk("uint32", 12, 32, np.uint32, is_int=True)
UINT64 = _mk("uint64", 13, 64, np.uint64, is_int=True)
BFLOAT16 = _mk("bfloat16", 16, 16, None, is_float=True)
FLOAT8_E4M3FN = _mk("float8_e4m3fn", 17, 8, None, is_float=True)
FLOAT8_E5M2 = _mk("float8_e5m2", 19, 8, None, is_float=True)
UINT4 = _mk("uint4", 21, 4, None, is_int=True)
INT4 = _mk("int4", 22, 4, None, is_int=True)

# numpy>=1.24 has no native bfloat16; ml_dtypes provides one.
try:  # pragma: no cover - environment dependent
    import ml_dtypes

    object.__setattr__(BFLOAT16._info, "np_dtype", np.dtype(ml_dtypes.bfloat16))
    object.__setattr__(FLOAT8_E4M3FN._info, "np_dtype", np.dtype(ml_dtypes.float8_e4m3fn))
    object.__setattr__(FLOAT8_E5M2._info, "np_dtype", np.dtype(ml_dtypes.float8_e5m2))
    object.__setattr__(INT4._info, "np_dtype", np.dtype(ml_dtypes.int4))
    object.__setattr__(UINT4._info, "np_dtype", np.dtype(ml_dtypes.uint4))
except ImportError:
    pass
