"""Graph tensors.

TensorObj mirrors the reference's tensor (reference include/core/tensor.h:20-163,
tensor_base.h:9-60): shape + dtype + role, a producer edge and consumer edges,
and optional host data for weights/constants. Unlike the reference there is no
device blob here: device tensors belong to the executor (runtime/executor.py),
and the graph IR holds only metadata and host constants.

Copy of infinitensor_tpu/core/tensor.py (no jax code).
"""

from __future__ import annotations

import enum
import itertools
from typing import Optional, Sequence, TYPE_CHECKING

import numpy as np

from infinitensor_tpu_torch.core.dtype import DataType

if TYPE_CHECKING:
    from infinitensor_tpu_torch.core.operator import Operator

_guid_counter = itertools.count(1)


class TensorRole(enum.Enum):
    """Drives memory planning / executor argument classification
    (reference include/core/tensor.h TensorType {weight,input,output,others})."""

    WEIGHT = "weight"    # constant parameter; jit-donatable, shardable
    INPUT = "input"      # graph input fed per call
    OUTPUT = "output"    # graph output fetched per call
    OTHERS = "others"    # intermediate activation


class TensorObj:
    __slots__ = (
        "name", "shape", "dtype", "role", "data", "source", "targets", "guid",
        "fuid",
    )

    def __init__(
        self,
        shape: Sequence[int],
        dtype: DataType,
        name: Optional[str] = None,
        role: TensorRole = TensorRole.OTHERS,
        data: Optional[np.ndarray] = None,
    ):
        self.guid: int = next(_guid_counter)
        # fuid: family id, shared across clones (reference include/core/object.h Fuid)
        self.fuid: int = self.guid
        self.name: str = name if name is not None else f"t{self.guid}"
        self.shape: tuple[int, ...] = tuple(int(d) for d in shape)
        self.dtype: DataType = dtype
        self.role: TensorRole = role
        self.data: Optional[np.ndarray] = data
        self.source: Optional["Operator"] = None
        self.targets: list["Operator"] = []

    # -- shape helpers -----------------------------------------------------
    @property
    def rank(self) -> int:
        return len(self.shape)

    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def bytes(self) -> int:
        return (self.size() * self.dtype.size_bits + 7) // 8

    # -- data --------------------------------------------------------------
    def has_data(self) -> bool:
        return self.data is not None

    def set_data(self, array: np.ndarray) -> None:
        array = np.ascontiguousarray(array)
        if tuple(array.shape) != self.shape:
            if array.size != self.size():
                raise ValueError(
                    f"data shape {array.shape} incompatible with tensor {self.shape}")
            array = array.reshape(self.shape)
        self.data = array

    def numpy(self) -> np.ndarray:
        if self.data is None:
            raise ValueError(f"tensor {self.name} has no host data")
        return self.data

    # -- graph edges -------------------------------------------------------
    def add_target(self, op: "Operator") -> None:
        self.targets.append(op)

    def remove_target(self, op: "Operator") -> None:
        self.targets = [t for t in self.targets if t is not op]

    def clone_spec(self) -> "TensorObj":
        t = TensorObj(self.shape, self.dtype, name=self.name + "_clone", role=self.role)
        t.fuid = self.fuid
        return t

    def __repr__(self) -> str:
        return (f"Tensor({self.name}, {list(self.shape)}, {self.dtype.name}, "
                f"{self.role.value})")


def equal_data(a: np.ndarray, b: np.ndarray, rtol: float = 1e-3, atol: float = 1e-3) -> bool:
    """Relative-error compare (reference tensor.cc equalData)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        return False
    return bool(np.allclose(a, b, rtol=rtol, atol=atol))
