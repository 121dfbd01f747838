"""Tensor dump/load for cross-run debugging and weight persistence.

Reference analog: the optional protobuf tensor save/load
(reference proto/data.proto, src/utils/dataloader.cc, TensorObj::save/load).
Reuses the built-in ONNX TensorProto wire codec — one serialization format
across the whole frontend, no protobuf dependency.

Copy of infinitensor_tpu/utils/dataio.py over this package's onnx.proto;
the files it writes are byte for byte the JAX package's.
"""

from __future__ import annotations

import struct

import numpy as np

from infinitensor_tpu_torch.onnx import proto

MAGIC = b"ITPU0001"


def save_tensor(array: np.ndarray, path: str, name: str = "") -> None:
    tp = proto.TensorProto.from_numpy(np.ascontiguousarray(array), name)
    with open(path, "wb") as f:
        f.write(tp.serialize())


def load_tensor(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return proto.TensorProto.parse(f.read()).to_numpy()


def save_tensors(tensors: dict[str, np.ndarray], path: str) -> None:
    """Length-prefixed TensorProto stream (multi-tensor dump file)."""
    with open(path, "wb") as f:
        f.write(MAGIC)
        for name, arr in tensors.items():
            blob = proto.TensorProto.from_numpy(
                np.ascontiguousarray(arr), name).serialize()
            f.write(struct.pack("<q", len(blob)))
            f.write(blob)


def load_tensors(path: str) -> dict[str, np.ndarray]:
    out = {}
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError(f"{path}: not an ITPU tensor dump")
        while True:
            header = f.read(8)
            if not header:
                break
            (n,) = struct.unpack("<q", header)
            tp = proto.TensorProto.parse(f.read(n))
            out[tp.name] = tp.to_numpy()
    return out


def save_graph_weights(graph, path: str) -> None:
    """Persist all weight tensors of a graph (reference weight restore on
    re-malloc, onnx.py initializer handling)."""
    save_tensors({t.name: t.numpy() for t in graph.weights()}, path)


def load_graph_weights(graph, path: str) -> int:
    data = load_tensors(path)
    n = 0
    for t in graph.weights():
        if t.name in data:
            t.set_data(data[t.name])
            n += 1
    return n
