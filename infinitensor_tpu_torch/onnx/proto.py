"""ONNX protobuf messages over the wire codec.

Hand-written message classes for the subset of onnx.proto the frontend needs
(ModelProto / GraphProto / NodeProto / AttributeProto / TensorProto /
ValueInfoProto and friends), with numpy conversion for tensors. Field numbers
follow the public onnx.proto3 schema.

Copy of infinitensor_tpu/onnx/proto.py over this package's DataType and
native.onnx_wire: load_model takes the native initializer scan where the
library builds and scans cleanly, else the pure-Python parse (host
parsing; both give the same messages).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np

from infinitensor_tpu_torch.core.dtype import DataType
from infinitensor_tpu_torch.onnx import wire as w


# -- AttributeProto.AttributeType enum --------------------------------------
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_GRAPH = 5
ATTR_FLOATS = 6
ATTR_INTS = 7
ATTR_STRINGS = 8


@dataclasses.dataclass
class TensorProto:
    dims: list = dataclasses.field(default_factory=list)
    data_type: int = 1
    name: str = ""
    raw_data: bytes = b""
    float_data: list = dataclasses.field(default_factory=list)
    int32_data: list = dataclasses.field(default_factory=list)
    int64_data: list = dataclasses.field(default_factory=list)
    double_data: list = dataclasses.field(default_factory=list)
    uint64_data: list = dataclasses.field(default_factory=list)

    @staticmethod
    def parse(buf: bytes) -> "TensorProto":
        t = TensorProto()
        for field, wt, val in w.iter_fields(buf):
            if field == 1:
                if wt == w.LENGTH:
                    t.dims.extend(w.unpack_varints(val))
                else:
                    t.dims.append(w.to_signed64(val))
            elif field == 2:
                t.data_type = val
            elif field == 4:
                if wt == w.LENGTH:
                    t.float_data.extend(w.unpack_floats(val))
                else:
                    t.float_data.append(struct.unpack("<f", val)[0])
            elif field == 5:
                if wt == w.LENGTH:
                    t.int32_data.extend(w.unpack_varints(val))
                else:
                    t.int32_data.append(w.to_signed64(val))
            elif field == 7:
                if wt == w.LENGTH:
                    t.int64_data.extend(w.unpack_varints(val))
                else:
                    t.int64_data.append(w.to_signed64(val))
            elif field == 8:
                t.name = val.decode("utf-8")
            elif field == 9:
                t.raw_data = val
            elif field == 10:
                if wt == w.LENGTH:
                    t.double_data.extend(w.unpack_doubles(val))
                else:
                    t.double_data.append(struct.unpack("<d", val)[0])
            elif field == 11:
                if wt == w.LENGTH:
                    t.uint64_data.extend(w.unpack_varints(val, signed=False))
                else:
                    t.uint64_data.append(val)
        return t

    def serialize(self) -> bytes:
        out = bytearray()
        if self.dims:
            out += w.encode_packed_varints(1, self.dims)
        out += w.encode_field_varint(2, self.data_type)
        if self.name:
            out += w.encode_field_string(8, self.name)
        if self.raw_data:
            out += w.encode_field_bytes(9, self.raw_data)
        if self.float_data:
            out += w.encode_packed_floats(4, self.float_data)
        if self.int32_data:
            out += w.encode_packed_varints(5, self.int32_data)
        if self.int64_data:
            out += w.encode_packed_varints(7, self.int64_data)
        if self.double_data:
            out += w.encode_packed_doubles(10, self.double_data)
        if self.uint64_data:
            out += w.encode_packed_varints(11, self.uint64_data)
        return bytes(out)

    # -- numpy bridge -----------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        dt = DataType.from_onnx(self.data_type)
        shape = tuple(self.dims)
        if self.raw_data:
            if dt.size_bits < 8:
                raise NotImplementedError("sub-byte raw tensors")
            arr = np.frombuffer(self.raw_data, dtype=dt.np()).reshape(shape)
            return arr.copy()
        if self.float_data:
            return np.asarray(self.float_data, dtype=np.float32).reshape(shape)
        if self.int64_data:
            return np.asarray(self.int64_data, dtype=np.int64).reshape(shape)
        if self.double_data:
            return np.asarray(self.double_data, dtype=np.float64).reshape(shape)
        if self.uint64_data:
            return np.asarray(self.uint64_data, dtype=np.uint64).reshape(shape)
        if self.int32_data:
            # int32_data stores int32/int16/int8/uint8/bool/fp16/bf16 payloads
            arr = np.asarray(self.int32_data, dtype=np.int64)
            if dt.name == "float16":
                return arr.astype(np.uint16).view(np.float16).reshape(shape)
            if dt.name == "bfloat16":
                return arr.astype(np.uint16).view(dt.np()).reshape(shape)
            return arr.astype(dt.np()).reshape(shape)
        return np.zeros(shape, dtype=dt.np())

    @staticmethod
    def from_numpy(arr: np.ndarray, name: str = "") -> "TensorProto":
        dt = DataType.from_numpy(arr.dtype)
        return TensorProto(dims=list(arr.shape), data_type=dt.onnx_id,
                           name=name,
                           raw_data=np.ascontiguousarray(arr).tobytes())


@dataclasses.dataclass
class AttributeProto:
    name: str = ""
    type: int = 0
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional[TensorProto] = None
    floats: list = dataclasses.field(default_factory=list)
    ints: list = dataclasses.field(default_factory=list)
    strings: list = dataclasses.field(default_factory=list)

    @staticmethod
    def parse(buf: bytes) -> "AttributeProto":
        a = AttributeProto()
        for field, wt, val in w.iter_fields(buf):
            if field == 1:
                a.name = val.decode("utf-8")
            elif field == 2:
                a.f = struct.unpack("<f", val)[0]
            elif field == 3:
                a.i = w.to_signed64(val)
            elif field == 4:
                a.s = val
            elif field == 5:
                a.t = TensorProto.parse(val)
            elif field == 7:
                if wt == w.LENGTH:
                    a.floats.extend(w.unpack_floats(val))
                else:
                    a.floats.append(struct.unpack("<f", val)[0])
            elif field == 8:
                if wt == w.LENGTH:
                    a.ints.extend(w.unpack_varints(val))
                else:
                    a.ints.append(w.to_signed64(val))
            elif field == 9:
                a.strings.append(val)
            elif field == 20:
                a.type = val
        return a

    def serialize(self) -> bytes:
        out = bytearray()
        out += w.encode_field_string(1, self.name)
        if self.type:
            out += w.encode_field_varint(20, self.type)
        if self.type == ATTR_FLOAT:
            out += w.encode_field_float(2, self.f)
        elif self.type == ATTR_INT:
            out += w.encode_field_varint(3, self.i)
        elif self.type == ATTR_STRING:
            out += w.encode_field_bytes(4, self.s)
        elif self.type == ATTR_TENSOR and self.t is not None:
            out += w.encode_field_bytes(5, self.t.serialize())
        elif self.type == ATTR_FLOATS:
            out += w.encode_packed_floats(7, self.floats)
        elif self.type == ATTR_INTS:
            out += w.encode_packed_varints(8, self.ints)
        elif self.type == ATTR_STRINGS:
            for s in self.strings:
                out += w.encode_field_bytes(9, s)
        return bytes(out)

    # python-value bridge --------------------------------------------------
    def value(self):
        if self.type == ATTR_FLOAT:
            return self.f
        if self.type == ATTR_INT:
            return self.i
        if self.type == ATTR_STRING:
            return self.s.decode("utf-8")
        if self.type == ATTR_TENSOR:
            return self.t.to_numpy()
        if self.type == ATTR_FLOATS:
            return list(self.floats)
        if self.type == ATTR_INTS:
            return list(self.ints)
        if self.type == ATTR_STRINGS:
            return [s.decode("utf-8") for s in self.strings]
        return None

    @staticmethod
    def make(name: str, value) -> "AttributeProto":
        a = AttributeProto(name=name)
        if isinstance(value, bool):
            a.type, a.i = ATTR_INT, int(value)
        elif isinstance(value, (int, np.integer)):
            a.type, a.i = ATTR_INT, int(value)
        elif isinstance(value, (float, np.floating)):
            a.type, a.f = ATTR_FLOAT, float(value)
        elif isinstance(value, str):
            a.type, a.s = ATTR_STRING, value.encode("utf-8")
        elif isinstance(value, np.ndarray):
            a.type, a.t = ATTR_TENSOR, TensorProto.from_numpy(value)
        elif isinstance(value, (list, tuple)):
            if all(isinstance(v, (int, np.integer)) for v in value):
                a.type, a.ints = ATTR_INTS, [int(v) for v in value]
            elif all(isinstance(v, str) for v in value):
                a.type = ATTR_STRINGS
                a.strings = [v.encode("utf-8") for v in value]
            else:
                a.type, a.floats = ATTR_FLOATS, [float(v) for v in value]
        else:
            raise TypeError(f"cannot make attribute from {type(value)}")
        return a


@dataclasses.dataclass
class NodeProto:
    input: list = dataclasses.field(default_factory=list)
    output: list = dataclasses.field(default_factory=list)
    name: str = ""
    op_type: str = ""
    domain: str = ""
    attribute: list = dataclasses.field(default_factory=list)

    @staticmethod
    def parse(buf: bytes) -> "NodeProto":
        n = NodeProto()
        for field, wt, val in w.iter_fields(buf):
            if field == 1:
                n.input.append(val.decode("utf-8"))
            elif field == 2:
                n.output.append(val.decode("utf-8"))
            elif field == 3:
                n.name = val.decode("utf-8")
            elif field == 4:
                n.op_type = val.decode("utf-8")
            elif field == 5:
                n.attribute.append(AttributeProto.parse(val))
            elif field == 7:
                n.domain = val.decode("utf-8")
        return n

    def serialize(self) -> bytes:
        out = bytearray()
        for s in self.input:
            out += w.encode_field_string(1, s)
        for s in self.output:
            out += w.encode_field_string(2, s)
        if self.name:
            out += w.encode_field_string(3, self.name)
        out += w.encode_field_string(4, self.op_type)
        for a in self.attribute:
            out += w.encode_field_bytes(5, a.serialize())
        if self.domain:
            out += w.encode_field_string(7, self.domain)
        return bytes(out)

    def attrs(self) -> dict:
        return {a.name: a.value() for a in self.attribute}


@dataclasses.dataclass
class Dimension:
    dim_value: Optional[int] = None
    dim_param: str = ""

    @staticmethod
    def parse(buf):
        d = Dimension()
        for field, wt, val in w.iter_fields(buf):
            if field == 1:
                d.dim_value = w.to_signed64(val)
            elif field == 2:
                d.dim_param = val.decode("utf-8")
        return d

    def serialize(self):
        out = bytearray()
        if self.dim_value is not None:
            out += w.encode_field_varint(1, self.dim_value)
        elif self.dim_param:
            out += w.encode_field_string(2, self.dim_param)
        return bytes(out)


@dataclasses.dataclass
class TensorShapeProto:
    dim: list = dataclasses.field(default_factory=list)

    @staticmethod
    def parse(buf):
        s = TensorShapeProto()
        for field, wt, val in w.iter_fields(buf):
            if field == 1:
                s.dim.append(Dimension.parse(val))
        return s

    def serialize(self):
        return b"".join(w.encode_field_bytes(1, d.serialize()) for d in self.dim)


@dataclasses.dataclass
class TypeProtoTensor:
    elem_type: int = 1
    shape: TensorShapeProto = dataclasses.field(default_factory=TensorShapeProto)

    @staticmethod
    def parse(buf):
        t = TypeProtoTensor()
        for field, wt, val in w.iter_fields(buf):
            if field == 1:
                t.elem_type = val
            elif field == 2:
                t.shape = TensorShapeProto.parse(val)
        return t

    def serialize(self):
        out = bytearray(w.encode_field_varint(1, self.elem_type))
        out += w.encode_field_bytes(2, self.shape.serialize())
        return bytes(out)


@dataclasses.dataclass
class ValueInfoProto:
    name: str = ""
    tensor_type: Optional[TypeProtoTensor] = None

    @staticmethod
    def parse(buf):
        v = ValueInfoProto()
        for field, wt, val in w.iter_fields(buf):
            if field == 1:
                v.name = val.decode("utf-8")
            elif field == 2:
                for f2, wt2, val2 in w.iter_fields(val):  # TypeProto
                    if f2 == 1:
                        v.tensor_type = TypeProtoTensor.parse(val2)
        return v

    def serialize(self):
        out = bytearray(w.encode_field_string(1, self.name))
        if self.tensor_type is not None:
            type_proto = w.encode_field_bytes(1, self.tensor_type.serialize())
            out += w.encode_field_bytes(2, type_proto)
        return bytes(out)

    @staticmethod
    def make(name: str, elem_type: int, shape) -> "ValueInfoProto":
        tsp = TensorShapeProto(
            dim=[Dimension(dim_value=int(d)) for d in shape])
        return ValueInfoProto(name=name,
                              tensor_type=TypeProtoTensor(elem_type, tsp))

    def np_shape(self) -> tuple:
        if self.tensor_type is None:
            return ()
        dims = []
        for d in self.tensor_type.shape.dim:
            dims.append(d.dim_value if d.dim_value is not None else -1)
        return tuple(dims)


@dataclasses.dataclass
class GraphProto:
    node: list = dataclasses.field(default_factory=list)
    name: str = ""
    initializer: list = dataclasses.field(default_factory=list)
    input: list = dataclasses.field(default_factory=list)
    output: list = dataclasses.field(default_factory=list)
    value_info: list = dataclasses.field(default_factory=list)

    @staticmethod
    def parse(buf):
        g = GraphProto()
        for field, wt, val in w.iter_fields(buf):
            if field == 1:
                g.node.append(NodeProto.parse(val))
            elif field == 2:
                g.name = val.decode("utf-8")
            elif field == 5:
                g.initializer.append(TensorProto.parse(val))
            elif field == 11:
                g.input.append(ValueInfoProto.parse(val))
            elif field == 12:
                g.output.append(ValueInfoProto.parse(val))
            elif field == 13:
                g.value_info.append(ValueInfoProto.parse(val))
        return g

    def serialize(self):
        out = bytearray()
        for n in self.node:
            out += w.encode_field_bytes(1, n.serialize())
        if self.name:
            out += w.encode_field_string(2, self.name)
        for t in self.initializer:
            out += w.encode_field_bytes(5, t.serialize())
        for v in self.input:
            out += w.encode_field_bytes(11, v.serialize())
        for v in self.output:
            out += w.encode_field_bytes(12, v.serialize())
        for v in self.value_info:
            out += w.encode_field_bytes(13, v.serialize())
        return bytes(out)


@dataclasses.dataclass
class OperatorSetId:
    domain: str = ""
    version: int = 17

    @staticmethod
    def parse(buf):
        o = OperatorSetId()
        for field, wt, val in w.iter_fields(buf):
            if field == 1:
                o.domain = val.decode("utf-8")
            elif field == 2:
                o.version = w.to_signed64(val)
        return o

    def serialize(self):
        out = bytearray()
        if self.domain:
            out += w.encode_field_string(1, self.domain)
        out += w.encode_field_varint(2, self.version)
        return bytes(out)


@dataclasses.dataclass
class ModelProto:
    ir_version: int = 8
    producer_name: str = "infinitensor_tpu"
    graph: GraphProto = dataclasses.field(default_factory=GraphProto)
    opset_import: list = dataclasses.field(default_factory=list)

    @staticmethod
    def parse(buf: bytes) -> "ModelProto":
        m = ModelProto(opset_import=[])
        for field, wt, val in w.iter_fields(buf):
            if field == 1:
                m.ir_version = w.to_signed64(val)
            elif field == 2:
                m.producer_name = val.decode("utf-8")
            elif field == 7:
                m.graph = GraphProto.parse(val)
            elif field == 8:
                m.opset_import.append(OperatorSetId.parse(val))
        if not m.opset_import:
            m.opset_import = [OperatorSetId()]
        return m

    def serialize(self) -> bytes:
        out = bytearray()
        out += w.encode_field_varint(1, self.ir_version)
        out += w.encode_field_string(2, self.producer_name)
        out += w.encode_field_bytes(7, self.graph.serialize())
        for o in (self.opset_import or [OperatorSetId()]):
            out += w.encode_field_bytes(8, o.serialize())
        return bytes(out)

    def opset_version(self, domain: str = "") -> int:
        for o in self.opset_import:
            if o.domain == domain:
                return o.version
        return 17


class LazyTensorProto:
    """Initializer view over the serialized model buffer (native-scan fast
    path, native/onnx_wire.cc): name/dtype/dims come from the native index;
    payload bytes stay in place and ``to_numpy`` maps them with a zero-copy
    ``numpy.frombuffer`` view. Mirrors the reference's native weight path
    where Python never touches initializer bytes
    (src/ffi/ffi_infinitensor.cc:478-541)."""

    __slots__ = ("_buf", "_desc")

    def __init__(self, buf: bytes, desc):
        self._buf = buf
        self._desc = desc

    @property
    def name(self) -> str:
        return self._desc.name

    @property
    def dims(self) -> list:
        return list(self._desc.dims)

    @property
    def data_type(self) -> int:
        return self._desc.data_type

    def _materialize(self) -> TensorProto:
        d = self._desc
        return TensorProto.parse(self._buf[d.msg_off:d.msg_off + d.msg_len])

    def __getattr__(self, attr):  # raw_data / int64_data / ... on demand
        return getattr(self._materialize(), attr)

    def serialize(self) -> bytes:
        # the original span IS a valid TensorProto encoding
        d = self._desc
        return bytes(self._buf[d.msg_off:d.msg_off + d.msg_len])

    def to_numpy(self) -> np.ndarray:
        from infinitensor_tpu_torch.native import onnx_wire as ow

        d = self._desc
        dt = DataType.from_onnx(d.data_type)
        shape = tuple(d.dims)
        count = 1
        for s in shape:
            count *= int(s)
        if d.data_kind == ow.KIND_RAW and dt.size_bits >= 8 and \
                count * dt.size_bits // 8 <= d.data_len:
            arr = np.frombuffer(self._buf, dtype=dt.np(), count=count,
                                offset=d.data_off)
            return arr.reshape(shape)
        if d.data_kind == ow.KIND_FLOAT and count * 4 <= d.data_len:
            return np.frombuffer(self._buf, dtype="<f4", count=count,
                                 offset=d.data_off).reshape(shape)
        if d.data_kind == ow.KIND_DOUBLE and count * 8 <= d.data_len:
            return np.frombuffer(self._buf, dtype="<f8", count=count,
                                 offset=d.data_off).reshape(shape)
        # varint-packed ints, irregular layouts, empty payloads: full parse
        return self._materialize().to_numpy()


def _parse_graph_scanned(buf: bytes, scan) -> GraphProto:
    """GraphProto parse that takes initializers from the native scan and
    never slices their payload bytes."""
    g = GraphProto()
    g.initializer = [LazyTensorProto(buf, d) for d in scan.initializers]
    for field, wt, val in w.iter_field_spans(buf, scan.graph_off,
                                             scan.graph_off + scan.graph_len):
        if field == 5:
            continue  # initializer — already indexed natively
        if not isinstance(val, tuple):
            continue
        s, e = val
        if field == 1:
            g.node.append(NodeProto.parse(buf[s:e]))
        elif field == 2:
            g.name = buf[s:e].decode("utf-8")
        elif field == 11:
            g.input.append(ValueInfoProto.parse(buf[s:e]))
        elif field == 12:
            g.output.append(ValueInfoProto.parse(buf[s:e]))
        elif field == 13:
            g.value_info.append(ValueInfoProto.parse(buf[s:e]))
    return g


def _load_model_scanned(data: bytes) -> Optional[ModelProto]:
    """Native-scan fast path for load_model; None -> pure-Python fallback."""
    try:
        from infinitensor_tpu_torch.native.onnx_wire import scan_model
        scan = scan_model(data)
    except Exception:
        return None
    if scan is None:
        return None
    m = ModelProto(opset_import=[])
    m.graph = _parse_graph_scanned(data, scan)
    for field, wt, val in w.iter_field_spans(data):
        if field == 1 and not isinstance(val, tuple):
            m.ir_version = w.to_signed64(val)
        elif field == 2 and isinstance(val, tuple):
            m.producer_name = data[val[0]:val[1]].decode("utf-8")
        elif field == 8 and isinstance(val, tuple):
            m.opset_import.append(OperatorSetId.parse(data[val[0]:val[1]]))
    if not m.opset_import:
        m.opset_import = [OperatorSetId()]
    return m


def load_model(path_or_bytes) -> ModelProto:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    m = _load_model_scanned(data)
    return m if m is not None else ModelProto.parse(data)


def save_model(model: ModelProto, path: str) -> None:
    with open(path, "wb") as f:
        f.write(model.serialize())
