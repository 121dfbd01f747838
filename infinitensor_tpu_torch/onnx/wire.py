"""Protocol-buffers wire-format codec (no protobuf dependency).

The environment ships no ``onnx``/``protobuf`` packages, so the ONNX frontend
carries its own minimal, dependency-free wire codec. Covers everything ONNX
uses: varint / 64-bit / length-delimited / 32-bit fields, packed repeated
scalars, nested messages.

Wire format: each field is a tag varint ``(field_number << 3) | wire_type``
followed by the payload. Varints are little-endian base-128; negative int64
values occupy 10 bytes (two's complement).

Copy of infinitensor_tpu/onnx/wire.py (no jax code).
"""

from __future__ import annotations

import struct
from typing import Iterator, Tuple, Union

VARINT = 0
FIXED64 = 1
LENGTH = 2
FIXED32 = 5


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def encode_varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # two's complement, 10-byte form
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_tag(field: int, wire_type: int) -> bytes:
    return encode_varint((field << 3) | wire_type)


def encode_field_varint(field: int, value: int) -> bytes:
    return encode_tag(field, VARINT) + encode_varint(value)


def encode_field_bytes(field: int, payload: bytes) -> bytes:
    return encode_tag(field, LENGTH) + encode_varint(len(payload)) + payload


def encode_field_string(field: int, s: str) -> bytes:
    return encode_field_bytes(field, s.encode("utf-8"))


def encode_field_float(field: int, value: float) -> bytes:
    return encode_tag(field, FIXED32) + struct.pack("<f", value)


def encode_field_double(field: int, value: float) -> bytes:
    return encode_tag(field, FIXED64) + struct.pack("<d", value)


def encode_packed_varints(field: int, values) -> bytes:
    payload = b"".join(encode_varint(v) for v in values)
    return encode_field_bytes(field, payload)


def encode_packed_floats(field: int, values) -> bytes:
    return encode_field_bytes(field, struct.pack(f"<{len(values)}f", *values))


def encode_packed_doubles(field: int, values) -> bytes:
    return encode_field_bytes(field, struct.pack(f"<{len(values)}d", *values))


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")
    return result, pos


def to_signed64(value: int) -> int:
    """Interpret a decoded varint as int64 (two's complement)."""
    if value >= 1 << 63:
        value -= 1 << 64
    return value


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Yield (field_number, wire_type, value). LENGTH fields yield bytes;
    VARINT yields unsigned int; FIXED32/64 yield raw bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = decode_varint(buf, pos)
        field = tag >> 3
        wt = tag & 7
        if wt == VARINT:
            value, pos = decode_varint(buf, pos)
        elif wt == FIXED64:
            value = buf[pos:pos + 8]
            pos += 8
        elif wt == LENGTH:
            size, pos = decode_varint(buf, pos)
            value = buf[pos:pos + size]
            pos += size
        elif wt == FIXED32:
            value = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} for field {field}")
        yield field, wt, value


def iter_field_spans(buf: bytes, start: int = 0,
                     end: int = None) -> Iterator[Tuple[int, int, object]]:
    """Like :func:`iter_fields` but never slices payloads: LENGTH / FIXED
    fields yield an ``(offset, offset_end)`` span into ``buf`` and VARINT
    yields the unsigned int. Used by the native-scan fast path so multi-GB
    initializer payloads are skipped without being copied."""
    pos = start
    n = len(buf) if end is None else end
    while pos < n:
        tag, pos = decode_varint(buf, pos)
        field = tag >> 3
        wt = tag & 7
        if wt == VARINT:
            value, pos = decode_varint(buf, pos)
        elif wt == FIXED64:
            value = (pos, pos + 8)
            pos += 8
        elif wt == LENGTH:
            size, pos = decode_varint(buf, pos)
            value = (pos, pos + size)
            pos += size
        elif wt == FIXED32:
            value = (pos, pos + 4)
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} for field {field}")
        yield field, wt, value


def unpack_varints(payload: bytes, signed: bool = True) -> list[int]:
    out = []
    pos = 0
    while pos < len(payload):
        v, pos = decode_varint(payload, pos)
        out.append(to_signed64(v) if signed else v)
    return out


def unpack_floats(payload: bytes) -> list[float]:
    return list(struct.unpack(f"<{len(payload) // 4}f", payload))


def unpack_doubles(payload: bytes) -> list[float]:
    return list(struct.unpack(f"<{len(payload) // 8}d", payload))
