"""Minimal descriptor-driven proto3 wire codec (no generated code).

The port's copy of rs_face_detection_tpu/runtime/proto3.py, byte for byte
in behaviour (tests/test_torch_proto3.py holds the two codecs' bytes
equal).  The Triton protobuf contract (grpc_service.proto) is encoded and
decoded here directly against the documented proto3 wire format
(https://protobuf.dev/programming-guides/encoding/), without grpcio-tools
or generated code:

  key   = (field_number << 3) | wire_type
  types = 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32

Schemas are plain dicts mapping field name -> Field (number, kind,
repeated/map flags); messages are plain Python dicts.  Semantics follow
proto3: default-valued singular scalars are omitted on encode and filled
on decode, repeated numeric scalars encode packed but decode either form,
unknown fields are skipped by wire type.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

#: fixed-width packed kinds bulk-encode/decode through numpy — the
#: reference's production ModelInfer carries ~1.2M floats in fp32_contents
#: (1x3x640x640), which per-element struct.pack/unpack would spend seconds
#: of single-core Python on for every request.
_NP_FMT = {"float": "<f4", "double": "<f8", "fixed32": "<u4", "fixed64": "<u8"}


class Field(NamedTuple):
    number: int
    kind: str  # scalar kind name, or "message"
    repeated: bool = False
    #: nested schema dict for kind="message"
    schema: Optional[Dict[str, "Field"]] = None
    #: (key_field, value_field) for protobuf map<K, V> fields
    map_entry: Optional[Tuple["Field", "Field"]] = None
    #: member of a proto3 oneof: EXPLICIT presence — encoded even at the
    #: type's default value (protoc does the same), and NOT pre-filled with
    #: a default on decode, so `name in msg` reports which oneof case was
    #: actually set on the wire.
    oneof: bool = False


# wire type per scalar kind
_WIRE_TYPE = {
    "bool": 0,
    "int32": 0,
    "int64": 0,
    "uint32": 0,
    "uint64": 0,
    "enum": 0,
    "fixed32": 5,
    "float": 5,
    "fixed64": 1,
    "double": 1,
    "string": 2,
    "bytes": 2,
    "message": 2,
}

_DEFAULTS = {
    "bool": False,
    "int32": 0,
    "int64": 0,
    "uint32": 0,
    "uint64": 0,
    "enum": 0,
    "fixed32": 0,
    "float": 0.0,
    "fixed64": 0,
    "double": 0.0,
    "string": "",
    "bytes": b"",
}


def _encode_varint(value: int) -> bytes:
    """Unsigned LEB128.  Negative int32/int64 are sign-extended to 64 bits
    first (proto3 two's-complement varint encoding)."""
    if value < 0:
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def _signed(value: int, bits: int) -> int:
    """Reinterpret an unsigned varint as a signed two's-complement value."""
    value &= (1 << 64) - 1  # varints always carry 64 bits
    if value >= 1 << 63:
        value -= 1 << 64
    if bits == 32:
        # int32 fields truncate to 32 bits on the wire per the spec
        value &= (1 << 32) - 1
        if value >= 1 << 31:
            value -= 1 << 32
    return value


def _encode_scalar(kind: str, value: Any) -> bytes:
    if kind in ("bool", "enum", "int32", "int64", "uint32", "uint64"):
        return _encode_varint(int(value))
    if kind == "float":
        return struct.pack("<f", float(value))
    if kind == "double":
        return struct.pack("<d", float(value))
    if kind == "fixed32":
        return struct.pack("<I", int(value))
    if kind == "fixed64":
        return struct.pack("<Q", int(value))
    if kind == "string":
        data = value.encode("utf-8")
        return _encode_varint(len(data)) + data
    if kind == "bytes":
        data = bytes(value)
        return _encode_varint(len(data)) + data
    raise ValueError(f"unknown scalar kind {kind!r}")


def _decode_scalar(kind: str, buf: bytes, pos: int) -> Tuple[Any, int]:
    if kind in ("bool", "enum", "int32", "int64", "uint32", "uint64"):
        raw, pos = _decode_varint(buf, pos)
        if kind == "bool":
            return bool(raw), pos
        if kind == "int32":
            return _signed(raw, 32), pos
        if kind == "int64":
            return _signed(raw, 64), pos
        return raw, pos
    if kind in ("float", "fixed32"):
        if pos + 4 > len(buf):
            raise ValueError(f"truncated {kind} field")
        fmt = "<f" if kind == "float" else "<I"
        return struct.unpack_from(fmt, buf, pos)[0], pos + 4
    if kind in ("double", "fixed64"):
        if pos + 8 > len(buf):
            raise ValueError(f"truncated {kind} field")
        fmt = "<d" if kind == "double" else "<Q"
        return struct.unpack_from(fmt, buf, pos)[0], pos + 8
    if kind in ("string", "bytes"):
        size, pos = _decode_varint(buf, pos)
        end = pos + size
        if end > len(buf):
            raise ValueError("truncated length-delimited field")
        data = buf[pos:end]
        return (data.decode("utf-8") if kind == "string" else data), end
    raise ValueError(f"unknown scalar kind {kind!r}")


def _key(number: int, wire_type: int) -> bytes:
    return _encode_varint((number << 3) | wire_type)


def encode_message(schema: Dict[str, Field], msg: Dict[str, Any]) -> bytes:
    """Dict -> proto3 bytes.  Fields encode in field-number order (protoc's
    serialization order for messages built in one pass), so byte-for-byte
    golden comparisons are meaningful."""
    unknown = set(msg) - set(schema)
    if unknown:
        raise ValueError(f"fields not in schema: {sorted(unknown)}")
    out = bytearray()
    for name, field in sorted(schema.items(), key=lambda kv: kv[1].number):
        if name not in msg:
            continue
        value = msg[name]
        if field.map_entry is not None:
            kf, vf = field.map_entry
            entry_schema = {"key": kf, "value": vf}
            for k, v in value.items():
                body = encode_message(entry_schema, {"key": k, "value": v})
                out += _key(field.number, 2) + _encode_varint(len(body)) + body
            continue
        if field.kind == "message":
            items = value if field.repeated else [value]
            for item in items:
                if item is None:
                    continue
                body = encode_message(field.schema, item)
                out += _key(field.number, 2) + _encode_varint(len(body)) + body
            continue
        if field.repeated:
            if len(value) == 0:  # len(), not truthiness: value may be ndarray
                continue
            wt = _WIRE_TYPE[field.kind]
            if wt in (0, 1, 5):  # packed numeric (proto3 default)
                fmt = _NP_FMT.get(field.kind)
                if fmt is not None:  # fixed-width: one bulk cast
                    body = np.asarray(value, dtype=fmt).tobytes()
                else:
                    body = b"".join(_encode_scalar(field.kind, v) for v in value)
                out += _key(field.number, 2) + _encode_varint(len(body)) + body
            else:  # string/bytes repeat the key
                for v in value:
                    out += _key(field.number, wt) + _encode_scalar(field.kind, v)
            continue
        # singular scalar: proto3 omits default values — except oneof
        # members, whose presence is explicit
        if not field.oneof:
            if value == _DEFAULTS[field.kind] and not isinstance(value, float):
                continue
            if isinstance(value, float) and value == 0.0:
                continue
        out += _key(field.number, _WIRE_TYPE[field.kind]) + _encode_scalar(
            field.kind, value
        )
    return bytes(out)


def _skip_field(wire_type: int, buf: bytes, pos: int) -> int:
    if wire_type == 0:
        _, pos = _decode_varint(buf, pos)
        return pos
    elif wire_type == 1:
        pos += 8
    elif wire_type == 5:
        pos += 4
    elif wire_type == 2:
        size, pos = _decode_varint(buf, pos)
        pos += size
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    if pos > len(buf):  # protoc rejects truncated unknown fields too
        raise ValueError("truncated unknown field")
    return pos


def decode_message(schema: Dict[str, Field], buf: bytes) -> Dict[str, Any]:
    """proto3 bytes -> dict with every schema field present (proto3
    semantics: absent singular scalars read as their default, repeated as
    [], maps as {}, absent submessages as None) — EXCEPT oneof members,
    which appear only when their case was set on the wire."""
    by_number = {f.number: (name, f) for name, f in schema.items()}
    msg: Dict[str, Any] = {}
    for name, field in schema.items():
        if field.map_entry is not None:
            msg[name] = {}
        elif field.repeated:
            msg[name] = []
        elif field.kind == "message":
            msg[name] = None
        elif not field.oneof:  # oneof members keep explicit presence
            msg[name] = _DEFAULTS[field.kind]

    pos = 0
    while pos < len(buf):
        tag, pos = _decode_varint(buf, pos)
        number, wire_type = tag >> 3, tag & 0x7
        entry = by_number.get(number)
        if entry is None:
            pos = _skip_field(wire_type, buf, pos)
            continue
        name, field = entry
        if field.map_entry is not None or field.kind == "message":
            if wire_type != 2:
                raise ValueError(
                    f"field {name} (#{number}): wire type {wire_type}, "
                    f"expected 2 (length-delimited)"
                )
        if field.map_entry is not None:
            size, pos = _decode_varint(buf, pos)
            end = pos + size
            if end > len(buf):
                raise ValueError("truncated map entry")
            kf, vf = field.map_entry
            entry_msg = decode_message({"key": kf, "value": vf}, buf[pos:end])
            msg[name][entry_msg["key"]] = entry_msg["value"]
            pos = end
            continue
        if field.kind == "message":
            size, pos = _decode_varint(buf, pos)
            end = pos + size
            if end > len(buf):
                raise ValueError("truncated submessage")
            sub = decode_message(field.schema, buf[pos:end])
            pos = end
            if field.repeated:
                msg[name].append(sub)
            else:
                msg[name] = sub
            continue
        expected_wt = _WIRE_TYPE[field.kind]
        if field.repeated and wire_type == 2 and expected_wt in (0, 1, 5):
            # packed encoding of a numeric repeated field
            size, pos = _decode_varint(buf, pos)
            end = pos + size
            if end > len(buf):
                raise ValueError("truncated packed field")
            fmt = _NP_FMT.get(field.kind)
            if fmt is not None:  # fixed-width: one bulk frombuffer
                itemsize = np.dtype(fmt).itemsize
                if size % itemsize:
                    raise ValueError("packed field overran its length")
                msg[name].extend(
                    np.frombuffer(buf, dtype=fmt, count=size // itemsize,
                                  offset=pos).tolist()
                )
                pos = end
                continue
            while pos < end:
                v, pos = _decode_scalar(field.kind, buf, pos)
                msg[name].append(v)
            if pos != end:
                raise ValueError("packed field overran its length")
            continue
        if wire_type != expected_wt:
            raise ValueError(
                f"field {name} (#{number}): wire type {wire_type}, "
                f"expected {expected_wt}"
            )
        v, pos = _decode_scalar(field.kind, buf, pos)
        if field.repeated:
            msg[name].append(v)
        else:
            msg[name] = v
    return msg
