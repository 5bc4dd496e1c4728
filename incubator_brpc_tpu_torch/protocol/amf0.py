"""AMF0 — the Action Message Format codec RTMP command/data messages use
(reference src/brpc/amf.{h,cpp}; the public AMF0 spec defines the bytes).

Python values map directly: float/int → Number (IEEE double), bool →
Boolean, str → String/LongString, dict → Object (or ECMA array on
decode), list → StrictArray, None → Null. ``Undefined`` is a distinct
singleton so round-trips preserve it.

The port's copy of the JAX package's ``protocol/amf0.py``, on the port's
``tbus_std.ParseError``: the same bytes both ways.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

from incubator_brpc_tpu_torch.protocol.tbus_std import ParseError

NUMBER = 0x00
BOOLEAN = 0x01
STRING = 0x02
OBJECT = 0x03
NULL = 0x05
UNDEFINED = 0x06
REFERENCE = 0x07
ECMA_ARRAY = 0x08
OBJECT_END = 0x09
STRICT_ARRAY = 0x0A
DATE = 0x0B
LONG_STRING = 0x0C

_MAX_DEPTH = 32


class _Undefined:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "amf0.Undefined"


Undefined = _Undefined()


def _encode_utf8(s: str) -> bytes:
    b = s.encode()
    if len(b) > 0xFFFF:
        raise ValueError("amf0 short string exceeds 65535 bytes")
    return struct.pack(">H", len(b)) + b


def encode_value(v: Any, depth: int = 0) -> bytes:
    if depth > _MAX_DEPTH:
        raise ValueError("amf0 nesting too deep")
    if v is Undefined:
        return bytes([UNDEFINED])
    if v is None:
        return bytes([NULL])
    if isinstance(v, bool):
        return bytes([BOOLEAN, 1 if v else 0])
    if isinstance(v, (int, float)):
        return bytes([NUMBER]) + struct.pack(">d", float(v))
    if isinstance(v, str):
        b = v.encode()
        if len(b) > 0xFFFF:
            return bytes([LONG_STRING]) + struct.pack(">I", len(b)) + b
        return bytes([STRING]) + _encode_utf8(v)
    if isinstance(v, dict):
        out = bytearray([OBJECT])
        for k, item in v.items():
            out += _encode_utf8(str(k))
            out += encode_value(item, depth + 1)
        out += b"\x00\x00" + bytes([OBJECT_END])
        return bytes(out)
    if isinstance(v, (list, tuple)):
        out = bytearray([STRICT_ARRAY]) + struct.pack(">I", len(v))
        for item in v:
            out += encode_value(item, depth + 1)
        return bytes(out)
    raise ValueError(f"amf0 cannot encode {type(v).__name__}")


def encode_all(*values: Any) -> bytes:
    return b"".join(encode_value(v) for v in values)


def _read_utf8(mv: memoryview, off: int) -> Tuple[str, int]:
    if off + 2 > len(mv):
        raise ParseError("amf0 string length truncated")
    (n,) = struct.unpack_from(">H", mv, off)
    off += 2
    if off + n > len(mv):
        raise ParseError("amf0 string truncated")
    try:
        return bytes(mv[off : off + n]).decode(), off + n
    except UnicodeDecodeError:
        raise ParseError("amf0 string is not valid UTF-8")


def decode_value(mv: memoryview, off: int, depth: int = 0) -> Tuple[Any, int]:
    if depth > _MAX_DEPTH:
        raise ParseError("amf0 nesting too deep")
    if off >= len(mv):
        raise ParseError("amf0 value truncated")
    marker = mv[off]
    off += 1
    if marker == NUMBER:
        if off + 8 > len(mv):
            raise ParseError("amf0 number truncated")
        return struct.unpack_from(">d", mv, off)[0], off + 8
    if marker == BOOLEAN:
        if off >= len(mv):
            raise ParseError("amf0 boolean truncated")
        return mv[off] != 0, off + 1
    if marker == STRING:
        return _read_utf8(mv, off)
    if marker == LONG_STRING:
        if off + 4 > len(mv):
            raise ParseError("amf0 long string truncated")
        (n,) = struct.unpack_from(">I", mv, off)
        off += 4
        if off + n > len(mv):
            raise ParseError("amf0 long string truncated")
        try:
            return bytes(mv[off : off + n]).decode(), off + n
        except UnicodeDecodeError:
            raise ParseError("amf0 long string is not valid UTF-8")
    if marker in (OBJECT, ECMA_ARRAY):
        if marker == ECMA_ARRAY:
            if off + 4 > len(mv):
                raise ParseError("amf0 ecma array truncated")
            off += 4  # approximate count: the end marker is authoritative
        obj = {}
        while True:
            key, off = _read_utf8(mv, off)
            if key == "":
                if off >= len(mv) or mv[off] != OBJECT_END:
                    raise ParseError("amf0 object missing end marker")
                return obj, off + 1
            obj[key], off = decode_value(mv, off, depth + 1)
    if marker == STRICT_ARRAY:
        if off + 4 > len(mv):
            raise ParseError("amf0 strict array truncated")
        (n,) = struct.unpack_from(">I", mv, off)
        off += 4
        if n > len(mv):  # cheap bound before allocating
            raise ParseError("amf0 strict array count out of range")
        items = []
        for _ in range(n):
            item, off = decode_value(mv, off, depth + 1)
            items.append(item)
        return items, off
    if marker == NULL:
        return None, off
    if marker == UNDEFINED:
        return Undefined, off
    if marker == DATE:
        if off + 10 > len(mv):
            raise ParseError("amf0 date truncated")
        ms = struct.unpack_from(">d", mv, off)[0]
        return ms, off + 10  # millis-since-epoch as a plain number
    raise ParseError(f"amf0 marker {marker:#x} unsupported")


def decode_all(data) -> List[Any]:
    mv = memoryview(data)
    off = 0
    out: List[Any] = []
    while off < len(mv):
        v, off = decode_value(mv, off)
        out.append(v)
    return out
