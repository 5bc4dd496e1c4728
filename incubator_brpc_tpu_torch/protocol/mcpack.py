"""mcpack — the mcpack2pb analog: the legacy binary object format with the
typed schema layer as its front-end.

The reference's src/mcpack2pb (4,382 LoC) makes protobuf the front-end of
mcpack: a protoc plugin (generator.cpp) emits parse/serialize code per
message so nshead+mcpack services speak typed messages. Here the schema
layer is ``protocol.json2pb.Message``; the codec is derived from the class
at runtime (Python introspection replaces the codegen pass — same
capability, no build step), plus a dynamic ``loads``/``dumps`` for
schema-less dict payloads (the reference's UnparsedValue/ObjectIterator
surface, parser.h:88-120).

Wire format (byte-faithful to the reference so real mcpack peers
interoperate; layouts from field_type.h:28-77 and the packed head structs
in serializer.cpp:25-80):

- FieldFixedHead  = u8 type, u8 name_size                  (primitives)
- FieldShortHead  = u8 type|0x80, u8 name_size, u8  value_size
                    (strings <=254 incl NUL / binary <=255)
- FieldLongHead   = u8 type, u8 name_size, u32 value_size  (the rest)
- names are NUL-terminated; name_size counts the NUL; 0 = unnamed
- OBJECT/ARRAY value = u32 item_count + item fields (array items unnamed)
- ISOARRAY value = u8 item_type + packed primitive values
- STRING values carry a trailing NUL (counted in value_size)
- a field whose type & 0x70 == 0 is deleted: skip it

The port's copy of the JAX package's ``protocol/mcpack.py``, whole, over
the port's own ``protocol/json2pb.py``: the same values dump to the same
bytes in both packages.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple, Type

from incubator_brpc_tpu_torch.protocol.json2pb import Message
from incubator_brpc_tpu_torch.protocol.tbus_std import ParseError

# field types (field_type.h:28-77)
OBJECT = 0x10
ARRAY = 0x20
ISOARRAY = 0x30
OBJECTISOARRAY = 0x40
STRING = 0x50
BINARY = 0x60
INT8, INT16, INT32, INT64 = 0x11, 0x12, 0x14, 0x18
UINT8, UINT16, UINT32, UINT64 = 0x21, 0x22, 0x24, 0x28
BOOL = 0x31
FLOAT, DOUBLE = 0x44, 0x48
DATE = 0x58
NULL = 0x61

SHORT_MASK = 0x80
FIXED_MASK = 0x0F
NON_DELETED_MASK = 0x70
MAX_DEPTH = 128  # field_type.h MAX_DEPTH

_INT_PACK = {
    INT8: "<b", INT16: "<h", INT32: "<i", INT64: "<q",
    UINT8: "<B", UINT16: "<H", UINT32: "<I", UINT64: "<Q",
    FLOAT: "<f", DOUBLE: "<d",
}


# ---------------------------------------------------------------------------
# dump (Python value → mcpack bytes)
# ---------------------------------------------------------------------------


def _pick_int_type(v: int) -> int:
    if -(1 << 31) <= v < (1 << 31):
        return INT32
    if -(1 << 63) <= v < (1 << 63):
        return INT64
    if 0 <= v < (1 << 64):
        return UINT64
    raise ValueError(f"integer {v} out of 64-bit range")


def _name_bytes(name: str) -> bytes:
    if not name:
        return b""
    nb = name.encode() + b"\x00"
    if len(nb) > 255:
        raise ValueError("mcpack field name too long")
    return nb


def _emit_fixed(out: bytearray, ftype: int, name: bytes, value: bytes) -> None:
    out += struct.pack("<BB", ftype, len(name))
    out += name
    out += value


def _emit_sized(out: bytearray, ftype: int, name: bytes, value: bytes) -> None:
    """Short head when the value fits (strings <=254 incl NUL, binary
    <=255), long head otherwise — serializer.cpp FieldShortHead note."""
    if len(value) <= 0xFF:
        out += struct.pack("<BBB", ftype | SHORT_MASK, len(name), len(value))
    else:
        out += struct.pack("<BBI", ftype, len(name), len(value))
    out += name
    out += value


def _dump_field(out: bytearray, name: str, v: Any, depth: int) -> None:
    if depth > MAX_DEPTH:
        raise ValueError("mcpack nesting exceeds MAX_DEPTH")
    nb = _name_bytes(name)
    if v is None:
        _emit_fixed(out, NULL, nb, b"\x00")
    elif isinstance(v, bool):
        _emit_fixed(out, BOOL, nb, b"\x01" if v else b"\x00")
    elif isinstance(v, int):
        t = _pick_int_type(v)
        _emit_fixed(out, t, nb, struct.pack(_INT_PACK[t], v))
    elif isinstance(v, float):
        _emit_fixed(out, DOUBLE, nb, struct.pack("<d", v))
    elif isinstance(v, str):
        _emit_sized(out, STRING, nb, v.encode() + b"\x00")
    elif isinstance(v, (bytes, bytearray, memoryview)):
        _emit_sized(out, BINARY, nb, bytes(v))
    elif isinstance(v, dict):
        body = bytearray(struct.pack("<I", len(v)))
        for k, item in v.items():
            if not isinstance(k, str):
                raise ValueError("mcpack object keys must be str")
            _dump_field(body, k, item, depth + 1)
        out += struct.pack("<BBI", OBJECT, len(nb), len(body))
        out += nb
        out += body
    elif isinstance(v, (list, tuple)):
        body = bytearray(struct.pack("<I", len(v)))
        for item in v:
            _dump_field(body, "", item, depth + 1)
        out += struct.pack("<BBI", ARRAY, len(nb), len(body))
        out += nb
        out += body
    else:
        raise ValueError(f"mcpack cannot encode {type(v).__name__}")


def dumps(obj: Dict[str, Any]) -> bytes:
    """Serialize a dict as one unnamed top-level OBJECT field — the shape
    nshead+mcpack bodies carry."""
    if not isinstance(obj, dict):
        raise ValueError("top-level mcpack value must be a dict")
    out = bytearray()
    _dump_field(out, "", obj, 0)
    return bytes(out)


# ---------------------------------------------------------------------------
# load (mcpack bytes → Python value)
# ---------------------------------------------------------------------------


class _Reader:
    __slots__ = ("mv", "off")

    def __init__(self, data) -> None:
        self.mv = memoryview(data)
        self.off = 0

    def take(self, n: int) -> memoryview:
        if n < 0 or self.off + n > len(self.mv):
            raise ParseError("mcpack truncated")
        chunk = self.mv[self.off : self.off + n]
        self.off += n
        return chunk

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]


def _read_field(r: _Reader, depth: int) -> Tuple[str, Any, bool]:
    """One field → (name, value, deleted)."""
    if depth > MAX_DEPTH:
        raise ParseError("mcpack nesting exceeds MAX_DEPTH")
    ftype = r.u8()
    name_size = r.u8()
    base = ftype & ~SHORT_MASK
    if ftype & SHORT_MASK:
        value_size = r.u8()
    elif base in (OBJECT, ARRAY, ISOARRAY, OBJECTISOARRAY, STRING, BINARY):
        value_size = r.u32()
    else:
        # primitives (incl. DATE=0x58 and NULL=0x61): size in the low nibble
        value_size = ftype & FIXED_MASK
    name_mv = r.take(name_size)
    if name_size:
        if name_mv[-1] != 0:
            raise ParseError("mcpack name not NUL-terminated")
        try:
            name = bytes(name_mv[:-1]).decode()
        except UnicodeDecodeError:
            raise ParseError("mcpack name is not valid UTF-8")
    else:
        name = ""
    deleted = (ftype & NON_DELETED_MASK) == 0
    body = r.take(value_size)
    if deleted:
        return name, None, True
    value = _parse_value(base, body, depth)
    return name, value, False


def _parse_value(base: int, body: memoryview, depth: int) -> Any:
    if base == OBJECT:
        sub = _Reader(body)
        count = sub.u32()
        obj: Dict[str, Any] = {}
        for _ in range(count):
            k, v, deleted = _read_field(sub, depth + 1)
            if not deleted:
                obj[k] = v
        return obj
    if base in (ARRAY, OBJECTISOARRAY):
        # OBJECTISOARRAY stores columns; surfacing it as its column object
        # array keeps the data readable without the transpose
        sub = _Reader(body)
        count = sub.u32()
        items: List[Any] = []
        for _ in range(count):
            _, v, deleted = _read_field(sub, depth + 1)
            if not deleted:
                items.append(v)
        return items
    if base == ISOARRAY:
        if len(body) < 1:
            raise ParseError("isoarray missing item type")
        item_type = body[0]
        fmt = _INT_PACK.get(item_type)
        if fmt is None and item_type != BOOL:
            raise ParseError(f"isoarray of unsupported type {item_type:#x}")
        raw = body[1:]
        size = 1 if item_type == BOOL else item_type & FIXED_MASK
        if size == 0 or len(raw) % size:
            raise ParseError("isoarray size not a multiple of item size")
        if item_type == BOOL:
            return [b != 0 for b in bytes(raw)]
        return [
            struct.unpack_from(fmt, raw, i)[0] for i in range(0, len(raw), size)
        ]
    if base == STRING:
        if len(body) == 0 or body[-1] != 0:
            raise ParseError("mcpack string not NUL-terminated")
        try:
            return bytes(body[:-1]).decode()
        except UnicodeDecodeError:
            raise ParseError("mcpack string is not valid UTF-8")
    if base == BINARY:
        return bytes(body)
    if base == BOOL:
        return body[0] != 0
    if base == NULL:
        return None
    if base == DATE:  # semantics undocumented even in the reference: raw
        return bytes(body)
    fmt = _INT_PACK.get(base)
    if fmt is not None:
        if len(body) != struct.calcsize(fmt):
            raise ParseError("mcpack primitive size mismatch")
        return struct.unpack(fmt, body)[0]
    raise ParseError(f"unknown mcpack type {base:#x}")


def loads(data) -> Dict[str, Any]:
    """Parse one top-level field (normally the unnamed OBJECT an
    nshead+mcpack body carries) and return its value."""
    r = _Reader(data)
    _, value, deleted = _read_field(r, 0)
    if deleted:
        raise ParseError("top-level mcpack field is deleted")
    return value


# ---------------------------------------------------------------------------
# schema bridge — Message front-end (the mcpack2pb generator role, derived
# at runtime instead of emitted by a protoc plugin)
# ---------------------------------------------------------------------------


def message_to_mcpack(msg: Message) -> bytes:
    return dumps(_message_to_dict(msg))


def _message_to_dict(msg: Message) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for spec in msg._specs.values():
        v = getattr(msg, spec.name)
        if v is None:
            continue
        if spec.repeated:
            out[spec.name] = [
                _message_to_dict(item) if isinstance(item, Message) else item
                for item in v
            ]
        elif isinstance(v, Message):
            out[spec.name] = _message_to_dict(v)
        else:
            out[spec.name] = v
    return out


def message_from_mcpack(cls: Type[Message], data) -> Message:
    obj = loads(data)
    if not isinstance(obj, dict):
        raise ParseError("mcpack top-level value is not an object")
    return _message_from_dict(cls, obj)


def _coerce(spec, v):
    kind = spec.kind
    if isinstance(kind, type) and issubclass(kind, Message):
        if not isinstance(v, dict):
            raise ParseError(f"field {spec.name}: expected object")
        return _message_from_dict(kind, v)
    if kind is float and isinstance(v, int) and not isinstance(v, bool):
        return float(v)
    if kind is bytes and isinstance(v, (bytes, bytearray)):
        return bytes(v)
    if kind is int and isinstance(v, bool):
        raise ParseError(f"field {spec.name}: bool where int expected")
    if not isinstance(v, kind):
        raise ParseError(
            f"field {spec.name}: {type(v).__name__} where "
            f"{getattr(kind, '__name__', kind)} expected"
        )
    return v


def _message_from_dict(cls: Type[Message], obj: Dict[str, Any]) -> Message:
    msg = cls()
    for spec in cls._specs.values():
        if spec.name not in obj:
            continue
        v = obj[spec.name]
        if spec.repeated:
            if not isinstance(v, list):
                raise ParseError(f"field {spec.name}: expected array")
            setattr(msg, spec.name, [_coerce(spec, item) for item in v])
        else:
            setattr(msg, spec.name, _coerce(spec, v))
    return msg


# ---------------------------------------------------------------------------
# nshead+mcpack service adaptor (the reference's NsheadMcpackAdaptor:
# policy/nshead_mcpack_protocol.cpp parses the nshead body as mcpack and
# serializes the typed response back)
# ---------------------------------------------------------------------------


def make_mcpack_service(handler):
    """Wrap ``fn(cntl, request: dict) -> dict`` as an
    ``ServerOptions(nshead_service=...)`` handler whose bodies are mcpack
    objects. Parse errors fail the connection-visible response with an
    empty body (matching the adaptor's drop-on-bad-request posture)."""

    def nshead_mcpack_service(cntl, head: dict, body: bytes) -> bytes:
        req = loads(body) if body else {}
        if not isinstance(req, dict):
            raise ParseError("mcpack request body is not an object")
        resp = handler(cntl, req)
        return dumps(resp if resp is not None else {})

    return nshead_mcpack_service
