"""json2pb — typed schema messages with binary↔JSON transcoding.

The reference bridges HTTP+JSON clients onto protobuf services with
src/json2pb/ (1,390 LoC of rapidjson↔pb glue): a pb service is callable
as `curl -d '{"field":...}'` because the gateway transcodes JSON to the
request message and the response message back to JSON. This module is
that role without a protobuf dependency:

- ``Message`` subclasses declare numbered fields (`f = field(1, str)`),
  giving a schema that encodes to **proto2-compatible wire bytes**
  (varint / length-delimited, same codec family as protocol/baidu_std) —
  a real protobuf definition with the same numbers/types interoperates.
- ``to_json`` / ``from_json`` transcode the same schema to JSON.
- The HTTP→RPC gateway consults the typed-service registry: a JSON body
  is transcoded to binary before the handler and the binary response back
  to JSON, so ONE registered handler serves binary RPC callers and curl
  alike (the reference's http+pb story).

Supported kinds: int (varint, proto2 int64), bool, str, bytes, float
(fixed64 double), nested Message, and repeated variants of each.

The port's copy of the JAX package's ``protocol/json2pb.py``, whole.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Optional, Tuple, Type

from incubator_brpc_tpu_torch.protocol.baidu_std import (
    _read_varint,
    _tag,
    _varint,
    _walk_fields,
)
from incubator_brpc_tpu_torch.protocol.tbus_std import ParseError


class FieldSpec:
    __slots__ = ("number", "kind", "default", "repeated", "name")

    def __init__(self, number: int, kind, default=None, repeated: bool = False):
        if number < 1:
            raise ValueError("field numbers start at 1")
        self.number = number
        self.kind = kind
        self.repeated = repeated
        self.name = ""  # filled by the metaclass
        if default is None and not repeated:
            default = {int: 0, bool: False, str: "", bytes: b"", float: 0.0}.get(
                kind, None
            )
        self.default = default

    def fresh_default(self):
        if self.repeated:
            return []
        if isinstance(self.kind, type) and issubclass(self.kind, Message):
            return None  # absent submessage
        return self.default


def field(number: int, kind, default=None, repeated: bool = False) -> FieldSpec:
    return FieldSpec(number, kind, default, repeated)


class _MessageMeta(type):
    def __new__(mcls, name, bases, ns):
        specs: Dict[str, FieldSpec] = {}
        for base in bases:
            specs.update(getattr(base, "_specs", {}))
        for key, val in list(ns.items()):
            if isinstance(val, FieldSpec):
                val.name = key
                specs[key] = val
                del ns[key]
        numbers = [s.number for s in specs.values()]
        if len(numbers) != len(set(numbers)):
            raise TypeError(f"duplicate field numbers in {name}")
        ns["_specs"] = specs
        ns["_by_number"] = {s.number: s for s in specs.values()}
        return super().__new__(mcls, name, bases, ns)


class Message(metaclass=_MessageMeta):
    """Declare fields as class attributes:

        class Echo(Message):
            msg = field(1, str)
            count = field(2, int)
    """

    _specs: Dict[str, FieldSpec] = {}
    _by_number: Dict[int, FieldSpec] = {}

    def __init__(self, **kwargs):
        for spec in self._specs.values():
            setattr(self, spec.name, spec.fresh_default())
        for key, val in kwargs.items():
            if key not in self._specs:
                raise TypeError(f"{type(self).__name__} has no field {key!r}")
            setattr(self, key, val)

    def __eq__(self, other):
        return type(self) is type(other) and all(
            getattr(self, s.name) == getattr(other, s.name)
            for s in self._specs.values()
        )

    def __repr__(self):
        parts = ", ".join(
            f"{s.name}={getattr(self, s.name)!r}" for s in self._specs.values()
        )
        return f"{type(self).__name__}({parts})"

    # -- binary (proto2 wire) -------------------------------------------

    def to_binary(self) -> bytes:
        out = bytearray()
        for spec in sorted(self._specs.values(), key=lambda s: s.number):
            value = getattr(self, spec.name)
            values = value if spec.repeated else [value]
            for v in values:
                if v is None:
                    continue
                out += _encode_one(spec, v)
        return bytes(out)

    @classmethod
    def from_binary(cls, data: bytes) -> "Message":
        msg = cls()
        try:
            items = list(_walk_fields(memoryview(data)))
        except ParseError:
            raise
        for number, wt, raw in items:
            spec = cls._by_number.get(number)
            if spec is None:
                continue  # unknown field: forward compat
            v = _decode_one(spec, wt, raw)
            if v is _SKIP:
                continue
            if spec.repeated:
                getattr(msg, spec.name).append(v)
            else:
                setattr(msg, spec.name, v)
        return msg

    # -- JSON -----------------------------------------------------------

    def to_json_obj(self) -> dict:
        d = {}
        for spec in self._specs.values():
            v = getattr(self, spec.name)
            if spec.repeated:
                d[spec.name] = [_json_value(spec, x) for x in v]
            elif v is not None:
                d[spec.name] = _json_value(spec, v)
        return d

    def to_json(self) -> bytes:
        return json.dumps(self.to_json_obj(), separators=(",", ":")).encode()

    @classmethod
    def from_json_obj(cls, obj: dict) -> "Message":
        msg = cls()
        for key, v in obj.items():
            spec = cls._specs.get(key)
            if spec is None:
                continue  # tolerate extra keys, like json2pb's relaxed mode
            if spec.repeated:
                setattr(msg, spec.name, [_from_json_value(spec, x) for x in v])
            else:
                setattr(msg, spec.name, _from_json_value(spec, v))
        return msg

    @classmethod
    def from_json(cls, data: bytes) -> "Message":
        try:
            obj = json.loads(data)
        except ValueError as e:
            raise ParseError(f"bad json: {e}") from None
        if not isinstance(obj, dict):
            raise ParseError("json body must be an object")
        return cls.from_json_obj(obj)


_SKIP = object()


def _encode_one(spec: FieldSpec, v) -> bytes:
    kind = spec.kind
    if kind is int or kind is bool:
        iv = int(v)
        if not iv and not spec.repeated:
            return b""
        return _tag(spec.number, 0) + _varint(iv)
    if kind is float:
        if not v and not spec.repeated:
            return b""
        return _tag(spec.number, 1) + struct.pack("<d", float(v))
    if kind is str:
        b = v.encode()
    elif kind is bytes:
        b = bytes(v)
    elif isinstance(kind, type) and issubclass(kind, Message):
        b = v.to_binary()
        return _tag(spec.number, 2) + _varint(len(b)) + b
    else:
        raise TypeError(f"unsupported field kind {kind!r}")
    if not b and not spec.repeated:
        return b""
    return _tag(spec.number, 2) + _varint(len(b)) + b


def _decode_one(spec: FieldSpec, wt: int, raw):
    kind = spec.kind
    if kind is int:
        return raw if wt == 0 else _SKIP
    if kind is bool:
        return bool(raw) if wt == 0 else _SKIP
    if kind is float:
        if wt == 1:
            return struct.unpack("<d", bytes(raw))[0]
        return _SKIP
    if wt != 2:
        return _SKIP
    if kind is str:
        return bytes(raw).decode(errors="replace")
    if kind is bytes:
        return bytes(raw)
    if isinstance(kind, type) and issubclass(kind, Message):
        return kind.from_binary(bytes(raw))
    return _SKIP


def _json_value(spec: FieldSpec, v):
    if isinstance(spec.kind, type) and issubclass(spec.kind, Message):
        return v.to_json_obj()
    if spec.kind is bytes:
        import base64

        return base64.b64encode(v).decode()  # json2pb's bytes convention
    return v


def _from_json_value(spec: FieldSpec, v):
    kind = spec.kind
    if isinstance(kind, type) and issubclass(kind, Message):
        if not isinstance(v, dict):
            raise ParseError(f"field {spec.name}: expected object")
        return kind.from_json_obj(v)
    if kind is bytes:
        import base64

        try:
            return base64.b64decode(v)
        except Exception:
            raise ParseError(f"field {spec.name}: bad base64") from None
    try:
        return kind(v)
    except (TypeError, ValueError):
        raise ParseError(f"field {spec.name}: cannot convert {v!r}") from None


# -- typed service adapter -----------------------------------------------


def typed_handler(request_cls: Type[Message], response_cls: Type[Message], fn):
    """Wrap ``fn(cntl, request_msg) -> response_msg`` into an ordinary
    bytes handler. The schema rides on the handler so the HTTP gateway can
    transcode (the json2pb method-options seam)."""

    def handler(cntl, payload: bytes):
        try:
            req = request_cls.from_binary(payload)
        except ParseError as e:
            from incubator_brpc_tpu_torch.utils.status import ErrorCode

            cntl.set_failed(ErrorCode.EREQUEST, f"bad {request_cls.__name__}: {e}")
            return b""
        resp = fn(cntl, req)
        if resp is None:
            return b""
        if not isinstance(resp, response_cls):
            from incubator_brpc_tpu_torch.utils.status import ErrorCode

            cntl.set_failed(
                ErrorCode.EINTERNAL,
                f"handler returned {type(resp).__name__}, "
                f"expected {response_cls.__name__}",
            )
            return b""
        return resp.to_binary()

    handler.request_cls = request_cls
    handler.response_cls = response_cls
    return handler


def make_typed_service(handlers: Dict[str, Tuple]) -> Dict[str, Any]:
    """{method: (fn, RequestCls, ResponseCls)} → {method: bytes_handler}
    ready for Server.add_service."""
    return {
        method: typed_handler(req_cls, resp_cls, fn)
        for method, (fn, req_cls, resp_cls) in handlers.items()
    }


def schema_of(handler) -> Optional[Tuple[Type[Message], Type[Message]]]:
    req = getattr(handler, "request_cls", None)
    resp = getattr(handler, "response_cls", None)
    if req is not None and resp is not None:
        return req, resp
    return None
