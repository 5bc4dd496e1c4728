"""mongo — server-side mongo wire protocol (reference
src/brpc/policy/mongo_protocol.cpp + mongo_service_adaptor.h +
mongo_head.h: a brpc server can speak enough mongo that client libraries'
queries reach user code; "server-side query only").

Kept design points:
- the 16-byte little-endian head `| message_length | request_id |
  response_to | op_code |` where a known op_code doubles as the magic
  (mongo_head.h:37-50, ParseMongoMessage mongo_protocol.cpp:127);
- the protocol participates in the shared-port scan only when the server
  registered a ``MongoServiceAdaptor`` (ServerOptions.mongo_service_adaptor
  — same gating as nshead);
- per-connection state: the adaptor creates a context object stored on the
  socket at first message (CreateSocketContext, mongo_protocol.cpp:146);
- responses are OP_REPLY frames `| head | response_flags i32 | cursor_id
  i64 | starting_from i32 | number_returned i32 | docs |`
  (SendMongoResponse mongo_protocol.cpp:60-100); errors serialize through
  the adaptor (SerializeError).

BSON: a self-contained subset codec (double, string, document, array,
binary/0, ObjectId(raw 12B), bool, null, int32, int64) — the slice mongo
client libraries use for queries; unknown element types fail the parse
cleanly.

The port's copy of the JAX package's ``protocol/mongo.py``: the same codec,
head and adaptor, server side only. On a ``native_plane=True`` server a
mongo connection is handed to the Python plane (its first four bytes, a
little-endian message length, are neither tbus_std's nor baidu_std's magic)
and served here.
"""

from __future__ import annotations

import logging
import struct
from typing import Any, Callable, Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch.protocol.registry import Protocol, protocol_registry
from incubator_brpc_tpu_torch.protocol.tbus_std import ParseError

logger = logging.getLogger(__name__)

HEAD = struct.Struct("<iiii")
HEAD_BYTES = 16

OP_REPLY = 1
OP_MSG_LEGACY = 1000
OP_UPDATE = 2001
OP_INSERT = 2002
OP_QUERY = 2004
OP_GET_MORE = 2005
OP_DELETE = 2006
OP_KILL_CURSORS = 2007

_OPCODES = {
    OP_REPLY,
    OP_MSG_LEGACY,
    OP_UPDATE,
    OP_INSERT,
    OP_QUERY,
    OP_GET_MORE,
    OP_DELETE,
    OP_KILL_CURSORS,
}


class ObjectId(bytes):
    """12-byte mongo ObjectId carried raw (BSON element 0x07)."""

    def __new__(cls, raw: bytes):
        if len(raw) != 12:
            raise ValueError("ObjectId must be 12 bytes")
        return super().__new__(cls, raw)


# ---------------------------------------------------------------------------
# BSON subset codec
# ---------------------------------------------------------------------------


def _bson_cstring(mv: memoryview, off: int) -> Tuple[str, int]:
    end = off
    n = len(mv)
    while end < n and mv[end] != 0:
        end += 1
    if end >= n:
        raise ParseError("bson cstring unterminated")
    return bytes(mv[off:end]).decode(), end + 1


def bson_encode(doc: Dict[str, Any]) -> bytes:
    out = bytearray(4)
    for key, v in doc.items():
        kb = key.encode() + b"\x00"
        if isinstance(v, bool):
            out += b"\x08" + kb + (b"\x01" if v else b"\x00")
        elif isinstance(v, ObjectId):
            out += b"\x07" + kb + v
        elif isinstance(v, int):
            if -(1 << 31) <= v < (1 << 31):
                out += b"\x10" + kb + struct.pack("<i", v)
            else:
                out += b"\x12" + kb + struct.pack("<q", v)
        elif isinstance(v, float):
            out += b"\x01" + kb + struct.pack("<d", v)
        elif isinstance(v, str):
            sb = v.encode() + b"\x00"
            out += b"\x02" + kb + struct.pack("<i", len(sb)) + sb
        elif isinstance(v, (bytes, bytearray, memoryview)):
            vb = bytes(v)
            out += b"\x05" + kb + struct.pack("<iB", len(vb), 0) + vb
        elif isinstance(v, dict):
            out += b"\x03" + kb + bson_encode(v)
        elif isinstance(v, (list, tuple)):
            out += b"\x04" + kb + bson_encode(
                {str(i): item for i, item in enumerate(v)}
            )
        elif v is None:
            out += b"\x0a" + kb
        else:
            raise ValueError(f"bson cannot encode {type(v).__name__}")
    out += b"\x00"
    struct.pack_into("<i", out, 0, len(out))
    return bytes(out)


_BSON_MAX_DEPTH = 128  # same posture as mcpack's MAX_DEPTH


def bson_decode(data, offset: int = 0, _depth: int = 0) -> Tuple[Dict[str, Any], int]:
    """Decode one document at ``offset``; returns (doc, bytes_consumed).
    Raises ParseError on ANY malformation (the decoder's whole error
    surface — struct underruns and bad UTF-8 included)."""
    if _depth > _BSON_MAX_DEPTH:
        raise ParseError("bson nesting exceeds depth limit")
    mv = memoryview(data)[offset:]
    if len(mv) < 5:
        raise ParseError("bson document truncated")
    (total,) = struct.unpack_from("<i", mv)
    if total < 5 or total > len(mv):
        raise ParseError("bson length out of range")
    try:
        doc, end = _bson_decode_body(mv[:total], _depth)
    except ParseError:
        raise
    except (struct.error, UnicodeDecodeError, ValueError, IndexError) as e:
        raise ParseError(f"bson malformed: {e}")
    return doc, total


def _bson_decode_body(mv: memoryview, depth: int) -> Tuple[Dict[str, Any], int]:
    doc: Dict[str, Any] = {}
    off = 4
    total = len(mv)
    while True:
        if off >= total:
            raise ParseError("bson document missing terminator")
        etype = mv[off]
        off += 1
        if etype == 0:
            if off != total:
                raise ParseError("bson trailing bytes after terminator")
            return doc, off
        key, off = _bson_cstring(mv, off)
        if etype == 0x01:
            (doc[key],) = struct.unpack_from("<d", mv, off)
            off += 8
        elif etype == 0x02:
            (n,) = struct.unpack_from("<i", mv, off)
            off += 4
            if n < 1 or off + n > total or mv[off + n - 1] != 0:
                raise ParseError("bson string malformed")
            doc[key] = bytes(mv[off : off + n - 1]).decode()
            off += n
        elif etype in (0x03, 0x04):
            sub, used = bson_decode(mv, off, _depth=depth + 1)
            off += used
            if etype == 0x04:
                if not all(k.isdigit() for k in sub):
                    raise ParseError("bson array with non-numeric keys")
                doc[key] = [sub[k] for k in sorted(sub, key=int)]
            else:
                doc[key] = sub
        elif etype == 0x05:
            n, subtype = struct.unpack_from("<iB", mv, off)
            off += 5
            if n < 0 or off + n > total:
                raise ParseError("bson binary out of range")
            doc[key] = bytes(mv[off : off + n])
            off += n
        elif etype == 0x07:
            if off + 12 > total:
                raise ParseError("bson objectid truncated")
            doc[key] = ObjectId(bytes(mv[off : off + 12]))
            off += 12
        elif etype == 0x08:
            doc[key] = mv[off] != 0
            off += 1
        elif etype == 0x0A:
            doc[key] = None
        elif etype == 0x10:
            (doc[key],) = struct.unpack_from("<i", mv, off)
            off += 4
        elif etype == 0x12:
            (doc[key],) = struct.unpack_from("<q", mv, off)
            off += 8
        else:
            raise ParseError(f"bson element type {etype:#x} unsupported")
        if off > total:
            raise ParseError("bson element overruns document")


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


class MongoFrame:
    __slots__ = (
        "request_id",
        "response_to",
        "op_code",
        "body",
        "process_inline",
        "arrival_ts",  # stamped by the messenger at cut
    )

    # the messenger's routing surface: always a request
    is_response = False
    is_stream = False
    wire_protocol = "mongo"

    def __init__(self, request_id, response_to, op_code, body: bytes):
        self.request_id = request_id
        self.response_to = response_to
        self.op_code = op_code
        self.body = body
        self.arrival_ts = None
        # per-connection context + in-order replies: stay on the reader
        self.process_inline = True


def parse_header(header: bytes) -> Optional[int]:
    if len(header) < HEAD_BYTES:
        # gate early on the opcode when enough bytes arrived to read it
        if len(header) >= 4:
            (length,) = struct.unpack_from("<i", header)
            if length < HEAD_BYTES:
                raise ParseError("not mongo: impossible length")
        return None
    length, _rid, _rto, op = HEAD.unpack_from(header)
    if op not in _OPCODES or length < HEAD_BYTES:
        raise ParseError("not a mongo opcode")
    return length


def try_parse_frame(buf: bytes) -> Tuple[Optional[MongoFrame], int]:
    if len(buf) < HEAD_BYTES:
        return None, 0
    length, rid, rto, op = HEAD.unpack_from(buf)
    if op not in _OPCODES or length < HEAD_BYTES:
        raise ParseError("not a mongo frame")
    if len(buf) < length:
        return None, 0
    return MongoFrame(rid, rto, op, bytes(buf[HEAD_BYTES:length])), length


def pack_reply(
    response_to: int,
    docs: List[Dict[str, Any]],
    request_id: int = 0,
    response_flags: int = 0,
    cursor_id: int = 0,
    starting_from: int = 0,
) -> bytes:
    body = struct.pack(
        "<iqii", response_flags, cursor_id, starting_from, len(docs)
    ) + b"".join(bson_encode(d) for d in docs)
    head = HEAD.pack(HEAD_BYTES + len(body), request_id, response_to, OP_REPLY)
    return head + body


class QueryMessage:
    """Parsed OP_QUERY (wire spec: flags i32, fullCollectionName cstring,
    numberToSkip i32, numberToReturn i32, query doc, optional selector)."""

    __slots__ = ("flags", "collection", "skip", "limit", "query", "fields")

    def __init__(self, body: bytes):
        mv = memoryview(body)
        if len(mv) < 4:
            raise ParseError("op_query truncated")
        (self.flags,) = struct.unpack_from("<i", mv)
        self.collection, off = _bson_cstring(mv, 4)
        if off + 8 > len(mv):
            raise ParseError("op_query truncated after collection")
        self.skip, self.limit = struct.unpack_from("<ii", mv, off)
        off += 8
        self.query, used = bson_decode(mv, off)
        off += used
        self.fields = None
        if off < len(mv):
            self.fields, _ = bson_decode(mv, off)


# ---------------------------------------------------------------------------
# adaptor (mongo_service_adaptor.h)
# ---------------------------------------------------------------------------


class MongoServiceAdaptor:
    """Subclass and register via ServerOptions(mongo_service_adaptor=...).

    ``handle_query`` returns the documents for an OP_REPLY. Write ops
    (insert/update/delete) have no wire reply in this legacy protocol;
    override their hooks for side effects. ``create_socket_context``
    supplies the per-connection state object (cursors, last error)."""

    def create_socket_context(self) -> Any:
        return {}

    def handle_query(self, ctx, query: QueryMessage) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def handle_insert(self, ctx, body: bytes) -> None:
        pass

    def handle_update(self, ctx, body: bytes) -> None:
        pass

    def handle_delete(self, ctx, body: bytes) -> None:
        pass

    def serialize_error(self, response_to: int, message: str) -> bytes:
        """The SerializeError hook: default = standard $err reply with the
        QueryFailure response flag (bit 1)."""
        return pack_reply(
            response_to, [{"$err": message, "code": 1}], response_flags=2
        )


def _process_request(sock, frame: MongoFrame) -> None:
    server = sock.context.get("server")
    adaptor = (
        getattr(server.options, "mongo_service_adaptor", None)
        if server is not None
        else None
    )
    if adaptor is None:
        logger.warning("mongo frame on %r with no adaptor", sock)
        return
    ctx = sock.context.get("mongo_ctx")
    if ctx is None:
        ctx = adaptor.create_socket_context()
        sock.context["mongo_ctx"] = ctx
    try:
        if frame.op_code == OP_QUERY:
            q = QueryMessage(frame.body)
            docs = adaptor.handle_query(ctx, q)
            sock.write(pack_reply(frame.request_id, list(docs)))
        elif frame.op_code == OP_INSERT:
            adaptor.handle_insert(ctx, frame.body)
        elif frame.op_code == OP_UPDATE:
            adaptor.handle_update(ctx, frame.body)
        elif frame.op_code == OP_DELETE:
            adaptor.handle_delete(ctx, frame.body)
        elif frame.op_code == OP_GET_MORE:
            # cursors are not retained: official "cursor not found" flag
            sock.write(
                pack_reply(frame.request_id, [], response_flags=1)
            )
        # OP_KILL_CURSORS / legacy OP_MSG: no reply defined
    except ParseError as e:
        sock.write(adaptor.serialize_error(frame.request_id, str(e)))
    except Exception as e:  # user adaptor bug: answer, don't wedge
        logger.exception("mongo adaptor raised")
        sock.write(adaptor.serialize_error(frame.request_id, repr(e)))


def _enabled_for(sock) -> bool:
    server = sock.context.get("server")
    return (
        server is not None
        and getattr(server.options, "mongo_service_adaptor", None) is not None
    )


MONGO = Protocol(
    name="mongo",
    parse=try_parse_frame,
    parse_header=parse_header,
    process_request=_process_request,
    enabled_for=_enabled_for,
)

if "mongo" not in protocol_registry:
    protocol_registry.register(MONGO)
