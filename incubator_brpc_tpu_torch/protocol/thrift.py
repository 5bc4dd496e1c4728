"""Thrift framed-binary client (reference src/brpc/policy/thrift_protocol.cpp
+ thrift_service/thrift_message: the framed transport + TBinaryProtocol
message envelope, pipelined over one Socket like every other client here).

Scope (matching how the reference is actually used — the dynamic
ThriftMessage path, not codegen): TFramedTransport (4-byte length prefix),
strict TBinaryProtocol message header (version|type, method, seqid), and
struct codecs for the common wire shapes — enough to call services of the
form ``binary echo(1: binary data)`` / ``string echo(1: string)`` and to
parse TApplicationException replies. Full IDL codegen (the reference
defers that to the thrift compiler) is out of scope.

Reply matching uses seqid, not FIFO: thrift brokers may reorder.

The port's copy of the JAX package's ``protocol/thrift.py``, client and
server halves, on the port's ``resp._Pending`` and ``tbus_std.ParseError``.
On a ``native_plane=True`` server a thrift connection is handed to the
Python plane (its first four bytes, a big-endian frame length, are neither
tbus_std's nor baidu_std's magic) and served here.
"""

from __future__ import annotations

import itertools
import logging
import struct
import threading
from typing import Dict, Optional, Tuple

from incubator_brpc_tpu_torch.protocol.resp import _Pending  # same future shape
from incubator_brpc_tpu_torch.protocol.tbus_std import ParseError

logger = logging.getLogger(__name__)

VERSION_1 = 0x80010000
T_CALL, T_REPLY, T_EXCEPTION = 1, 2, 3
# thrift type ids
TT_STOP, TT_STRING, TT_STRUCT, TT_I32 = 0, 11, 12, 8


class ThriftError(Exception):
    pass


class TApplicationException(ThriftError):
    def __init__(self, message: str, type_id: int):
        super().__init__(f"{message} (type {type_id})")
        self.type_id = type_id


def _pack_string(b: bytes) -> bytes:
    return struct.pack(">i", len(b)) + b


def pack_call(method: str, payload: bytes, seqid: int) -> bytes:
    """One framed CALL whose args struct is {1: binary payload}."""
    body = (
        struct.pack(">I", VERSION_1 | T_CALL)
        + _pack_string(method.encode())
        + struct.pack(">i", seqid)
        # args struct: field 1, type string/binary
        + struct.pack(">bh", TT_STRING, 1)
        + _pack_string(payload)
        + struct.pack(">b", TT_STOP)
    )
    return struct.pack(">i", len(body)) + body


def pack_reply(method: str, payload: bytes, seqid: int) -> bytes:
    """A success REPLY whose result struct is {0: binary} (servers/mocks)."""
    body = (
        struct.pack(">I", VERSION_1 | T_REPLY)
        + _pack_string(method.encode())
        + struct.pack(">i", seqid)
        + struct.pack(">bh", TT_STRING, 0)
        + _pack_string(payload)
        + struct.pack(">b", TT_STOP)
    )
    return struct.pack(">i", len(body)) + body


def pack_exception(method: str, message: str, seqid: int, type_id: int = 6) -> bytes:
    body = (
        struct.pack(">I", VERSION_1 | T_EXCEPTION)
        + _pack_string(method.encode())
        + struct.pack(">i", seqid)
        # TApplicationException struct: {1: string message, 2: i32 type}
        + struct.pack(">bh", TT_STRING, 1)
        + _pack_string(message.encode())
        + struct.pack(">bh", TT_I32, 2)
        + struct.pack(">i", type_id)
        + struct.pack(">b", TT_STOP)
    )
    return struct.pack(">i", len(body)) + body


def _read_string(buf: memoryview, off: int) -> Tuple[bytes, int]:
    (n,) = struct.unpack_from(">i", buf, off)
    off += 4
    if n < 0 or off + n > len(buf):
        raise ThriftError(f"bad string length {n} at offset {off - 4}")
    return bytes(buf[off : off + n]), off + n


def _skip_field(buf: memoryview, off: int, ftype: int) -> int:
    """Skip an unrecognized field (forward compatibility). Wire lengths are
    untrusted: a negative or overlong length must raise, never move ``off``
    backwards (which would cycle the cut loop forever)."""
    if ftype == TT_STRING:
        (n,) = struct.unpack_from(">i", buf, off)
        if n < 0 or off + 4 + n > len(buf):
            raise ThriftError(f"bad skip-string length {n} at offset {off}")
        return off + 4 + n
    if ftype == TT_I32:
        return off + 4
    sizes = {2: 1, 3: 1, 4: 8, 6: 2, 10: 8}  # bool, byte, double, i16, i64
    if ftype in sizes:
        return off + sizes[ftype]
    raise ThriftError(f"cannot skip field type {ftype}")


def parse_frame(buf: bytes) -> Tuple[Optional[dict], int]:
    """Cut one framed message: (parsed, consumed) or (None, -1) when
    incomplete. parsed = {type, method, seqid, payload | error}."""
    if len(buf) < 4:
        return None, -1
    (flen,) = struct.unpack_from(">i", buf)
    if flen <= 0 or flen > (64 << 20):
        raise ThriftError(f"bad frame length {flen}")
    if len(buf) < 4 + flen:
        return None, -1
    mv = memoryview(buf)[4 : 4 + flen]
    try:
        return _parse_body(mv, flen)
    except struct.error as e:
        # a *complete* frame whose declared flen is too short for its own
        # structure: wire corruption, not an incomplete read — surface it as
        # ThriftError so the client's fail-fast path runs
        raise ThriftError(f"truncated structure inside frame: {e}") from None


def _parse_body(mv: memoryview, flen: int) -> Tuple[Optional[dict], int]:
    (vt,) = struct.unpack_from(">I", mv, 0)
    if vt & 0xFFFF0000 != VERSION_1:
        raise ThriftError(f"bad thrift version {vt:#x}")
    mtype = vt & 0xFF
    method, off = _read_string(mv, 4)
    (seqid,) = struct.unpack_from(">i", mv, off)
    off += 4
    out = {"type": mtype, "method": method.decode(), "seqid": seqid}
    # walk the result struct
    fields: Dict[int, object] = {}
    while off < len(mv):
        (ftype,) = struct.unpack_from(">b", mv, off)
        off += 1
        if ftype == TT_STOP:
            break
        (fid,) = struct.unpack_from(">h", mv, off)
        off += 2
        if ftype == TT_STRING:
            val, off = _read_string(mv, off)
            fields[fid] = val
        elif ftype == TT_I32:
            (val,) = struct.unpack_from(">i", mv, off)
            off += 4
            fields[fid] = val
        else:
            off = _skip_field(mv, off, ftype)
    if mtype == T_EXCEPTION:
        out["error"] = TApplicationException(
            (fields.get(1) or b"").decode(errors="replace"),
            int(fields.get(2, 0)),
        )
    else:
        out["payload"] = fields.get(0, fields.get(1, b""))
    return out, 4 + flen


class ThriftClient:
    """Framed-binary client over one Socket; replies matched by seqid."""

    def __init__(self, remote: str, timeout: float = 5.0):
        from incubator_brpc_tpu_torch.transport.sock import Socket

        self._pending: Dict[int, _Pending] = {}
        self._plock = threading.Lock()
        self._rbuf = b""
        self._seq = itertools.count(1)
        self._sock = Socket.connect(remote, timeout=timeout)
        self._sock.messenger = self
        # a bound-method hook on a socket this client owns (created here,
        # closed with the client): hook and owner share one lifetime
        self._sock.on_failed.append(self._on_socket_failed)

    def process(self, sock, defer_tail: bool = False) -> None:
        data = sock._read_buf.to_bytes()
        sock._read_buf.popn(len(data))
        self._rbuf += data
        off = 0
        while True:
            try:
                msg, consumed = parse_frame(self._rbuf[off:] if off else self._rbuf)
            except ThriftError as e:
                self._fail_all(e)
                sock.set_failed()
                return
            if consumed == -1:
                break
            # slice once per loop pass is fine here: frames are small and
            # off-tracking keeps it linear overall
            self._rbuf = self._rbuf[off + consumed :] if off else self._rbuf[consumed:]
            off = 0
            with self._plock:
                pending = self._pending.pop(msg["seqid"], None)
            if pending is not None:
                pending.set(msg)

    def _on_socket_failed(self, sock) -> None:
        from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool

        err = ThriftError(f"connection lost: {sock.error_text}")
        global_worker_pool().spawn(self._fail_all, err)

    def _fail_all(self, err: Exception) -> None:
        with self._plock:
            pending, self._pending = dict(self._pending), {}
        for p in pending.values():
            p.set(err)

    def call(
        self, method: str, payload: bytes, timeout: Optional[float] = 5.0
    ) -> bytes:
        """Invoke ``method(binary) -> binary``; raises
        TApplicationException on an EXCEPTION reply."""
        seqid = next(self._seq)
        p = _Pending()
        with self._plock:
            self._pending[seqid] = p
            rc = self._sock.write(pack_call(method, payload, seqid))
            if rc != 0:
                self._pending.pop(seqid, None)
        if rc != 0:
            raise ThriftError(f"write failed ({rc})")
        if not p.wait(timeout):
            with self._plock:
                self._pending.pop(seqid, None)
            raise TimeoutError("thrift reply timed out")
        if isinstance(p.reply, Exception):
            raise p.reply
        msg = p.reply
        if "error" in msg:
            raise msg["error"]
        return msg["payload"]

    def close(self) -> None:
        self._sock.recycle()


class MockThriftServer:
    """Echo-style framed thrift server on the Acceptor/Socket stack:
    ``echo`` returns the payload; anything else raises
    TApplicationException UNKNOWN_METHOD (the loopback test shape)."""

    def __init__(self):
        self._acceptor = None
        self.port = 0

    def start(self) -> bool:
        from incubator_brpc_tpu_torch.transport.acceptor import Acceptor
        from incubator_brpc_tpu_torch.utils.endpoint import EndPoint

        self._acceptor = Acceptor(
            EndPoint(ip="127.0.0.1", port=0), messenger=_MockMessenger()
        )
        self.port = self._acceptor.endpoint.port
        return True

    def stop(self) -> None:
        if self._acceptor is not None:
            self._acceptor.stop()


class _MockMessenger:
    def process(self, sock, defer_tail: bool = False) -> None:
        data = sock._read_buf.to_bytes()
        consumed = 0
        out = []
        while True:
            msg, n = parse_frame(data[consumed:])
            if n == -1:
                break
            consumed += n
            if msg["method"] == "echo":
                out.append(pack_reply("echo", msg["payload"], msg["seqid"]))
            else:
                out.append(
                    pack_exception(
                        msg["method"], "unknown method", msg["seqid"], type_id=1
                    )
                )
        if consumed:
            sock._read_buf.popn(consumed)
        if out:
            sock.write(b"".join(out))


# ---------------------------------------------------------------------------
# server side — ServerOptions(thrift_service=...) serves framed thrift on
# the shared port (reference ThriftService / thrift_service.cpp,
# ProcessThriftRequest thrift_protocol.cpp:314: one handler object receives
# (method, args) and fills the result; here the handler is
# ``fn(cntl, method: str, payload: bytes) -> bytes`` with the args/result
# carried as the binary-field convention this module's client speaks)
# ---------------------------------------------------------------------------


class ThriftRequestFrame:
    __slots__ = ("method", "seqid", "payload", "arrival_ts")  # arrival_ts: stamped at cut

    is_response = False
    is_stream = False
    process_inline = False
    correlation_id = 0
    meta = None
    wire_protocol = "thrift"

    def __init__(self, method: str, seqid: int, payload: bytes):
        self.method = method
        self.seqid = seqid
        self.payload = payload
        self.arrival_ts = None


def _server_parse_header(header: bytes):
    # framed thrift: i32 length then the 0x8001 version word — the version
    # bytes at offset 4..6 classify; fewer than 6 bytes cannot (the
    # enabled_for gate keeps this protocol off servers without a
    # thrift_service, like nshead's deep-magic discipline)
    if len(header) < 6:
        return None
    if header[4] != 0x80 or header[5] != 0x01:
        raise ParseError("not thrift")
    (flen,) = struct.unpack_from(">i", header)
    if flen <= 0 or flen > (64 << 20):
        raise ParseError(f"bad thrift frame length {flen}")
    return 4 + flen


def _server_try_parse(buf: bytes):
    try:
        msg, consumed = parse_frame(buf)
    except ThriftError as e:
        raise ParseError(str(e)) from None
    if msg is None:
        return None, 0
    if msg["type"] != T_CALL:
        raise ParseError(f"unexpected thrift message type {msg['type']}")
    return (
        ThriftRequestFrame(msg["method"], msg["seqid"], msg.get("payload", b"")),
        consumed,
    )


def _server_process_request(sock, frame: ThriftRequestFrame) -> None:
    from incubator_brpc_tpu_torch.rpc.controller import Controller
    from incubator_brpc_tpu_torch.utils.status import ErrorCode

    server = sock.context.get("server")
    handler = (
        getattr(server.options, "thrift_service", None) if server else None
    )
    if handler is None:
        sock.set_failed(ErrorCode.EREQUEST, "no thrift service")
        return
    cntl = Controller()
    cntl._server = server
    cntl.remote_side = sock.remote
    cntl._sock = sock
    cntl._mark_start()
    from incubator_brpc_tpu_torch.rpc import server as server_mod

    _prev_server = getattr(server_mod._usercode_tls, "server", None)
    server_mod._usercode_tls.server = server  # thread_local_data() works here
    try:
        reply = handler(cntl, frame.method, frame.payload)
    except Exception as e:
        logger.exception("thrift service raised")
        cntl.set_failed(ErrorCode.EINTERNAL, f"handler raised: {e!r}")
        reply = None
    finally:
        server_mod._usercode_tls.server = _prev_server
    cntl._mark_end()
    if cntl.error_code:
        # INTERNAL_ERROR(6) unless the handler chose UNKNOWN_METHOD-style
        # codes via cntl.error_code mapping is deliberate-simple here
        wire = pack_exception(
            frame.method, cntl.error_text or "error", frame.seqid,
            type_id=1 if cntl.error_code == ErrorCode.ENOMETHOD else 6,
        )
    else:
        wire = pack_reply(frame.method, reply or b"", frame.seqid)
    sock.write(wire)


def _server_enabled(sock) -> bool:
    server = sock.context.get("server") if sock.context else None
    return (
        server is not None
        and getattr(server.options, "thrift_service", None) is not None
    )


from incubator_brpc_tpu_torch.protocol.registry import (  # noqa: E402
    Protocol,
    protocol_registry,
)

THRIFT_SERVER = Protocol(
    name="thrift",
    parse=_server_try_parse,
    parse_header=_server_parse_header,
    process_request=_server_process_request,
    enabled_for=_server_enabled,
)

if "thrift" not in protocol_registry:
    protocol_registry.register(THRIFT_SERVER)
