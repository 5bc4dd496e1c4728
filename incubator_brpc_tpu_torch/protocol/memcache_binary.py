"""Memcache BINARY protocol client — the wire the reference speaks
(policy/memcache_binary_protocol.cpp + memcache_binary_header.h; the
couchbase_authenticator rides the same SASL commands).

Wire: 24-byte header
    magic(1) opcode(1) key_len(u16be) extras_len(1) data_type(1)
    vbucket_or_status(u16be) total_body(u32be) opaque(4) cas(u64be)
then extras + key + value. Responses echo the request's ``opaque``, so
replies match by opaque (NOT fifo) — several in-flight commands may
complete out of order on a real server; the reference relies on the same
field (memcache_binary_protocol.cpp ParseMemcacheMessage).

SASL PLAIN auth (MC_BINARY_SASL_AUTH) is the CouchbaseAuthenticator
analog: credentials go first on the connection, a rejection fails the
client at construction.

The port's copy of the JAX package's ``protocol/memcache_binary.py``: the
same header, opaque matching and mock, on the port's ``resp._Pending``.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, Optional, Tuple

from incubator_brpc_tpu_torch.protocol.resp import _Pending

MAGIC_REQUEST = 0x80
MAGIC_RESPONSE = 0x81

OP_GET = 0x00
OP_SET = 0x01
OP_ADD = 0x02
OP_REPLACE = 0x03
OP_DELETE = 0x04
OP_INCREMENT = 0x05
OP_DECREMENT = 0x06
OP_FLUSH = 0x08
OP_NOOP = 0x0A
OP_VERSION = 0x0B
OP_GETK = 0x0C
OP_APPEND = 0x0E
OP_PREPEND = 0x0F
OP_SASL_AUTH = 0x21

STATUS_OK = 0x0000
STATUS_KEY_NOT_FOUND = 0x0001
STATUS_KEY_EXISTS = 0x0002
STATUS_ITEM_NOT_STORED = 0x0005
STATUS_AUTH_ERROR = 0x0020

_HDR = struct.Struct(">BBHBBHI4sQ")
HEADER_BYTES = _HDR.size  # 24


class MemcacheBinaryError(Exception):
    def __init__(self, status: int, message: str = ""):
        super().__init__(message or f"status {status:#06x}")
        self.status = status


def pack_request(
    opcode: int,
    key: bytes = b"",
    value: bytes = b"",
    extras: bytes = b"",
    opaque: int = 0,
    cas: int = 0,
) -> bytes:
    total = len(extras) + len(key) + len(value)
    return _HDR.pack(
        MAGIC_REQUEST, opcode, len(key), len(extras), 0, 0, total,
        struct.pack(">I", opaque & 0xFFFFFFFF), cas,
    ) + extras + key + value


def pack_response(
    opcode: int,
    status: int = STATUS_OK,
    key: bytes = b"",
    value: bytes = b"",
    extras: bytes = b"",
    opaque: bytes = b"\x00\x00\x00\x00",
    cas: int = 0,
) -> bytes:
    total = len(extras) + len(key) + len(value)
    return _HDR.pack(
        MAGIC_RESPONSE, opcode, len(key), len(extras), 0, status, total,
        opaque, cas,
    ) + extras + key + value


def parse_packet(buf: bytes, off: int = 0):
    """(frame_dict, next_offset) or (None, -1) while incomplete; raises
    MemcacheBinaryError on a broken magic (connection desync)."""
    if len(buf) - off < HEADER_BYTES:
        return None, -1
    magic, opcode, key_len, extras_len, _, status, total, opaque, cas = \
        _HDR.unpack_from(buf, off)
    if magic not in (MAGIC_REQUEST, MAGIC_RESPONSE):
        raise MemcacheBinaryError(0xFFFF, f"bad magic {magic:#x}")
    end = off + HEADER_BYTES + total
    if len(buf) < end:
        return None, -1
    body = memoryview(buf)[off + HEADER_BYTES : end]
    extras = bytes(body[:extras_len])
    key = bytes(body[extras_len : extras_len + key_len])
    value = bytes(body[extras_len + key_len :])
    return {
        "magic": magic, "opcode": opcode, "status": status,
        "extras": extras, "key": key, "value": value,
        "opaque": opaque, "cas": cas,
    }, end


class MemcacheBinaryClient:
    """Pipelined binary-protocol client over one Socket; replies match by
    opaque. API mirrors the text MemcacheClient so callers can swap
    protocols (the reference exposes one MemcacheRequest/Response API over
    its binary wire)."""

    def __init__(self, remote: str, timeout: float = 5.0,
                 username: Optional[str] = None,
                 password: Optional[str] = None):
        from incubator_brpc_tpu_torch.transport.sock import Socket

        self._pending: Dict[bytes, _Pending] = {}
        self._plock = threading.Lock()
        self._opaque = 0
        self._rbuf = b""
        self._sock = Socket.connect(remote, timeout=timeout)
        self._sock.messenger = self
        # a bound-method hook on a socket this client owns (created here,
        # closed with the client): hook and owner share one lifetime
        self._sock.on_failed.append(self._on_socket_failed)
        if password is not None:
            # SASL PLAIN: authzid \0 authcid \0 passwd (couchbase_authenticator.cpp)
            token = b"\x00" + (username or "").encode() + b"\x00" + \
                password.encode()
            try:
                frame = self._issue(
                    OP_SASL_AUTH, key=b"PLAIN", value=token, timeout=timeout
                )
            except (MemcacheBinaryError, TimeoutError):
                self._sock.recycle()
                raise
            if frame["status"] != STATUS_OK:
                self._sock.recycle()
                raise MemcacheBinaryError(
                    frame["status"], "SASL auth rejected"
                )

    # InputMessenger duck-type (same shape as the RESP client)
    def process(self, sock, defer_tail: bool = False) -> None:
        data = sock._read_buf.to_bytes()
        sock._read_buf.popn(len(data))
        self._rbuf += data
        off = 0
        while True:
            try:
                frame, nxt = parse_packet(self._rbuf, off)
            except MemcacheBinaryError as e:
                self._fail_all(e)
                sock.set_failed()
                return
            if nxt == -1:
                break
            off = nxt
            with self._plock:
                pending = self._pending.pop(frame["opaque"], None)
            if pending is not None:
                pending.set(frame)
        if off:
            self._rbuf = self._rbuf[off:]

    def _on_socket_failed(self, sock) -> None:
        from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool

        err = MemcacheBinaryError(0xFFFF, f"connection lost: {sock.error_text}")
        global_worker_pool().spawn(self._fail_all, err)

    def _fail_all(self, err: MemcacheBinaryError) -> None:
        with self._plock:
            pending, self._pending = dict(self._pending), {}
        for p in pending.values():
            p.set(err)

    def _issue(self, opcode: int, key: bytes = b"", value: bytes = b"",
               extras: bytes = b"", timeout: Optional[float] = 5.0) -> dict:
        p = _Pending()
        with self._plock:
            self._opaque = (self._opaque + 1) & 0xFFFFFFFF
            opq = struct.pack(">I", self._opaque)
            self._pending[opq] = p
            rc = self._sock.write(
                pack_request(opcode, key, value, extras,
                             opaque=self._opaque)
            )
        if rc != 0:
            with self._plock:
                self._pending.pop(opq, None)
            raise MemcacheBinaryError(0xFFFF, f"write failed rc={rc}")
        if not p.wait(timeout):
            with self._plock:
                self._pending.pop(opq, None)
            raise TimeoutError(f"memcache opcode {opcode:#x} timed out")
        frame = p.reply
        if isinstance(frame, Exception):
            raise frame
        return frame

    # -- public API (text-client parity) -----------------------------------

    def set(self, key: str, value: bytes, flags: int = 0, exptime: int = 0,
            timeout: Optional[float] = 5.0) -> bool:
        return self._store(OP_SET, key, value, flags, exptime, timeout)

    def add(self, key: str, value: bytes, timeout: Optional[float] = 5.0) -> bool:
        return self._store(OP_ADD, key, value, 0, 0, timeout)

    def replace(self, key: str, value: bytes,
                timeout: Optional[float] = 5.0) -> bool:
        return self._store(OP_REPLACE, key, value, 0, 0, timeout)

    def _store(self, opcode, key, value, flags, exptime, timeout) -> bool:
        frame = self._issue(
            opcode, key.encode(), value,
            extras=struct.pack(">II", flags, exptime), timeout=timeout,
        )
        if frame["status"] == STATUS_OK:
            return True
        if frame["status"] in (STATUS_KEY_EXISTS, STATUS_ITEM_NOT_STORED,
                               STATUS_KEY_NOT_FOUND):
            return False
        raise MemcacheBinaryError(frame["status"])

    def get(self, key: str, timeout: Optional[float] = 5.0) -> Optional[bytes]:
        frame = self._issue(OP_GET, key.encode(), timeout=timeout)
        if frame["status"] == STATUS_KEY_NOT_FOUND:
            return None
        if frame["status"] != STATUS_OK:
            raise MemcacheBinaryError(frame["status"])
        return frame["value"]

    def get_multi(self, *keys: str,
                  timeout: Optional[float] = 5.0) -> Dict[str, bytes]:
        # pipelined GETKs: all requests written before the first wait
        pendings = []
        for k in keys:
            p = _Pending()
            with self._plock:
                self._opaque = (self._opaque + 1) & 0xFFFFFFFF
                opq = struct.pack(">I", self._opaque)
                self._pending[opq] = p
                rc = self._sock.write(
                    pack_request(OP_GETK, k.encode(), opaque=self._opaque)
                )
                if rc != 0:
                    self._pending.pop(opq, None)
                    raise MemcacheBinaryError(
                        0xFFFF, f"write failed rc={rc}"
                    )
            pendings.append((k, opq, p))
        out: Dict[str, bytes] = {}
        for k, opq, p in pendings:
            if not p.wait(timeout):
                with self._plock:  # timed out: never leak the entry
                    self._pending.pop(opq, None)
                raise TimeoutError(f"get_multi({k!r}) timed out")
            frame = p.reply
            if isinstance(frame, Exception):
                raise frame
            if frame["status"] == STATUS_OK:
                out[k] = frame["value"]
            elif frame["status"] != STATUS_KEY_NOT_FOUND:
                raise MemcacheBinaryError(frame["status"])
        return out

    def delete(self, key: str, timeout: Optional[float] = 5.0) -> bool:
        frame = self._issue(OP_DELETE, key.encode(), timeout=timeout)
        if frame["status"] == STATUS_OK:
            return True
        if frame["status"] == STATUS_KEY_NOT_FOUND:
            return False
        raise MemcacheBinaryError(frame["status"])

    def incr(self, key: str, delta: int = 1,
             timeout: Optional[float] = 5.0) -> Optional[int]:
        return self._arith(OP_INCREMENT, key, delta, timeout)

    def decr(self, key: str, delta: int = 1,
             timeout: Optional[float] = 5.0) -> Optional[int]:
        return self._arith(OP_DECREMENT, key, delta, timeout)

    def _arith(self, opcode, key, delta, timeout) -> Optional[int]:
        # expiry 0xFFFFFFFF = do NOT vivify a missing key (binary spec:
        # any other expiration auto-creates with `initial`) — required for
        # the text-client-parity None-on-missing contract
        extras = struct.pack(">QQI", delta, 0, 0xFFFFFFFF)
        frame = self._issue(opcode, key.encode(), extras=extras,
                            timeout=timeout)
        if frame["status"] == STATUS_KEY_NOT_FOUND:
            return None
        if frame["status"] != STATUS_OK:
            raise MemcacheBinaryError(frame["status"])
        return struct.unpack(">Q", frame["value"])[0]

    def append(self, key: str, value: bytes,
               timeout: Optional[float] = 5.0) -> bool:
        return self._concat(OP_APPEND, key, value, timeout)

    def prepend(self, key: str, value: bytes,
                timeout: Optional[float] = 5.0) -> bool:
        return self._concat(OP_PREPEND, key, value, timeout)

    def _concat(self, opcode, key, value, timeout) -> bool:
        frame = self._issue(opcode, key.encode(), value, timeout=timeout)
        if frame["status"] == STATUS_OK:
            return True
        if frame["status"] in (STATUS_ITEM_NOT_STORED, STATUS_KEY_NOT_FOUND):
            return False
        raise MemcacheBinaryError(frame["status"])

    def version(self, timeout: Optional[float] = 5.0) -> str:
        frame = self._issue(OP_VERSION, timeout=timeout)
        if frame["status"] != STATUS_OK:
            raise MemcacheBinaryError(frame["status"])
        return frame["value"].decode()

    def flush_all(self, timeout: Optional[float] = 5.0) -> bool:
        frame = self._issue(OP_FLUSH, timeout=timeout)
        if frame["status"] != STATUS_OK:
            raise MemcacheBinaryError(frame["status"])
        return True

    def close(self) -> None:
        self._sock.recycle()


class MockMemcacheBinaryServer:
    """In-process binary-protocol server for tests (the reference tests
    its client against a mock the same way)."""

    def __init__(self, password: Optional[str] = None):
        self._data: Dict[bytes, Tuple[bytes, int]] = {}
        self._lock = threading.Lock()
        self._acceptor = None
        self.port = 0
        self.password = password

    def start(self) -> bool:
        from incubator_brpc_tpu_torch.transport.acceptor import Acceptor
        from incubator_brpc_tpu_torch.utils.endpoint import EndPoint

        self._acceptor = Acceptor(
            EndPoint(ip="127.0.0.1", port=0), messenger=self
        )
        self.port = self._acceptor.endpoint.port
        return True

    def stop(self) -> None:
        if self._acceptor is not None:
            self._acceptor.stop()

    # messenger duck-type
    def process(self, sock, defer_tail: bool = False) -> None:
        data = sock._read_buf.to_bytes()
        consumed = 0
        out = []
        while True:
            try:
                frame, nxt = parse_packet(data, consumed)
            except MemcacheBinaryError:
                sock.set_failed()
                return
            if nxt == -1:
                break
            consumed = nxt
            out.append(self._handle(frame, sock.context))
        if consumed:
            sock._read_buf.popn(consumed)
        if out:
            sock.write(b"".join(out))

    def _handle(self, f: dict, ctx: dict) -> bytes:
        op, key, value = f["opcode"], f["key"], f["value"]
        opq = f["opaque"]

        def resp(status=STATUS_OK, value=b"", extras=b"", key=b""):
            return pack_response(op, status, key, value, extras, opq)

        if self.password is not None and not ctx.get("mc_authed"):
            if op == OP_SASL_AUTH:
                # PLAIN token: authzid \0 authcid \0 passwd — any authcid
                # is accepted, only the password is checked
                parts = value.split(b"\x00")
                if (
                    key == b"PLAIN"
                    and len(parts) == 3
                    and parts[2] == self.password.encode()
                ):
                    ctx["mc_authed"] = True
                    return resp(value=b"Authenticated")
                return resp(STATUS_AUTH_ERROR, value=b"Auth failure")
            return resp(STATUS_AUTH_ERROR, value=b"Auth required")
        with self._lock:
            if op in (OP_SET, OP_ADD, OP_REPLACE):
                flags = struct.unpack_from(">I", f["extras"])[0] \
                    if len(f["extras"]) >= 4 else 0
                exists = key in self._data
                if op == OP_ADD and exists:
                    return resp(STATUS_KEY_EXISTS)
                if op == OP_REPLACE and not exists:
                    return resp(STATUS_KEY_NOT_FOUND)
                self._data[key] = (value, flags)
                return resp()
            if op in (OP_GET, OP_GETK):
                item = self._data.get(key)
                if item is None:
                    return resp(STATUS_KEY_NOT_FOUND)
                return resp(
                    value=item[0],
                    extras=struct.pack(">I", item[1]),
                    key=key if op == OP_GETK else b"",
                )
            if op == OP_DELETE:
                return resp() if self._data.pop(key, None) is not None \
                    else resp(STATUS_KEY_NOT_FOUND)
            if op in (OP_INCREMENT, OP_DECREMENT):
                delta = struct.unpack_from(">Q", f["extras"])[0]
                item = self._data.get(key)
                if item is None:
                    return resp(STATUS_KEY_NOT_FOUND)
                cur = int(item[0] or b"0")
                cur = cur + delta if op == OP_INCREMENT else max(0, cur - delta)
                self._data[key] = (str(cur).encode(), item[1])
                return resp(value=struct.pack(">Q", cur))
            if op in (OP_APPEND, OP_PREPEND):
                item = self._data.get(key)
                if item is None:
                    return resp(STATUS_ITEM_NOT_STORED)
                joined = item[0] + value if op == OP_APPEND else value + item[0]
                self._data[key] = (joined, item[1])
                return resp()
            if op == OP_VERSION:
                return resp(value=b"1.6.0-tbrpc")
            if op == OP_FLUSH:
                self._data.clear()
                return resp()
            if op == OP_NOOP:
                return resp()
        return resp(0x0081, value=b"Unknown command")
