"""Memcache client — text protocol, pipelined over one Socket (reference
src/brpc/memcache.{h,cpp} + policy/memcache_binary_protocol.cpp; the
reference speaks the binary protocol, this speaks the text protocol — same
client architecture: request builder + resumable reply parser + FIFO
pipelining over Socket's write queue).

Supported: get / set / add / replace / delete / incr / decr / version.
Replies are matched FIFO exactly like the RESP client (resp.py); each
command produces one self-delimiting reply unit (single line, or
VALUE...END for retrievals).

The port's copy of the JAX package's ``protocol/memcache.py``, on the port's
``resp._Pending``; the mock's version line is the JAX package's, word for
word.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple, Union

from incubator_brpc_tpu_torch.protocol.resp import _Pending  # same future shape

CRLF = b"\r\n"

class MemcacheError(Exception):
    pass


def _check_key(key: str) -> str:
    """Text-protocol keys: <=250 bytes, no whitespace/control characters —
    anything else would inject extra commands and shift the FIFO reply
    matching for every later caller on the connection."""
    if not key or len(key) > 250 or any(ord(c) <= 32 or ord(c) == 127 for c in key):
        raise MemcacheError(f"invalid memcache key {key!r}")
    return key


def pack_store(
    verb: str, key: str, value: bytes, flags: int = 0, exptime: int = 0
) -> bytes:
    _check_key(key)
    return (
        f"{verb} {key} {flags} {exptime} {len(value)}\r\n".encode() + value + CRLF
    )


def pack_get(*keys: str) -> bytes:
    return ("get " + " ".join(_check_key(k) for k in keys)).encode() + CRLF


def pack_line(verb: str, *words: Union[str, int], key_first: bool = True) -> bytes:
    if words and key_first:
        _check_key(str(words[0]))
    return " ".join([verb] + [str(w) for w in words]).encode() + CRLF


def parse_reply(buf: bytes, off: int = 0):
    """One reply unit at ``off`` → (parsed, new_off); new_off == -1 when
    incomplete. Retrieval units parse to {key: (flags, value)}; line units
    parse to the line as str; numeric lines to int."""
    line_end = buf.find(CRLF, off)
    if line_end < 0:
        return None, -1
    first = bytes(buf[off:line_end])
    if first.split(b" ", 1)[0] in (b"VALUE", b"END"):
        values: Dict[str, Tuple[int, bytes]] = {}
        pos = off
        while True:
            line_end = buf.find(CRLF, pos)
            if line_end < 0:
                return None, -1
            line = bytes(buf[pos:line_end])
            if line == b"END":
                return values, line_end + 2
            if not line.startswith(b"VALUE "):
                raise MemcacheError(f"bad retrieval line {line!r}")
            _, key, flags, nbytes = line.split(b" ")[:4]
            n = int(nbytes)
            data_at = line_end + 2
            if len(buf) < data_at + n + 2:
                return None, -1
            values[key.decode()] = (int(flags), bytes(buf[data_at : data_at + n]))
            pos = data_at + n + 2
    if first.isdigit():
        return int(first), line_end + 2
    return first.decode(), line_end + 2


class MemcacheClient:
    """Pipelined memcache client (FIFO matching, see resp.RedisClient)."""

    def __init__(self, remote: str, timeout: float = 5.0):
        from incubator_brpc_tpu_torch.transport.sock import Socket

        self._pending: List[_Pending] = []
        self._plock = threading.Lock()
        self._rbuf = b""
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
                reply, nxt = parse_reply(self._rbuf, off)
            except MemcacheError as e:
                self._fail_all(e)
                sock.set_failed()
                return
            if nxt == -1:
                break
            off = nxt
            with self._plock:
                pending = self._pending.pop(0) if self._pending else None
            if pending is not None:
                pending.set(reply)
        if off:
            self._rbuf = self._rbuf[off:]

    def _on_socket_failed(self, sock) -> None:
        # deferred to a pool fiber: this callback can fire synchronously
        # from sock.write() while _issue holds _plock — running _fail_all
        # inline would self-deadlock on the non-reentrant lock
        from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool

        err = MemcacheError(f"connection lost: {sock.error_text}")
        global_worker_pool().spawn(self._fail_all, err)

    def _fail_all(self, err: Exception) -> None:
        with self._plock:
            pending, self._pending = self._pending, []
        for p in pending:
            p.set(err)

    def _issue(self, wire: bytes, timeout: Optional[float]):
        p = _Pending()
        with self._plock:
            self._pending.append(p)
            rc = self._sock.write(wire)
            if rc != 0:
                self._pending.pop()
        if rc != 0:
            raise MemcacheError(f"write failed ({rc})")
        if not p.wait(timeout):
            raise TimeoutError("memcache reply timed out")
        if isinstance(p.reply, Exception):
            raise p.reply
        return p.reply

    # -- commands (memcache.h Request verbs) --------------------------------

    def set(self, key: str, value: bytes, flags: int = 0, exptime: int = 0,
            timeout: Optional[float] = 5.0) -> bool:
        return self._issue(pack_store("set", key, value, flags, exptime), timeout) == "STORED"

    def add(self, key: str, value: bytes, timeout: Optional[float] = 5.0) -> bool:
        return self._issue(pack_store("add", key, value), timeout) == "STORED"

    def replace(self, key: str, value: bytes, timeout: Optional[float] = 5.0) -> bool:
        return self._issue(pack_store("replace", key, value), timeout) == "STORED"

    def get(self, key: str, timeout: Optional[float] = 5.0) -> Optional[bytes]:
        values = self._issue(pack_get(key), timeout)
        entry = values.get(key) if isinstance(values, dict) else None
        return entry[1] if entry else None

    def get_multi(self, *keys: str, timeout: Optional[float] = 5.0) -> Dict[str, bytes]:
        values = self._issue(pack_get(*keys), timeout)
        return {k: v for k, (_, v) in values.items()} if isinstance(values, dict) else {}

    def delete(self, key: str, timeout: Optional[float] = 5.0) -> bool:
        return self._issue(pack_line("delete", key), timeout) == "DELETED"

    def incr(self, key: str, delta: int = 1, timeout: Optional[float] = 5.0):
        return self._issue(pack_line("incr", key, delta), timeout)

    def decr(self, key: str, delta: int = 1, timeout: Optional[float] = 5.0):
        return self._issue(pack_line("decr", key, delta), timeout)

    def version(self, timeout: Optional[float] = 5.0) -> str:
        return str(self._issue(pack_line("version", key_first=False), timeout))

    def close(self) -> None:
        self._sock.recycle()


class MockMemcacheServer:
    """Dict-backed text-protocol server on the Acceptor/Socket stack (the
    loopback test shape, SURVEY §4)."""

    def __init__(self):
        self._data: Dict[str, Tuple[int, bytes]] = {}
        self._lock = threading.Lock()
        self._acceptor = None
        self.port = 0

    def start(self) -> bool:
        from incubator_brpc_tpu_torch.transport.acceptor import Acceptor
        from incubator_brpc_tpu_torch.utils.endpoint import EndPoint

        self._acceptor = Acceptor(
            EndPoint(ip="127.0.0.1", port=0), messenger=_MockMessenger(self)
        )
        self.port = self._acceptor.endpoint.port
        return True

    def stop(self) -> None:
        if self._acceptor is not None:
            self._acceptor.stop()

    def handle_line(self, line: bytes, body: Optional[bytes]) -> bytes:
        words = line.decode().split()
        cmd = words[0] if words else ""
        with self._lock:
            if cmd in ("set", "add", "replace"):
                key, flags = words[1], int(words[2])
                exists = key in self._data
                if (cmd == "add" and exists) or (cmd == "replace" and not exists):
                    return b"NOT_STORED\r\n"
                self._data[key] = (flags, body or b"")
                return b"STORED\r\n"
            if cmd == "get":
                out = []
                for key in words[1:]:
                    entry = self._data.get(key)
                    if entry is not None:
                        flags, value = entry
                        out.append(
                            b"VALUE %s %d %d\r\n%s\r\n"
                            % (key.encode(), flags, len(value), value)
                        )
                out.append(b"END\r\n")
                return b"".join(out)
            if cmd == "delete":
                return (
                    b"DELETED\r\n"
                    if self._data.pop(words[1], None) is not None
                    else b"NOT_FOUND\r\n"
                )
            if cmd in ("incr", "decr"):
                entry = self._data.get(words[1])
                if entry is None:
                    return b"NOT_FOUND\r\n"
                delta = int(words[2])
                v = int(entry[1]) + (delta if cmd == "incr" else -delta)
                v = max(0, v)
                self._data[words[1]] = (entry[0], str(v).encode())
                return b"%d\r\n" % v
            if cmd == "version":
                return b"VERSION incubator_brpc_tpu-mock\r\n"
        return b"ERROR\r\n"


class _MockMessenger:
    def __init__(self, server: MockMemcacheServer):
        self._server = server

    def process(self, sock, defer_tail: bool = False) -> None:
        data = sock._read_buf.to_bytes()
        consumed = 0
        out = []
        while True:
            line_end = data.find(CRLF, consumed)
            if line_end < 0:
                break
            line = data[consumed:line_end]
            words = line.split(b" ")
            if words[0] in (b"set", b"add", b"replace"):
                n = int(words[4])
                data_at = line_end + 2
                if len(data) < data_at + n + 2:
                    break  # body incomplete
                body = data[data_at : data_at + n]
                consumed = data_at + n + 2
                out.append(self._server.handle_line(line, body))
            else:
                consumed = line_end + 2
                out.append(self._server.handle_line(line, None))
        if consumed:
            sock._read_buf.popn(consumed)
        if out:
            sock.write(b"".join(out))
