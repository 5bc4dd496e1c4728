"""RESP — the redis wire protocol, client-side (reference src/brpc/redis.{h,cpp},
redis_command.cpp, redis_reply.cpp, policy/redis_protocol.cpp).

Kept design points:
- commands are built into RESP arrays and pipelined over ONE connection;
  replies come back strictly in command order, matched FIFO — the
  reference implements this with Socket's PipelinedInfo queue
  (socket.h:133); here the client keeps its own FIFO of pending futures
  hanging off the same Socket machinery.
- the reply parser is resumable: a partial reply returns None and is
  retried when more bytes arrive (the redis_reply.cpp incremental parse).

Reply values map to Python: simple string → str, error → RespError,
integer → int, bulk → bytes (None for nil), array → list (None for nil).

A dict-backed ``MockRedisServer`` (GET/SET/DEL/INCR/MGET/PING/ECHO) rides
the same Acceptor/Socket stack — the in-process loopback test shape the
reference uses for every protocol (SURVEY §4).

The port's copy of the JAX package's ``protocol/resp.py``: the same codec,
pipelining and mock, so the two packages put the same bytes on the wire. The
client and the mock are duck-typed messengers of the port's Socket, whose
reader passes ``defer_tail``; neither has a tail to defer. RESP stays on the
host: the JAX package serves no device work over it either.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple, Union

from incubator_brpc_tpu_torch.runtime.butex import Butex, ETIMEDOUT

CRLF = b"\r\n"


class RespError(Exception):
    """An -ERR reply (reference REDIS_REPLY_ERROR)."""


Reply = Union[str, int, bytes, None, List["Reply"], RespError]


def pack_command(*args: Union[str, bytes, int]) -> bytes:
    """Build one RESP array command (RedisCommand, redis_command.cpp)."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, int):
            a = str(a).encode()
        elif isinstance(a, str):
            a = a.encode()
        out.append(b"$%d\r\n%s\r\n" % (len(a), a))
    return b"".join(out)


def parse_reply(buf: bytes, off: int = 0) -> Tuple[Optional[Reply], int]:
    """Parse one reply at ``off``. Returns (reply, new_off); (None-marker)
    incomplete is signaled by new_off == -1. nil bulbs/arrays return None
    with a valid offset, so incompleteness uses the offset sentinel."""
    if off >= len(buf):
        return None, -1
    kind = buf[off : off + 1]
    line_end = buf.find(CRLF, off)
    if line_end < 0:
        return None, -1
    line = buf[off + 1 : line_end]
    nxt = line_end + 2
    if kind == b"+":
        return line.decode(), nxt
    if kind == b"-":
        return RespError(line.decode()), nxt
    if kind == b":":
        return int(line), nxt
    if kind == b"$":
        n = int(line)
        if n == -1:
            return None, nxt
        if len(buf) < nxt + n + 2:
            return None, -1
        return bytes(buf[nxt : nxt + n]), nxt + n + 2
    if kind == b"*":
        n = int(line)
        if n == -1:
            return None, nxt
        items: List[Reply] = []
        for _ in range(n):
            item, nxt = parse_reply(buf, nxt)
            if nxt == -1:
                return None, -1
            items.append(item)
        return items, nxt
    raise ValueError(f"bad RESP type byte {kind!r}")


class _Pending:
    __slots__ = ("reply", "ready")

    def __init__(self):
        self.reply: Reply = None
        self.ready = Butex(0)

    def wait(self, timeout: Optional[float]) -> bool:
        while self.ready.load() == 0:
            if self.ready.wait(0, timeout=timeout) == ETIMEDOUT:
                return False
        return True

    def set(self, reply: Reply) -> None:
        self.reply = reply
        self.ready.add(1)
        self.ready.wake_all()


class RedisClient:
    """Pipelined redis client over one Socket. ``execute`` is synchronous;
    ``pipeline`` sends a batch and collects replies in order."""

    def __init__(self, remote: str, timeout: float = 5.0,
                 password: Optional[str] = None):
        from incubator_brpc_tpu_torch.transport.sock import Socket

        self._pending: List[_Pending] = []
        self._plock = threading.Lock()
        self._rbuf = b""
        self._sock = Socket.connect(remote, timeout=timeout)
        # raw reader: RESP is not header-sized, so bypass InputMessenger
        # and consume the socket's read buffer directly
        self._sock.messenger = self
        # a bound-method hook on a socket this client owns (created here,
        # closed with the client): hook and owner share one lifetime
        self._sock.on_failed.append(self._on_socket_failed)
        if password is not None:
            # the RedisAuthenticator contract: AUTH is the FIRST command on
            # the connection (policy/redis_authenticator.cpp
            # GenerateCredential packs "AUTH <passwd>"); a rejected or
            # timed-out credential fails the client loudly at construction
            # WITHOUT leaking the connected socket + reader fiber
            try:
                reply = self.execute("AUTH", password, timeout=timeout)
            except (RespError, TimeoutError):
                self._sock.recycle()
                raise
            if reply != "OK":  # simple strings parse to str
                self._sock.recycle()
                raise RespError(f"AUTH rejected: {reply!r}")

    # InputMessenger duck-type: called by the reader fiber with the socket
    def process(self, sock, defer_tail: bool = False) -> None:
        data = sock._read_buf.to_bytes()
        sock._read_buf.popn(len(data))
        self._rbuf += data
        off = 0  # running offset: slice the buffer ONCE per burst, not per reply
        while True:
            try:
                reply, nxt = parse_reply(self._rbuf, off)
            except ValueError:
                self._fail_all(RespError("protocol desync"))
                sock.set_failed()
                return
            if nxt == -1:
                break  # incomplete: wait for more bytes
            off = nxt
            with self._plock:
                pending = self._pending.pop(0) if self._pending else None
            if pending is not None:
                pending.set(reply)
        if off:
            self._rbuf = self._rbuf[off:]

    def _on_socket_failed(self, sock) -> None:
        # deferred to a pool fiber: this callback can fire synchronously
        # from sock.write() while pipeline() holds _plock — running
        # _fail_all inline would self-deadlock on the non-reentrant lock
        from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool

        err = RespError(f"connection lost: {sock.error_text}")
        global_worker_pool().spawn(self._fail_all, err)

    def _fail_all(self, err: RespError) -> None:
        with self._plock:
            pending, self._pending = self._pending, []
        for p in pending:
            p.set(err)

    def execute(self, *args, timeout: Optional[float] = 5.0) -> Reply:
        """One command, wait for its reply. Raises RespError on -ERR."""
        (reply,) = self.pipeline([args], timeout=timeout)
        if isinstance(reply, RespError):
            raise reply
        return reply

    def pipeline(
        self, commands: List[tuple], timeout: Optional[float] = 5.0
    ) -> List[Reply]:
        """Send all commands in one write; replies in command order
        (the PipelinedInfo contract)."""
        pendings = [_Pending() for _ in commands]
        payload = b"".join(pack_command(*c) for c in commands)
        # enqueue + write must be atomic together: if another pipeline's
        # write slipped between them, replies would be matched to the wrong
        # commands (the reference couples the PipelinedInfo push to the
        # write for the same reason, socket.h:133)
        with self._plock:
            self._pending.extend(pendings)
            rc = self._sock.write(payload)
            if rc != 0:
                # nothing of THIS call reached the wire: drop only our
                # pendings (failing the whole FIFO would desync replies
                # still in flight for earlier, successfully-written calls)
                del self._pending[len(self._pending) - len(pendings):]
        if rc != 0:
            err = RespError(f"write failed ({rc})")
            for p in pendings:
                p.set(err)
        out: List[Reply] = []
        for p in pendings:
            if not p.wait(timeout):
                raise TimeoutError("redis reply timed out")
            out.append(p.reply)
        return out

    def close(self) -> None:
        self._sock.recycle()

    # convenience wrappers (the reference exposes these through RedisCommand)
    def set(self, key: str, value: Union[str, bytes]) -> Reply:
        return self.execute("SET", key, value)

    def get(self, key: str) -> Reply:
        return self.execute("GET", key)

    def incr(self, key: str) -> Reply:
        return self.execute("INCR", key)

    def delete(self, *keys: str) -> Reply:
        return self.execute("DEL", *keys)

    def ping(self) -> Reply:
        return self.execute("PING")


class MockRedisServer:
    """Dict-backed RESP server on the framework's Acceptor/Socket stack —
    enough of redis for pipelining/protocol tests (the reference tests
    against hand-built buffers + a real server; SURVEY §4's loopback
    shape)."""

    def __init__(self, password: Optional[str] = None):
        self._data = {}
        self._lock = threading.Lock()
        self._acceptor = None
        self.port = 0
        self.password = password

    def start(self) -> bool:
        from incubator_brpc_tpu_torch.transport.acceptor import Acceptor
        from incubator_brpc_tpu_torch.utils.endpoint import EndPoint

        self._acceptor = Acceptor(
            EndPoint(ip="127.0.0.1", port=0),
            messenger=_MockMessenger(self),
        )
        self.port = self._acceptor.endpoint.port
        return True

    def stop(self) -> None:
        if self._acceptor is not None:
            self._acceptor.stop()

    def handle(self, cmd: List[bytes], ctx: Optional[dict] = None) -> bytes:
        name = cmd[0].decode().upper() if cmd else ""
        args = cmd[1:]
        if self.password is not None:
            if name == "AUTH":
                if args and args[0].decode() == self.password:
                    if ctx is not None:
                        ctx["redis_authed"] = True
                    return b"+OK\r\n"
                return b"-ERR invalid password\r\n"
            if ctx is None or not ctx.get("redis_authed"):
                return b"-NOAUTH Authentication required.\r\n"
        with self._lock:
            if name == "PING":
                return b"+PONG\r\n"
            if name == "ECHO":
                return b"$%d\r\n%s\r\n" % (len(args[0]), args[0])
            if name == "SET":
                self._data[args[0]] = args[1]
                return b"+OK\r\n"
            if name == "GET":
                v = self._data.get(args[0])
                if v is None:
                    return b"$-1\r\n"
                return b"$%d\r\n%s\r\n" % (len(v), v)
            if name == "DEL":
                n = 0
                for k in args:
                    n += 1 if self._data.pop(k, None) is not None else 0
                return b":%d\r\n" % n
            if name == "INCR":
                v = int(self._data.get(args[0], b"0")) + 1
                self._data[args[0]] = str(v).encode()
                return b":%d\r\n" % v
            if name == "MGET":
                parts = [b"*%d\r\n" % len(args)]
                for k in args:
                    v = self._data.get(k)
                    parts.append(
                        b"$-1\r\n" if v is None else b"$%d\r\n%s\r\n" % (len(v), v)
                    )
                return b"".join(parts)
        return b"-ERR unknown command '%s'\r\n" % name.encode()


class _MockMessenger:
    """Server-side RESP cut loop (a Protocol-shaped reader for the mock)."""

    def __init__(self, server: MockRedisServer):
        self._server = server

    def process(self, sock, defer_tail: bool = False) -> None:
        data = sock._read_buf.to_bytes()
        consumed_total = 0
        out = []
        while True:
            cmd, nxt = parse_reply(data, consumed_total)
            if nxt == -1:
                break
            consumed_total = nxt
            if isinstance(cmd, list):
                out.append(
                    self._server.handle(
                        [bytes(c) for c in cmd], ctx=sock.context
                    )
                )
            else:
                out.append(b"-ERR expected array\r\n")
        if consumed_total:
            sock._read_buf.popn(consumed_total)
        if out:
            sock.write(b"".join(out))
