"""Socket — versioned-ref connection object with a single-drainer MPSC
write path (reference src/brpc/socket.{h,cpp}).

Kept design points (and where they live in the reference):
- SocketId out of a versioned registry: ``address()`` fails after
  ``set_failed()`` yet the object stays reachable by holders
  (socket.h:619-630 versioned refs; never-freed ResourcePool slots).
- Write path: producers append WriteRequests under the queue lock; the
  producer that finds no active writer claims drainer-ship, writes once
  inline, and hands leftovers to a KeepWrite fiber — contenders only
  enqueue (StartWrite socket.cpp:1591-1686, KeepWrite :1688). At most one
  thread ever writes the fd.
- Read path: dispatcher IN event (oneshot) dedupes into one ProcessEvent
  fiber (StartInputEvent socket.cpp:2113-2158) which drains to EAGAIN
  into an IOBuf then runs the InputMessenger cut loop.
- set_failed + health check + revive: a failed client socket probes its
  remote every ``health_check_interval`` seconds and revives in place
  (socket.cpp:950-1026); pending writes are failed with callbacks.
- EOVERCROWDED backpressure when the unwritten backlog passes
  ``socket_max_unwritten_bytes`` (socket.cpp:1537).
- TLS on ``ssl.MemoryBIO`` + ``SSLObject``, pumped by this socket's own
  read and write paths (``ssl_context=``; the reference's SSLHandshake
  and ssl_helper, socket.cpp:1880): ciphertext on the fd, plaintext in
  the read IOBuf, so messenger and protocols never know. A client
  handshakes on its blocking dial socket, a server from the reactor's
  read path, and a revived client handshakes a fresh session.
- ``unix://<path>`` endpoints dial an AF_UNIX stream socket.

The port's copy of the JAX package's ``transport/sock.py``, with the
fault injector's socket-write seam (``rpc/fault_injector.py``) and the
per-second rate bvars the portal plots (``socket_in_bytes_per_second``,
``socket_out_bytes_per_second``), without the caller-driven write drain
(``write(drain_inline=True)``) that the JAX package's stream writers opt
into: the port's streams write through the same KeepWrite path as every
other frame.
"""

from __future__ import annotations

import contextlib
import errno as _errno
import logging
import os
import socket as _pysocket
import threading
from time import monotonic as _monotonic
from collections import deque
from typing import Callable, Dict, List, Optional, Union

from incubator_brpc_tpu_torch.bvar import Adder, PerSecond
from incubator_brpc_tpu_torch.iobuf import IOBuf, read_burst_bytes
from incubator_brpc_tpu_torch.runtime.butex import Butex
from incubator_brpc_tpu_torch.runtime.timer_thread import global_timer_thread
from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool
from incubator_brpc_tpu_torch.transport.event_dispatcher import (
    EVENT_ERR,
    EVENT_IN,
    EVENT_OUT,
    global_dispatcher,
)
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint, str2endpoint
from incubator_brpc_tpu_torch.utils.flags import get_flag
from incubator_brpc_tpu_torch.utils.status import ErrorCode

logger = logging.getLogger(__name__)

# states
CONNECTED = 0
FAILED = 1
RECYCLED = 2

in_bytes = Adder(name="socket_in_bytes")
out_bytes = Adder(name="socket_out_bytes")

_rate_vars: list = []


def _ensure_rate_vars() -> None:
    """Per-second rates for /vars/series.json, created on FIRST socket
    construction — a Window registers with the 1 Hz bvar sampler thread,
    which must not spawn as an import side effect (fork-after-import
    would strand registered vars without their sampler)."""
    if not _rate_vars:
        _rate_vars.append(PerSecond(in_bytes, name="socket_in_bytes_per_second"))
        _rate_vars.append(PerSecond(out_bytes, name="socket_out_bytes_per_second"))

def when_drained(sock, action, stalls: int = 0, last_unwritten: int = -1) -> None:
    """Run ``action(sock)`` once the write queue drains. Forces the action
    only after a sustained *stall* (unwritten bytes unchanged across ~2s of
    10ms checks) — a slow-but-progressing reader keeps its connection; a
    fixed deadline could truncate a large payload."""
    with sock._wlock:
        drained = not sock._wqueue
        unwritten = sock._unwritten
    stalls = stalls + 1 if unwritten == last_unwritten else 0
    if drained or stalls > 200:
        action(sock)
    else:
        # self-terminating retry chain: every path either runs action() or
        # re-arms, and the stall cap (200 ticks ~ 2s) bounds the chain
        global_timer_thread().schedule(
            lambda: when_drained(sock, action, stalls, unwritten), delay=0.01
        )


class _Registry:
    """Socket registry on the native versioned-id slab (csrc/host/tbutil
    tb_respool; reference resource_pool.h:24-83 backing SocketId). The
    slot/version/ABA discipline, what makes Address-after-SetFailed safe,
    lives in native code; Python keeps only the slot-indexed object array
    (PyObjects can't live in the C slab). SocketId = version<<32 | slot,
    version odd while live. Without the host runtime the version and
    free-list state is kept here, its plain twin."""

    def __init__(self):
        from incubator_brpc_tpu_torch.native import NATIVE_AVAILABLE, ResourcePool

        self._lock = threading.Lock()
        self._objs: List[Optional["Socket"]] = []
        self._pool = ResourcePool(8) if NATIVE_AVAILABLE else None
        self._versions: List[int] = []
        self._free: List[int] = []

    def insert(self, sock: "Socket") -> int:
        with self._lock:
            if self._pool is not None:
                sid = self._pool.get()
                slot = sid & 0xFFFFFFFF
                while len(self._objs) <= slot:
                    self._objs.append(None)
                self._objs[slot] = sock
                return sid
            if self._free:
                slot = self._free.pop()
                self._versions[slot] += 2
                self._objs[slot] = sock
            else:
                slot = len(self._objs)
                self._objs.append(sock)
                self._versions.append(1)
            return (self._versions[slot] << 32) | slot

    def address(self, sid: int) -> Optional["Socket"]:
        slot = sid & 0xFFFFFFFF
        with self._lock:
            if self._pool is not None:
                if self._pool.address(sid) is None:
                    return None  # stale version: recycled (or never issued)
                sock = self._objs[slot] if slot < len(self._objs) else None
            else:
                if slot >= len(self._objs) or self._versions[slot] != sid >> 32:
                    return None
                sock = self._objs[slot]
        if sock is None or sock.state != CONNECTED:
            return None
        return sock

    def recycle(self, sid: int) -> None:
        slot = sid & 0xFFFFFFFF
        with self._lock:
            if self._pool is not None:
                if self._pool.return_(sid) and slot < len(self._objs):
                    self._objs[slot] = None
                return
            if slot < len(self._objs) and self._versions[slot] == sid >> 32:
                self._objs[slot] = None
                self._versions[slot] += 1
                self._free.append(slot)

    def live_count(self) -> int:
        if self._pool is not None:
            return self._pool.live
        with self._lock:
            return sum(1 for s in self._objs if s is not None)


_registry = _Registry()


def address_socket(sid: int) -> Optional["Socket"]:
    """Socket::Address analog — None after set_failed/recycle."""
    return _registry.address(sid)


class WriteRequest:
    __slots__ = ("buf", "on_error")

    def __init__(self, buf: IOBuf, on_error: Optional[Callable[[int, str], None]]):
        self.buf = buf
        self.on_error = on_error


def _dial(ep: EndPoint, timeout: float) -> _pysocket.socket:
    """Open a client connection to a TCP or unix:// endpoint (the ONE
    place that knows how to dial — used by connect and health probing)."""
    if ep.ip.startswith("unix://"):
        conn = _pysocket.socket(_pysocket.AF_UNIX, _pysocket.SOCK_STREAM)
        conn.settimeout(timeout)
        try:
            conn.connect(ep.ip[len("unix://"):])
        except OSError:
            conn.close()
            raise
        return conn
    conn = _pysocket.create_connection((ep.ip, ep.port), timeout=timeout)
    conn.setsockopt(_pysocket.IPPROTO_TCP, _pysocket.TCP_NODELAY, 1)
    return conn


class Socket:
    def __init__(
        self,
        conn: _pysocket.socket,
        *,
        remote: Optional[EndPoint],
        messenger=None,
        is_client: bool = False,
        context: Optional[Dict] = None,
        inline_read: bool = False,
        preread: bytes = b"",
        ssl_context=None,
        ssl_server_side: bool = False,
        ssl_server_hostname: Optional[str] = None,
    ):
        _ensure_rate_vars()
        # TLS: a client handshakes here on the still-blocking dial socket
        # (connect already blocks a fiber); a server pumps its handshake
        # from the reactor's read path (_ssl_read_pump)
        self._ssl_context = ssl_context
        self._ssl_server_side = ssl_server_side
        self._ssl_server_hostname = ssl_server_hostname
        self._sslobj = None
        self._ssl_done = False
        if ssl_context is not None:
            self._ssl_lock = threading.Lock()
            self._in_bio, self._out_bio, self._sslobj = self._ssl_new()
            if not ssl_server_side:
                self._ssl_blocking_handshake(conn, self._in_bio, self._out_bio, self._sslobj)
                self._ssl_done = True
        conn.setblocking(False)
        # NOTE: no explicit SO_RCVBUF/SO_SNDBUF — setting them disables
        # kernel autotuning and is silently clamped to rmem_max/wmem_max,
        # which SHRINKS effective buffers on stock kernels (measured)
        self._conn = conn
        self.fd = conn.fileno()
        self.remote = remote
        self.messenger = messenger  # InputMessenger; may be set post-create
        self.is_client = is_client
        self.state = CONNECTED
        self.error_code = 0
        self.error_text = ""
        self.preferred_protocol = None  # remembered by InputMessenger
        # arbitrary per-connection state for protocols/rpc.
        # Must be seeded via the constructor when a frame could arrive in the
        # same packet burst as the connect: the dispatcher registration at
        # the bottom of __init__ makes the socket live immediately, so a
        # post-construction stamp (e.g. the owning server) can lose the race
        # with the first request.
        self.context: Dict = dict(context) if context else {}
        # Inline reads: drain + cut + process ON the reactor thread instead
        # of a pool fiber — removes two thread handoffs per message. The
        # reference gets the same shape from bthread_start_urgent switching
        # the dispatcher's own worker onto ProcessEvent (socket.cpp:2113).
        # Only safe when message processing never blocks for long: client
        # response paths (framework-only; user done callbacks are spawned),
        # and servers that opt in with usercode_inline.
        self.inline_read = inline_read
        self.on_failed: List[Callable[["Socket"], None]] = []
        # fired after a health-check (or inline) revival: the LB's circuit
        # breaker re-admits an isolated node early (lb/__init__.py)
        self.on_revived: List[Callable[["Socket"], None]] = []
        # last wire activity (either direction) — the idle-connection
        # reaper's clock (reference server.cpp idle_timeout_sec reaper)
        self.last_active = _monotonic()

        self._read_buf = IOBuf()
        self._read_saturated = False  # bulk-read escalation (_drain_and_cut)
        # bytes another plane already read off this fd (the native plane's
        # protocol-sniff handoff), seeded BEFORE the dispatcher
        # registration below makes the socket live
        if preread:
            self._read_buf.append(preread)
        self._wlock = threading.Lock()
        self._wqueue: deque = deque()
        self._writing = False
        # bumped on every set_failed: a drainer from an older epoch exits
        # without touching _writing, so a post-revive drainer never runs
        # concurrently with it (single-writer invariant across failures)
        self._wepoch = 0
        self._unwritten = 0
        self._epollout_butex = Butex(0)
        self._want_out = False
        self._reading = False
        self._state_lock = threading.Lock()
        # fd lifetime: set_failed only shutdown()s; the real close waits
        # until in-flight I/O fibers release their refs, so a reused fd
        # number can never be touched by a stale fiber (the reference gets
        # this from Socket refcounting)
        self._io_refs = 0
        self._pending_close: Optional[_pysocket.socket] = None
        self._kick_fd: Optional[int] = None  # lazy eventfd for poller wakes
        self._reconnecting = False  # connect_if_not single-dialer gate
        self.health_check_interval = float(get_flag("health_check_interval"))

        self._dispatcher = global_dispatcher(self.fd)
        self._pool = global_worker_pool()
        self.id = _registry.insert(self)
        self._dispatcher.add_consumer(self.fd, self._on_event, EVENT_IN)
        if preread:
            # frames may already be complete in the preread bytes and no
            # further wire activity will announce them: run one read pass
            with self._state_lock:
                claimed = not self._reading and self.state == CONNECTED
                if claimed:
                    self._reading = True
            if claimed:
                self._pool.spawn(self._process_event)

    # -- TLS ----------------------------------------------------------------

    def _ssl_new(self):
        """A fresh (in_bio, out_bio, SSLObject): TLS state never survives a
        new connection."""
        import ssl as _ssl

        in_bio, out_bio = _ssl.MemoryBIO(), _ssl.MemoryBIO()
        sslobj = self._ssl_context.wrap_bio(
            in_bio,
            out_bio,
            server_side=self._ssl_server_side,
            server_hostname=self._ssl_server_hostname,
        )
        return in_bio, out_bio, sslobj

    @staticmethod
    def _ssl_blocking_handshake(conn: _pysocket.socket, in_bio, out_bio, sslobj) -> None:
        """Client handshake on the still-blocking dial socket (bounded by
        its connect timeout); closes the socket on failure."""
        import ssl as _ssl

        try:
            while True:
                try:
                    sslobj.do_handshake()
                    break
                except _ssl.SSLWantReadError:
                    pending = out_bio.read()
                    if pending:
                        conn.sendall(pending)
                    data = conn.recv(65536)
                    if not data:
                        raise ConnectionError("TLS handshake: peer closed")
                    in_bio.write(data)
            pending = out_bio.read()
            if pending:
                conn.sendall(pending)  # our Finished record
        except (OSError, _ssl.SSLError):
            try:
                conn.close()
            except OSError:
                pass
            raise

    def _flush_ssl_out(self) -> None:
        """Queue whatever ciphertext the SSLObject produced (handshake
        records, alerts, KeyUpdate responses). Forced past the EOVERCROWDED
        gate: TLS control records already advanced the session state and
        can never be dropped, and they are small."""
        data = self._out_bio.read()
        if not data:
            return
        buf = IOBuf()
        buf.append(data)
        rc, epoch = self._enqueue(buf, None, force=True)
        if rc == 0 and epoch is not None:
            self._drive_drain(epoch)

    def _ssl_read_pump(self):
        """The TLS read path: ciphertext fd → in_bio → the handshake pump
        and/or plaintext into the read IOBuf → messenger. Returns ``(alive,
        tail)`` as the plaintext drain does, with the same deferred tail."""
        import ssl as _ssl

        eof = False
        while True:
            try:
                data = self._conn.recv(65536)
            except (BlockingIOError, _ssl.SSLWantReadError):
                break
            except InterruptedError:
                continue
            except OSError as e:
                self.set_failed(ErrorCode.EFAILEDSOCKET, f"ssl read failed: {e}")
                return False, None
            if not data:
                eof = True
                break
            in_bytes << len(data)
            self._in_bio.write(data)
        with self._ssl_lock:
            if not self._ssl_done:
                try:
                    self._sslobj.do_handshake()
                    self._ssl_done = True
                except _ssl.SSLWantReadError:
                    pass
                except _ssl.SSLError as e:
                    self._flush_ssl_out()  # the alert, best effort
                    self.set_failed(ErrorCode.EFAILEDSOCKET, f"TLS handshake failed: {e}")
                    return False, None
                self._flush_ssl_out()
                if not self._ssl_done:
                    if eof:
                        self.set_failed(ErrorCode.EEOF, "peer closed mid-handshake")
                        return False, None
                    return True, None
            while True:
                try:
                    pt = self._sslobj.read(65536)
                except _ssl.SSLWantReadError:
                    break
                except _ssl.SSLZeroReturnError:
                    eof = True
                    break
                except _ssl.SSLError as e:
                    self.set_failed(ErrorCode.EFAILEDSOCKET, f"TLS record error: {e}")
                    return False, None
                if not pt:
                    eof = True
                    break
                self._read_buf.append(pt)
            # a TLS 1.3 KeyUpdate response produced by the reads sits in
            # out_bio; on a read-mostly connection no write would flush it
            self._flush_ssl_out()
        tail = None
        if self.messenger is not None and len(self._read_buf):
            if not eof:
                tail = self.messenger.process(self, defer_tail=True)
            else:
                # EOF: process everything before failing the socket, so the
                # final request's response can still be written
                self.messenger.process(self)
        if eof:
            self.set_failed(ErrorCode.EEOF, "remote closed connection")
            return False, None
        return True, tail

    # -- construction -------------------------------------------------------

    @classmethod
    def connect(
        cls,
        remote: Union[str, EndPoint],
        messenger=None,
        timeout: float = 5.0,
        **kwargs,
    ) -> "Socket":
        """Client connect (bthread_connect analog: blocking a fiber/thread,
        never the reactor)."""
        ep = str2endpoint(remote) if isinstance(remote, str) else remote
        conn = _dial(ep, timeout)
        return cls(conn, remote=ep, messenger=messenger, is_client=True, **kwargs)

    @classmethod
    def from_accepted(
        cls, conn: _pysocket.socket, peer, messenger=None, **kwargs
    ) -> "Socket":
        try:
            conn.setsockopt(_pysocket.IPPROTO_TCP, _pysocket.TCP_NODELAY, 1)
        except OSError:
            pass
        remote = EndPoint(ip=peer[0], port=peer[1]) if peer else None
        return cls(conn, remote=remote, messenger=messenger, is_client=False, **kwargs)

    # -- write path ---------------------------------------------------------

    def write(
        self,
        data: Union[bytes, IOBuf],
        on_error: Optional[Callable[[int, str], None]] = None,
        timeout: Optional[float] = None,
    ) -> int:
        """Queue data; returns 0 or an ErrorCode. Never blocks the caller
        beyond one nonblocking write (the StartWrite inline attempt);
        backpressure is EOVERCROWDED. ``timeout`` is accepted for
        write-path parity with ``DeviceSocket.write``, whose send can block
        on its window; this one never waits."""
        if self.state != CONNECTED:
            return ErrorCode.EFAILEDSOCKET
        # the socket-write fault seam (rpc/fault_injector.py): the master
        # flag gates everything, so the steady-state cost is ONE flag
        # read (the module import happens only while injection is armed)
        if get_flag("fault_injection"):
            from incubator_brpc_tpu_torch.rpc.fault_injector import socket_injector

            inj = socket_injector()
            if inj is not None:
                action = inj.decide()
                if action == "close":
                    self.set_failed(ErrorCode.EFAILEDSOCKET, "injected close")
                    return ErrorCode.EFAILEDSOCKET
                if action == "error":
                    return ErrorCode.EFAILEDSOCKET
        if isinstance(data, (bytes, bytearray, memoryview)):
            buf = IOBuf()
            buf.append(bytes(data))
        else:
            buf = data
        if self._sslobj is not None:
            # Encrypt-and-ENQUEUE atomically (two writers' TLS records must
            # reach the queue in SSLObject order or the peer's record layer
            # desyncs), but DRAIN outside the ssl lock: the reactor needs
            # this lock in _ssl_read_pump. Backpressure is checked BEFORE
            # encrypting: a record that passed the SSLObject has advanced
            # the sequence number and can never be dropped.
            import ssl as _ssl

            with self._ssl_lock:
                if not self._ssl_done:
                    return ErrorCode.EFAILEDSOCKET  # handshake incomplete
                with self._wlock:
                    over = self._unwritten + len(buf) > int(get_flag("socket_max_unwritten_bytes"))
                if over:
                    return ErrorCode.EOVERCROWDED
                try:
                    self._sslobj.write(buf.to_bytes())
                except _ssl.SSLError as e:
                    self.set_failed(ErrorCode.EFAILEDSOCKET, f"TLS write failed: {e}")
                    return ErrorCode.EFAILEDSOCKET
                cipher = IOBuf()
                cipher.append(self._out_bio.read())
                # force: the budget was charged against the plaintext above;
                # TLS record overhead must not flip the verdict post-encrypt
                rc, epoch = self._enqueue(cipher, on_error, force=True)
        else:
            rc, epoch = self._enqueue(buf, on_error)
        if rc == 0 and epoch is not None:
            self._drive_drain(epoch)
        return rc

    def _enqueue(
        self,
        buf: IOBuf,
        on_error: Optional[Callable[[int, str], None]],
        force: bool = False,
    ):
        """Queue one request. Returns (rc, epoch_or_None): a non-None epoch
        means the caller became the drainer and must drain. ``force`` skips
        the EOVERCROWDED gate (TLS records that can no longer be dropped)."""
        n = len(buf)
        if n == 0:
            return 0, None  # never enqueue an empty request
        req = WriteRequest(buf, on_error)
        with self._wlock:
            if not force and self._unwritten + n > int(get_flag("socket_max_unwritten_bytes")):
                return ErrorCode.EOVERCROWDED, None
            self._wqueue.append(req)
            self._unwritten += n
            if self._writing:
                return 0, None  # contender: active drainer picks it up
            self._writing = True
            return 0, self._wepoch

    def _drive_drain(self, epoch: int) -> None:
        # one inline nonblocking attempt, then hand off to KeepWrite
        if not self._drain_once(epoch):
            self._pool.spawn(self._keep_write, epoch)

    # -- fd I/O refs (deferred close) --------------------------------------

    def _acquire_io(self) -> bool:
        with self._state_lock:
            if self.state != CONNECTED:
                return False
            self._io_refs += 1
            return True

    def _release_io(self) -> None:
        conn = None
        with self._state_lock:
            self._io_refs -= 1
            if self._io_refs == 0 and self._pending_close is not None:
                conn, self._pending_close = self._pending_close, None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def _drain_once(self, epoch: int) -> bool:
        """One nonblocking drain round. Returns True if drainer-ship was
        released (queue empty, socket failed, or epoch stale), False if a
        KeepWrite must continue."""
        while True:
            with self._wlock:
                if self._wepoch != epoch:
                    return True  # failed since we claimed; new epoch owns _writing
                if not self._wqueue:
                    self._writing = False
                    return True
                front = self._wqueue[0]
            if len(front.buf) == 0:
                with self._wlock:
                    if self._wepoch == epoch and self._wqueue and self._wqueue[0] is front:
                        self._wqueue.popleft()
                continue
            if not self._acquire_io():
                return True
            try:
                rc = front.buf.cut_into_fd(self.fd, 4 << 20)
            finally:
                self._release_io()
            if rc > 0:
                out_bytes << rc
                self.last_active = _monotonic()
                with self._wlock:
                    self._unwritten -= rc
                if len(front.buf) == 0:
                    with self._wlock:
                        if self._wepoch == epoch and self._wqueue and self._wqueue[0] is front:
                            self._wqueue.popleft()
                continue
            if rc in (0, -_errno.EAGAIN, -_errno.EWOULDBLOCK):
                return False  # 0-byte writev == no room: wait for writability
            if rc == -_errno.EINTR:
                continue
            self._fail_from_write(-rc if rc < 0 else _errno.EPIPE)
            return True  # failed: nothing left to drain

    def _keep_write(self, epoch: int) -> None:
        """Single-drainer loop (KeepWrite socket.cpp:1688): waits for
        writability on the epollout butex when the kernel buffer fills."""
        while True:
            if self._drain_once(epoch):
                return
            seq = self._epollout_butex.load()
            with self._state_lock:
                if self.state != CONNECTED:
                    return
                self._want_out = True
            self._arm()
            self._epollout_butex.wait(seq, timeout=1.0)

    def _fail_from_write(self, err: int) -> None:
        self.set_failed(
            ErrorCode.EFAILEDSOCKET, f"write failed: {_errno.errorcode.get(err, err)}"
        )

    # -- read path ----------------------------------------------------------

    def _on_event(self, revents: int) -> None:
        # reactor thread: cheap work only
        if revents & EVENT_ERR:
            self._pool.spawn(
                self.set_failed, ErrorCode.EFAILEDSOCKET, "epoll error/hup"
            )
            return
        spawned_reader = False
        if revents & EVENT_IN:
            with self._state_lock:
                if not self._reading and self.state == CONNECTED:
                    self._reading = True
                    spawned_reader = True
            if spawned_reader:
                if self.inline_read:
                    self._process_event()
                else:
                    self._pool.spawn(self._process_event)
        if revents & EVENT_OUT:
            with self._state_lock:
                self._want_out = False
            self._epollout_butex.add(1)
            self._epollout_butex.wake_all()
        # re-arm whatever interest remains (IN unless a reader fiber owns the
        # fd; OUT if a KeepWrite re-requested it concurrently)
        self._arm()

    def _arm(self) -> None:
        with self._state_lock:
            if self.state != CONNECTED:
                return
            mask = 0
            if not self._reading:
                mask |= EVENT_IN
            if self._want_out:
                mask |= EVENT_OUT
        if mask:
            self._dispatcher.rearm(self.fd, mask)

    def _drain_and_cut(self):
        """Drain the fd to EAGAIN into the read IOBuf and run the messenger
        cut loop. Caller holds an io ref AND read ownership. Returns
        ``(alive, tail)``: alive=False if the socket died (EOF / read
        error — already failed); ``tail`` is the deferred last message
        (messenger defer_tail) to process AFTER the caller releases the
        socket's read state."""
        self.last_active = _monotonic()
        if self._sslobj is not None:
            return self._ssl_read_pump()
        eof = False
        # must equal what one read can actually deliver: a larger ask
        # would make every full read look "short" and end the drain loop
        read_chunk = read_burst_bytes()
        # saturated-stream escalation: consecutive FULL bursts mean the peer
        # is pushing bulk data — switch to multi-MB reads into big malloc'd
        # blocks. Saturation is sticky across drains, but each drain's
        # FIRST read is pooled, and a short read anywhere drops the socket
        # back to pooled reads.
        sticky = self._read_saturated
        full_reads = 0
        bulk = False
        while True:
            if bulk:
                rc = self._read_buf.append_from_fd_bulk(self.fd, 4 << 20, 256 << 10)
                chunk_now = 4 << 20
            else:
                rc = self._read_buf.append_from_fd(self.fd, read_chunk)
                chunk_now = read_chunk
            if rc > 0:
                in_bytes << rc
                if rc < chunk_now:
                    self._read_saturated = False
                    break  # short read: kernel buffer drained
                full_reads += 1
                bulk = full_reads >= (1 if sticky else 2)
                self._read_saturated = bulk or sticky
                continue
            if rc == 0:
                eof = True
                break
            if rc in (-_errno.EAGAIN, -_errno.EWOULDBLOCK):
                break
            if rc == -_errno.EINTR:
                continue
            self.set_failed(
                ErrorCode.EFAILEDSOCKET,
                f"read failed: {_errno.errorcode.get(-rc, rc)}",
            )
            return False, None
        tail = None
        if self.messenger is not None and len(self._read_buf):
            if not eof:
                tail = self.messenger.process(self, defer_tail=True)
            else:
                # the EOF case: the tail must run BEFORE set_failed shuts
                # the fd down (a half-closed client still expects its final
                # response; a response+EOF read must surface the response,
                # not EEOF)
                self.messenger.process(self)
        if eof:
            self.set_failed(ErrorCode.EEOF, "remote closed connection")
            return False, None
        return True, tail

    def _process_event(self) -> None:
        """ProcessEvent fiber: drain fd → cut messages → dispatch. The
        deferred tail message runs AFTER the read state is released and
        the dispatcher re-armed: a handler that blocks (a nested RPC back
        over this very connection, a slow service) must not wedge this
        connection's reads — the reference's M:N bthreads give it the
        same property for free."""
        if not self._acquire_io():
            with self._state_lock:
                self._reading = False
            return
        tail = None
        try:
            alive, tail = self._drain_and_cut()
            if not alive:
                return
        finally:
            self._release_io()
            with self._state_lock:
                self._reading = False
            self._arm()
        if tail is not None:
            self.messenger._process_one(self, tail[0], tail[1])

    # -- caller-driven reads (sync-call fast path) --------------------------
    #
    # A synchronous caller that just wrote a request can take over the
    # socket's read side and poll it on its OWN thread: the response is
    # processed with zero reactor/fiber wakeups — the only threads in a
    # sync round trip are the caller and the peer. Under the GIL a thread
    # handoff costs tens of µs, so this is the difference between ~300 µs
    # and ~30 µs echo latency. The reference needs no analog because waking
    # a bthread costs ~100 ns; the role (completion processed on the
    # waiter's context) matches its butex wait-wake path.

    def try_read_ownership(self) -> bool:
        """Claim the reader role (the dispatcher will not schedule reads
        while held). False if someone else is reading or the socket is
        down."""
        with self._state_lock:
            if self.state != CONNECTED or self._reading:
                return False
            self._reading = True
        # clear any stale kick so the first poll doesn't spuriously wake
        kick = self._kick_fd
        if kick is not None:
            try:
                os.read(kick, 8)
            except (OSError, BlockingIOError):
                pass
        return True

    def release_read_ownership(self) -> None:
        with self._state_lock:
            self._reading = False
        self._arm()

    def _ensure_kick_fd(self) -> Optional[int]:
        k = self._kick_fd
        if k is None:  # first use: create under the lock; stable afterwards
            with self._state_lock:
                if self._kick_fd is None:
                    try:
                        self._kick_fd = os.eventfd(0, os.EFD_NONBLOCK)
                    except (AttributeError, OSError):
                        self._kick_fd = -1  # no eventfd: ticks instead
                k = self._kick_fd
        return k if k != -1 else None

    def kick_poller(self) -> None:
        """Wake a thread parked in poll_and_process (e.g. its RPC finished
        on another socket)."""
        kick = self._kick_fd
        if kick is not None and kick != -1:
            try:
                os.eventfd_write(kick, 1)
            except OSError:
                pass

    def poll_and_process(self, timeout: float) -> bool:
        """Block THIS thread until the fd is readable (or kicked / timeout),
        then drain + cut + process inline. Requires read ownership. Returns
        False when the socket died."""
        import select as _select

        if not self._acquire_io():
            return False
        try:
            kick = self._ensure_kick_fd()
            rlist = [self.fd] if kick is None else [self.fd, kick]
            try:
                r, _, _ = _select.select(rlist, [], [], timeout)
            except (OSError, ValueError):
                return False  # fd closed under us
            if kick is not None and kick in r:
                try:
                    os.read(kick, 8)
                except (OSError, BlockingIOError):
                    pass
            if self.fd not in r:
                return self.state == CONNECTED
            # caller-driven path: the sync caller IS the processor, and
            # client responses never block — no tail deferral here
            alive, tail = self._drain_and_cut()
            if tail is not None:
                self.messenger._process_one(self, tail[0], tail[1])
            return alive
        finally:
            self._release_io()

    # -- failure / revival --------------------------------------------------

    def set_failed(self, code: int = ErrorCode.EFAILEDSOCKET, reason: str = "") -> bool:
        """Flip to FAILED once; fail pending writes; start health checking
        for client sockets. Returns False if already failed/recycled."""
        with self._state_lock:
            if self.state != CONNECTED:
                return False
            self.state = FAILED
            self.error_code = code
            self.error_text = reason
            old_conn = self._conn
            # close is deferred until in-flight I/O fibers drop their refs —
            # shutdown() makes their syscalls fail without freeing the fd
            # number for reuse
            if self._io_refs > 0:
                self._pending_close = old_conn
            else:
                self._pending_close = None
        self._dispatcher.remove_consumer(self.fd)
        try:
            old_conn.shutdown(_pysocket.SHUT_RDWR)
        except OSError:
            pass
        with self._state_lock:
            close_now = self._pending_close is None
        if close_now:
            try:
                old_conn.close()
            except OSError:
                pass
        with self._wlock:
            pending, self._wqueue = list(self._wqueue), deque()
            self._unwritten = 0
            self._writing = False
            self._wepoch += 1  # stale drainers exit; see _drain_once
        for req in pending:
            if req.on_error is not None:
                try:
                    req.on_error(code, reason)
                except Exception:
                    logger.exception("write on_error callback failed")
        self._epollout_butex.add(1)
        self._epollout_butex.wake_all()
        for cb in list(self.on_failed):
            try:
                cb(self)
            except Exception:
                logger.exception("on_failed callback raised")
        if (
            self.is_client
            and self.remote is not None
            and self.health_check_interval > 0
            and code != ErrorCode.ECLOSE
        ):
            self._schedule_health_check()
        return True

    def _schedule_health_check(self) -> None:
        """Timer-driven probing (HealthCheckThread, socket.cpp:950-1026).
        The reference parks a bthread between probes — free under M:N; here
        a parked fiber would pin a worker for the (possibly unbounded) life
        of a dead remote, so the wait lives on the TimerThread and only the
        short connect probe occupies a fiber."""
        # self-terminating probe chain: _health_probe re-arms only while
        # state == FAILED and exits on revive/recycle
        global_timer_thread().schedule(self._spawn_health_probe, delay=self.health_check_interval)

    def _spawn_health_probe(self) -> None:
        # a recycled socket probes no more: its pool may be stopped by now
        # (rpc.shutdown_host_plane recycles every client socket first)
        if self.state == FAILED:
            self._pool.spawn(self._health_probe)

    def connect_if_not(self, timeout: float = 1.0) -> bool:
        """Inline bounded reconnect of a FAILED client socket — the write
        path's ConnectIfNot (socket.cpp:1591-1686): a healthy-but-dropped
        peer reconnects on the NEXT call instead of waiting out the
        health-check interval. One dialer at a time; the periodic health
        probe keeps running and revives through the same _revive gate."""
        import time as _time

        deadline = _monotonic() + timeout
        while True:
            with self._state_lock:
                if self.state == CONNECTED:
                    return True
                if (
                    self.state != FAILED
                    or not self.is_client
                    or self.remote is None
                ):
                    return False
                if not self._reconnecting:
                    self._reconnecting = True
                    break
            # another caller is dialing: WAIT for its verdict instead of
            # failing this call instantly — racers that returned False
            # here burned their whole retry budget inside one dial window
            # (the reference queues writes behind the in-flight connect)
            if _monotonic() >= deadline:
                return False
            _time.sleep(0.002)
        try:
            conn = _dial(self.remote, timeout=max(0.05, deadline - _monotonic()))
            tls = self._ssl_rewrap(conn)
        except OSError:  # ssl.SSLError and ConnectionError both subclass it
            return False
        finally:
            with self._state_lock:
                self._reconnecting = False
        return self._revive(conn, tls)

    def _ssl_rewrap(self, conn: _pysocket.socket):
        """A reconnected TLS client starts a fresh session: a new SSLObject
        handshaken on the dial socket (closed on failure), or None without
        TLS. The session is built aside and installed by ``_revive`` only
        if this dial wins it, so a health probe racing an inline reconnect
        never swaps the session under a live connection."""
        if self._ssl_context is None:
            return None
        tls = self._ssl_new()
        self._ssl_blocking_handshake(conn, *tls)
        return tls

    def _health_probe(self) -> None:
        if self.state != FAILED:
            return  # recycled or already revived: stop probing
        try:
            conn = _dial(self.remote, timeout=2.0)
            tls = self._ssl_rewrap(conn)
        except OSError:
            self._schedule_health_check()
            return
        if not self._revive(conn, tls):
            self._schedule_health_check()

    def _revive(self, conn: _pysocket.socket, tls=None) -> bool:
        # lock order ssl -> state, as in _ssl_read_pump's set_failed
        ssl_lock = self._ssl_lock if tls is not None else contextlib.nullcontext()
        with ssl_lock, self._state_lock:
            if self.state != FAILED:
                conn.close()
                return False
            if tls is not None:
                self._in_bio, self._out_bio, self._sslobj = tls
                self._ssl_done = True
            conn.setblocking(False)
            try:
                conn.setsockopt(_pysocket.IPPROTO_TCP, _pysocket.TCP_NODELAY, 1)
            except OSError:
                pass
            self._conn = conn
            self.fd = conn.fileno()
            self._read_buf = IOBuf()
            self._reading = False
            self._want_out = False
            self.state = CONNECTED
            self.error_code = 0
            self.error_text = ""
        self._dispatcher = global_dispatcher(self.fd)
        self._dispatcher.add_consumer(self.fd, self._on_event, EVENT_IN)
        for cb in list(self.on_revived):
            try:
                cb(self)
            except Exception:
                logger.exception("on_revived callback raised")
        logger.info("socket to %s revived", self.remote)
        return True

    def recycle(self) -> None:
        """Final teardown: no health check, id becomes stale forever."""
        self.set_failed(ErrorCode.ECLOSE, "recycled")
        with self._state_lock:
            self.state = RECYCLED
        _registry.recycle(self.id)

    def __del__(self):
        # the kick eventfd lives as long as this object: closing it earlier
        # would race late kick_poller() calls against kernel fd-number reuse
        kick = getattr(self, "_kick_fd", None)
        if kick is not None and kick != -1:
            try:
                os.close(kick)
            except OSError:
                pass

    # -- introspection ------------------------------------------------------

    def __repr__(self) -> str:
        st = {CONNECTED: "up", FAILED: "failed", RECYCLED: "recycled"}[self.state]
        return f"<Socket id={self.id:#x} fd={self.fd} remote={self.remote} {st}>"
