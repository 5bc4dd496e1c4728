"""The port's host transport (``transport/sock.py``, ``acceptor.py``,
``socket_map.py``, ``messenger.py`` and the IOBuf's fd path) against the
JAX package's: the 20 cases of tests/test_transport.py, each run on both
packages through the ``pkg`` fixture, over loopback TCP and unix-domain
sockets.

They cover contended writers on one socket (the single-drainer contract),
multi-MB writes through KeepWrite, ``set_failed`` (pending-write
callbacks, the versioned address), EOF, health-check revival against a
restarted listener, the messenger's cut on fragmented, garbage and
giant-header input, EOVERCROWDED backpressure, the socket map's dedupe,
the saturated-read escalation to bulk reads, and ``unix://`` endpoints
(end to end, a live listener refused, a stale file rebound, the path
unlinked at stop).

Per-package accessors, where the port's internals differ and are not
renamed to match:

- the port's messenger has no user message handler; a raw socket's frames
  reach the test's handler through a messenger whose ``_process_one`` is
  that handler (``_HandlerMessenger``);
- the port's ``Socket`` takes no ``health_check_interval`` argument; the
  test sets the attribute after the connect, as the port's socket map
  does for its secondary connections;
- the port has no caller-driven write drain (``write(drain_inline=True)``,
  a difference by design: its streams write through KeepWrite). The two
  ``drain_inline`` cases send the same frames through its plain ``write``
  and hold it to the same outcome: a slow reader's multi-MB frame and a
  contender's frame both arrive, in order.

Servers of the port run on ``device="cpu"``. Tolerance: none, everything
here is bytes."""

import os
import socket as pysocket
import struct
import threading
import time
import types

import pytest

import incubator_brpc_tpu.iobuf as jax_iobuf
import incubator_brpc_tpu.protocol as jax_proto
import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu.transport as jax_transport
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu.utils import endpoint as jax_endpoint
from incubator_brpc_tpu.utils import flags as jax_flags
import incubator_brpc_tpu_torch.iobuf as port_iobuf
import incubator_brpc_tpu_torch.protocol as port_proto
import incubator_brpc_tpu_torch.rpc as port_rpc
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.transport import acceptor as port_acceptor
from incubator_brpc_tpu_torch.transport import messenger as port_messenger
from incubator_brpc_tpu_torch.transport import sock as port_sock
from incubator_brpc_tpu_torch.transport import socket_map as port_socket_map
from incubator_brpc_tpu_torch.utils import endpoint as port_endpoint
from incubator_brpc_tpu_torch.utils import flags as port_flags
from incubator_brpc_tpu_torch.utils.status import ErrorCode

LOOP = "127.0.0.1"


class _HandlerMessenger(port_messenger.InputMessenger):
    """The port's stand-in for the JAX socket's ``user_message_handler``:
    every cut frame goes to ``handler(sock, frame, proto)``."""

    def __init__(self, handler=None):
        self.handler = handler

    def _process_one(self, sock, proto, frame):
        self.handler(sock, frame, proto)


def _jax_acceptor(ep, handler=None):
    return jax_transport.Acceptor(ep, messenger=jax_transport.InputMessenger(),
                                  user_message_handler=handler)


def _port_acceptor(ep, handler=None):
    messenger = _HandlerMessenger(handler) if handler else port_messenger.InputMessenger()
    return port_acceptor.Acceptor(ep, messenger=messenger)


def _jax_connect(remote, health_check_interval, handler=None):
    sock = jax_transport.Socket.connect(remote, messenger=jax_transport.InputMessenger(),
                                        health_check_interval=health_check_interval)
    sock.user_message_handler = handler
    return sock


def _port_connect(remote, health_check_interval, handler=None):
    messenger = _HandlerMessenger(handler) if handler else port_messenger.InputMessenger()
    sock = port_sock.Socket.connect(remote, messenger=messenger)
    sock.health_check_interval = health_check_interval
    return sock


PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", tbus=jax_tbus, proto=jax_proto, rpc=jax_rpc, IOBuf=jax_iobuf.IOBuf,
        EndPoint=jax_endpoint.EndPoint, SocketMap=jax_transport.SocketMap,
        address_socket=jax_transport.address_socket, flags=jax_flags,
        acceptor=_jax_acceptor, connect=_jax_connect,
        write_inline=lambda sock, data, timeout: sock.write(data, timeout=timeout,
                                                            drain_inline=True),
        server_kw={},
    ),
    "torch": types.SimpleNamespace(
        name="torch", tbus=port_tbus, proto=port_proto, rpc=port_rpc, IOBuf=port_iobuf.IOBuf,
        EndPoint=port_endpoint.EndPoint, SocketMap=port_socket_map.SocketMap,
        address_socket=port_sock.address_socket, flags=port_flags,
        acceptor=_port_acceptor, connect=_port_connect,
        write_inline=lambda sock, data, timeout: sock.write(data, timeout=timeout),
        server_kw={"device": "cpu"},
    ),
}

_OPEN = []  # servers the test started, stopped at teardown


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    while _OPEN:
        srv = _OPEN.pop()
        srv.stop()
        srv.join(timeout=10)
    port_rpc.shutdown_host_plane()
    assert shutdown_watchers(timeout=60)
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


def _server(pkg, services):
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
    for name, handlers in services.items():
        srv.add_service(name, handlers)
    _OPEN.append(srv)
    return srv


def _echo_handler(pkg):
    """Server side: echo the payload back, marked as a response."""
    t = pkg.tbus

    def handler(sock, frame, proto):
        sock.write(t.pack_frame(frame.meta, frame.payload, frame.correlation_id,
                                flags=t.FLAG_RESPONSE, attachment=frame.attachment))

    return handler


class _Client:
    """Collects responses by correlation id."""

    def __init__(self, pkg, endpoint):
        self.pkg = pkg
        self.responses = {}
        self.cv = threading.Condition()
        self.sock = pkg.connect(endpoint, 0.1, self._on_msg)

    def _on_msg(self, sock, frame, proto):
        with self.cv:
            self.responses[frame.correlation_id] = frame
            self.cv.notify_all()

    def call(self, payload: bytes, cid: int, timeout=5.0):
        t = self.pkg.tbus
        rc = self.sock.write(t.pack_frame(t.Meta(service="echo", method="echo"), payload, cid))
        assert rc == 0, f"write failed: {rc}"
        return self.wait(cid, timeout)

    def wait(self, cid: int, timeout=5.0):
        deadline = time.monotonic() + timeout
        with self.cv:
            while cid not in self.responses:
                left = deadline - time.monotonic()
                assert left > 0, f"timeout waiting for cid {cid}"
                self.cv.wait(left)
            return self.responses.pop(cid)


@pytest.fixture()
def echo_server(pkg):
    acceptor = pkg.acceptor(pkg.EndPoint(ip=LOOP, port=0), _echo_handler(pkg))
    yield acceptor
    acceptor.stop()


def test_echo_roundtrip(pkg, echo_server):
    c = _Client(pkg, f"{LOOP}:{echo_server.port}")
    try:
        frame = c.call(b"hello tpu fabric", cid=1)
        assert frame.payload == b"hello tpu fabric"
        assert frame.is_response
        # the preferred protocol is remembered after the first cut
        assert c.sock.preferred_protocol is pkg.proto.TBUS_STD
    finally:
        c.sock.recycle()


def test_large_payload_exercises_keepwrite(pkg, echo_server):
    c = _Client(pkg, f"{LOOP}:{echo_server.port}")
    try:
        payload = os.urandom(8 * 1024 * 1024)  # far beyond one writev
        assert c.call(payload, cid=7, timeout=30.0).payload == payload
    finally:
        c.sock.recycle()


def test_attachment_survives_transport(pkg, echo_server):
    t = pkg.tbus
    c = _Client(pkg, f"{LOOP}:{echo_server.port}")
    try:
        att = b"A" * 1000
        data = t.pack_frame(t.Meta(service="echo", method="echo"), b"payload", 42, attachment=att)
        assert c.sock.write(data) == 0
        frame = c.wait(42)
        assert frame.payload == b"payload"
        assert frame.attachment == att
    finally:
        c.sock.recycle()


def test_contended_writers_single_drainer(pkg, echo_server):
    """32 threads x 8 writes each on ONE socket: every frame arrives intact
    (two threads' interleaved writev would corrupt the framing)."""
    t = pkg.tbus
    c = _Client(pkg, f"{LOOP}:{echo_server.port}")
    try:
        nthreads, neach = 32, 8
        errs = []

        def hammer(tid):
            for i in range(neach):
                cid = tid * 1000 + i
                payload = bytes([tid]) * (100 + i * 997)
                rc = c.sock.write(t.pack_frame(t.Meta(service="e", method="e"), payload, cid))
                if rc != 0:
                    errs.append((cid, rc))

        threads = [threading.Thread(target=hammer, args=(i,)) for i in range(nthreads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errs
        for tid in range(nthreads):
            for i in range(neach):
                frame = c.wait(tid * 1000 + i, timeout=30.0)
                assert frame.payload == bytes([tid]) * (100 + i * 997)
    finally:
        c.sock.recycle()


def test_versioned_address_and_set_failed(pkg):
    acceptor = pkg.acceptor(pkg.EndPoint(ip=LOOP, port=0))
    try:
        sock = pkg.connect(f"{LOOP}:{acceptor.port}", 0)
        sid = sock.id
        assert pkg.address_socket(sid) is sock
        failures = []
        sock.set_failed(ErrorCode.EFAILEDSOCKET, "test kill")
        assert pkg.address_socket(sid) is None  # Address-after-SetFailed
        assert sock.write(b"x", on_error=lambda c, m: failures.append(c)) != 0
        sock.recycle()
        assert pkg.address_socket(sid) is None
    finally:
        acceptor.stop()


def test_write_on_error_callback_on_failure(pkg):
    # a server end that never reads: fill the pipe, then kill the socket
    lsock = pysocket.socket()
    lsock.bind((LOOP, 0))
    lsock.listen(1)
    sock = pkg.connect(f"{LOOP}:{lsock.getsockname()[1]}", 0)
    conn, _ = lsock.accept()
    try:
        conn.setsockopt(pysocket.SOL_SOCKET, pysocket.SO_RCVBUF, 4096)
        failed = []
        # flood until the kernel buffer jams, then fail the socket: the
        # queued requests must see their on_error callbacks
        for _ in range(200):
            sock.write(b"z" * 65536, on_error=lambda c, m: failed.append(c))
        sock.set_failed(ErrorCode.EFAILEDSOCKET, "killed by test")
        deadline = time.monotonic() + 5
        while not failed and time.monotonic() < deadline:
            time.sleep(0.01)
        assert failed, "queued writes were not failed"
        assert all(c == ErrorCode.EFAILEDSOCKET for c in failed)
    finally:
        conn.close()
        lsock.close()
        sock.recycle()


def test_eof_fails_socket(pkg, echo_server):
    c = _Client(pkg, f"{LOOP}:{echo_server.port}")
    c.sock.health_check_interval = 0  # no revive: observe the failure
    c.call(b"warm", cid=1)
    for s in echo_server.connections():
        s.set_failed(ErrorCode.ECLOSE, "server closing")
    deadline = time.monotonic() + 5
    while c.sock.state == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert c.sock.state != 0
    assert c.sock.error_code in (ErrorCode.EEOF, ErrorCode.EFAILEDSOCKET)
    c.sock.recycle()


def test_health_check_revives_against_restarted_server(pkg):
    acceptor = pkg.acceptor(pkg.EndPoint(ip=LOOP, port=0), _echo_handler(pkg))
    port = acceptor.port
    c = _Client(pkg, f"{LOOP}:{port}")
    try:
        assert c.call(b"one", cid=1).payload == b"one"
        acceptor.stop()  # kills the connection under the client
        deadline = time.monotonic() + 5
        while c.sock.state == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert c.sock.state != 0
        # a listener restarted on the same port; the 0.1 s health checker
        # revives. Rebinding can fail for a moment (TIME_WAIT): retry
        acceptor2 = None
        rebind_deadline = time.monotonic() + 5
        while acceptor2 is None:
            try:
                acceptor2 = pkg.acceptor(pkg.EndPoint(ip=LOOP, port=port), _echo_handler(pkg))
            except OSError:
                if time.monotonic() > rebind_deadline:
                    pytest.skip("port could not be rebound on this host")
                time.sleep(0.1)
        try:
            deadline = time.monotonic() + 10
            while c.sock.state != 0 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert c.sock.state == 0, "socket did not revive"
            assert c.call(b"after revival", cid=2).payload == b"after revival"
        finally:
            acceptor2.stop()
    finally:
        c.sock.recycle()


def test_garbage_input_fails_connection(pkg, echo_server):
    raw = pysocket.create_connection((LOOP, echo_server.port))
    try:
        # no registered protocol matches (not "TPRC", not an HTTP line)
        raw.sendall(b"\x00\xffGARBAGE-ON-THE-WIRE\r\n\r\n")
        raw.settimeout(5)
        assert raw.recv(4096) == b""  # the server dropped us
    finally:
        raw.close()


def test_unix_domain_socket_rpc(pkg, tmp_path):
    """unix:// endpoints end to end (reference butil/unix_socket.cpp and a
    Server listening on a unix path)."""
    path = str(tmp_path / "echo.sock")
    server = _server(pkg, {"u": {"echo": lambda c, r: r[::-1]}})
    assert server.start(f"unix://{path}")
    ch = pkg.rpc.Channel()
    assert ch.init(f"unix://{path}")
    cntl = ch.call_method("u", "echo", b"abcdef")
    assert cntl.ok(), cntl.error_text
    assert cntl.response_payload == b"fedcba"


def test_unix_socket_lifecycle(pkg, tmp_path):
    """stop() unlinks the path; a live listener cannot be hijacked; a stale
    file from a dead server is cleaned and rebound."""
    path = str(tmp_path / "life.sock")
    a = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
    a.add_service("u", {"e": lambda c, r: r})
    assert a.start(f"unix://{path}")
    # a second bind on a LIVE path fails loudly instead of hijacking it
    b = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
    b.add_service("u", {"e": lambda c, r: r})
    with pytest.raises(OSError):
        b.start(f"unix://{path}")
    a.stop()
    a.join(timeout=5)
    assert not os.path.exists(path)  # a clean shutdown removed the file
    dead = pysocket.socket(pysocket.AF_UNIX, pysocket.SOCK_STREAM)
    dead.bind(path)
    dead.close()  # bound then closed WITHOUT unlink: a classic stale file
    c = _server(pkg, {"u": {"e": lambda cx, r: r + r}})
    assert c.start(f"unix://{path}")
    ch = pkg.rpc.Channel()
    assert ch.init(f"unix://{path}")
    assert ch.call_method("u", "e", b"xy").response_payload == b"xyxy"


def test_fragmented_frame_reassembles(pkg, echo_server):
    """The resumable cut: a frame dribbled in 7-byte chunks still parses."""
    t = pkg.tbus
    raw = pysocket.create_connection((LOOP, echo_server.port))
    try:
        data = t.pack_frame(t.Meta(service="e", method="e"), b"fragmented-payload", 99)
        for i in range(0, len(data), 7):
            raw.sendall(data[i : i + 7])
            time.sleep(0.002)
        raw.settimeout(5)
        got = b""
        while True:
            got += raw.recv(65536)
            frame, _ = t.try_parse_frame(got)
            if frame is not None:
                break
        assert frame.payload == b"fragmented-payload"
        assert frame.correlation_id == 99
    finally:
        raw.close()


def test_overcrowded_backpressure(pkg):
    lsock = pysocket.socket()
    lsock.bind((LOOP, 0))
    lsock.listen(1)
    sock = pkg.connect(f"{LOOP}:{lsock.getsockname()[1]}", 0)
    conn, _ = lsock.accept()
    old = pkg.flags.get_flag("socket_max_unwritten_bytes")
    pkg.flags.set_flag_unchecked("socket_max_unwritten_bytes", 256 * 1024)
    try:
        saw_overcrowded = False
        for _ in range(300):
            if sock.write(b"q" * 65536) == ErrorCode.EOVERCROWDED:
                saw_overcrowded = True
                break
        assert saw_overcrowded, "write queue never backpressured"
    finally:
        pkg.flags.set_flag_unchecked("socket_max_unwritten_bytes", old)
        conn.close()
        lsock.close()
        sock.recycle()


def test_socket_map_dedups(pkg):
    acceptor = pkg.acceptor(pkg.EndPoint(ip=LOOP, port=0))
    smap = pkg.SocketMap()
    try:
        s1 = smap.get_or_create(f"{LOOP}:{acceptor.port}")
        s2 = smap.get_or_create(f"{LOOP}:{acceptor.port}")
        assert s1 is s2
        assert len(smap) == 1
    finally:
        smap.recycle_all()
        acceptor.stop()


def test_iobuf_write_zero_copy_path(pkg, echo_server):
    """write() takes an IOBuf directly (the path the RPC layer uses: the
    header bytes packed, the payload's blocks shared)."""
    t = pkg.tbus
    c = _Client(pkg, f"{LOOP}:{echo_server.port}")
    try:
        payload = b"P" * 100_000
        buf = pkg.IOBuf()
        buf.append(t.pack_frame(t.Meta(service="e", method="e"), payload, 5))
        assert c.sock.write(buf) == 0
        assert c.wait(5).payload == payload
    finally:
        c.sock.recycle()


class TestOversizedHeaderRejected:
    def test_crafted_giant_header_fails_connection_before_buffering(self, pkg):
        # a valid-magic header declaring a ~4 GiB body is rejected at
        # header time, not buffered until memory runs out
        srv = _server(pkg, {"t": {"echo": lambda cntl, req: req}})
        assert srv.start(0)
        # the preferred protocol established by one good call first
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{srv.port}")
        assert ch.call_method("t", "echo", b"ok").ok()
        c = pysocket.create_connection(("127.0.0.1", srv.port))
        c.sendall(struct.pack("<8I", 0x54505243, 0xFFFFFF00, 0, 1, 0, 0, 0, 0) + b"slow-drip")
        c.settimeout(5)
        # the server closes the connection (recv -> EOF) instead of buffering
        deadline = time.monotonic() + 5
        got = b"x"
        while got and time.monotonic() < deadline:
            try:
                got = c.recv(4096)
            except (ConnectionResetError, OSError):
                got = b""
        assert not got, "connection not closed after oversized header"
        c.close()


def test_drain_inline_slow_reader_and_contenders(pkg, echo_server):
    """A multi-MB frame past a full kernel buffer and a contender's frame
    queued while its writer holds drainer-ship both flush, in order (the
    JAX package drains on the calling thread, drain_inline=True; the port
    through KeepWrite)."""
    t = pkg.tbus
    c = _Client(pkg, f"{LOOP}:{echo_server.port}")
    try:
        big = b"D" * (8 << 20)  # overruns the loopback sndbuf several times
        data = t.pack_frame(t.Meta(service="e", method="e"), big, 7001)
        contender = t.pack_frame(t.Meta(service="e", method="e"), b"tail", 7002)
        rcs = []
        th = threading.Thread(target=lambda: rcs.append(c.sock.write(contender)))
        rc = None

        def drive():
            nonlocal rc
            th.start()  # the contender races the drainer
            rc = pkg.write_inline(c.sock, data, 30)

        d = threading.Thread(target=drive)
        d.start()
        d.join(30)
        th.join(10)
        assert rc == 0 and rcs == [0]
        assert c.wait(7001, timeout=30.0).payload == big
        assert c.wait(7002, timeout=30.0).payload == b"tail"
    finally:
        c.sock.recycle()


def test_drain_inline_timeout_falls_back_to_keepwrite(pkg, echo_server):
    """An inline drainer whose timeout elapses with bytes still queued hands
    off to the KeepWrite fiber: the frame still arrives."""
    t = pkg.tbus
    c = _Client(pkg, f"{LOOP}:{echo_server.port}")
    try:
        big = b"F" * (8 << 20)
        data = t.pack_frame(t.Meta(service="e", method="e"), big, 7003)
        assert pkg.write_inline(c.sock, data, 0) == 0  # timeout 0: gives up at once
        assert c.wait(7003, timeout=30.0).payload == big
    finally:
        c.sock.recycle()


class TestBulkReadEscalation:
    """Saturated drains escalate to big malloc'd blocks
    (append_from_fd_bulk) after consecutive full bursts; the re-cut byte
    stream stays intact across the pooled -> bulk -> pooled transitions."""

    def test_large_echo_roundtrip_through_bulk_path(self, pkg):
        srv = _server(pkg, {"bulk": {"echo": lambda cntl, req: req}})
        assert srv.start(0)
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{srv.port}")
        # 16 MiB >> the 512 KiB pooled burst: the server's drain sees many
        # consecutive full reads and escalates; the response drives the
        # client's drain the same way
        blob = bytes(range(256)) * (16 * 4096)
        for _ in range(2):
            cntl = ch.call_method("bulk", "echo", blob, cntl=pkg.rpc.Controller(timeout_ms=60000))
            assert cntl.ok(), cntl.error_text
            assert cntl.response_payload == blob
        # and small frames still flow after de-escalation
        c = ch.call_method("bulk", "echo", b"tiny")
        assert c.ok() and c.response_payload == b"tiny"

    def test_bulk_append_iobuf_api(self, pkg):
        a, b = pysocket.socketpair()
        try:
            payload = os.urandom(1 << 20)
            # a writer thread: sendall past the socketpair's buffer would
            # deadlock against an unread peer
            w = threading.Thread(target=a.sendall, args=(payload,))
            w.start()
            buf = pkg.IOBuf()
            got = 0
            while got < len(payload):
                rc = buf.append_from_fd_bulk(b.fileno(), 4 << 20, 256 << 10)
                assert rc > 0, rc
                got += rc
            w.join(timeout=10)
            assert buf.to_bytes() == payload
        finally:
            a.close()
            b.close()


# -- ROADMAP C14: a connection accepted while the acceptor stops ---------------


def test_connection_accepted_while_stopping_is_closed(monkeypatch):
    """The accept loop creates a connection's Socket, and only then
    registers it; ``stop()`` fails the connections registered when it
    looks. Held by order: the accept loop is parked between the two
    steps until ``stop()`` has returned. The port then fails the late
    connection itself (its peer reads EOF) and leaves none registered. The
    JAX package's acceptor registers it after ``stop()`` and serves it on
    (ROADMAP C14), so this case runs on the port alone."""
    accepted = threading.Event()
    release = threading.Event()

    class ParkedSocket(port_sock.Socket):
        @classmethod
        def from_accepted(cls, *args, **kwargs):
            sock = port_sock.Socket.from_accepted(*args, **kwargs)
            accepted.set()
            assert release.wait(30), "the test never released the accept loop"
            return sock

    monkeypatch.setattr(port_acceptor, "Socket", ParkedSocket)
    acceptor = _port_acceptor(port_endpoint.EndPoint(ip=LOOP, port=0))
    client = pysocket.create_connection((LOOP, acceptor.port), timeout=10)
    try:
        assert accepted.wait(10), "the connection was not accepted"
        acceptor.stop()  # its snapshot cannot hold the parked connection
        release.set()
        assert client.recv(1) == b"", "a connection accepted while stopping lived on"
        assert acceptor.connections() == []
    finally:
        release.set()
        client.close()
