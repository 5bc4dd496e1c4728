"""The port's streaming RPC (``incubator_brpc_tpu_torch.rpc.stream``) and
execution queue (``runtime/execution_queue.py``) on the CPU, held against
the JAX package's:

- each of tests/test_stream.py's 15 tests, run on both packages with the
  answers the JAX package's tests assert: ``TestHandshake`` (3),
  ``TestDataPath`` (3), ``TestFlowControl`` (2), ``TestClose`` (3),
  ``TestOversizedMessage`` (1), ``TestStreamOverDeviceLink`` (1; the port's
  server on ``device="cpu"``: one device, so the link takes the host swap)
  and ``TestRawMessages`` (2);
- the four ``test_execution_queue_*`` cases of tests/test_runtime.py on
  both packages' ``ExecutionQueue``;
- wire parity: one seeded script of stream frames (data, feedback, close,
  rst, the RST answer to a frame for an unknown stream), with and without
  the body checksum, written by both packages' ``Stream`` objects onto a
  recording socket: byte-identical, and each package's cut reads the
  other's frames back;
- the port's IOBuf cut hands a stream's data body to the stream layer as a
  zero-copy cut of the read chain;
- interop over TCP both ways: a port Channel's stream to a JAX-package
  Server, and a JAX-package Channel's stream to a port Server, data both
  ways and the close.

Each test stops what it started, and after each no ``tbtorch-*`` thread
is left."""

import threading
import time
import types

import numpy as np
import pytest

import incubator_brpc_tpu.iobuf as jax_iobuf
import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu.rpc.server as jax_server_mod
import incubator_brpc_tpu.rpc.stream as jax_stream
import incubator_brpc_tpu.runtime.execution_queue as jax_eq
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu.transport import device_link as jax_dl
from incubator_brpc_tpu.utils.flags import set_flag as jax_set_flag
import incubator_brpc_tpu_torch.iobuf as port_iobuf
import incubator_brpc_tpu_torch.rpc as port_rpc
import incubator_brpc_tpu_torch.rpc.stream as port_stream
import incubator_brpc_tpu_torch.runtime as port_runtime
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.transport import device_link as port_dl
from incubator_brpc_tpu_torch.utils.flags import set_flag as port_set_flag
from incubator_brpc_tpu_torch.utils.status import ErrorCode

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", rpc=jax_rpc, ServerOptions=jax_server_mod.ServerOptions,
        stream=jax_stream, eq=jax_eq, IOBuf=jax_iobuf.IOBuf, tbus=jax_tbus,
        dl=jax_dl, set_flag=jax_set_flag, server_kw={},
    ),
    "torch": types.SimpleNamespace(
        name="torch", rpc=port_rpc, ServerOptions=port_rpc.ServerOptions,
        stream=port_stream, eq=port_runtime, IOBuf=port_iobuf.IOBuf, tbus=port_tbus,
        dl=port_dl, set_flag=port_set_flag, server_kw={"device": "cpu"},
    ),
}

_OPEN = []  # servers the test started, stopped at teardown


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    while _OPEN:
        srv = _OPEN.pop()
        srv.stop()
        assert srv.join(timeout=10)
    port_rpc.shutdown_host_plane()
    assert shutdown_watchers(timeout=60)
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _recorder(pkg, delay=0.0):
    class Recorder(pkg.stream.StreamHandler):
        def __init__(self):
            self.messages = []
            self.closed = threading.Event()
            self.failed = threading.Event()

        def on_received_messages(self, stream, messages):
            if delay:
                time.sleep(delay)
            self.messages.extend(messages)

        def on_closed(self, stream):
            self.closed.set()

        def on_failed(self, stream, code, reason):
            self.failed.set()
            self.closed.set()

    return Recorder()


def _start(pkg, services, **opts):
    srv = pkg.rpc.Server(pkg.ServerOptions(**opts, **pkg.server_kw))
    for name, handlers in services.items():
        srv.add_service(name, handlers)
    assert srv.start(0)
    _OPEN.append(srv)
    return srv


def _stream_server(pkg):
    """The JAX test's ``echo_server``: ``test.open_stream`` accepts with the
    handler the test parked in ``accepted["handler"]``; ``test.plain``
    never accepts."""
    accepted = {}

    def open_stream(cntl, request):
        opts = pkg.stream.StreamOptions(handler=accepted.get("handler") or _recorder(pkg))
        s = pkg.stream.stream_accept(cntl, opts)
        assert s is not None
        accepted["stream"] = s
        return b"accepted"

    def plain(cntl, request):
        return request

    srv = _start(pkg, {"test": {"open_stream": open_stream, "plain": plain}})
    return srv, accepted


@pytest.fixture
def echo_server(pkg):
    return _stream_server(pkg)


def _connect(pkg, server, accepted, handler=None, client_opts=None):
    ch = pkg.rpc.Channel()
    assert ch.init(f"127.0.0.1:{server.port}")
    accepted["handler"] = handler
    s = pkg.stream.stream_create(
        client_opts or pkg.stream.StreamOptions(handler=_recorder(pkg))
    )
    cntl = ch.call_method("test", "open_stream", b"", request_stream=s)
    assert cntl.ok(), cntl.error_text
    assert s.wait_connected(timeout=5)
    return ch, s


# -- tests/test_stream.py, on both packages -----------------------------------


class TestHandshake:
    def test_accept_connects_both_sides(self, pkg, echo_server):
        server, accepted = echo_server
        _, s = _connect(pkg, server, accepted, handler=_recorder(pkg))
        srv_stream = accepted["stream"]
        assert s.state == pkg.stream.CONNECTED
        assert srv_stream.state == pkg.stream.CONNECTED
        assert s.remote_id == srv_stream.id
        assert srv_stream.remote_id == s.id
        s.close()

    def test_unaccepted_stream_fails(self, pkg, echo_server):
        server, accepted = echo_server
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{server.port}")
        s = pkg.stream.stream_create(pkg.stream.StreamOptions(handler=_recorder(pkg)))
        # "plain" never calls stream_accept → response meta has no stream id
        cntl = ch.call_method("test", "plain", b"x", request_stream=s)
        assert cntl.ok()
        assert _wait(lambda: s.state == pkg.stream.CLOSED)
        assert s.write(b"data") == ErrorCode.EINVAL

    def test_failed_rpc_kills_stream(self, pkg, echo_server):
        server, accepted = echo_server
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{server.port}")
        s = pkg.stream.stream_create(pkg.stream.StreamOptions(handler=_recorder(pkg)))
        cntl = ch.call_method("test", "nosuch", b"", request_stream=s)
        assert cntl.failed()
        assert _wait(lambda: s.state == pkg.stream.CLOSED)


class TestDataPath:
    def test_ordered_delivery_client_to_server(self, pkg, echo_server):
        server, accepted = echo_server
        rec = _recorder(pkg)
        _, s = _connect(pkg, server, accepted, handler=rec)
        msgs = [f"msg-{i}".encode() for i in range(50)]
        for m in msgs:
            assert s.write(m) == 0
        assert _wait(lambda: len(rec.messages) == 50)
        assert rec.messages == msgs
        s.close()

    def test_bidirectional(self, pkg, echo_server):
        server, accepted = echo_server
        client_rec = _recorder(pkg)
        _, s = _connect(
            pkg, server, accepted, handler=_recorder(pkg),
            client_opts=pkg.stream.StreamOptions(handler=client_rec),
        )
        srv_stream = accepted["stream"]
        assert srv_stream.write(b"from-server") == 0
        assert _wait(lambda: client_rec.messages == [b"from-server"])
        s.close()

    def test_large_messages(self, pkg, echo_server):
        server, accepted = echo_server
        rec = _recorder(pkg)
        _, s = _connect(pkg, server, accepted, handler=rec)
        big = bytes(range(256)) * 4096  # 1 MiB
        assert s.write(big, timeout=10) == 0
        assert _wait(lambda: rec.messages == [big])
        s.close()


class TestFlowControl:
    def test_window_blocks_writer_and_feedback_resumes(self, pkg, echo_server):
        """The credit-window property (stream.cpp:263-300): a slow consumer
        stalls the writer at max_buf_size; its feedback un-stalls."""
        server, accepted = echo_server
        rec = _recorder(pkg, delay=0.15)  # slow consumer
        _, s = _connect(pkg, server, accepted, handler=rec)
        s.options.max_buf_size = 4096
        chunk = b"x" * 2048
        # two chunks fill the window; the third must hit EAGAIN immediately
        assert s.write(chunk) == 0
        assert s.write(chunk) == 0
        assert s.write(chunk, timeout=0) == ErrorCode.EAGAIN
        assert s.unconsumed_bytes == 4096
        # blocking write parks until the consumer's feedback lifts the window
        t0 = time.monotonic()
        assert s.write(chunk, timeout=10) == 0
        assert time.monotonic() - t0 > 0.05  # it actually blocked on the butex
        assert _wait(lambda: len(rec.messages) == 3)
        s.close()

    def test_unlimited_window_never_blocks(self, pkg, echo_server):
        server, accepted = echo_server
        rec = _recorder(pkg)
        _, s = _connect(pkg, server, accepted, handler=rec)
        s.options.max_buf_size = 0
        for _ in range(20):
            assert s.write(b"y" * 1024, timeout=0) == 0
        assert _wait(lambda: len(rec.messages) == 20)
        s.close()


class TestClose:
    def test_close_notifies_peer_after_data(self, pkg, echo_server):
        server, accepted = echo_server
        rec = _recorder(pkg)
        _, s = _connect(pkg, server, accepted, handler=rec)
        s.write(b"last-words")
        s.close()
        assert rec.closed.wait(timeout=5)
        assert rec.messages == [b"last-words"]  # data seen before close
        assert s.state == pkg.stream.CLOSED
        assert s.write(b"after") == ErrorCode.EINVAL

    def test_registry_cleanup(self, pkg, echo_server):
        server, accepted = echo_server
        rec = _recorder(pkg)
        _, s = _connect(pkg, server, accepted, handler=rec)
        sid, srv_sid = s.id, accepted["stream"].id
        assert pkg.stream.get_stream(sid) is not None
        s.close()
        assert rec.closed.wait(timeout=5)
        assert pkg.stream.get_stream(sid) is None
        assert _wait(lambda: pkg.stream.get_stream(srv_sid) is None)

    def test_socket_failure_fails_stream(self, pkg, echo_server):
        server, accepted = echo_server
        ch, s = _connect(pkg, server, accepted, handler=_recorder(pkg))
        # fail the client's underlying socket out from under the stream
        client_rec = _recorder(pkg)
        s2 = pkg.stream.stream_create(pkg.stream.StreamOptions(handler=client_rec))
        cntl = ch.call_method("test", "open_stream", b"", request_stream=s2)
        assert cntl.ok()
        assert s2.wait_connected(timeout=5)
        s2._sock.set_failed(ErrorCode.EFAILEDSOCKET, "injected")
        assert client_rec.failed.wait(timeout=5)
        assert s2.write(b"z") == ErrorCode.EINVAL


class TestOversizedMessage:
    def test_message_larger_than_window_still_goes_out(self, pkg, echo_server):
        # one message bigger than max_buf_size is admitted on an idle stream
        # (AppendIfNotFull stream.cpp:263)
        server, accepted = echo_server
        rec = _recorder(pkg)
        _, s = _connect(
            pkg, server, accepted, handler=rec,
            client_opts=pkg.stream.StreamOptions(handler=_recorder(pkg), max_buf_size=64 * 1024),
        )
        big = bytes(256 * 1024)  # 4x the window
        assert s.write(big, timeout=5) == 0
        assert _wait(lambda: len(rec.messages) == 1)
        assert rec.messages[0] == big
        # and the window still functions afterwards: feedback caught up
        assert _wait(lambda: s.unconsumed_bytes == 0)
        s.close()


class TestStreamOverDeviceLink:
    def test_stream_rides_the_device_link(self, pkg, echo_server):
        server, accepted = echo_server
        rec = _recorder(pkg)
        accepted["handler"] = rec
        ch = pkg.rpc.Channel()
        assert ch.init(
            f"127.0.0.1:{server.port}",
            options=pkg.rpc.ChannelOptions(transport="tpu", timeout_ms=60000),
        )
        s = pkg.stream.stream_create(pkg.stream.StreamOptions(handler=_recorder(pkg)))
        cntl = ch.call_method("test", "open_stream", b"", request_stream=s)
        assert cntl.ok(), cntl.error_text
        assert s.wait_connected(timeout=10)
        # the RPC (and therefore the stream frames) rode a DeviceSocket
        assert isinstance(ch._device_sock, pkg.dl.DeviceSocket)
        assert s._sock is ch._device_sock
        blob = bytes(range(256)) * 64
        for i in range(20):
            assert s.write(b"%03d:" % i + blob, timeout=30) == 0
        assert _wait(lambda: len(rec.messages) == 20, timeout=30)
        assert rec.messages[0][:4] == b"000:"
        assert rec.messages[19][:4] == b"019:"
        assert all(m[4:] == blob for m in rec.messages)
        s.close()
        assert rec.closed.wait(10)


class TestRawMessages:
    def test_raw_handler_gets_iobufs_with_correct_content(self, pkg):
        got = []
        done = threading.Event()

        class RawSink(pkg.stream.StreamHandler):
            def on_received_messages(self, s, msgs):
                got.extend(msgs)
                if sum(len(m) for m in got) >= 3 * 65536:
                    done.set()

        def open_stream(cntl, req):
            pkg.stream.stream_accept(
                cntl, pkg.stream.StreamOptions(handler=RawSink(), raw_messages=True)
            )
            return b""

        srv = _start(pkg, {"raw": {"open": open_stream}}, usercode_inline=True)
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{srv.port}")
        s = pkg.stream.stream_create(pkg.stream.StreamOptions())
        c = ch.call_method("raw", "open", b"", request_stream=s)
        assert c.ok(), c.error_text
        assert s.wait_connected(5)
        msgs = [bytes([i]) * 65536 for i in range(3)]
        for m in msgs:
            assert s.write(m, timeout=10) == 0
        assert done.wait(10), "raw messages not delivered"
        # every delivered message is an IOBuf whose bytes round-trip
        assert all(isinstance(m, pkg.IOBuf) for m in got)
        assert [m.to_bytes() for m in got] == msgs
        s.close()

    def test_bytes_are_wrapped_for_raw_handlers(self, pkg):
        got = []

        class RawSink(pkg.stream.StreamHandler):
            def on_received_messages(self, s, msgs):
                got.extend(msgs)

        s = pkg.stream.Stream(
            999001, pkg.stream.StreamOptions(handler=RawSink(), raw_messages=True),
            is_client=False,
        )
        s._rq.execute((pkg.stream.FT_DATA, b"plain-bytes-payload"))
        assert _wait(lambda: bool(got)), "message not consumed"
        assert isinstance(got[0], pkg.IOBuf)
        assert got[0].to_bytes() == b"plain-bytes-payload"


# -- tests/test_runtime.py's execution-queue cases, on both packages ----------


def test_execution_queue_n_producers_per_producer_order(pkg):
    seen = []

    def consumer(it):
        for item in it:
            seen.append(item)

    q = pkg.eq.ExecutionQueue(consumer)
    nproducers, nitems = 8, 200

    def producer(p):
        for i in range(nitems):
            assert q.execute((p, i)) == 0

    threads = [threading.Thread(target=producer, args=(p,)) for p in range(nproducers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    q.stop()
    assert q.join(timeout=10)
    assert len(seen) == nproducers * nitems
    # single-consumer actor: each producer's items arrive in order
    for p in range(nproducers):
        assert [i for (pp, i) in seen if pp == p] == list(range(nitems))


def test_execution_queue_single_consumer_at_a_time(pkg):
    active = [0]
    max_active = [0]
    lock = threading.Lock()

    def consumer(it):
        with lock:
            active[0] += 1
            max_active[0] = max(max_active[0], active[0])
        for _ in it:
            time.sleep(0.0005)
        with lock:
            active[0] -= 1

    q = pkg.eq.ExecutionQueue(consumer, max_batch=4)
    threads = [
        threading.Thread(target=lambda: [q.execute(i) for i in range(50)]) for _ in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    q.stop()
    assert q.join(timeout=10)
    assert max_active[0] == 1


def test_execution_queue_high_priority_lane(pkg):
    seen = []
    gate = threading.Event()

    def consumer(it):
        gate.wait(timeout=10)
        for item in it:
            seen.append(item)

    q = pkg.eq.ExecutionQueue(consumer)
    q.execute("n1")
    q.execute("n2")
    q.execute("hi", high_priority=True)
    gate.set()
    q.stop()
    assert q.join(timeout=10)
    # the batch drained after the gate put the high-priority item first
    assert seen.index("hi") < seen.index("n1") or seen[0] == "n1"
    assert set(seen) == {"n1", "n2", "hi"}


def test_execution_queue_stop_rejects_and_reports(pkg):
    stopped_seen = []

    def consumer(it):
        list(it)
        stopped_seen.append(it.is_queue_stopped())

    q = pkg.eq.execution_queue_start(consumer)
    q.execute(1)
    q.stop()
    assert q.execute(2) != 0  # EINVAL after stop
    assert q.join(timeout=10)
    assert stopped_seen[-1] is True


# -- wire parity ---------------------------------------------------------------


class _RecordingSock:
    """Socket-shaped sink: every frame a Stream writes, as bytes."""

    def __init__(self):
        self.frames = []
        self.on_failed = []
        self.context = {}

    def write(self, data, on_error=None, timeout=None, drain_inline=False):
        self.frames.append(data if isinstance(data, bytes) else data.to_bytes())
        return 0


def _stream_script(pkg, seed, body_crc):
    """One seeded script of stream frames through ``pkg``'s Stream objects:
    data of seeded sizes, feedback after seeded consumption, the RST
    answer to a data frame for an unknown stream, a close and an rst."""
    rng = np.random.default_rng(seed)
    pkg.set_flag("tbus_body_crc", body_crc)
    try:
        sock = _RecordingSock()
        opts = pkg.stream.StreamOptions(max_buf_size=0)
        a = pkg.stream.Stream(41, opts, is_client=True)
        b = pkg.stream.Stream(42, pkg.stream.StreamOptions(max_buf_size=0), is_client=False)
        a._connect(sock, 7001)
        b._connect(sock, 7002)
        for _ in range(12):
            op = int(rng.integers(0, 3))
            if op < 2:
                n = int(rng.integers(0, 3000))
                assert a.write(rng.integers(0, 256, n, dtype=np.uint8).tobytes()) == 0
            else:
                b._consumed += int(rng.integers(1, 5000))
                b._send_feedback()
        stray = pkg.tbus.ParsedFrame(
            meta=pkg.tbus.Meta(stream_id=987654, extra={"ft": "data", "from": 55}),
            payload=b"late", flags=pkg.tbus.FLAG_STREAM,
        )
        pkg.stream.process_stream(sock, stray)
        a.close()
        b.rst()
        return sock.frames
    finally:
        pkg.set_flag("tbus_body_crc", False)


@pytest.mark.parametrize("body_crc", [False, True], ids=["meta-crc", "body-crc"])
def test_stream_frames_byte_identical_to_the_jax_package(body_crc):
    jax_frames = _stream_script(PKGS["jax"], 19, body_crc)
    port_frames = _stream_script(PKGS["torch"], 19, body_crc)
    assert len(port_frames) == len(jax_frames) > 10
    assert port_frames == jax_frames
    kinds = []
    for raw in port_frames:
        # the JAX package's parse reads the port's frames; the port's IOBuf
        # cut reads them back to the same meta and body
        want, n = jax_tbus.try_parse_frame(raw)
        assert n == len(raw)
        buf = port_iobuf.IOBuf()
        buf.append(raw)
        got, m = port_tbus.parse_frame_iobuf(buf)
        assert m == len(raw) and len(buf) == 0
        assert got.is_stream and got.flags == want.flags
        assert got.meta.extra == want.meta.extra
        assert got.meta.stream_id == want.meta.stream_id
        assert got.payload == want.payload
        kinds.append(got.meta.extra["ft"])
    assert {"data", "fb", "close", "rst"} <= set(kinds)


def test_stream_body_is_a_zero_copy_cut_of_the_read_chain():
    meta = port_tbus.Meta(stream_id=3, extra={"ft": "data", "from": 9})
    body = bytes(range(256)) * 40
    raw = port_tbus.pack_frame(meta, body, 0, flags=port_tbus.FLAG_STREAM)
    block = bytearray(raw)
    buf = port_iobuf.IOBuf()
    buf.append_external(block)
    frame, n = port_tbus.parse_frame_iobuf(buf)
    assert n == len(raw)
    assert frame.payload_iobuf is not None and frame._payload == b""
    # the body's block IS the read chain's block: a later write to it shows
    view = frame.payload_iobuf.views()[0]
    block[len(raw) - len(body)] ^= 0xFF
    assert view[0] == body[0] ^ 0xFF
    block[len(raw) - len(body)] ^= 0xFF
    assert frame.payload == body  # the lazy bytes, once


# -- interop over TCP ----------------------------------------------------------


@pytest.mark.parametrize("client,server", [("torch", "jax"), ("jax", "torch")])
def test_stream_interop_over_tcp(client, server):
    cli, srv_pkg = PKGS[client], PKGS[server]
    srv, accepted = _stream_server(srv_pkg)
    server_rec = _recorder(srv_pkg)
    client_rec = _recorder(cli)
    ch, s = _connect(
        cli, srv, accepted, handler=server_rec,
        client_opts=cli.stream.StreamOptions(handler=client_rec, max_buf_size=8192),
    )
    rng = np.random.default_rng(23)
    msgs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(1, 20000, 30)]
    for m in msgs:
        assert s.write(m, timeout=10) == 0
    assert _wait(lambda: len(server_rec.messages) == len(msgs), timeout=10)
    assert server_rec.messages == msgs
    assert _wait(lambda: s.unconsumed_bytes == 0)  # the peer's feedback arrived
    back = [m[::-1] for m in msgs[:5]]
    for m in back:
        assert accepted["stream"].write(m, timeout=10) == 0
    assert _wait(lambda: client_rec.messages == back)
    s.close()
    assert server_rec.closed.wait(5)
    assert _wait(lambda: srv_pkg.stream.get_stream(accepted["stream"].id) is None)
