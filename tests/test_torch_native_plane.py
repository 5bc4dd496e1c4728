"""The port's native network plane (``csrc/host/tbnet`` +
``incubator_brpc_tpu_torch/transport/native_plane.py``) on the CPU, held
against the JAX package's:

- tests/test_native_plane.py's classes, each case run on both packages
  with the answers the JAX test asserts (the port's servers on
  ``ServerOptions(device="cpu")``): ``TestNativeDispatch``,
  ``TestPythonRoute``, ``TestInterop``, ``TestUserNativeMethods`` (a
  ``.so`` built from a source the test writes under ``tmp_path``),
  ``TestStreamsOverNative``, ``TestNativeClientModes``,
  ``TestGarbageAndEdge``, ``TestTelemetryRingStress`` (``slow``, as
  there), ``TestMultiReactor``, ``TestDispatchPool``,
  ``TestWorkStealingDeque``, ``TestWorkStealingDequeStress`` (``slow``, as
  there) and ``TestMultiReactorReviewFixes``;
- interop over TCP both ways: a JAX-package ``Channel(native_plane=True)``
  against a port native-plane ``Server`` and the reverse; each package's
  native client emits the same request frame bytes (but for the
  correlation id, which each library mints), and the two native servers
  answer one script of raw frames with the same bytes and the same
  telemetry records, field by field apart from the times;
- the handoff of a connection that speaks another protocol to a Python
  ``Socket``, which answers it over HTTP (``/health``) on both packages;
- the device echo (K1, ``DeviceEndpoint(device="cpu").server_handler()``)
  through a port native-plane server, from the port's Python ``Channel``
  and its native client: bitwise the endpoint's answer through the Python
  plane.

Since ROADMAP A7: ``TestPythonRoute.test_method_admission_via_python_
route`` and ``TestGatesStayEnforced`` (a per-method limit on the Python
route, an authenticator and a constant server-wide limit keeping native
methods on the Python route) run on both packages, and so do the three
native-plane options that refused naming A7 before (the native client's
fault schedule, auth, a server-wide limit). Since ROADMAP A11a the native
client on baidu_std is served by both packages (what refused naming A11
here before), and an authenticator's token table keeps native methods in
C++ on both (``_served_auth``); ``TestInterop.test_http_handoff_same_port``
is in tests/test_torch_http.py, and baidu_std on the native plane in
tests/test_torch_native_baidu.py. Since ROADMAP A10
``TestGarbageAndEdge.test_unix_endpoint_falls_back_to_python_acceptor``
runs on both packages: a ``unix://`` endpoint is served on the Python
acceptor. Tolerance: none, everything here is bytes and integers.
"""

from __future__ import annotations

import ctypes
import errno
import socket as pysocket
import struct
import subprocess
import threading
import time
import types

import numpy as np
import pytest

import incubator_brpc_tpu.rpc as jax_rpc
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu.transport import native_plane as jax_np
from incubator_brpc_tpu.utils import flags as jax_flags
import incubator_brpc_tpu_torch.rpc as port_rpc
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.transport import native_plane as port_np
from incubator_brpc_tpu_torch.transport.device import DeviceEndpoint
from incubator_brpc_tpu_torch.utils import flags as port_flags
from incubator_brpc_tpu_torch.utils.status import ErrorCode

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", rpc=jax_rpc, np=jax_np, tbus=jax_tbus, flags=jax_flags, server_kw={},
    ),
    "torch": types.SimpleNamespace(
        name="torch", rpc=port_rpc, np=port_np, tbus=port_tbus, flags=port_flags,
        server_kw={"device": "cpu"},
    ),
}

_OPEN = []  # servers and endpoints the test started, stopped at teardown


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    while _OPEN:
        obj = _OPEN.pop()
        if isinstance(obj, DeviceEndpoint):
            assert obj.close(timeout=60)
        else:
            obj.stop()
            obj.join(timeout=10)
    port_rpc.shutdown_host_plane()
    assert shutdown_watchers(timeout=60)
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


@pytest.fixture
def tune():
    """tune(pkg, flag, value): set a flag of one package, restored after."""
    touched = []

    def set_(pkg, name, value):
        touched.append((pkg.flags, name, pkg.flags.get_flag(name)))
        pkg.flags.set_flag_unchecked(name, value)

    yield set_
    for flags, name, value in reversed(touched):
        flags.set_flag_unchecked(name, value)


def _server(pkg, services, **opts):
    """A native-plane server of ``pkg`` (inline user code, as the JAX
    test's fixture), started on an ephemeral port."""
    opts.setdefault("usercode_inline", True)
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(native_plane=True, **opts, **pkg.server_kw))
    for name, handlers in services.items():
        srv.add_service(name, handlers)
    _OPEN.append(srv)
    assert srv.start(0)
    assert srv._native_plane is not None, "native plane did not engage"
    return srv


def _channel(pkg, port, **opts):
    ch = pkg.rpc.Channel()
    assert ch.init(f"127.0.0.1:{port}", options=pkg.rpc.ChannelOptions(**opts))
    return ch


def _native(pkg, port, protocol="tbus_std"):
    return pkg.np.NativeClientChannel("127.0.0.1", port, protocol=protocol)


def _capture_drained(pkg, plane):
    """Keep a copy of every drained telemetry batch (the JAX test's
    capture pattern): the fan-out still runs."""
    captured = []
    lock = threading.Lock()
    orig = plane._consume_records
    dtype = pkg.np.NativeServerPlane._rec_dtype()

    def capture(batch, n):
        arr = np.frombuffer(batch, dtype=dtype, count=n).copy()
        with lock:
            captured.append(arr)
        orig(batch, n)

    plane._consume_records = capture
    return captured


def _build_so(tmp_path_factory, name, src):
    d = tmp_path_factory.mktemp(name)
    (d / "m.cc").write_text(src)
    so = d / "libm.so"
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-o", str(so), str(d / "m.cc")],
                   check=True, capture_output=True)
    return str(so)


def _py_reverse(cntl, req):
    return req[::-1]


class TestNativeDispatch:
    def test_native_echo_roundtrip(self, pkg):
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
        c = _channel(pkg, srv.port, native_plane=True).call_method("svc", "echo", b"payload-bytes")
        assert c.ok(), c.error_text
        assert c.response_payload == b"payload-bytes"
        assert srv._native_plane.stats()["native_reqs"] >= 1  # no interpreter

    def test_native_echo_with_attachment(self, pkg):
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
        ch = _channel(pkg, srv.port, native_plane=True)
        c = ch.call_method("svc", "echo", b"pp", attachment=b"A" * 1000)
        assert c.ok(), c.error_text
        assert c.response_payload == b"pp"
        assert c.response_attachment == b"A" * 1000

    def test_native_nop(self, pkg):
        srv = _server(pkg, {"svc": {"nop": pkg.rpc.native_nop}})
        c = _channel(pkg, srv.port, native_plane=True).call_method("svc", "nop", b"ignored")
        assert c.ok(), c.error_text
        assert c.response_payload == b""

    def test_body_crc_flag_roundtrip(self, pkg, tune):
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
        tune(pkg, "tbus_body_crc", True)
        c = _channel(pkg, srv.port, native_plane=True).call_method("svc", "echo", b"crc-covered")
        assert c.ok(), c.error_text
        assert c.response_payload == b"crc-covered"

    def test_unknown_method_fails_cleanly(self, pkg):
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
        ch = _channel(pkg, srv.port, native_plane=True)
        c = ch.call_method("svc", "missing", b"")
        assert c.failed() and c.error_code == ErrorCode.ENOMETHOD
        c = ch.call_method("ghost", "echo", b"")
        assert c.failed() and c.error_code == ErrorCode.ENOSERVICE


class TestPythonRoute:
    def test_python_handler_and_error(self, pkg):
        def boom(cntl, req):
            cntl.set_failed(ErrorCode.EINTERNAL, "deliberate")
            return b""

        srv = _server(pkg, {"svc": {"up": lambda cntl, req: req.upper(), "boom": boom}})
        ch = _channel(pkg, srv.port, native_plane=True)
        c = ch.call_method("svc", "up", b"abc")
        assert c.ok() and c.response_payload == b"ABC"
        c = ch.call_method("svc", "boom", b"")
        assert c.failed() and "deliberate" in c.error_text

    def test_async_handler_responds_from_other_thread(self, pkg):
        def slow(cntl, req):
            cntl.set_async()

            def later():
                time.sleep(0.05)
                cntl.send_response(b"late:" + req)

            threading.Thread(target=later).start()
            return None

        srv = _server(pkg, {"svc": {"slow": slow}})
        c = _channel(pkg, srv.port, native_plane=True, timeout_ms=2000).call_method(
            "svc", "slow", b"x")
        assert c.ok(), c.error_text
        assert c.response_payload == b"late:x"

    def test_python_route_through_the_worker_pool(self, pkg):
        """usercode_inline=False: the Python route hands each frame to the
        worker pool, and concurrent callers all get their own answer."""
        srv = _server(pkg, {"svc": {"up": lambda cntl, req: req.upper()}}, usercode_inline=False)
        ch = _channel(pkg, srv.port, native_plane=True, timeout_ms=5000)
        errs = []

        def worker(tag):
            for i in range(20):
                p = f"{tag}-{i}".encode()
                c = ch.call_method("svc", "up", p)
                if not c.ok() or c.response_payload != p.upper():
                    errs.append((tag, i, c.error_text))

        ts = [threading.Thread(target=worker, args=(f"t{t}",)) for t in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs
        assert srv._native_plane.stats()["cb_frames"] >= 80


class TestInterop:
    def test_python_client_native_server(self, pkg):
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
        c = _channel(pkg, srv.port).call_method("svc", "echo", b"from-python-plane")
        assert c.ok(), c.error_text
        assert c.response_payload == b"from-python-plane"

    def test_native_client_python_server(self, pkg):
        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(usercode_inline=True, **pkg.server_kw))
        srv.add_service("svc", {"echo": lambda cntl, req: req})
        _OPEN.append(srv)
        assert srv.start(0)
        assert srv._native_plane is None
        ch = _channel(pkg, srv.port, native_plane=True)
        c = ch.call_method("svc", "echo", b"native-to-python")
        assert c.ok(), c.error_text
        assert c.response_payload == b"native-to-python"
        assert ch._native_ch is not None  # the native client carried it

    def test_fallback_when_channel_dies(self, pkg):
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
        ch = _channel(pkg, srv.port, native_plane=True, timeout_ms=1000)
        assert ch.call_method("svc", "echo", b"1").ok()
        srv.stop()
        c = ch.call_method("svc", "echo", b"2")
        assert c.failed()  # recovered into a clean failure, no hang

    def test_another_protocol_is_handed_off_to_a_python_socket(self, pkg):
        """The protocol-sniff handoff: a connection that opens with
        neither tbus_std nor baidu_std leaves the C++ plane for a Python
        Socket, which answers it over HTTP."""
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
        raw = pysocket.create_connection(("127.0.0.1", srv.port), timeout=5)
        raw.sendall(b"GET /health HTTP/1.1\r\nHost: x\r\n\r\n")
        deadline = time.monotonic() + 5
        while srv._native_plane.stats()["handoffs"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv._native_plane.stats()["handoffs"] == 1
        reply = raw.recv(4096)
        raw.close()
        assert reply.startswith(b"HTTP/1.1")
        # the native plane keeps serving
        assert _channel(pkg, srv.port, native_plane=True).call_method("svc", "echo", b"k").ok()


@pytest.mark.parametrize("client,server", [("jax", "torch"), ("torch", "jax")])
def test_interop_over_tcp_both_ways(client, server):
    """A native-plane Channel of one package against a native-plane Server
    of the other: native methods, the Python route, attachments, errors."""
    cpkg, spkg = PKGS[client], PKGS[server]
    srv = _server(spkg, {"svc": {"echo": spkg.rpc.native_echo, "nop": spkg.rpc.native_nop,
                                 "rev": _py_reverse}})
    for opts in ({"native_plane": True}, {"native_plane": True, "connection_type": "pooled"}):
        ch = _channel(cpkg, srv.port, **opts)
        rng = np.random.default_rng(3)
        for n in (0, 1, 255, 4096, 40_000):
            p = rng.bytes(n)
            c = ch.call_method("svc", "echo", p, attachment=p[:17])
            assert c.ok() and c.response_payload == p and c.response_attachment == p[:17]
            c = ch.call_method("svc", "rev", p)
            assert c.ok() and c.response_payload == p[::-1]
        assert ch.call_method("svc", "nop", b"x").response_payload == b""
        c = ch.call_method("svc", "nope", b"x")
        assert c.error_code == ErrorCode.ENOMETHOD
        assert ch._native_ch is not None or opts.get("connection_type") == "pooled"


def _recording_server():
    """A raw TCP listener that records each connection's first frame and
    answers it with an empty response (same cid)."""
    lst = pysocket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(4)
    frames = []

    def serve():
        while True:
            try:
                conn, _ = lst.accept()
            except OSError:
                return
            buf = b""
            while len(buf) < 32 or len(buf) < 32 + struct.unpack_from("<8I", buf)[1]:
                d = conn.recv(65536)
                if not d:
                    break
                buf += d
            h = struct.unpack_from("<8I", buf)
            frames.append(buf[: 32 + h[1]])
            conn.sendall(port_tbus.pack_frame(None, b"", h[3] | (h[4] << 32),
                                              flags=port_tbus.FLAG_RESPONSE))
            conn.close()

    threading.Thread(target=serve, daemon=True).start()
    return lst, frames


@pytest.mark.parametrize("body_crc", [False, True])
def test_native_clients_emit_the_same_frames(body_crc, tune):
    lst, frames = _recording_server()
    port = lst.getsockname()[1]
    try:
        for pkg in (PKGS["jax"], PKGS["torch"]):
            tune(pkg, "tbus_body_crc", body_crc)
            ch = _native(pkg, port)
            try:
                rc, err, _m, _b = ch.call("svc", "echo", b"frame-bytes" * 9, b"att",
                                          timeout_ms=3000, log_id=5)
                assert rc >= 0 and err == 0
            finally:
                ch.close()
    finally:
        lst.close()
    jax_frame, port_frame = frames
    hj, hp = struct.unpack_from("<8I", jax_frame), struct.unpack_from("<8I", port_frame)
    # every word but the correlation id (3, 4: each library mints its own)
    assert [hj[i] for i in (0, 1, 2, 5, 6, 7)] == [hp[i] for i in (0, 1, 2, 5, 6, 7)]
    assert jax_frame[32:] == port_frame[32:]
    assert bool(hp[2] & port_tbus.FLAG_BODY_CRC) == body_crc


def _raw_exchange(port, frames):
    """Send ``frames`` on one connection, one at a time; the raw replies."""
    out = []
    with pysocket.create_connection(("127.0.0.1", port), timeout=5) as s:
        for f in frames:
            s.sendall(f)
            buf = b""
            while len(buf) < 32 or len(buf) < 32 + struct.unpack_from("<8I", buf)[1]:
                d = s.recv(65536)
                assert d, "server closed the connection"
                buf += d
            out.append(buf)
    return out


def test_native_servers_answer_a_raw_script_alike(tune):
    """One script of raw tbus_std frames (fixed correlation ids) to each
    package's native-plane server: the reply bytes are identical, and the
    drained telemetry records agree field by field apart from the times."""
    rng = np.random.default_rng(7)
    script = []
    for i, (method, n) in enumerate((("echo", 0), ("echo", 64), ("nop", 5), ("echo", 40_000),
                                     ("missing", 3), ("echo", 1000))):
        meta = port_tbus.Meta(service="svc", method=method)
        script.append(port_tbus.pack_frame(meta, rng.bytes(n), (1 << 32) | (100 + i)))
    replies, records = {}, {}
    for pkg in (PKGS["jax"], PKGS["torch"]):
        tune(pkg, "native_telemetry", True)
        tune(pkg, "native_telemetry_sample_every", 2)
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo, "nop": pkg.rpc.native_nop}},
                      num_reactors=1)
        captured = _capture_drained(pkg, srv._native_plane)
        replies[pkg.name] = _raw_exchange(srv.port, script)
        srv._native_plane.drain_telemetry()
        records[pkg.name] = np.concatenate(captured)
    assert replies["jax"] == replies["torch"]
    assert len(replies["torch"]) == len(script)
    fields = ("method_idx", "error_code", "correlation_id", "request_size", "response_size",
              "sampled", "reactor_id", "trace_id", "span_id")
    rj, rp = records["jax"], records["torch"]
    assert len(rj) == len(rp) == 5  # the unknown method never reaches a ring
    for f in fields:
        assert rj[f].tolist() == rp[f].tolist(), f
    assert (rp["latency_ns"] > 0).all()


class TestUserNativeMethods:
    SRC = r"""
    #include <stdlib.h>
    #include <string.h>
    extern "C" int reverse_method(void* ud, const char* req, size_t n,
                                  char** resp, size_t* resp_len) {
      (void)ud;
      char* out = (char*)malloc(n ? n : 1);
      for (size_t i = 0; i < n; ++i) out[i] = req[n - 1 - i];
      *resp = out;
      *resp_len = n;
      return 0;
    }
    extern "C" int failing_method(void* ud, const char* req, size_t n,
                                  char** resp, size_t* resp_len) {
      (void)ud; (void)req; (void)n; (void)resp; (void)resp_len;
      return 1008;  /* an application error code */
    }
    """

    @pytest.fixture(scope="class")
    def method_lib(self, tmp_path_factory):
        return _build_so(tmp_path_factory, "native_methods", self.SRC)

    def test_so_method_never_crosses_into_python(self, pkg, method_lib):
        srv = _server(pkg, {"user": {"reverse": pkg.np.native_method_lib(
            method_lib, "reverse_method", _py_reverse)}})
        ch = _channel(pkg, srv.port, native_plane=True)
        before = srv._native_plane.stats()
        for payload in (b"abc", b"", b"x" * 10000):
            cntl = ch.call_method("user", "reverse", payload)
            assert cntl.ok(), cntl.error_text
            assert cntl.response_payload == payload[::-1]
        after = srv._native_plane.stats()
        assert after["native_reqs"] - before["native_reqs"] == 3
        assert after["cb_frames"] == before["cb_frames"]  # zero Python frames

    def test_so_method_error_code_surfaces(self, pkg, method_lib):
        srv = _server(pkg, {"user": {"boom": pkg.np.native_method_lib(
            method_lib, "failing_method", _py_reverse)}})
        cntl = _channel(pkg, srv.port, native_plane=True).call_method("user", "boom", b"q")
        assert cntl.failed()
        assert cntl.error_code == 1008

    def test_missing_symbol_falls_back_to_python_route(self, pkg, method_lib):
        srv = _server(pkg, {"user": {"reverse": pkg.np.native_method_lib(
            method_lib, "no_such_symbol", _py_reverse)}})
        cntl = _channel(pkg, srv.port, native_plane=True).call_method("user", "reverse", b"abc")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"cba"  # the Python fallback served
        assert srv._native_plane.stats()["cb_frames"] > 0


class TestStreamsOverNative:
    def test_stream_over_native_conn(self, pkg):
        got = []
        done = threading.Event()

        class Sink(pkg.rpc.StreamHandler):
            def on_received_messages(self, s, msgs):
                got.extend(msgs)
                if sum(len(m) for m in got) >= 4096:
                    done.set()

        def open_stream(cntl, req):
            pkg.rpc.stream_accept(cntl, pkg.rpc.StreamOptions(handler=Sink()))
            return b""

        srv = _server(pkg, {"svc": {"open": open_stream}})
        ch = _channel(pkg, srv.port, native_plane=True, timeout_ms=3000)
        s = pkg.rpc.stream_create(pkg.rpc.StreamOptions())
        c = ch.call_method("svc", "open", b"", request_stream=s)
        assert c.ok(), c.error_text
        assert s.wait_connected(3)
        chunk = b"z" * 1024
        for _ in range(4):
            assert s.write(chunk, timeout=3) == 0
        assert done.wait(5)
        assert b"".join(bytes(m) for m in got) == chunk * 4
        s.close()


class TestNativeClientModes:
    def test_pooled_connection_type(self, pkg):
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
        ch = _channel(pkg, srv.port, native_plane=True, connection_type="pooled")
        errs = []

        def worker():
            for i in range(50):
                c = ch.call_method("svc", "echo", b"t%d" % i)
                if c.failed() or c.response_payload != b"t%d" % i:
                    errs.append(c.error_text)

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs

    def test_concurrent_callers_shared_conn(self, pkg):
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
        ch = _channel(pkg, srv.port, native_plane=True)
        errs = []

        def worker(tag):
            for i in range(100):
                payload = f"{tag}-{i}".encode()
                c = ch.call_method("svc", "echo", payload)
                if c.failed() or c.response_payload != payload:
                    errs.append((tag, i, c.error_text))

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs[:3]

    def test_pump_harness(self, pkg):
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
        nch = _native(pkg, srv.port)
        try:
            ns = nch.pump("svc", "echo", b"x" * 64, 2000, inflight=32)
            assert 0 < ns < 1_000_000  # < 1 ms a request even on a loaded host
        finally:
            nch.close()

    def test_timeout_maps_to_rpc_timeout(self, pkg):
        def sleepy(cntl, req):
            time.sleep(0.5)
            return b""

        srv = _server(pkg, {"svc": {"sleepy": sleepy}})
        ch = _channel(pkg, srv.port, native_plane=True, timeout_ms=100)
        t0 = time.monotonic()
        c = ch.call_method("svc", "sleepy", b"")
        assert c.failed()
        assert c.error_code == ErrorCode.ERPCTIMEDOUT
        assert time.monotonic() - t0 < 0.45


def test_port_refuses_what_waits_naming_the_item():
    """Once refused naming A11: both packages' native clients speak
    baidu_std (a native echo and a Python-routed error over PRPC), and
    refuse a protocol neither native channel packs."""
    for pkg in PKGS.values():
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo,
                                    "boom": lambda c, r: c.set_failed(ErrorCode.EINTERNAL, "b")}})
        nch = _native(pkg, srv.port, protocol="baidu_std")
        try:
            rc, code, meta, body = nch.call("svc", "echo", b"prpc", b"att", timeout_ms=5000)
            m = nch.decode_resp_meta(meta)
            assert (rc >= 0, code, m.attachment_size, body.to_bytes()) == (True, 0, 3, b"prpcatt")
            rc, code, meta, _ = nch.call("svc", "boom", b"", timeout_ms=5000)
            assert (code, nch.decode_resp_meta(meta).error_text) == (ErrorCode.EINTERNAL, "b")
        finally:
            nch.close()
        with pytest.raises(ValueError):
            pkg.np.NativeClientChannel("127.0.0.1", srv.port, protocol="nshead")


def _served_fault_schedule(pkg, tune):
    """install_native_client_fault: every 3rd native call fails with the
    scheduled code, the same positions on both packages."""
    tune(pkg, "fault_injection", True)
    pkg.np.install_native_client_fault(fail_every=3, error_code=ErrorCode.EINTERNAL)
    try:
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
        nch = _native(pkg, srv.port)
    finally:
        pkg.np.install_native_client_fault()  # clear: later channels are clean
    try:
        codes = [nch.call("svc", "echo", b"x", timeout_ms=5000)[1] for _ in range(9)]
    finally:
        nch.close()
    return codes


def _served_auth(pkg, tune):
    """ServerOptions(native_plane=True, auth=...): the right token answers,
    a missing or wrong one gets ERPCAUTH, all through the Python route."""
    auth = pkg.rpc.TokenAuthenticator(["tok-a"])
    srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}}, auth=auth)
    good = _channel(pkg, srv.port, auth=pkg.rpc.TokenAuthenticator("tok-a"))
    codes = [good.call_method("svc", "echo", b"x").error_code for _ in range(2)]
    codes.append(_channel(pkg, srv.port, native_plane=True).call_method("svc", "echo", b"x").error_code)
    wrong = _channel(pkg, srv.port, auth=pkg.rpc.TokenAuthenticator("tok-b"))
    codes.append(wrong.call_method("svc", "echo", b"x").error_code)
    # the C++ token table keeps native methods in C++ on both packages: a
    # connection the Python route proved answers its later frames natively
    assert srv._native_plane.native_method_names() == ["svc.echo"]
    assert srv._native_plane.stats()["native_reqs"] == 1
    return codes


def _served_server_limit(pkg, tune):
    """ServerOptions(native_plane=True, max_concurrency=1): a constant
    server-wide limit keeps native methods on the Python route, where a
    second call while one is held gets ELIMIT."""
    gate = threading.Event()
    entered = threading.Event()

    def hold(cntl, req):
        entered.set()
        gate.wait(10)
        return b"done"

    srv = _server(pkg, {"svc": {"hold": hold, "echo": pkg.rpc.native_echo}},
                  max_concurrency=1, usercode_inline=False)
    assert srv._native_plane.native_method_names() == []
    ch = _channel(pkg, srv.port, native_plane=True, timeout_ms=10000, max_retry=0)
    held = []
    t = threading.Thread(target=lambda: held.append(ch.call_method("svc", "hold", b"")))
    t.start()
    try:
        assert entered.wait(10)
        second = ch.call_method("svc", "echo", b"x").error_code
    finally:
        gate.set()
        t.join(10)
    return [held[0].error_code, second, ch.call_method("svc", "echo", b"x").error_code]


SERVED_A7 = {
    "install_native_client_fault": (_served_fault_schedule, [0, 0, ErrorCode.EINTERNAL] * 3),
    "auth": (_served_auth, [0, 0, ErrorCode.ERPCAUTH, ErrorCode.ERPCAUTH]),
    "max_concurrency": (_served_server_limit, [0, ErrorCode.ELIMIT, 0]),
}


@pytest.mark.parametrize("option", sorted(SERVED_A7))
def test_port_serves_the_native_options_a7_brought(option, tune):
    """Each native-plane option that refused naming A7 is served by both
    packages with the same codes."""
    drive, want = SERVED_A7[option]
    for pkg in PKGS.values():
        assert drive(pkg, tune) == want, pkg.name


class TestGatesStayEnforced:
    def test_method_admission_via_python_route(self, pkg):
        gate = threading.Event()
        entered = threading.Event()

        def hold(cntl, req):
            entered.set()
            gate.wait(10)
            return b"done"

        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(native_plane=True, **pkg.server_kw))
        srv.add_service("svc", {"hold": hold})
        srv._methods.get("svc.hold").status.max_concurrency = 1
        _OPEN.append(srv)
        assert srv.start(0)
        ch = _channel(pkg, srv.port, native_plane=True, timeout_ms=10000)
        results = []
        t1 = threading.Thread(target=lambda: results.append(ch.call_method("svc", "hold", b"")))
        t1.start()
        try:
            assert entered.wait(10)
            c2 = ch.call_method("svc", "hold", b"")
            assert c2.failed()
            assert c2.error_code == ErrorCode.ELIMIT
        finally:
            gate.set()
            t1.join(10)
        assert results[0].ok()

    def test_auth_server_keeps_native_methods_on_python_route(self, pkg):
        """An Authenticator is a per-request gate the C++ fast path does not
        run on tbus_std: with auth configured, even native-kind methods go
        through Server.process_request (and reject bad credentials)."""
        auth = pkg.rpc.SharedSecretAuthenticator("secret", identity="svc-a")
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}}, auth=auth)
        ch_ok = _channel(pkg, srv.port,
                         auth=pkg.rpc.SharedSecretAuthenticator("secret", identity="svc-a"))
        assert ch_ok.call_method("svc", "echo", b"hi").ok()
        # an unauthenticated native-plane client is rejected, not silently
        # served by the C++ dispatcher
        c = _channel(pkg, srv.port, native_plane=True).call_method("svc", "echo", b"hi")
        assert c.failed()
        assert c.error_code == ErrorCode.ERPCAUTH
        assert srv._native_plane.stats()["native_reqs"] == 0

    def test_server_max_concurrency_disables_native_kinds(self, pkg):
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}}, max_concurrency=64)
        ch = _channel(pkg, srv.port, native_plane=True)
        assert ch.call_method("svc", "echo", b"x").ok()
        # served via the Python route so the server-wide gate applies
        assert srv._native_plane.stats()["native_reqs"] == 0
        assert srv.nrequest.get_value() >= 1


class TestGarbageAndEdge:
    def test_garbage_after_magic_kills_conn_only(self, pkg):
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
        raw = pysocket.create_connection(("127.0.0.1", srv.port))
        hdr = struct.pack("<8I", 0x54505243, 8, 0, 1, 0, 0, 0xDEAD, 0)
        raw.sendall(hdr + b"xxxxxxxx")  # valid magic, crc mismatch
        raw.settimeout(2)
        assert raw.recv(1024) == b""  # the server killed the connection
        raw.close()
        ch = _channel(pkg, srv.port, native_plane=True)
        assert ch.call_method("svc", "echo", b"still-up").ok()

    def test_large_payload(self, pkg):
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
        ch = _channel(pkg, srv.port, native_plane=True, timeout_ms=10000)
        blob = bytes(range(256)) * (4 * 1024 * 16)  # 16 MiB
        c = ch.call_method("svc", "echo", blob)
        assert c.ok(), c.error_text
        assert c.response_payload == blob

    def test_unix_endpoint_falls_back_to_python_acceptor(self, pkg, tmp_path):
        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(native_plane=True, usercode_inline=True,
                                                   **pkg.server_kw))
        srv.add_service("svc", {"echo": pkg.rpc.native_echo})
        _OPEN.append(srv)
        assert srv.start(f"unix://{tmp_path}/np.sock")
        assert srv._native_plane is None  # fell back
        ch = pkg.rpc.Channel()
        assert ch.init(f"unix://{tmp_path}/np.sock")
        c = ch.call_method("svc", "echo", b"via-unix")
        assert c.ok(), c.error_text
        assert c.response_payload == b"via-unix"


@pytest.mark.slow
class TestTelemetryRingStress:
    @pytest.mark.parametrize("num_reactors", [None, 4])
    def test_multi_producer_append_vs_concurrent_drain(self, pkg, tune, num_reactors):
        nthreads, per_thread = 8, 2000
        tune(pkg, "native_telemetry", True)
        tune(pkg, "native_telemetry_ring_size", 4096)
        tune(pkg, "native_telemetry_sample_every", 64)
        tune(pkg, "native_telemetry_drain_ms", 1)
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}}, num_reactors=num_reactors)
        plane = srv._native_plane
        captured = _capture_drained(pkg, plane)
        errors = []

        def producer(tid):
            try:
                ch = _native(pkg, srv.port)
                payload = b"x" * (64 + tid)  # request_size names the producer
                for _ in range(per_thread):
                    rc, err, _meta, _body = ch.call("svc", "echo", payload, timeout_ms=10000)
                    if rc < 0 or err != 0:
                        errors.append((tid, rc, err))
                        return
                ch.close()
            except Exception as e:  # noqa: BLE001
                errors.append((tid, repr(e), None))

        stop_drain = threading.Event()

        def drainer():
            while not stop_drain.is_set():
                plane.drain_telemetry()

        threads = [threading.Thread(target=producer, args=(t,)) for t in range(nthreads)]
        dr = threading.Thread(target=drainer)
        dr.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stop_drain.set()
        dr.join()
        assert not errors, errors[:5]
        produced = plane.stats()["native_reqs"]
        assert produced == nthreads * per_thread
        srv.stop()  # the final drain happens in stop()
        drained, dropped = plane._tel_drained, plane.telemetry_dropped()
        assert drained + dropped == produced
        dtype = pkg.np.NativeServerPlane._rec_dtype()
        all_recs = np.concatenate(captured) if captured else np.zeros(0, dtype)
        assert len(all_recs) == drained
        if not len(all_recs):
            return
        streams = 0
        for size in np.unique(all_recs["request_size"]):
            grp = all_recs[all_recs["request_size"] == size]
            grp = grp[np.argsort(grp["correlation_id"], kind="stable")]
            assert (np.diff(grp["start_ns"].astype(np.int64)) >= -2_000_000).all()
            streams += 1
        assert streams == nthreads
        assert int(all_recs["sampled"].sum()) <= produced // 64 + plane.num_reactors


class TestMultiReactor:
    def test_connection_shard_affinity(self, pkg, tune):
        tune(pkg, "native_telemetry", True)
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}}, num_reactors=4)
        plane = srv._native_plane
        assert plane.num_reactors == 4
        captured = _capture_drained(pkg, plane)
        chans = [_native(pkg, srv.port) for _ in range(4)]
        try:
            for _round in range(20):
                for ch in chans:
                    rc, err, _m, _b = ch.call("svc", "echo", b"affinity", timeout_ms=5000)
                    assert rc >= 0 and err == 0, (rc, err)
        finally:
            shards = [ch.reactor for ch in chans]
            for ch in chans:
                ch.close()
        plane.drain_telemetry()
        recs = np.concatenate(captured)
        assert len(recs) == 80
        seen = set()
        for shard in shards:
            grp = recs[(recs["correlation_id"] >> 56) == shard]
            assert len(grp) == 20
            reactors = {int(r) for r in np.unique(grp["reactor_id"])}
            assert len(reactors) == 1, (shard, reactors)  # one conn, one reactor
            seen |= reactors
        assert seen == {0, 1, 2, 3}  # round-robin accept sharding
        for i in range(4):
            st = plane.reactor_stats(i)
            assert st["conns"] in (0, 1)
            assert st["reqs"] >= 20

    def test_interleaved_cross_reactor_calls_no_misroutes(self, pkg):
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}}, num_reactors=4)
        chans = [_native(pkg, srv.port) for _ in range(4)]
        errs = []

        def hammer(idx, ch):
            payload = bytes([65 + idx]) * (16 + idx)
            for _ in range(200):
                rc, err, _m, body = ch.call("svc", "echo", payload, timeout_ms=5000)
                if rc < 0 or err != 0 or body.to_bytes(len(body)) != payload:
                    errs.append((idx, rc, err))
                    return

        try:
            ts = [threading.Thread(target=hammer, args=(i, ch)) for i, ch in enumerate(chans)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert not errs, errs[:3]
            assert sum(ch.cid_misroutes() for ch in chans) == 0
        finally:
            for ch in chans:
                ch.close()

    @staticmethod
    def _wrong_shard_server():
        """A raw tbus_std 'server' that echoes request frames with the
        cid's shard byte flipped: the cross-reactor misroute fuzz."""
        lst = pysocket.socket()
        lst.bind(("127.0.0.1", 0))
        lst.listen(4)

        def serve():
            while True:
                try:
                    conn, _ = lst.accept()
                except OSError:
                    return
                buf = b""
                while True:
                    try:
                        d = conn.recv(65536)
                    except OSError:
                        break
                    if not d:
                        break
                    buf += d
                    while len(buf) >= 32:
                        h = struct.unpack("<8I", buf[:32])
                        if len(buf) < 32 + h[1]:
                            break
                        frame, buf = buf[: 32 + h[1]], buf[32 + h[1]:]
                        hdr = list(struct.unpack("<8I", frame[:32]))
                        hdr[2] |= 1  # response flag
                        hdr[4] ^= 0xFF000000  # corrupt the shard tag
                        try:
                            conn.sendall(struct.pack("<8I", *hdr) + frame[32:])
                        except OSError:
                            break

        threading.Thread(target=serve, daemon=True).start()
        return lst, lst.getsockname()[1]

    def test_wrong_shard_cid_answered_erequest_not_crash(self, pkg):
        lst, port = self._wrong_shard_server()
        try:
            ch = _native(pkg, port)
            try:
                rc, err, _m, _b = ch.call("svc", "echo", b"payload", timeout_ms=3000)
                assert rc == -errno.EBADMSG
                assert ch.cid_misroutes() == 1
                assert ch.healthy()  # survived: no sticky failure
            finally:
                ch.close()
        finally:
            lst.close()

    def test_wrong_shard_cid_surfaces_erequest_at_l5(self, pkg):
        lst, port = self._wrong_shard_server()
        try:
            cntl = _channel(pkg, port, native_plane=True, timeout_ms=3000).call_method(
                "svc", "echo", b"q")
            assert cntl.failed()
            assert cntl.error_code == ErrorCode.EREQUEST
        finally:
            lst.close()

    def test_lame_duck_multi_reactor(self, pkg):
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}}, num_reactors=4)
        chans = [_native(pkg, srv.port) for _ in range(4)]
        try:
            for ch in chans:
                rc, err, _m, _b = ch.call("svc", "echo", b"x", timeout_ms=5000)
                assert rc >= 0 and err == 0
            srv._native_plane.pause_accept()
            deadline = time.monotonic() + 3.0
            refused = False
            while time.monotonic() < deadline:
                try:
                    probe = pysocket.create_connection(("127.0.0.1", srv.port), timeout=0.2)
                    probe.close()
                    time.sleep(0.05)
                except OSError:
                    refused = True
                    break
            assert refused, "listeners still accepting after pause_accept"
            for ch in chans:  # existing connections keep working
                rc, err, _m, _b = ch.call("svc", "echo", b"y", timeout_ms=5000)
                assert rc >= 0 and err == 0
        finally:
            for ch in chans:
                ch.close()

    def test_close_idle_multi_reactor(self, pkg):
        srv = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}}, num_reactors=4)
        chans = [_native(pkg, srv.port) for _ in range(4)]
        try:
            for ch in chans:
                rc, err, _m, _b = ch.call("svc", "echo", b"x", timeout_ms=5000)
                assert rc >= 0 and err == 0
            time.sleep(0.15)
            assert srv._native_plane.close_idle(0.05) == 4  # one idle conn a reactor
            assert srv.connection_count() <= 4
        finally:
            for ch in chans:
                ch.close()


_SLOW_SRC = r"""
#include <stdlib.h>
#include <string.h>
#include <unistd.h>
extern "C" int slow_reverse_method(void* ud, const char* req, size_t n,
                                   char** resp, size_t* resp_len) {
  (void)ud;
  usleep(400000);  /* 400 ms: long enough to prove the loop is free */
  char* out = (char*)malloc(n ? n : 1);
  for (size_t i = 0; i < n; ++i) out[i] = req[n - 1 - i];
  *resp = out;
  *resp_len = n;
  return 0;
}
"""


@pytest.fixture(scope="module")
def slow_lib(tmp_path_factory):
    return _build_so(tmp_path_factory, "slow_methods", _SLOW_SRC)


def _slow(pkg, slow_lib):
    return pkg.rpc.native_long_running(
        pkg.np.native_method_lib(slow_lib, "slow_reverse_method", _py_reverse))


class TestDispatchPool:
    def test_long_running_method_does_not_stall_reactor(self, pkg, slow_lib):
        srv = _server(pkg, {"user": {"slow": _slow(pkg, slow_lib), "echo": pkg.rpc.native_echo}},
                      num_reactors=1, native_dispatch_workers=2)
        slow_ch, echo_ch = _native(pkg, srv.port), _native(pkg, srv.port)
        result = {}

        def run_slow():
            t0 = time.perf_counter()
            rc, err, _m, body = slow_ch.call("user", "slow", b"abcdef", timeout_ms=10000)
            result.update(rc=rc, err=err, body=body.to_bytes(len(body)),
                          dt=time.perf_counter() - t0)

        try:
            t = threading.Thread(target=run_slow)
            t.start()
            time.sleep(0.08)  # the slow call is now inside usleep
            t0 = time.perf_counter()
            rc, err, _m, body = echo_ch.call("user", "echo", b"fast", timeout_ms=5000)
            echo_dt = time.perf_counter() - t0
            assert rc >= 0 and err == 0
            assert body.to_bytes(len(body)) == b"fast"
            t.join(timeout=15)
            assert result["rc"] >= 0 and result["err"] == 0, result
            assert result["body"] == b"fedcba"
            assert result["dt"] >= 0.4
            assert echo_dt < 0.2, f"echo stalled {echo_dt * 1e3:.0f} ms"
            stats = srv._native_plane.stats()
            assert stats["cb_frames"] == 0
            assert stats["native_reqs"] >= 2
        finally:
            slow_ch.close()
            echo_ch.close()

    def test_pool_telemetry_records_carry_reactor(self, pkg, slow_lib, tune):
        tune(pkg, "native_telemetry", True)
        srv = _server(pkg, {"user": {"slow": _slow(pkg, slow_lib)}}, num_reactors=2,
                      native_dispatch_workers=1)
        plane = srv._native_plane
        captured = _capture_drained(pkg, plane)
        ch = _native(pkg, srv.port)
        try:
            rc, err, _m, body = ch.call("user", "slow", b"xy", timeout_ms=10000)
            assert rc >= 0 and err == 0
            assert body.to_bytes(len(body)) == b"yx"
        finally:
            shard = ch.reactor
            ch.close()
        # the pool worker appends the completion record after it wrote the
        # response: drain until the record has landed
        deadline = time.monotonic() + 5
        while not sum(len(c) for c in captured) and time.monotonic() < deadline:
            plane.drain_telemetry()
            time.sleep(0.01)
        recs = np.concatenate(captured)
        mine = recs[(recs["correlation_id"] >> 56) == shard]
        assert len(mine) == 1
        assert int(mine[0]["error_code"]) == 0
        assert int(mine[0]["latency_ns"]) >= 400_000_000  # the sleep is in it
        assert int(mine[0]["reactor_id"]) in (0, 1)
        if pkg.name == "torch":  # the drain fed the method's latency summary
            rec = plane.method_latency("user.slow")
            assert rec is not None and rec.count() == 1 and rec.latency() >= 400_000


class TestWorkStealingDeque:
    def test_push_pop_fifo_lifo_contract(self, pkg):
        lib = pkg.np.LIB
        q = lib.tb_wsq_create(64)
        try:
            for v in (10, 20, 30):
                assert lib.tb_wsq_push(q, v) == 0
            assert lib.tb_wsq_size(q) == 3
            out = ctypes.c_uint64()
            assert lib.tb_wsq_pop(q, ctypes.byref(out)) == 1 and out.value == 30  # LIFO
            assert lib.tb_wsq_steal(q, ctypes.byref(out)) == 1 and out.value == 10  # FIFO
            assert lib.tb_wsq_pop(q, ctypes.byref(out)) == 1 and out.value == 20
            assert lib.tb_wsq_pop(q, ctypes.byref(out)) == 0  # empty
            assert lib.tb_wsq_steal(q, ctypes.byref(out)) == 0
        finally:
            lib.tb_wsq_destroy(q)

    def test_full_deque_rejects_push(self, pkg):
        lib = pkg.np.LIB
        q = lib.tb_wsq_create(1)  # rounds up to the 64 minimum
        try:
            pushed = 0
            while lib.tb_wsq_push(q, pushed) == 0:
                pushed += 1
                assert pushed < 10000  # must hit the cap
            assert pushed >= 64
            out = ctypes.c_uint64()
            assert lib.tb_wsq_pop(q, ctypes.byref(out)) == 1
            assert lib.tb_wsq_push(q, 999) == 0  # space freed
        finally:
            lib.tb_wsq_destroy(q)


@pytest.mark.slow
class TestWorkStealingDequeStress:
    def test_steal_storm_conservation(self, pkg):
        lib = pkg.np.LIB
        nthieves, n_items = 4, 20000
        q = lib.tb_wsq_create(1024)
        stop = threading.Event()
        stolen = [[] for _ in range(nthieves)]
        popped = []

        def thief(idx):
            out = ctypes.c_uint64()
            while not stop.is_set() or lib.tb_wsq_size(q) > 0:
                if lib.tb_wsq_steal(q, ctypes.byref(out)) == 1:
                    stolen[idx].append(out.value)

        ts = [threading.Thread(target=thief, args=(i,)) for i in range(nthieves)]
        for t in ts:
            t.start()
        out = ctypes.c_uint64()
        pushed = 0
        while pushed < n_items:
            if lib.tb_wsq_push(q, pushed) == 0:
                pushed += 1
            elif lib.tb_wsq_pop(q, ctypes.byref(out)) == 1:
                popped.append(out.value)
            if pushed % 97 == 0 and lib.tb_wsq_pop(q, ctypes.byref(out)) == 1:
                popped.append(out.value)
        stop.set()
        for t in ts:
            t.join()
        while lib.tb_wsq_pop(q, ctypes.byref(out)) == 1:
            popped.append(out.value)
        lib.tb_wsq_destroy(q)
        consumed = popped + [v for lst in stolen for v in lst]
        assert len(consumed) == n_items and len(set(consumed)) == n_items


class TestMultiReactorReviewFixes:
    def test_explicit_port_double_bind_still_eaddrinuse(self, pkg):
        srv1 = _server(pkg, {"svc": {"echo": pkg.rpc.native_echo}}, num_reactors=4)
        srv2 = pkg.rpc.Server(pkg.rpc.ServerOptions(native_plane=True, usercode_inline=True,
                                                    num_reactors=4, has_builtin_services=False,
                                                    **pkg.server_kw))
        srv2.add_service("svc2", {"echo": pkg.rpc.native_echo})
        try:
            # the native listen refuses, and the Python acceptor then fails
            # the same way: the double start is loud
            with pytest.raises(OSError) as exc:
                assert not srv2.start(srv1.port)
            assert exc.value.errno == errno.EADDRINUSE
        finally:
            srv2.stop()
        ch = _native(pkg, srv1.port)
        try:
            rc, err, _m, _b = ch.call("svc", "echo", b"x", timeout_ms=5000)
            assert rc >= 0 and err == 0
        finally:
            ch.close()

    def test_queue_expired_deadline_shed_in_pool(self, pkg, slow_lib):
        srv = _server(pkg, {"user": {"slow": _slow(pkg, slow_lib)}}, num_reactors=1,
                      native_dispatch_workers=1)  # ONE worker: the second call queues
        ch1, ch2 = _native(pkg, srv.port), _native(pkg, srv.port)
        results = {}

        def first():
            results["first"] = ch1.call("user", "slow", b"ab", timeout_ms=10000)[:2]

        try:
            t = threading.Thread(target=first)
            t.start()
            time.sleep(0.1)  # the worker is now inside the 400 ms sleep
            rc, err, _m, _b = ch2.call("user", "slow", b"cd", timeout_ms=150)
            t.join(timeout=15)
            assert results["first"] == (2, 0), results
            assert err == ErrorCode.EDEADLINE or rc < 0, (rc, err)
            deadline = time.monotonic() + 2
            while time.monotonic() < deadline:
                if srv._native_plane.stats()["deadline_sheds"] >= 1:
                    break
                time.sleep(0.02)
            assert srv._native_plane.stats()["deadline_sheds"] >= 1
        finally:
            ch1.close()
            ch2.close()


# -- the device echo behind the native plane -------------------------------------


@pytest.mark.parametrize("native_client", [False, True], ids=["python-channel", "native-client"])
def test_device_echo_through_a_native_plane_server(native_client):
    """K1's echo on ``DeviceEndpoint(device="cpu")`` mounted on a port
    native-plane server: the C++ reactor hands each frame to the Python
    route and the endpoint answers; 256 B at window 16, sequential and 16
    callers at once, every response bitwise the endpoint's answer through
    the Python plane (for the echo table, the request itself)."""
    ep = DeviceEndpoint(device="cpu", window_size=16, max_batch=16)
    _OPEN.append(ep)
    srv = _server(PKGS["torch"], {"tensor": {"echo": ep.server_handler()}}, usercode_inline=False)
    ref = port_rpc.Server(port_rpc.ServerOptions(device="cpu"))
    ref.add_service("tensor", {"echo": ep.server_handler()})
    _OPEN.append(ref)
    assert ref.start(0)
    rng = np.random.default_rng(11)
    payloads = [rng.bytes(256) for _ in range(20)] + [rng.bytes(n) for n in (4, 1000, 32768)]
    ch_ref = _channel(PKGS["torch"], ref.port, timeout_ms=60_000)
    want = [ch_ref.call_method("tensor", "echo", p).response_payload for p in payloads]
    assert want == payloads
    ch = _channel(PKGS["torch"], srv.port, native_plane=native_client, timeout_ms=60_000)
    got = [ch.call_method("tensor", "echo", p) for p in payloads]
    assert all(c.ok() for c in got), [c.error_text for c in got if not c.ok()][:3]
    assert [c.response_payload for c in got] == want
    errors = []

    def caller(i):
        for j in range(8):
            p = bytes([i, j]) * 128  # 256 B
            c = ch.call_method("tensor", "echo", p)
            if not c.ok() or c.response_payload != p:
                errors.append((i, j, c.error_code))

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors
    stats = srv._native_plane.stats()
    assert stats["cb_frames"] >= len(payloads) + 128  # every call took the Python route
    assert (ch._native_ch is not None) == native_client


def test_chip_smoke_phase_3f_on_the_cpu():
    """chip_smoke.py's phase 3f at a small scale on the CPU: the second
    build, the twins, the host echo geometries and device RPC behind the
    native plane from both clients (no card, so no launch is counted and
    no profile taken)."""
    import torch

    import chip_smoke
    from incubator_brpc_tpu_torch.ops import kernels

    rpc3b = {"rpc_seq_us": 1.0, "handler_seq_us": 1.0, "rpc_qps": 1.0, "host_echo_seq_us": 1.0,
             "host_echo_qps": 1.0, "profile": {"idle_pct": None}}
    out, k1 = chip_smoke.native_phase(torch, kernels, rpc3b, device="cpu", scale=0.01)
    assert k1 == {"frame_rows": 0, "verify_rows": 0, "echo_step_rows": 0}  # no card, no launch
    assert out["build"]["zlib_h"] is True and out["build"]["seconds"] > 0
    assert set(out["host"]["pump_qps_sweep"]) == {f"r{r}c{c}" for r in (1, 2, 4) for c in (1, 2, 4)}
    assert len(out["host"]["echo_64_us"]) == chip_smoke.NATIVE_SEQ[1]
    dev = out["device_rpc"]
    for name in chip_smoke.NATIVE_RPC_CONFIGS:
        assert len(dev["seq_us"][name]) == 2
        assert all(0 < h < t for h, t in zip(dev["handler_us"][name], dev["seq_us"][name]))
        assert dev["launches"][name] == {"frame_rows": 0, "verify_rows": 0, "echo_step_rows": 0}
    assert set(dev["qps"]) == {"python_plane", "native_plane_python_channel",
                               "native_plane_native_client"}
    # both native-plane channels' calls (warm-ups, 2 x 20 sequential, 2 bursts)
    assert dev["stats"]["cb_frames"] == 2 * (16 * 2 + 2 * 20 + 2 * 16)
