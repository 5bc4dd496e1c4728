"""The port's host RPC plane (``incubator_brpc_tpu_torch.rpc``) on the CPU,
held against the JAX package's:

- the ``TestEcho`` and ``TestErrors`` cases of tests/test_rpc.py, run on
  each package's own Server and Channel with the same payloads, and a
  record of every case's (error code, error text, payload, attachment)
  that must be identical across the two;
- interop both ways: a port Channel calling a JAX-package Server and a
  JAX-package Channel calling a port Server (echo, attachment, each codec,
  each error case);
- device RPC: ``DeviceEndpoint(device="cpu").server_handler()`` mounted on
  the port's Server and called through the port's Channel answers with the
  bytes the JAX package's endpoint answers through its own Server (the echo
  table and methods {0: echo, 3: x2, 5: +10}, ENOMETHOD for an unknown id),
  and 16 threads x 8 calls all succeed with ``fiber_concurrency`` 4;
- frames over ``max_body_size`` refused alike.

Every comparison is byte for byte. Each test stops and joins what it
started: servers, endpoints, and the port's threads (``tbtorch-*``)."""

import sys
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest

import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu.rpc.server as jax_server_mod
from incubator_brpc_tpu.models.tensor_echo import TensorEchoService as JaxService
from incubator_brpc_tpu.transport.device import DeviceEndpoint as JaxEndpoint
from incubator_brpc_tpu.utils import flags as jax_flags
from incubator_brpc_tpu.utils.status import ErrorCode as JaxErrorCode
import incubator_brpc_tpu_torch.rpc as port_rpc
from incubator_brpc_tpu_torch.models.tensor_echo import TensorEchoService
from incubator_brpc_tpu_torch.ops import kernels
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool
from incubator_brpc_tpu_torch.transport.device import DeviceEndpoint
from incubator_brpc_tpu_torch.utils import flags as port_flags
from incubator_brpc_tpu_torch.utils.status import ErrorCode

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", Server=jax_rpc.Server, ServerOptions=jax_server_mod.ServerOptions,
        Channel=jax_rpc.Channel, ChannelOptions=jax_rpc.ChannelOptions,
        Controller=jax_rpc.Controller, flags=jax_flags,
    ),
    "torch": types.SimpleNamespace(
        name="torch", Server=port_rpc.Server, ServerOptions=port_rpc.ServerOptions,
        Channel=port_rpc.Channel, ChannelOptions=port_rpc.ChannelOptions,
        Controller=port_rpc.Controller, flags=port_flags,
    ),
}

_OPEN = []  # servers and endpoints the test built, stopped at teardown


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    while _OPEN:
        obj = _OPEN.pop()
        if isinstance(obj, (DeviceEndpoint, JaxEndpoint)):
            if isinstance(obj, DeviceEndpoint):
                assert obj.close(timeout=60)
        else:
            obj.stop()
            assert obj.join(timeout=10)
    port_rpc.shutdown_host_plane()
    assert shutdown_watchers(timeout=60)
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


def make_echo_server(pkg, delay_s=0.0):
    srv = pkg.Server()

    def echo(cntl, req):
        if delay_s:
            time.sleep(delay_s)
        cntl.response_attachment = cntl.request_attachment
        return req

    def fail(cntl, req):
        cntl.set_failed(ErrorCode.EINTERNAL, "deliberate")
        return b""

    def boom(cntl, req):
        raise RuntimeError("kaboom")

    srv.add_service("Echo", {"echo": echo, "fail": fail, "boom": boom})
    assert srv.start(0)
    _OPEN.append(srv)
    return srv


def connect(pkg, port, **opts):
    ch = pkg.Channel()
    assert ch.init(f"127.0.0.1:{port}", options=pkg.ChannelOptions(**opts))
    return ch


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture
def echo_server(pkg):
    return make_echo_server(pkg)


class TestEcho:
    def test_sync_echo(self, pkg, echo_server):
        ch = connect(pkg, echo_server.port)
        cntl = ch.call("Echo", "echo", b"payload-123")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"payload-123"
        assert cntl.latency_us > 0

    def test_large_payload(self, pkg, echo_server):
        ch = connect(pkg, echo_server.port)
        blob = bytes(range(256)) * 4096  # 1 MiB
        cntl = ch.call("Echo", "echo", blob)
        assert cntl.ok()
        assert cntl.response_payload == blob

    def test_attachment_roundtrip(self, pkg, echo_server):
        ch = connect(pkg, echo_server.port)
        cntl = ch.call("Echo", "echo", b"body", attachment=b"side-channel")
        assert cntl.ok()
        assert cntl.response_payload == b"body"
        assert cntl.response_attachment == b"side-channel"

    def test_async_done(self, pkg, echo_server):
        ch = connect(pkg, echo_server.port)
        done_evt = threading.Event()
        result = {}

        def done(cntl):
            result["payload"] = cntl.response_payload
            result["ok"] = cntl.ok()
            done_evt.set()

        ch.call("Echo", "echo", b"async", done=done)
        assert done_evt.wait(5)
        assert result["ok"] and result["payload"] == b"async"

    def test_many_sequential(self, pkg, echo_server):
        ch = connect(pkg, echo_server.port)
        for i in range(50):
            cntl = ch.call("Echo", "echo", f"msg-{i}".encode())
            assert cntl.ok() and cntl.response_payload == f"msg-{i}".encode()

    def test_concurrent_callers(self, pkg, echo_server):
        ch = connect(pkg, echo_server.port)
        errors = []

        def worker(n):
            for i in range(10):
                cntl = ch.call("Echo", "echo", f"{n}-{i}".encode())
                if not cntl.ok() or cntl.response_payload != f"{n}-{i}".encode():
                    errors.append((n, i, cntl.error_code))

        threads = [threading.Thread(target=worker, args=(n,)) for n in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors

    def test_compress_roundtrip(self, pkg, echo_server):
        ch = connect(pkg, echo_server.port)
        for codec in ("gzip", "zlib", "zlib1", "snappy"):
            cntl = pkg.Controller()
            cntl.compress_type = codec
            cntl = ch.call("Echo", "echo", b"Z" * 50000, cntl=cntl)
            assert cntl.ok(), (codec, cntl.error_text)
            assert cntl.response_payload == b"Z" * 50000
            assert cntl.response_meta.compress == codec  # answered in kind


class TestErrors:
    def test_unknown_codec_fails_fast(self, pkg, echo_server):
        ch = connect(pkg, echo_server.port)
        cntl = pkg.Controller()
        cntl.compress_type = "lz4"  # not registered
        t0 = time.monotonic()
        cntl = ch.call("Echo", "echo", b"x", cntl=cntl)
        assert cntl.error_code == ErrorCode.EREQUEST
        assert time.monotonic() - t0 < 0.4  # failed fast, not via timeout

    def test_enoservice(self, pkg, echo_server):
        ch = connect(pkg, echo_server.port)
        cntl = ch.call("Nothing", "echo", b"")
        assert cntl.error_code == ErrorCode.ENOSERVICE

    def test_enomethod(self, pkg, echo_server):
        ch = connect(pkg, echo_server.port)
        cntl = ch.call("Echo", "nonexistent", b"")
        assert cntl.error_code == ErrorCode.ENOMETHOD

    def test_handler_set_failed(self, pkg, echo_server):
        ch = connect(pkg, echo_server.port)
        cntl = ch.call("Echo", "fail", b"")
        assert cntl.error_code == ErrorCode.EINTERNAL
        assert "deliberate" in cntl.error_text

    def test_handler_raises(self, pkg, echo_server):
        ch = connect(pkg, echo_server.port)
        cntl = ch.call("Echo", "boom", b"")
        assert cntl.error_code == ErrorCode.EINTERNAL
        assert "kaboom" in cntl.error_text

    def test_connection_refused(self, pkg):
        ch = connect(pkg, 1, max_retry=0)  # port 1: nothing listens
        cntl = ch.call("Echo", "echo", b"")
        assert cntl.failed()
        assert cntl.error_code == ErrorCode.EFAILEDSOCKET

    def test_timeout(self, pkg):
        srv = make_echo_server(pkg, delay_s=1.0)
        ch = connect(pkg, srv.port, timeout_ms=100)
        t0 = time.monotonic()
        cntl = ch.call("Echo", "echo", b"slow")
        dt = time.monotonic() - t0
        assert cntl.error_code == ErrorCode.ERPCTIMEDOUT
        assert dt < 0.9  # returned at the deadline, not the handler

    def test_elogoff_when_stopping(self, pkg, echo_server):
        ch = connect(pkg, echo_server.port)
        assert ch.call("Echo", "echo", b"warm").ok()
        echo_server._stopping = True  # stop intake without closing conns
        try:
            cntl = ch.call("Echo", "echo", b"x")
            assert cntl.error_code == ErrorCode.ELOGOFF
            assert cntl.retried_count == 3  # ELOGOFF is retriable
        finally:
            echo_server._stopping = False

    def test_start_cancel(self, pkg):
        srv = make_echo_server(pkg, delay_s=0.5)
        ch = connect(pkg, srv.port, timeout_ms=5000)
        done_evt = threading.Event()
        cntl = ch.call("Echo", "echo", b"x", done=lambda c: done_evt.set())
        cntl.start_cancel()
        assert done_evt.wait(5)
        assert cntl.error_code == ErrorCode.ECANCELED
        assert cntl.retried_count == 0  # a cancel is never retried


# -- the same calls on both packages give the same answers --------------------


def _scenario(pkg, rng_seed):
    """Every case above in one run: (label, code, text, payload, attachment)."""
    rng = np.random.default_rng(rng_seed)
    payloads = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
                for n in (0, 1, 100, 4096, 70_000)]
    srv = make_echo_server(pkg)
    slow = make_echo_server(pkg, delay_s=0.6)
    ch = connect(pkg, srv.port)
    out = []

    def record(label, cntl):
        out.append((label, int(cntl.error_code), cntl.error_text,
                    cntl.response_payload, cntl.response_attachment, cntl.retried_count))

    for i, p in enumerate(payloads):
        record(f"echo {i}", ch.call("Echo", "echo", p))
        record(f"attachment {i}", ch.call("Echo", "echo", p, attachment=p[::-1]))
    for codec in ("gzip", "zlib", "zlib1", "snappy"):
        c = pkg.Controller()
        c.compress_type = codec
        record(f"compress {codec}", ch.call("Echo", "echo", payloads[3] * 4, cntl=c))
    c = pkg.Controller()
    c.compress_type = "lz4"
    cntl = ch.call("Echo", "echo", b"x", cntl=c)
    out.append(("unknown codec", int(cntl.error_code), cntl.error_text.split(":")[0]))
    record("enoservice", ch.call("Nothing", "echo", b""))
    record("enomethod", ch.call("Echo", "nonexistent", b""))
    record("set_failed", ch.call("Echo", "fail", b"abc"))
    record("raises", ch.call("Echo", "boom", b""))
    record("refused", connect(pkg, 1, max_retry=0).call("Echo", "echo", b""))
    record("timeout", connect(pkg, slow.port, timeout_ms=100).call("Echo", "echo", b"slow"))
    srv._stopping = True
    try:
        record("elogoff", ch.call("Echo", "echo", b"x"))
    finally:
        srv._stopping = False
    return out


def test_both_packages_answer_the_same_calls_alike():
    got = {name: _scenario(PKGS[name], 7) for name in ("jax", "torch")}
    assert len(got["torch"]) == len(got["jax"]) == 22
    for want, have in zip(got["jax"], got["torch"]):
        assert have == want, want[0]


# -- interop: each package's Channel against the other's Server ---------------


@pytest.mark.parametrize("client,server", [("torch", "jax"), ("jax", "torch")])
def test_interop(client, server):
    cli, srv_pkg = PKGS[client], PKGS[server]
    srv = make_echo_server(srv_pkg)
    ch = connect(cli, srv.port)
    rng = np.random.default_rng(11)
    blob = rng.integers(0, 256, size=100_000, dtype=np.uint8).tobytes()
    cntl = ch.call("Echo", "echo", blob)
    assert cntl.ok() and cntl.response_payload == blob
    cntl = ch.call("Echo", "echo", b"body", attachment=b"att")
    assert (cntl.response_payload, cntl.response_attachment) == (b"body", b"att")
    for codec in ("gzip", "zlib", "zlib1", "snappy"):
        c = cli.Controller()
        c.compress_type = codec
        cntl = ch.call("Echo", "echo", blob[:5000] * 10, cntl=c)
        assert cntl.ok() and cntl.response_payload == blob[:5000] * 10, codec
    cases = [
        ("Nothing", "echo", ErrorCode.ENOSERVICE, "unknown Nothing.echo"),
        ("Echo", "nonexistent", ErrorCode.ENOMETHOD, "unknown Echo.nonexistent"),
        ("Echo", "fail", ErrorCode.EINTERNAL, "deliberate"),
        ("Echo", "boom", ErrorCode.EINTERNAL, "handler raised: RuntimeError('kaboom')"),
    ]
    for service, method, code, text in cases:
        cntl = ch.call(service, method, b"q")
        assert (cntl.error_code, cntl.error_text) == (code, text)
    slow = make_echo_server(srv_pkg, delay_s=0.6)
    cntl = connect(cli, slow.port, timeout_ms=100).call("Echo", "echo", b"slow")
    assert cntl.error_code == ErrorCode.ERPCTIMEDOUT
    srv._stopping = True
    try:
        cntl = ch.call("Echo", "echo", b"x")
        assert cntl.error_code == ErrorCode.ELOGOFF
    finally:
        srv._stopping = False


def test_frames_over_max_body_size_are_refused_alike():
    """A request over ``max_body_size`` is refused from its header: the
    server fails the connection and the caller sees EFAILEDSOCKET, on both
    packages; a frame under the limit passes."""
    results = {}
    for name in ("jax", "torch"):
        pkg = PKGS[name]
        srv = make_echo_server(pkg)
        pkg.flags.set_flag_unchecked("max_body_size", 4096)
        try:
            ch = connect(pkg, srv.port, max_retry=0)
            small = ch.call("Echo", "echo", b"s" * 1000)
            big = ch.call("Echo", "echo", b"b" * (4096 + 64 * 1024 + 1))
            results[name] = (int(small.error_code), small.response_payload == b"s" * 1000,
                             int(big.error_code))
        finally:
            pkg.flags.set_flag_unchecked("max_body_size", 64 * 1024 * 1024)
    assert results["torch"] == results["jax"] == (0, True, ErrorCode.EFAILEDSOCKET)


def test_propagated_deadline_is_shed_with_edeadline():
    """A server handler's downstream call inherits what is left of the
    caller's budget; once it is spent the call fails fast with EDEADLINE."""
    pkg = PKGS["torch"]
    inner = make_echo_server(pkg)
    seen = {}
    srv = pkg.Server()

    def relay(cntl, req):
        time.sleep(0.3)
        ch = connect(pkg, inner.port, timeout_ms=5000)
        c = ch.call("Echo", "echo", req)
        seen["code"] = c.error_code
        seen["left"] = cntl.deadline_left_ms()
        return b"relayed"

    srv.add_service("Relay", {"go": relay})
    assert srv.start(0)
    _OPEN.append(srv)
    cntl = connect(pkg, srv.port, timeout_ms=200).call("Relay", "go", b"x")
    assert cntl.error_code == ErrorCode.ERPCTIMEDOUT
    assert wait_for(lambda: "code" in seen)
    assert seen["code"] == ErrorCode.EDEADLINE and seen["left"] < 0


def wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


def test_async_handler_answers_later():
    pkg = PKGS["torch"]
    srv = pkg.Server()

    def later(cntl, req):
        cntl.set_async()
        threading.Timer(0.05, lambda: cntl.send_response(req[::-1])).start()
        return None

    srv.add_service("Later", {"rev": later})
    assert srv.start(0)
    _OPEN.append(srv)
    cntl = connect(pkg, srv.port).call("Later", "rev", b"abc")
    assert cntl.ok() and cntl.response_payload == b"cba"


# -- device RPC: DeviceEndpoint.server_handler behind each package's Server ----


def _port_mixed_service():
    svc = TensorEchoService()
    svc.add_method(3, lambda p: kernels.bits32(kernels.u64(p) * 2))
    svc.add_method(5, lambda p: kernels.bits32(kernels.u64(p) + 10))
    return svc


def _jax_mixed_service():
    svc = JaxService()
    svc.add_method(3, lambda p: p * jnp.uint32(2))
    svc.add_method(5, lambda p: p + jnp.uint32(10))
    return svc


def _device_server(name, mixed):
    """A Server of package ``name`` with service "tensor" (the echo table's
    endpoint) and, when ``mixed``, service "mixed" with methods echo, x2,
    plus10 and unknown (ids 0, 3, 5, 999) on a {0, 3, 5} endpoint."""
    if name == "torch":
        ep = DeviceEndpoint(device="cpu", window_size=16, max_batch=16)
        mep = DeviceEndpoint(service=_port_mixed_service(), device="cpu",
                             window_size=16, max_batch=16) if mixed else None
    else:
        ep = JaxEndpoint(window_size=16, max_batch=16)
        mep = JaxEndpoint(service=_jax_mixed_service(), window_size=16,
                          max_batch=16) if mixed else None
    _OPEN.extend(e for e in (ep, mep) if e is not None)
    srv = PKGS[name].Server()
    srv.add_service("tensor", {"echo": ep.server_handler()})
    if mixed:
        srv.add_service("mixed", {m: mep.server_handler(method_id=i)
                                  for m, i in (("echo", 0), ("x2", 3), ("plus10", 5),
                                               ("unknown", 999))})
    assert srv.start(0)
    _OPEN.append(srv)
    return srv


def _device_calls(name, seed):
    srv = _device_server(name, mixed=True)
    ch = connect(PKGS[name], srv.port, timeout_ms=60_000)
    rng = np.random.default_rng(seed)
    out = []
    for n in (1, 3, 4, 255, 256, 1000, 32 * 1024):
        p = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        for service, method in (("tensor", "echo"), ("mixed", "echo"), ("mixed", "x2"),
                                ("mixed", "plus10"), ("mixed", "unknown")):
            c = ch.call(service, method, p)
            out.append((service, method, n, int(c.error_code), c.error_text, c.response_payload))
    return out


def test_device_rpc_answers_as_the_jax_packages():
    want = _device_calls("jax", 5)
    got = _device_calls("torch", 5)
    assert len(got) == len(want) == 35
    for w, g in zip(want, got):
        assert g == w, w[:4]
    for service, method, n, code, text, payload in got:
        if method == "unknown":
            assert code == ErrorCode.ENOMETHOD and payload == b""
        else:
            assert code == 0 and len(payload) == n


def test_device_rpc_words_are_the_methods_results():
    srv = _device_server("torch", mixed=True)
    ch = connect(PKGS["torch"], srv.port, timeout_ms=60_000)
    words = np.arange(1, 65, dtype=np.uint32) * np.uint32(0x01010101)
    for method, want in (("echo", words), ("x2", words * np.uint32(2)),
                         ("plus10", words + np.uint32(10))):
        c = ch.call("mixed", method, words.tobytes())
        assert c.ok(), c.error_text
        np.testing.assert_array_equal(np.frombuffer(c.response_payload, np.uint32), want)


def test_device_rpc_16_callers_with_fiber_concurrency_4():
    """16 threads x 8 calls through the port's Channel and Server into one
    endpoint (window 16) all succeed with a pool of 4 workers: handlers
    parked on the endpoint do not hold the pool's places."""
    port_rpc.shutdown_host_plane()  # the next pool reads the flag
    port_flags.set_flag_unchecked("fiber_concurrency", 4)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    try:
        srv = _device_server("torch", mixed=False)
        assert global_worker_pool().concurrency == 4
        ch = connect(PKGS["torch"], srv.port, timeout_ms=120_000)
        errors = []

        def caller(i):
            for j in range(8):
                p = bytes([i, j]) * 128  # 256 B
                c = ch.call("tensor", "echo", p)
                if not c.ok() or c.response_payload != p:
                    errors.append((i, j, c.error_code))

        threads = [threading.Thread(target=caller, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert errors == []
        # the server records a call's latency after its response is on the
        # wire, so the last caller may return first: wait for the record
        latency = srv.method_status("tensor", "echo").latency
        deadline = time.monotonic() + 10
        while latency.count() < 128 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert latency.count() == 128
    finally:
        sys.setswitchinterval(switch)
        port_flags.set_flag_unchecked("fiber_concurrency", 8)


def test_device_handler_failure_reaches_the_client_as_its_code():
    srv = _device_server("torch", mixed=True)
    ch = connect(PKGS["torch"], srv.port, timeout_ms=60_000)
    c = ch.call("mixed", "unknown", b"abcd")
    assert c.error_code == ErrorCode.ENOMETHOD
    assert c.error_text == f"device call failed ({int(ErrorCode.ENOMETHOD)})"
    assert int(JaxErrorCode.ENOMETHOD) == int(ErrorCode.ENOMETHOD)
