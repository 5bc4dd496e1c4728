"""TLS on the port's transport against the JAX package's: the 11 cases of
tests/test_ssl.py, each run on both packages through the ``pkg`` fixture,
with the certificate in tests/data/ (CN=localhost; the targets are the
loopback IP, so hostname checking is off and the chain is verified).

They cover an encrypted echo, a 1 MiB payload over many TLS records,
eight concurrent writers on one TLS connection, the wire seen through a
recording proxy (the plaintext never crosses it), a plaintext client
against a TLS server and the reverse, an untrusted certificate refused,
TLS and plaintext kept apart in the client socket map, a stream over TLS,
a PartitionChannel over TLS, and a fresh handshake after a reconnect.

Since ROADMAP A10 three more run here: the same device echo
(``DeviceEndpoint.server_handler()``) over each of tbus_std, baidu_std and
HTTP on TLS answers with the bytes of plain TCP, and a device link whose
bootstrap is TLS (``transport="tpu"`` with ``ssl_context``) echoes the
same bytes as a plain link, on both packages: the JAX package on its
CPU device, the port on ``device="cpu"``; and ``chip_smoke.py``'s phase 3k
runs its routes on the CPU at a small scale. Tolerance: none, everything
here is bytes."""

from __future__ import annotations

import pathlib
import socket as pysocket
import ssl
import threading
import time
import types

import numpy as np
import pytest

import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu.rpc.channel as jax_channel
from incubator_brpc_tpu.transport.device import DeviceEndpoint as JaxEndpoint
import incubator_brpc_tpu_torch.rpc as port_rpc
import incubator_brpc_tpu_torch.rpc.channel as port_channel
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.transport.device import DeviceEndpoint
from incubator_brpc_tpu_torch.transport.device_link import device_link_map as port_link_map

DATA = pathlib.Path(__file__).parent / "data"
CERT = str(DATA / "test_cert.pem")
KEY = str(DATA / "test_key.pem")

PKGS = {
    "jax": types.SimpleNamespace(name="jax", rpc=jax_rpc, channel=jax_channel, server_kw={}),
    "torch": types.SimpleNamespace(name="torch", rpc=port_rpc, channel=port_channel,
                                   server_kw={"device": "cpu"}),
}

_OPEN = []  # servers the test started, stopped at teardown


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
        elif not isinstance(obj, JaxEndpoint):
            obj.stop()
            obj.join(timeout=10)
    port_link_map.recycle_all()
    port_rpc.shutdown_host_plane()
    assert shutdown_watchers(timeout=60)
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


def server_ctx() -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(CERT, KEY)
    return ctx


def client_ctx() -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(CERT)
    ctx.check_hostname = False  # the cert is CN=localhost; targets use the IP
    ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def _server(pkg, services, port=0, **opts):
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(usercode_inline=True, **opts, **pkg.server_kw))
    for name, handlers in services.items():
        srv.add_service(name, handlers)
    _OPEN.append(srv)
    assert srv.start(port)
    return srv


@pytest.fixture
def tls_server(pkg):
    return _server(pkg, {"svc": {"echo": lambda cntl, req: req}}, ssl_context=server_ctx())


def _tls_channel(pkg, port, **opts):
    ch = pkg.rpc.Channel()
    assert ch.init(f"127.0.0.1:{port}",
                   options=pkg.rpc.ChannelOptions(ssl_context=client_ctx(), **opts))
    return ch


class TestTlsRpc:
    def test_echo_over_tls(self, pkg, tls_server):
        c = _tls_channel(pkg, tls_server.port).call_method("svc", "echo", b"secret-ping")
        assert c.ok(), c.error_text
        assert c.response_payload == b"secret-ping"

    def test_large_payload_many_records(self, pkg, tls_server):
        # >> the 16 KiB TLS record limit: record reassembly on both sides
        payload = bytes(range(256)) * 4096  # 1 MiB
        c = _tls_channel(pkg, tls_server.port, timeout_ms=20000).call_method("svc", "echo", payload)
        assert c.ok(), c.error_text
        assert c.response_payload == payload

    def test_concurrent_tls_writers(self, pkg, tls_server):
        # encrypt-and-enqueue is atomic, or records interleave corruptly
        ch = _tls_channel(pkg, tls_server.port, timeout_ms=20000)
        errs = []

        def hammer(tid):
            for i in range(10):
                payload = bytes([tid]) * (1000 + i * 977)
                c = ch.call_method("svc", "echo", payload)
                if not (c.ok() and c.response_payload == payload):
                    errs.append((tid, i, c.error_text))

        threads = [threading.Thread(target=hammer, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs

    def test_wire_is_actually_encrypted(self, pkg, tls_server):
        # a recording TCP proxy between client and server: the plaintext
        # marker never appears in either direction's wire bytes
        marker = b"PLAINTEXT-MARKER-0123456789"
        seen = bytearray()
        seen_lock = threading.Lock()
        lsock = pysocket.socket()
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(4)
        stop = threading.Event()

        def pump(src, dst):
            try:
                while not stop.is_set():
                    data = src.recv(65536)
                    if not data:
                        break
                    with seen_lock:
                        seen.extend(data)
                    dst.sendall(data)
            except OSError:
                pass
            finally:
                for c in (src, dst):
                    try:
                        c.close()
                    except OSError:
                        pass

        def proxy():
            while not stop.is_set():
                try:
                    cli, _ = lsock.accept()
                except OSError:
                    return
                upstream = pysocket.create_connection(("127.0.0.1", tls_server.port))
                threading.Thread(target=pump, args=(cli, upstream), daemon=True).start()
                threading.Thread(target=pump, args=(upstream, cli), daemon=True).start()

        threading.Thread(target=proxy, daemon=True).start()
        try:
            ch = _tls_channel(pkg, lsock.getsockname()[1], timeout_ms=10000)
            c = ch.call_method("svc", "echo", marker)
            assert c.ok(), c.error_text
            assert c.response_payload == marker
            with seen_lock:
                wire = bytes(seen)
            assert len(wire) > 0
            assert marker not in wire
        finally:
            stop.set()
            lsock.close()

    def test_plaintext_client_cannot_talk_to_tls_server(self, pkg, tls_server):
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{tls_server.port}",
                       options=pkg.rpc.ChannelOptions(timeout_ms=2000, max_retry=0))
        assert not ch.call_method("svc", "echo", b"x").ok()

    def test_tls_client_against_plaintext_server_fails_cleanly(self, pkg):
        srv = _server(pkg, {"svc": {"echo": lambda cntl, req: req}})
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{srv.port}",
                       options=pkg.rpc.ChannelOptions(ssl_context=client_ctx(), timeout_ms=2000,
                                                      max_retry=0))
        assert not ch.call_method("svc", "echo", b"x").ok()

    def test_untrusted_cert_rejected(self, pkg, tls_server):
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_REQUIRED  # but no CA loaded
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{tls_server.port}",
                       options=pkg.rpc.ChannelOptions(ssl_context=ctx, timeout_ms=2000,
                                                      max_retry=0))
        assert not ch.call_method("svc", "echo", b"x").ok()

    def test_tls_and_plain_partition_in_socket_map(self, pkg, tls_server):
        ch = _tls_channel(pkg, tls_server.port)
        assert ch.call_method("svc", "echo", b"a").ok()
        keys = [k for k in pkg.channel._client_socket_map._map
                if k.startswith(f"127.0.0.1:{tls_server.port}|")]
        assert any("|ssl-" in k for k in keys), keys


class TestTlsStream:
    def test_stream_over_tls(self, pkg):
        rpc = pkg.rpc
        total = 4 << 20
        got = [0]
        done = threading.Event()

        class Sink(rpc.StreamHandler):
            def on_received_messages(self, s, msgs):
                got[0] += sum(len(m) for m in msgs)
                if got[0] >= total:
                    done.set()

        def open_stream(cntl, req):
            rpc.stream_accept(cntl, rpc.StreamOptions(handler=Sink()))
            return b""

        srv = _server(pkg, {"str": {"open": open_stream}}, ssl_context=server_ctx())
        ch = _tls_channel(pkg, srv.port, timeout_ms=20000)
        s = rpc.stream_create(rpc.StreamOptions())
        c = ch.call_method("str", "open", b"", request_stream=s)
        assert c.ok(), c.error_text
        assert s.wait_connected(5)
        chunk = b"s" * (256 * 1024)
        sent = 0
        while sent < total:
            assert s.write(chunk, timeout=30) == 0
            sent += len(chunk)
        assert done.wait(30), f"got {got[0]} of {total}"
        s.close()


class TestTlsCombo:
    def test_partition_channel_over_tls(self, pkg):
        eps = []
        for part in range(2):
            srv = _server(pkg, {"svc": {"echo": (lambda p: lambda cntl, req: req + b"|p%d" % p)(part)}},
                          ssl_context=server_ctx())
            eps.append(f"127.0.0.1:{srv.port} %d/2" % part)
        pch = pkg.rpc.PartitionChannel()
        assert pch.init("list://" + ",".join(eps), partition_count=2, lb_name="rr",
                        options=pkg.rpc.ChannelOptions(ssl_context=client_ctx(), timeout_ms=10000))
        try:
            c = pch.call_method("svc", "echo", b"x")
            assert c.ok(), c.error_text
        finally:
            if pkg.name == "torch":
                pch.stop()  # the port's stop detaches its LBs (ROADMAP A8)


class TestTlsReconnect:
    def test_reconnect_rehandshakes(self, pkg):
        srv = _server(pkg, {"svc": {"echo": lambda cntl, req: req}}, ssl_context=server_ctx())
        port = srv.port
        ch = _tls_channel(pkg, port, timeout_ms=5000)
        assert ch.call_method("svc", "echo", b"one").ok()
        srv.stop()
        # restarted on the same port: the dropped TLS socket re-dials AND
        # handshakes a fresh session
        _server(pkg, {"svc": {"echo": lambda cntl, req: req}}, port=port,
                ssl_context=server_ctx())
        end = time.monotonic() + 10
        ok = False
        while time.monotonic() < end:
            c = ch.call_method("svc", "echo", b"two")
            if c.ok():
                ok = True
                break
            time.sleep(0.2)
        assert ok, f"reconnect never succeeded: {c.error_text}"
        assert c.response_payload == b"two"


# -- the device echo over TLS (ROADMAP A10) ---------------------------------

WINDOW = 4  # chip_smoke.py phase 3k runs 256 B requests at window 16


def _echo_endpoint(pkg):
    if pkg.name == "jax":
        ep = JaxEndpoint(window_size=WINDOW, max_batch=WINDOW)
    else:
        ep = DeviceEndpoint(window_size=WINDOW, max_batch=WINDOW, device="cpu")
    _OPEN.append(ep)
    return ep


def _requests():
    rng = np.random.default_rng(26)
    return [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in (256, 100, 4, 256)]


@pytest.mark.parametrize("protocol", ["tbus_std", "baidu_std", "http"])
def test_device_echo_over_tls_is_the_plain_routes_bytes(pkg, protocol):
    ep = _echo_endpoint(pkg)
    handler = ep.server_handler()
    plain = _server(pkg, {"tensor": {"echo": handler}})
    tls = _server(pkg, {"tensor": {"echo": handler}}, ssl_context=server_ctx())
    answers = {}
    for name, srv, opts in (("plain", plain, {}), ("tls", tls, {"ssl_context": client_ctx()})):
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{srv.port}",
                       options=pkg.rpc.ChannelOptions(protocol=protocol, timeout_ms=30000, **opts))
        got = []
        for req in _requests():
            c = ch.call_method("tensor", "echo", req)
            assert c.ok(), (name, c.error_text)
            got.append(c.response_payload)
        answers[name] = got
    assert answers["tls"] == answers["plain"]
    assert all(len(r) > 0 for r in answers["tls"])


def test_tls_device_link_echo_is_the_plain_links_bytes(pkg):
    """transport='tpu' with ssl_context: the link's handshake rides a TLS
    bootstrap channel, and its frames echo the plain link's bytes."""
    plain = _server(pkg, {"svc": {"echo": lambda cntl, req: req[::-1]}})
    tls = _server(pkg, {"svc": {"echo": lambda cntl, req: req[::-1]}}, ssl_context=server_ctx())
    answers, links = {}, {}
    try:
        for name, srv, opts in (("plain", plain, {}), ("tls", tls, {"ssl_context": client_ctx()})):
            ch = pkg.rpc.Channel()
            assert ch.init(f"127.0.0.1:{srv.port}",
                           options=pkg.rpc.ChannelOptions(transport="tpu", timeout_ms=30000,
                                                          link_slot_words=1024, link_window=4,
                                                          **opts))
            got = []
            for req in _requests():
                c = ch.call_method("svc", "echo", req)
                assert c.ok(), (name, c.error_text)
                got.append(c.response_payload)
            answers[name] = got
            links[name] = ch._device_sock  # the calls took the link
            assert links[name] is not None and links[name].link is not None
        assert answers["tls"] == answers["plain"] == [r[::-1] for r in _requests()]
        assert links["tls"] is not links["plain"]  # the TLS link is its own
    finally:
        for ds in links.values():
            ds.recycle()


# -- chip_smoke.py's phase 3k on the CPU ------------------------------------------------


def test_chip_smoke_phase_3k_on_the_cpu():
    """Phase 3k's routes at a small scale on the CPU: TLS on tbus_std,
    baidu_std and HTTP, the unix path on a native-plane server that falls
    back, the TLS-bootstrapped link, every answer held bitwise inside the
    phase (no card, so no launch is counted)."""
    import torch

    import chip_smoke
    from incubator_brpc_tpu_torch.ops import kernels

    out, k1 = chip_smoke.tls_phase(torch, kernels, device="cpu", scale=0.1)
    assert set(k1) == set(chip_smoke.TLS_ROUTES) | {"short_tcp", "short_tls"}
    assert all(row == {"frame_rows": 0, "verify_rows": 0, "echo_step_rows": 0} for row in k1.values())
    assert all(len(v) == chip_smoke.TLS_TURNS and min(v) > 0 for v in out["seq_us"].values())
    assert set(out["first_ms"]) == set(chip_smoke.TLS_ROUTES)
    assert len(out["handshake_us"]) == chip_smoke.TLS_TURNS
