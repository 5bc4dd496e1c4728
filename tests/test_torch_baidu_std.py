"""baidu_std (``protocol/baidu_std.py``) of the port on the CPU, held
against the JAX package's:

- ``tests/test_baidu_std.py``'s 11 cases (the hand-assembled wire fixtures,
  the cut, and the end-to-end echo, error, shared port and concurrency
  over a ``ChannelOptions(protocol="baidu_std")`` channel) on both
  packages;
- the packers byte for byte: one seeded set of request and response metas
  (services, methods, log and trace ids, deadlines, the sampled bit, error
  codes and texts, every codec of the wire's CompressType, credentials),
  bodies and attachments packs to identical frames in both packages, and
  each package's cut decodes the other's frames to the same fields;
- interop over TCP both ways: a port Channel against a JAX-package Server
  and a JAX-package Channel against a port Server, with attachments,
  errors, snappy and gzip bodies and a token credential;
- the protocol order of the shared port: both registries list tbus_std,
  http and baidu_std first and in that order, and one mixed script of
  connections (each opening with one of the three wires) is claimed by the
  same protocol on both servers.

The port's servers run on ``ServerOptions(device="cpu")``. After each test
the port's host plane is shut down and no ``tbtorch-*`` thread is left.
Tolerance: none; every comparison is of bytes, integers or strings."""

import socket
import struct
import threading
import types

import numpy as np
import pytest

import incubator_brpc_tpu.protocol as jax_proto
import incubator_brpc_tpu.rpc as jax_rpc
from incubator_brpc_tpu.protocol import baidu_std as jax_baidu
from incubator_brpc_tpu.protocol import compress as jax_compress
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu.utils import flags as jax_flags
import incubator_brpc_tpu_torch.protocol as port_proto
import incubator_brpc_tpu_torch.rpc as port_rpc
from incubator_brpc_tpu_torch.protocol import baidu_std as port_baidu
from incubator_brpc_tpu_torch.protocol import compress as port_compress
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.utils import flags as port_flags
from incubator_brpc_tpu_torch.utils.status import ErrorCode

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", rpc=jax_rpc, proto=jax_proto, baidu=jax_baidu, tbus=jax_tbus,
        compress=jax_compress, flags=jax_flags, server_kw={},
    ),
    "torch": types.SimpleNamespace(
        name="torch", rpc=port_rpc, proto=port_proto, baidu=port_baidu, tbus=port_tbus,
        compress=port_compress, flags=port_flags, server_kw={"device": "cpu"},
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


def server(pkg, services, **opts):
    """A started server of ``pkg`` (stopped at teardown)."""
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**opts, **pkg.server_kw))
    for name, handlers in services.items():
        srv.add_service(name, handlers)
    assert srv.start(0)
    _OPEN.append(srv)
    return srv


def connect(pkg, port, **opts):
    ch = pkg.rpc.Channel()
    assert ch.init(f"127.0.0.1:{port}", options=pkg.rpc.ChannelOptions(**opts))
    return ch


def read_frame(sock, header_bytes=12):
    """One PRPC frame off a raw socket."""
    buf = b""
    while True:
        if len(buf) >= header_bytes:
            total = header_bytes + struct.unpack(">I", buf[4:8])[0]
            if len(buf) >= total:
                return buf[:total]
        data = sock.recv(65536)
        assert data, "connection closed mid-frame"
        buf += data


# -- tests/test_baidu_std.py on both packages --------------------------------


class TestWireFormat:
    def test_request_frame_byte_exact(self, pkg):
        expected_meta = bytes.fromhex("0a090a044563686f12014520" "05")
        payload = b"hello"
        expected = (
            b"PRPC"
            + struct.pack(">II", len(expected_meta) + len(payload), len(expected_meta))
            + expected_meta
            + payload
        )
        got = pkg.baidu.pack_request(pkg.tbus.Meta(service="Echo", method="E"), payload,
                                     correlation_id=5)
        assert got == expected

    def test_response_frame_byte_exact(self, pkg):
        expected_meta = bytes.fromhex("120708e90712026e6f2007")
        expected = (
            b"PRPC"
            + struct.pack(">II", len(expected_meta) + 2, len(expected_meta))
            + expected_meta
            + b"ok"
        )
        got = pkg.baidu.pack_response(pkg.tbus.Meta(error_text="no"), b"ok", correlation_id=7,
                                      error_code=1001)
        assert got == expected

    def test_attachment_sets_meta_field(self, pkg):
        wire = pkg.baidu.pack_request(pkg.tbus.Meta(service="S", method="m"), b"pp",
                                      correlation_id=1, attachment=b"attach")
        frame, consumed = pkg.baidu.try_parse_frame(wire)
        assert consumed == len(wire)
        assert frame.payload == b"pp"
        assert frame.attachment == b"attach"
        assert frame.meta.attachment_size == 6

    def test_roundtrip_all_fields(self, pkg):
        meta = pkg.tbus.Meta(service="svc", method="mth", log_id=9, trace_id=11, span_id=13,
                             compress="gzip")
        meta.extra["auth"] = "cred"
        wire = pkg.baidu.pack_request(meta, b"xyz", correlation_id=(3 << 32) | 4)
        frame, _ = pkg.baidu.try_parse_frame(wire)
        m = frame.meta
        assert (m.service, m.method) == ("svc", "mth")
        assert (m.log_id, m.trace_id, m.span_id) == (9, 11, 13)
        assert m.compress == "gzip"
        assert m.extra["auth"] == "cred"
        assert frame.correlation_id == (3 << 32) | 4
        assert not frame.is_response

    def test_parse_header_sizes_the_cut(self, pkg):
        wire = pkg.baidu.pack_request(pkg.tbus.Meta(service="S", method="m"), b"12345", 1)
        assert pkg.baidu.parse_header(wire[:12]) == len(wire)
        assert pkg.baidu.parse_header(wire[:8]) is None
        with pytest.raises(pkg.tbus.ParseError):
            pkg.baidu.parse_header(b"TPRCxxxxxxxx")

    def test_resumable_and_meta_size_guard(self, pkg):
        wire = pkg.baidu.pack_request(pkg.tbus.Meta(service="S", method="m"), b"body", 2)
        for cut in (0, 3, 11, len(wire) - 1):
            assert pkg.baidu.try_parse_frame(wire[:cut]) == (None, 0)
        bad = bytearray(wire)
        struct.pack_into(">I", bad, 8, 1 << 20)
        with pytest.raises(pkg.tbus.ParseError):
            pkg.baidu.try_parse_frame(bytes(bad))

    def test_rpc_meta_decode_skips_unknown_fields(self, pkg):
        blob = pkg.baidu.RpcMeta(service_name="a", method_name="b").encode()
        tag = (99 << 3) | 0
        blob += bytes([tag & 0x7F | 0x80, tag >> 7]) + b"\x2a"
        m = pkg.baidu.RpcMeta.decode(blob)
        assert m.service_name == "a" and m.unknown.get(99) == 42


class TestEndToEnd:
    @pytest.fixture
    def srv(self, pkg):
        def echo(cntl, req):
            cntl.response_attachment = cntl.request_attachment
            return req

        def boom(cntl, req):
            cntl.set_failed(ErrorCode.EINTERNAL, "kaboom")
            return b""

        return server(pkg, {"EchoService": {"Echo": echo, "Boom": boom}})

    def test_echo_over_baidu_std(self, pkg, srv):
        ch = connect(pkg, srv.port, protocol="baidu_std")
        cntl = ch.call_method("EchoService", "Echo", b"ping", attachment=b"att")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"ping"
        assert cntl.response_attachment == b"att"

    def test_error_propagates_with_text(self, pkg, srv):
        cntl = connect(pkg, srv.port, protocol="baidu_std").call_method("EchoService", "Boom", b"")
        assert cntl.failed()
        assert cntl.error_code == ErrorCode.EINTERNAL
        assert "kaboom" in cntl.error_text

    def test_same_port_serves_both_protocols(self, pkg, srv):
        b = connect(pkg, srv.port, protocol="baidu_std")
        t = connect(pkg, srv.port)
        for i in range(5):
            cb = b.call_method("EchoService", "Echo", f"b{i}".encode())
            ct = t.call_method("EchoService", "Echo", f"t{i}".encode())
            assert cb.ok() and cb.response_payload == f"b{i}".encode()
            assert ct.ok() and ct.response_payload == f"t{i}".encode()

    def test_concurrent_baidu_calls(self, pkg, srv):
        ch = connect(pkg, srv.port, protocol="baidu_std")
        errs = []

        def worker(i):
            for j in range(20):
                c = ch.call_method("EchoService", "Echo", f"{i}-{j}".encode())
                if c.failed() or c.response_payload != f"{i}-{j}".encode():
                    errs.append((i, j, c.error_code))

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for th in ts:
            th.start()
        for th in ts:
            th.join()
        assert not errs, errs[:3]


# -- the packers byte for byte -------------------------------------------------

CODECS = ("", "snappy", "gzip", "zlib1")


def seeded_cases(seed=7, n=40):
    """(meta kwargs, body, attachment, correlation id, error code, auth)."""
    rng = np.random.default_rng(seed)
    names = ["Echo", "EchoService", "tensor", "svc.sub", "ünï", ""]
    cases = []
    for i in range(n):
        kw = dict(
            service=names[int(rng.integers(len(names)))],
            method=names[int(rng.integers(len(names)))],
            log_id=int(rng.integers(0, 1 << 63)) if i % 3 == 0 else 0,
            trace_id=int(rng.integers(0, 1 << 63)) if i % 4 == 0 else 0,
            span_id=int(rng.integers(0, 1 << 40)) if i % 4 == 0 else 0,
            parent_span_id=int(rng.integers(0, 1 << 40)) if i % 8 == 0 else 0,
            timeout_ms=int(rng.integers(0, 1 << 20)) if i % 2 else 0,
            sampled=int(i % 5 == 0),
            compress=CODECS[i % len(CODECS)],
            error_text="bad thing %d" % i if i % 6 == 1 else "",
        )
        body = rng.integers(0, 256, size=int(rng.integers(0, 3000)), dtype=np.uint8).tobytes()
        att = rng.integers(0, 256, size=int(rng.integers(0, 300)), dtype=np.uint8).tobytes() \
            if i % 3 else b""
        cid = int(rng.integers(0, 1 << 64, dtype=np.uint64))
        code = [0, 1001, 1004, 2001, -3][i % 5]
        auth = f"cred-{i}" if i % 7 == 2 else ""
        cases.append((kw, body, att, cid, code, auth))
    return cases


def _meta(pkg, kw, auth):
    m = pkg.tbus.Meta(**kw)
    if auth:
        m.extra["auth"] = auth
    return m


def _fields(frame):
    m = frame.meta
    return (m.service, m.method, m.log_id, m.trace_id, m.span_id, m.parent_span_id,
            m.timeout_ms, m.sampled, m.compress, m.attachment_size, m.error_text,
            dict(m.extra), frame.payload, frame.attachment, frame.correlation_id,
            frame.is_response, frame.error_code, frame.wire_protocol)


def test_request_frames_byte_identical():
    for kw, body, att, cid, _code, auth in seeded_cases():
        wires = [p.baidu.pack_request(_meta(p, kw, auth), p.compress.compress(kw["compress"], body)
                                      if kw["compress"] else body, cid, attachment=att)
                 for p in PKGS.values()]
        assert wires[0] == wires[1]
        decoded = [_fields(p.baidu.try_parse_frame(wires[0])[0]) for p in PKGS.values()]
        assert decoded[0] == decoded[1]


def test_response_frames_byte_identical():
    for kw, body, att, cid, code, _auth in seeded_cases(seed=8):
        meta_kw = {"error_text": kw["error_text"], "compress": kw["compress"]}
        wires = [p.baidu.pack_response(p.tbus.Meta(**meta_kw), body, cid, error_code=code,
                                       attachment=att) for p in PKGS.values()]
        assert wires[0] == wires[1]
        wires.append(PKGS["jax"].baidu.pack_response(None, body, cid, error_code=code))
        assert wires[2] == PKGS["torch"].baidu.pack_response(None, body, cid, error_code=code)
        decoded = [_fields(p.baidu.try_parse_frame(wires[0])[0]) for p in PKGS.values()]
        assert decoded[0] == decoded[1]


def test_rpc_meta_codec_byte_identical():
    """RpcMeta.encode and decode of every field on both packages, the
    out-of-enum codec value and a negative error code included."""
    rng = np.random.default_rng(9)
    for i in range(60):
        kw = dict(
            service_name="s%d" % i, method_name="m" * (i % 4), log_id=int(rng.integers(0, 1 << 62)),
            trace_id=int(rng.integers(0, 1 << 62)), span_id=i, parent_span_id=i * 3,
            timeout_ms=i * 7, sampled=i % 2, is_response=bool(i % 3 == 0),
            error_code=[0, 1001, -1, 2004][i % 4], error_text="t" * (i % 5),
            compress_type=[0, 1, 2, 3, 9][i % 5], correlation_id=int(rng.integers(0, 1 << 62)),
            attachment_size=i * 11, authentication_data=b"tok%d" % i if i % 3 == 1 else b"",
        )
        blobs = [p.baidu.RpcMeta(**kw).encode() for p in PKGS.values()]
        assert blobs[0] == blobs[1]
        dec = [p.baidu.RpcMeta.decode(blobs[0]) for p in PKGS.values()]
        assert vars(dec[0]) == vars(dec[1])
        metas = [p.baidu.rpc_meta_to_meta(d) for p, d in zip(PKGS.values(), dec)]
        assert metas[0].to_bytes() == metas[1].to_bytes()


# -- interop over TCP, both ways -----------------------------------------------


def _interop(server_pkg, client_pkg):
    def echo(cntl, req):
        cntl.response_attachment = cntl.request_attachment
        return req[::-1]

    def boom(cntl, req):
        cntl.set_failed(ErrorCode.EREQUEST, "refused: " + req.decode())
        return b""

    token = "interop-token"
    srv = server(server_pkg, {"Echo": {"echo": echo, "boom": boom}},
                 auth=server_pkg.rpc.TokenAuthenticator([token]))
    ch = connect(client_pkg, srv.port, protocol="baidu_std",
                 auth=client_pkg.rpc.TokenAuthenticator([token]))
    payload = bytes(range(256)) * 20
    for i, codec in enumerate(("", "snappy", "gzip", "zlib1", "")):
        cntl = client_pkg.rpc.Controller()
        cntl.compress_type = codec
        c = ch.call_method("Echo", "echo", payload[i:], cntl=cntl, attachment=b"att%d" % i)
        assert c.ok(), (c.error_code, c.error_text)
        assert c.response_payload == payload[i:][::-1]
        assert c.response_attachment == b"att%d" % i
    c = ch.call_method("Echo", "boom", b"why")
    assert (c.error_code, c.error_text) == (ErrorCode.EREQUEST, "refused: why")
    c = ch.call_method("Echo", "nothere", b"x")
    assert c.error_code == ErrorCode.ENOMETHOD
    bad = connect(client_pkg, srv.port, protocol="baidu_std",
                  auth=client_pkg.rpc.TokenAuthenticator(["wrong"]), max_retry=0)
    assert bad.call_method("Echo", "echo", b"x").error_code == ErrorCode.ERPCAUTH


def test_interop_port_channel_against_jax_server():
    _interop(PKGS["jax"], PKGS["torch"])


def test_interop_jax_channel_against_port_server():
    _interop(PKGS["torch"], PKGS["jax"])


# -- the protocol order of the shared port --------------------------------------


def test_registry_order_matches():
    names = [[p.name for p in pkg.proto.protocol_registry.ordered()] for pkg in PKGS.values()]
    assert names[1] == ["tbus_std", "http", "baidu_std"]
    assert names[0][:3] == names[1]


def _opening(kind):
    """The first bytes a client of ``kind`` sends on a fresh connection."""
    if kind == "tbus_std":
        return port_tbus.pack_frame(port_tbus.Meta(service="Echo", method="echo"), b"tb", 1)
    if kind == "baidu_std":
        return port_baidu.pack_request(port_tbus.Meta(service="Echo", method="echo"), b"bd", 2)
    if kind == "http":
        return b"POST /Echo/echo HTTP/1.1\r\nHost: x\r\nContent-Length: 2\r\n\r\nht"
    return kind  # raw garbage


def test_mixed_connection_script_claims_the_same_protocol():
    """Each connection of one script opens with a different wire; both
    packages' servers claim it with the same protocol (read back from the
    first bytes of their answer) or both close it."""
    script = ["tbus_std", "http", "baidu_std", "baidu_std", "http", "tbus_std",
              b"GARBAGE!\r\n\r\n", b"PRPX" + b"\0" * 12, b"GET"]
    answers = {}
    for name, pkg in PKGS.items():
        srv = server(pkg, {"Echo": {"echo": lambda c, r: r}})
        got = []
        for kind in script:
            s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
            try:
                s.sendall(_opening(kind))
                if kind == b"GET":
                    s.shutdown(socket.SHUT_WR)
                data = b""
                while len(data) < 4:
                    try:
                        more = s.recv(65536)
                    except (ConnectionResetError, socket.timeout):
                        more = b""
                    if not more:
                        break
                    data += more
                got.append(data[:4])
            finally:
                s.close()
        answers[name] = got
    assert answers["jax"] == answers["torch"]
    assert answers["torch"][:3] == [b"CRPT", b"HTTP", b"PRPC"]  # tbus_std magic, little-endian
