"""The legacy pbrpc family (``protocol/legacy_pbrpc.py``) of the port on the
CPU, held against the JAX package's:

- ``tests/test_legacy_pbrpc.py``'s 30 cases on both packages (the wire
  fixtures of hulu, sofa and esp, loopback round trips on the shared port,
  errors, the nova, public_pbrpc and ubrpc adaptors, the FIFO sockets
  partitioned by protocol, nova's snappy, the four-protocol stress and
  pooled connections);
- every frame of the family byte for byte: one seeded set of metas,
  payloads, attachments, correlation ids and error codes packs to the same
  hulu, sofa, nshead, nova, public_pbrpc, ubrpc_mcpack2, nshead_mcpack and
  esp bytes in both packages (public_pbrpc's create_time stamp held to one
  clock), each package's cut reading the other's frames alike, and the
  server adaptors answering one request with the same body;
- interop over TCP both ways: a port Channel against a JAX-package Server
  and a JAX-package Channel against a port Server, over hulu_pbrpc,
  sofa_pbrpc and nova_pbrpc (pooled);
- the native plane: a hulu, sofa and nshead connection to a
  ``native_plane=True`` server is handed to the Python plane and answered
  there, the C++ dispatch counting none of them;
- ``chip_smoke.py``'s phase 3l at a small scale on the CPU.

The port's servers run on ``ServerOptions(device="cpu")``. After each test
the port's host plane is shut down and no ``tbtorch-*`` thread is left.
Tolerance: none; every comparison is of bytes, integers or strings."""

from __future__ import annotations

import socket as pysock
import struct
import threading
import time
import types

import numpy as np
import pytest

import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu_torch.rpc as port_rpc
from incubator_brpc_tpu.protocol import compress as jax_compress
from incubator_brpc_tpu.protocol import legacy_pbrpc as jax_lp
from incubator_brpc_tpu.protocol import mcpack as jax_mcpack
from incubator_brpc_tpu.protocol import nshead as jax_nshead
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu.rpc import channel as jax_channel
from incubator_brpc_tpu_torch.protocol import compress as port_compress
from incubator_brpc_tpu_torch.protocol import legacy_pbrpc as port_lp
from incubator_brpc_tpu_torch.protocol import mcpack as port_mcpack
from incubator_brpc_tpu_torch.protocol import nshead as port_nshead
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.rpc import channel as port_channel
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", rpc=jax_rpc, lp=jax_lp, mcpack=jax_mcpack, nshead=jax_nshead,
        tbus=jax_tbus, Meta=jax_tbus.Meta, ParseError=jax_tbus.ParseError,
        compress=jax_compress, channel=jax_channel, server_kw={},
    ),
    "torch": types.SimpleNamespace(
        name="torch", rpc=port_rpc, lp=port_lp, mcpack=port_mcpack, nshead=port_nshead,
        tbus=port_tbus, Meta=port_tbus.Meta, ParseError=port_tbus.ParseError,
        compress=port_compress, channel=port_channel, server_kw={"device": "cpu"},
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


@pytest.fixture
def echo_server(pkg):
    def echo(cntl, req):
        return req

    def boom(cntl, req):
        cntl.set_failed(1007, "deliberate failure")
        return b""

    return server(pkg, {"svc": {"echo": echo, "boom": boom}}, usercode_inline=True)


def _call(pkg, port, protocol, service="svc", method="echo", payload=b"x", extra=None,
          timeout=5000, **opts):
    ch = pkg.rpc.Channel()
    assert ch.init(f"127.0.0.1:{port}",
                   options=pkg.rpc.ChannelOptions(protocol=protocol, timeout_ms=timeout, **opts))
    cntl = pkg.rpc.Controller(timeout_ms=timeout)
    if extra:
        cntl.request_extra = dict(extra)
    return ch.call_method(service, method, payload, cntl=cntl)


# -- tests/test_legacy_pbrpc.py on both packages -----------------------------


class TestHuluWire:
    def test_header_fixture(self, pkg):
        # "HULU" + u32le(body=meta+payload) + u32le(meta) — host (LE) order
        wire = pkg.lp._hulu_frame(b"M" * 10, b"P" * 3)
        assert wire[:4] == b"HULU"
        assert struct.unpack_from("<II", wire, 4) == (13, 10)

    def test_request_roundtrip(self, pkg):
        meta = pkg.Meta(service="svc", method="echo", log_id=77, extra={"method_index": 1})
        wire = pkg.lp.hulu_pack_request(meta, b"hello", 42, attachment=b"att")
        frame, consumed = pkg.lp.hulu_try_parse(wire)
        assert consumed == len(wire)
        assert not frame.is_response
        assert frame.meta.service == "svc"
        assert frame.meta.method == "echo"
        assert frame.meta.extra["method_index"] == 1
        assert frame.meta.log_id == 77
        assert frame.correlation_id == 42
        assert frame.payload == b"hello" and frame.attachment == b"att"

    def test_response_roundtrip_sint64_cid(self, pkg):
        # response correlation_id is sint64 (zigzag) on the wire
        wire = pkg.lp.hulu_pack_response(None, b"out", 99, error_code=0)
        frame, _ = pkg.lp.hulu_try_parse(wire)
        assert frame.is_response and frame.correlation_id == 99
        assert frame.payload == b"out" and frame.error_code == 0
        wire = pkg.lp.hulu_pack_response(pkg.Meta(error_text="nope"), b"", 7, error_code=1007)
        frame, _ = pkg.lp.hulu_try_parse(wire)
        assert frame.error_code == 1007
        assert frame.meta.error_text == "nope"

    def test_meta_size_overflow_rejected(self, pkg):
        bad = b"HULU" + struct.pack("<II", 4, 9) + b"xxxx"
        with pytest.raises(pkg.ParseError):
            pkg.lp.hulu_try_parse(bad)


class TestSofaWire:
    def test_header_fixture(self, pkg):
        # "SOFA" + u32le(meta) + u64le(body) + u64le(meta+body)
        wire = pkg.lp._sofa_frame(b"M" * 6, b"P" * 4)
        assert wire[:4] == b"SOFA"
        assert struct.unpack_from("<IQQ", wire, 4) == (6, 4, 10)

    def test_request_roundtrip(self, pkg):
        meta = pkg.Meta(service="pkg.EchoService", method="echo")
        wire = pkg.lp.sofa_pack_request(meta, b"ping", 5)
        frame, consumed = pkg.lp.sofa_try_parse(wire)
        assert consumed == len(wire)
        assert not frame.is_response
        assert frame.meta.service == "pkg.EchoService"
        assert frame.meta.method == "echo"
        assert frame.correlation_id == 5

    def test_response_failed(self, pkg):
        wire = pkg.lp.sofa_pack_response(pkg.Meta(error_text="broken"), b"", 8, error_code=2004)
        frame, _ = pkg.lp.sofa_try_parse(wire)
        assert frame.is_response and frame.correlation_id == 8
        assert frame.error_code == 2004
        assert frame.meta.error_text == "broken"

    def test_inconsistent_sizes_rejected(self, pkg):
        bad = b"SOFA" + struct.pack("<IQQ", 2, 2, 99) + b"abcd"
        with pytest.raises(pkg.ParseError):
            pkg.lp.sofa_try_parse(bad)


class TestHuluSofaLoopback:
    def test_hulu_end_to_end(self, pkg, echo_server):
        cntl = _call(pkg, echo_server.port, "hulu_pbrpc", payload=b"via-hulu")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"via-hulu"

    def test_hulu_by_method_index(self, pkg, echo_server):
        # no method name on the wire: index 1 = second registered = boom
        cntl = _call(pkg, echo_server.port, "hulu_pbrpc", method="", extra={"method_index": 1})
        assert not cntl.ok() and cntl.error_code == 1007

    def test_hulu_error_propagates(self, pkg, echo_server):
        cntl = _call(pkg, echo_server.port, "hulu_pbrpc", method="boom")
        assert not cntl.ok()
        assert cntl.error_code == 1007
        assert "deliberate" in cntl.error_text

    def test_sofa_end_to_end(self, pkg, echo_server):
        cntl = _call(pkg, echo_server.port, "sofa_pbrpc", payload=b"via-sofa")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"via-sofa"

    def test_sofa_error_propagates(self, pkg, echo_server):
        cntl = _call(pkg, echo_server.port, "sofa_pbrpc", method="boom")
        assert not cntl.ok() and cntl.error_code == 1007

    def test_three_protocols_share_the_port(self, pkg, echo_server):
        # tbus_std, hulu and sofa multiplex on one listener
        for proto in ("tbus_std", "hulu_pbrpc", "sofa_pbrpc"):
            cntl = _call(pkg, echo_server.port, proto, payload=proto.encode())
            assert cntl.ok(), f"{proto}: {cntl.error_text}"
            assert cntl.response_payload == proto.encode()


class TestNovaLoopback:
    @pytest.fixture
    def nova_server(self, pkg):
        return server(pkg, {"svc": {"echo": lambda cntl, req: req,
                                    "rev": lambda cntl, req: req[::-1]}},
                      usercode_inline=True, nshead_service=pkg.lp.NovaServiceAdaptor)

    def test_nova_by_index(self, pkg, nova_server):
        cntl = _call(pkg, nova_server.port, "nova_pbrpc", payload=b"abc",
                     extra={"method_index": 1})
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"cba"

    def test_nova_default_index(self, pkg, nova_server):
        cntl = _call(pkg, nova_server.port, "nova_pbrpc", payload=b"abc")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"abc"


class TestPublicPbrpcLoopback:
    @pytest.fixture
    def pub_server(self, pkg):
        def boom(cntl, req):
            cntl.set_failed(1008, "public failure")
            return b""

        return server(pkg, {"svc": {"echo": lambda cntl, req: req, "boom": boom}},
                      usercode_inline=True, nshead_service=pkg.lp.PublicPbrpcServiceAdaptor)

    def test_public_end_to_end(self, pkg, pub_server):
        cntl = _call(pkg, pub_server.port, "public_pbrpc", payload=b"wrapped")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"wrapped"

    def test_public_error_propagates(self, pkg, pub_server):
        cntl = _call(pkg, pub_server.port, "public_pbrpc", method="boom",
                     extra={"method_index": 1})
        assert not cntl.ok() and cntl.error_code == 1008
        assert "public failure" in cntl.error_text


class TestUbrpcLoopback:
    @pytest.fixture
    def ub_server(self, pkg):
        def add(cntl, req):
            params = pkg.mcpack.loads(req)
            return pkg.mcpack.dumps({"sum": params["a"] + params["b"]})

        return server(pkg, {"calc": {"add": add}}, usercode_inline=True,
                      nshead_service=pkg.lp.UbrpcServiceAdaptor)

    def test_ubrpc_end_to_end(self, pkg, ub_server):
        payload = pkg.mcpack.dumps({"a": 3, "b": 4})
        cntl = _call(pkg, ub_server.port, "ubrpc_mcpack2", service="calc", method="add",
                     payload=payload)
        assert cntl.ok(), cntl.error_text
        assert pkg.mcpack.loads(cntl.response_payload) == {"sum": 7}

    def test_ubrpc_unknown_method(self, pkg, ub_server):
        payload = pkg.mcpack.dumps({"a": 1, "b": 2})
        cntl = _call(pkg, ub_server.port, "ubrpc_mcpack2", service="calc", method="mul",
                     payload=payload)
        assert not cntl.ok()


def esp_echo_listener():
    """A raw socket that echoes the esp frame it reads back whole (the
    reference has no esp server; its unittest drives the client the same
    way). Returns (port, listening socket)."""
    lsock = pysock.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]

    def serve():
        conn, _ = lsock.accept()
        data = b""
        while len(data) < port_lp.ESP_HEADER:
            data += conn.recv(4096)
        body_len = struct.unpack_from("<i", data, port_lp.ESP_HEADER - 4)[0]
        while len(data) < port_lp.ESP_HEADER + body_len:
            data += conn.recv(4096)
        conn.sendall(data)  # echo the whole esp frame back
        conn.close()

    threading.Thread(target=serve, daemon=True).start()
    return port, lsock


class TestEsp:
    def test_head_fixture(self, pkg):
        wire = pkg.lp.esp_pack_request(
            pkg.Meta(extra={"to_stub": 2, "to_port": 8000, "to_ip": 0x7F000001, "esp_msg": 9}),
            b"BODY", 1234)
        assert len(wire) == pkg.lp.ESP_HEADER + 4
        vals = pkg.lp._ESP_HEAD.unpack_from(wire)
        assert vals[3:6] == (2, 8000, 0x7F000001)  # to
        assert vals[6] == 9 and vals[7] == 1234 and vals[8] == 4

    def test_parse_roundtrip(self, pkg):
        wire = pkg.lp.esp_pack_request(pkg.Meta(extra={"esp_msg": 5}), b"pp", 7)
        frame, consumed = pkg.lp.esp_try_parse(wire)
        assert consumed == len(wire)
        assert frame.head["msg"] == 5 and frame.head["msg_id"] == 7
        assert frame.payload == b"pp"

    def test_esp_against_mock_server(self, pkg, echo_server):
        port, lsock = esp_echo_listener()
        try:
            cntl = _call(pkg, port, "esp", payload=b"esp-body", extra={"esp_msg": 3})
            assert cntl.ok(), cntl.error_text
            assert cntl.response_payload == b"esp-body"
            assert cntl.response_meta.extra["esp_head"]["msg"] == 3
        finally:
            lsock.close()


class TestHuluEdgeCases:
    def test_empty_payload_with_attachment(self, pkg):
        # user_message_size=0 must be representable (present-with-zero):
        # an empty message whose body is ALL attachment
        wire = pkg.lp.hulu_pack_request(pkg.Meta(service="svc", method="echo"), b"", 3,
                                        attachment=b"ATT")
        frame, _ = pkg.lp.hulu_try_parse(wire)
        assert frame.payload == b"" and frame.attachment == b"ATT"
        wire = pkg.lp.hulu_pack_response(None, b"", 3, attachment=b"RSP")
        frame, _ = pkg.lp.hulu_try_parse(wire)
        assert frame.is_response
        assert frame.payload == b"" and frame.attachment == b"RSP"

    def test_service_required(self, pkg):
        with pytest.raises(ValueError):
            pkg.lp.hulu_pack_request(pkg.Meta(service="", method="m"), b"x", 1)

    def test_method_name_only_still_a_request(self, pkg):
        # classification keys on service_name OR method_name presence
        mb = pkg.lp._hulu_request_meta(pkg.Meta(service="", method="echo"), 5, 0, None)
        frame, _ = pkg.lp.hulu_try_parse(pkg.lp._hulu_frame(mb, b"p"))
        assert not frame.is_response and frame.meta.method == "echo"


class TestFifoSocketPartition:
    def test_mixed_fifo_channels_get_separate_sockets(self, pkg, echo_server):
        # two fifo protocols to ONE endpoint must not share a socket: the
        # response framing would be undecodable (esp has no magic)
        port = echo_server.port
        for proto in ("nova_pbrpc", "esp"):
            ch = pkg.rpc.Channel()
            assert ch.init(f"127.0.0.1:{port}",
                           options=pkg.rpc.ChannelOptions(protocol=proto, timeout_ms=500))
            # calls fail (the tbus server speaks neither) — the sockets
            # are what we are probing
            _ = ch.call_method("svc", "echo", b"x")
        keys = [k for k in pkg.channel._client_socket_map._map
                if k.endswith("fifo-nova_pbrpc") or k.endswith("fifo-esp")]
        assert len({k.rsplit("|", 1)[1] for k in keys}) == 2, keys


class TestNovaSnappy:
    def test_compressed_request_decompressed_by_adaptor(self, pkg):
        if not pkg.compress.has_codec("snappy"):
            pytest.skip("snappy codec not present in this environment")
        srv = server(pkg, {"svc": {"echo": lambda cntl, req: req}}, usercode_inline=True,
                     nshead_service=pkg.lp.NovaServiceAdaptor)
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{srv.port}",
                       options=pkg.rpc.ChannelOptions(protocol="nova_pbrpc", timeout_ms=5000))
        cntl = pkg.rpc.Controller(timeout_ms=5000)
        cntl.compress_type = "snappy"
        out = ch.call_method("svc", "echo", b"N" * 2048, cntl=cntl)
        assert out.ok(), out.error_text
        # adaptor decompressed: the echo returns the ORIGINAL bytes
        assert out.response_payload == b"N" * 2048


class TestMultiProtocolStress:
    def test_four_protocols_hammer_one_port(self, pkg, echo_server):
        """The per-connection protocol scan under concurrency: tbus_std,
        baidu_std, hulu and sofa clients all hit ONE listener at once;
        every reply must come back on the right connection with the right
        payload (the reference's shared-port contract, global.cpp scan)."""
        port = echo_server.port
        errs = []

        def hammer(proto, tid):
            try:
                ch = pkg.rpc.Channel()
                assert ch.init(f"127.0.0.1:{port}",
                               options=pkg.rpc.ChannelOptions(protocol=proto, timeout_ms=15000))
                for i in range(25):
                    want = f"{proto}:{tid}:{i}".encode()
                    c = ch.call_method("svc", "echo", want)
                    if not c.ok() or c.response_payload != want:
                        errs.append((proto, tid, i, c.error_text))
                        return
            except Exception as e:  # noqa: BLE001 — recorded for the assert
                errs.append((proto, tid, repr(e)))

        protos = ["tbus_std", "baidu_std", "hulu_pbrpc", "sofa_pbrpc"]
        threads = [threading.Thread(target=hammer, args=(p, t)) for p in protos for t in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs[:5]


class TestLegacyPooledConnections:
    def test_nova_over_pooled_connections(self, pkg):
        """CONNECTION_TYPE_POOLED_AND_SHORT is the reference contract for
        the nshead family: exclusive connection per in-flight call."""
        srv = server(pkg, {"svc": {"echo": lambda cntl, req: req}}, usercode_inline=True,
                     nshead_service=pkg.lp.NovaServiceAdaptor)
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{srv.port}",
                       options=pkg.rpc.ChannelOptions(protocol="nova_pbrpc",
                                                      connection_type="pooled", timeout_ms=15000))
        errs = []

        def worker(tid):
            for i in range(10):
                want = b"%d:%d" % (tid, i)
                c = ch.call_method("svc", "echo", want)
                if not c.ok() or c.response_payload != want:
                    errs.append((tid, i, c.error_text))

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs[:5]


# -- every frame byte for byte ----------------------------------------------


def seeded_calls(n=24, seed=27):
    """(meta kwargs, payload, attachment, correlation id, error code, error
    text) drawn from one seed: services and methods, log and trace ids,
    method indices, compress names, empty and binary bodies."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        payload = rng.integers(0, 256, int(rng.choice([0, 1, 37, 300, 5000])),
                               dtype=np.uint8).tobytes()
        attachment = rng.integers(0, 256, int(rng.choice([0, 0, 9, 700])),
                                  dtype=np.uint8).tobytes()
        meta = dict(service=f"pkg{i % 3}.Svc{i}", method=f"m{int(rng.integers(0, 99))}",
                    log_id=int(rng.integers(0, 1 << 40)), trace_id=int(rng.integers(0, 1 << 62)),
                    span_id=int(rng.integers(0, 1 << 62)),
                    parent_span_id=int(rng.integers(0, 1 << 62)),
                    compress=["", "snappy", "gzip", "zlib1"][i % 4],
                    extra={"method_index": int(rng.integers(0, 7)),
                           "to_stub": int(rng.integers(0, 1 << 16)),
                           "to_port": int(rng.integers(0, 1 << 16)),
                           "to_ip": int(rng.integers(0, 1 << 32)),
                           "esp_msg": int(rng.integers(0, 1 << 32))})
        out.append((meta, payload, attachment, int(rng.integers(1, 1 << 62)),
                    int(rng.choice([0, 0, 1007, 2004])), f"text {i}" if i % 3 else ""))
    return out


def ubrpc_params(rng):
    return {"a": int(rng.integers(-99, 99)), "s": "p" * int(rng.integers(0, 300)),
            "blob": rng.integers(0, 256, 64, dtype=np.uint8).tobytes()}


def test_request_frames_identical_across_packages(monkeypatch):
    # public_pbrpc stamps create_time from the clock: one clock for both
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "20261018120000")
    rng = np.random.default_rng(28)
    for kw, payload, attachment, cid, _err, _text in seeded_calls():
        jm, pm = jax_tbus.Meta(**kw), port_tbus.Meta(**kw)
        for name in ("hulu_pack_request", "sofa_pack_request", "nova_pack_request",
                     "public_pack_request", "nshead_mcpack_pack_request", "esp_pack_request"):
            jax_wire = getattr(jax_lp, name)(jm, payload, cid, attachment=attachment)
            port_wire = getattr(port_lp, name)(pm, payload, cid, attachment=attachment)
            assert port_wire == jax_wire, name
        body = jax_mcpack.dumps(ubrpc_params(rng))
        jax_wire = jax_lp.ubrpc_pack_request(jm, body, cid)
        assert port_lp.ubrpc_pack_request(pm, body, cid) == jax_wire
        # the nshead head itself, every field
        head = dict(id=cid & 0xFFFF, version=(cid >> 16) & 0xFFFF, log_id=kw["log_id"] & 0xFFFFFFFF,
                    provider=kw["service"].encode(), reserved=kw["extra"]["method_index"])
        assert port_nshead.pack_frame(payload, **head) == jax_nshead.pack_frame(payload, **head)


def test_response_frames_identical_across_packages():
    for kw, payload, attachment, cid, err, text in seeded_calls(seed=29):
        for meta_kw in (None, {"error_text": text, "compress": kw["compress"]}):
            jm = jax_tbus.Meta(**meta_kw) if meta_kw else None
            pm = port_tbus.Meta(**meta_kw) if meta_kw else None
            for name in ("hulu_pack_response", "sofa_pack_response"):
                jax_wire = getattr(jax_lp, name)(jm, payload, cid, error_code=err,
                                                 attachment=attachment)
                port_wire = getattr(port_lp, name)(pm, payload, cid, error_code=err,
                                                   attachment=attachment)
                assert port_wire == jax_wire, name


def _fields(frame):
    meta = frame.meta
    return (frame.is_response, frame.correlation_id, frame.error_code, bytes(frame.payload),
            bytes(frame.attachment), meta.service, meta.method, meta.log_id, meta.trace_id,
            meta.compress, meta.error_text, dict(meta.extra or {}))


def test_cuts_read_each_others_frames_alike(monkeypatch):
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "20261018120000")
    for kw, payload, attachment, cid, err, text in seeded_calls(seed=30):
        jm = jax_tbus.Meta(**kw)
        for pack, cut in (("hulu_pack_request", "hulu_try_parse"),
                          ("sofa_pack_request", "sofa_try_parse")):
            wire = getattr(jax_lp, pack)(jm, payload, cid, attachment=attachment)
            jf, jn = getattr(jax_lp, cut)(wire)
            pf, pn = getattr(port_lp, cut)(wire)
            assert pn == jn == len(wire) and _fields(pf) == _fields(jf)
        for pack, cut in (("hulu_pack_response", "hulu_try_parse"),
                          ("sofa_pack_response", "sofa_try_parse")):
            wire = getattr(port_lp, pack)(port_tbus.Meta(error_text=text), payload, cid,
                                          error_code=err, attachment=attachment)
            jf, jn = getattr(jax_lp, cut)(wire)
            pf, pn = getattr(port_lp, cut)(wire)
            assert pn == jn == len(wire) and _fields(pf) == _fields(jf)
        wire = jax_lp.esp_pack_request(jm, payload, cid)
        (jf, _), (pf, _) = jax_lp.esp_try_parse(wire), port_lp.esp_try_parse(wire)
        assert (pf.head, pf.payload) == (jf.head, jf.payload)
        wire = jax_lp.public_pack_request(jm, payload, cid)
        (jf, _), (pf, _) = jax_nshead.try_parse_frame(wire), port_nshead.try_parse_frame(wire)
        assert (pf.head, pf.payload) == (jf.head, jf.payload)


def test_adaptors_answer_alike(monkeypatch):
    """One request to each server adaptor of both packages, and the
    decoders of the responses: the same bodies, codes and texts."""
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "20261018120000")
    results = {}
    for name, p in PKGS.items():
        srv = p.rpc.Server(p.rpc.ServerOptions(**p.server_kw))

        def fail(cntl, req):
            cntl.set_failed(1009, "refused")
            return b""

        srv.add_service("calc", {"echo": lambda cntl, req: req, "fail": fail,
                                 "rev": lambda cntl, req: req[::-1]})
        bodies = []
        for adaptor, pack, meta, payload in (
                (p.lp.NovaServiceAdaptor, p.lp.nova_pack_request,
                 p.Meta(extra={"method_index": 2}), b"nova-body"),
                (p.lp.PublicPbrpcServiceAdaptor, p.lp.public_pack_request,
                 p.Meta(service="calc", extra={"method_index": 1}), b"public-body"),
                (p.lp.PublicPbrpcServiceAdaptor, p.lp.public_pack_request,
                 p.Meta(service="calc", extra={"method_index": 0}), b"public-ok"),
                (p.lp.UbrpcServiceAdaptor, p.lp.ubrpc_pack_request,
                 p.Meta(service="calc", method="echo"), p.mcpack.dumps({"x": b"\x01" * 300})),
                (p.lp.UbrpcServiceAdaptor, p.lp.ubrpc_pack_request,
                 p.Meta(service="calc", method="fail"), p.mcpack.dumps({"x": 1})),
                (p.lp.UbrpcServiceAdaptor, p.lp.ubrpc_pack_request,
                 p.Meta(service="calc", method="nope"), p.mcpack.dumps({"x": 1}))):
            frame, _ = p.nshead.try_parse_frame(pack(meta, payload, 77))
            cntl = p.rpc.Controller()
            cntl._server = srv
            out = adaptor(cntl, frame.head, frame.payload)
            resp, _ = p.nshead.try_parse_frame(p.nshead.pack_frame(out))
            decode = p.lp._FIFO_DECODERS[{p.lp.NovaServiceAdaptor: "nova_pbrpc",
                                          p.lp.PublicPbrpcServiceAdaptor: "public_pbrpc",
                                          p.lp.UbrpcServiceAdaptor: "ubrpc_mcpack2"}[adaptor]]
            code, text, body, _meta = decode(resp)
            bodies.append((out, cntl.error_code, code, text, body))
        results[name] = bodies
    assert results["torch"] == results["jax"]


# -- interop over TCP both ways -----------------------------------------------

INTEROP = ["hulu_pbrpc", "sofa_pbrpc", "nova_pbrpc"]


@pytest.mark.parametrize("protocol", INTEROP)
@pytest.mark.parametrize("client,srv_pkg", [("torch", "jax"), ("jax", "torch")],
                         ids=["port-client-jax-server", "jax-client-port-server"])
def test_interop_both_ways(protocol, client, srv_pkg):
    sp, cp = PKGS[srv_pkg], PKGS[client]

    def boom(cntl, req):
        cntl.set_failed(1007, "deliberate failure")
        return b""

    opts = {"nshead_service": sp.lp.NovaServiceAdaptor} if protocol == "nova_pbrpc" else {}
    srv = server(sp, {"svc": {"echo": lambda cntl, req: req[::-1], "boom": boom}},
                 usercode_inline=True, **opts)
    ch = cp.rpc.Channel()
    ctype = "pooled" if protocol == "nova_pbrpc" else "single"
    assert ch.init(f"127.0.0.1:{srv.port}",
                   options=cp.rpc.ChannelOptions(protocol=protocol, timeout_ms=10000,
                                                 connection_type=ctype))
    rng = np.random.default_rng(31)
    for i in range(8):
        body = rng.integers(0, 256, int(rng.integers(0, 4000)), dtype=np.uint8).tobytes()
        cntl = ch.call_method("svc", "echo", body)
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == body[::-1]
    if protocol != "nova_pbrpc":
        cntl = ch.call_method("svc", "boom", b"")
        assert cntl.error_code == 1007 and "deliberate" in cntl.error_text
        cntl = cp.rpc.Controller(timeout_ms=10000)
        cntl.request_attachment = b"att"
        got = ch.call_method("svc", "echo", b"with-attachment", cntl=cntl)
        assert got.ok() and got.response_payload == b"with-attachment"[::-1]


# -- the option gate and the native plane ------------------------------------


def test_nshead_gate_fails_short_garbage_fast(pkg):
    """Without an nshead_service the server leaves nshead out of its scan:
    12 bytes no protocol knows fail the connection at once, where the scan
    with nshead in it would hold them as an nshead head's first bytes (its
    magic sits at byte 24) and wait for more."""
    plain = server(pkg, {"svc": {"echo": lambda cntl, req: req}})
    gated = server(pkg, {"svc": {"echo": lambda cntl, req: req}},
                   nshead_service=lambda cntl, head, body: body)
    garbage = b"\x07" * 12
    with pysock.create_connection(("127.0.0.1", plain.port), timeout=10) as c:
        c.sendall(garbage)
        assert c.recv(1) == b"", "short garbage was not refused"
    with pysock.create_connection(("127.0.0.1", gated.port), timeout=10) as c:
        c.sendall(garbage)
        c.settimeout(0.5)
        with pytest.raises(pysock.timeout):
            c.recv(1)  # held: it may be the start of an nshead head
        # the next 24 bytes prove it is not one: refused then
        c.settimeout(10)
        c.sendall(b"\x07" * 24)
        assert c.recv(1) == b""


def _nshead_roundtrip(nshead, port, body, **head):
    with pysock.create_connection(("127.0.0.1", port), timeout=10) as c:
        c.sendall(nshead.pack_frame(body, **head))
        buf = b""
        while True:
            chunk = c.recv(65536)
            assert chunk, "connection closed before the response"
            buf += chunk
            frame, _ = nshead.try_parse_frame(buf)
            if frame is not None:
                return frame


def test_native_plane_hands_legacy_frames_off(pkg):
    """A native-plane server: the hulu/sofa and nshead connections are handed
    to the Python plane (their first four bytes are neither tbus_std's nor
    baidu_std's magic) and answered there; the C++ dispatch counts none."""
    srv = server(pkg, {"svc": {"echo": lambda cntl, req: req[::-1]}}, native_plane=True,
                 nshead_service=lambda cntl, head, body: b"ns:" + body)
    plane = srv._native_plane
    assert plane is not None
    before = plane.stats()
    for protocol in ("hulu_pbrpc", "sofa_pbrpc"):
        cntl = _call(pkg, srv.port, protocol, payload=b"handed-off")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"ffo-dednah"
    frame = _nshead_roundtrip(pkg.nshead, srv.port, b"legacy", id=9, log_id=42)
    assert frame.payload == b"ns:legacy" and frame.head["id"] == 9
    after = plane.stats()
    assert after["native_reqs"] == before["native_reqs"]
    # two connections: hulu and sofa carry correlation ids on the wire, so
    # their channels share the socket map's one connection to the server
    assert after["handoffs"] - before["handoffs"] == 2


# -- chip_smoke.py's phase 3l on the CPU -------------------------------------


def test_chip_smoke_phase_3l_on_the_cpu():
    """Phase 3l's parts (a)-(d) at a small scale on the CPU: every echo over
    hulu, sofa, nshead, nova, public_pbrpc and ubrpc bitwise ``expected()``,
    the native plane's handoffs, each wire held to the protocol it names
    (no fallback to tbus_std), and no launch counted (no card). Its counts
    are of calls and frames, never of time."""
    import torch

    import chip_smoke
    from incubator_brpc_tpu_torch.ops import kernels

    out, k1 = chip_smoke.legacy_phase(torch, kernels, device="cpu", scale=0.1)
    assert set(k1) == set("abc")
    assert all(row == {"frame_rows": 0, "verify_rows": 0, "echo_step_rows": 0}
               for row in k1.values())
    a = out["a"]
    for wire in ("tbus_std", "hulu_pbrpc", "sofa_pbrpc"):
        row = a[wire]
        assert row["calls"] == row["right"] == chip_smoke.LEGACY_TURNS * chip_smoke.LEGACY_SEQ_MIN
        assert row["burst_right"] == row["burst_calls"]
        assert row["burst_calls"] == chip_smoke.LEGACY_BURST[0] * chip_smoke.LEGACY_BURST_MIN
        assert row["server_frames"] == row["calls"] + row["burst_calls"]
    b = out["b"]
    assert set(b) == set(chip_smoke.LEGACY_NSHEAD_WIRES)
    for wire in ("nshead", "nova_pbrpc", "public_pbrpc", "ubrpc_mcpack2"):
        row = b[wire]
        assert row["right"] == row["calls"] > 0 and row["burst_right"] == row["burst_calls"]
        assert row["server_frames"] == row["calls"] + row["burst_calls"], wire
    c = out["c"]
    assert c["hulu_right"] and c["nshead_right"]
    assert c["handoffs"] == 2 and c["native_reqs_moved"] == 0
    d = out["d"]
    assert d["loads_equal"] and d["dumps_us"] > 0 and d["loads_us"] > 0
