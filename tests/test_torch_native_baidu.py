"""baidu_std on the native plane (``transport/native_plane.py`` over the
port's ``csrc/host/tbnet``) on the CPU, held against the JAX package's:

- ``tests/test_native_baidu.py``'s 39 cases on both packages: the C++
  plane's PRPC responses byte for byte against ``pack_response``, the
  native client's frames against ``pack_request`` (traced, compressed,
  authenticated), one port serving the native and the Python clients,
  the Python route's answers in PRPC (errors, compression, interleaved
  correlation ids), the fuzz-shaped frames, the native codec and auth
  seam answering byte-identically to the Python plane (the token table,
  the authenticator's callback, ERPCAUTH, the compression floor, the
  decompress ceiling), the compressed and authenticated pump kept off the
  interpreter (``cb_frames == 0``), and the PRPC pump;
- ``tests/test_wire_differential.py``'s 9 cases on both packages: each
  package's C++ RpcMeta scanner (``tb_scan_prpc_meta``) against its own
  Python decoder on the same seeded and fuzzed blobs, and the pump's cap on
  a hostile frame; also the two packages' scanners and decoders against
  each other on those blobs;
- ``tests/test_parser_robustness.py::test_http_parse_conn_never_leaks_
  exceptions`` (4 seeds) on both packages;
- one script of raw PRPC frames (native and Python-routed methods,
  attachments, errors, each codec, auth right and wrong, unknown methods
  and services, an out-of-enum codec, a decompress bomb) sent to both
  packages' native-plane servers draws the same response bytes, and the
  same from their Python-plane servers.

The port's servers run on ``ServerOptions(device="cpu")``. Tolerance:
none; every comparison is of bytes or integers."""

from __future__ import annotations

import ctypes
import random
import socket
import struct
import threading

import pytest

from incubator_brpc_tpu import native as jax_native
from incubator_brpc_tpu.iobuf import IOBuf as jax_IOBuf
from incubator_brpc_tpu.protocol import http as jax_http
from incubator_brpc_tpu.protocol import snappy_codec as jax_snappy
from incubator_brpc_tpu.transport import native_plane as jax_np
from incubator_brpc_tpu_torch import native as port_native
from incubator_brpc_tpu_torch.iobuf import IOBuf as port_IOBuf
from incubator_brpc_tpu_torch.protocol import http as port_http
from incubator_brpc_tpu_torch.protocol import snappy_codec as port_snappy
from incubator_brpc_tpu_torch.transport import native_plane as port_np
from incubator_brpc_tpu_torch.utils.status import ErrorCode
from tests.test_torch_baidu_std import (  # noqa: F401  (fixtures)
    _OPEN,
    PKGS,
    no_port_thread_outlives_the_test,
    pkg,
)

for _p, _n, _np, _s, _io, _h in (
    (PKGS["jax"], jax_native, jax_np, jax_snappy, jax_IOBuf, jax_http),
    (PKGS["torch"], port_native, port_np, port_snappy, port_IOBuf, port_http),
):
    _p.native, _p.np, _p.snappy, _p.IOBuf, _p.http = _n, _np, _s, _io, _h

pytestmark = pytest.mark.skipif(
    not (jax_np.NET_AVAILABLE and port_np.NET_AVAILABLE), reason="native runtime unavailable"
)


@pytest.fixture
def native_server(pkg):
    def make(services=None, options=None):
        opts = options or pkg.rpc.ServerOptions(native_plane=True, usercode_inline=True)
        opts.native_plane = True
        if pkg.name == "torch":
            opts.device = "cpu"
        srv = pkg.rpc.Server(opts)
        for name, handlers in (services or {}).items():
            srv.add_service(name, handlers)
        _OPEN.append(srv)
        assert srv.start(0)
        assert srv._native_plane is not None, "native plane did not engage"
        return srv

    return make


# -- tests/test_native_baidu.py on both packages -------------------------------


def _read_prpc_frame(sock: socket.socket, buf: bytes = b"") -> bytes:
    """Read exactly one PRPC frame off a raw socket."""
    while True:
        if len(buf) >= 12:
            total = 12 + struct.unpack(">I", buf[4:8])[0]
            if len(buf) >= total:
                return buf[:total]
        data = sock.recv(65536)
        assert data, "connection closed mid-frame"
        buf += data


class TestServerWireExactness:
    """C++-packed PRPC responses must be byte-identical to what
    protocol/pkg.baidu.py's pack_response emits for the same fields."""

    def _roundtrip(self, port: int, wire: bytes) -> bytes:
        s = socket.create_connection(("127.0.0.1", port))
        try:
            s.sendall(wire)
            return _read_prpc_frame(s)
        finally:
            s.close()

    def test_native_echo_response_byte_exact(self, pkg, native_server):
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        req = pkg.baidu.pack_request(
            pkg.tbus.Meta(service="svc", method="echo"), b"payload", correlation_id=77
        )
        resp = self._roundtrip(srv.port, req)
        assert resp == pkg.baidu.pack_response(
            None, b"payload", correlation_id=77
        )
        # answered in C++, not via the frame callback
        assert srv._native_plane.stats()["native_reqs"] >= 1
        assert srv._native_plane.stats()["cb_frames"] == 0

    def test_native_echo_with_attachment_byte_exact(self, pkg, native_server):
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        att = b"AT" * 500
        req = pkg.baidu.pack_request(
            pkg.tbus.Meta(service="svc", method="echo"), b"pp", correlation_id=3,
            attachment=att,
        )
        resp = self._roundtrip(srv.port, req)
        assert resp == pkg.baidu.pack_response(
            None, b"pp", correlation_id=3, attachment=att
        )

    def test_native_nop_response_byte_exact(self, pkg, native_server):
        srv = native_server({"svc": {"nop": pkg.rpc.native_nop}})
        req = pkg.baidu.pack_request(
            pkg.tbus.Meta(service="svc", method="nop"), b"ignored", correlation_id=9
        )
        resp = self._roundtrip(srv.port, req)
        assert resp == pkg.baidu.pack_response(None, b"", correlation_id=9)

    def test_error_response_decode_reencode_stable(self, pkg, native_server):
        # unknown method: the response must decode with the Python codec
        # and re-encode to the identical bytes (pack path exactness for
        # error responses, whatever plane answered)
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        req = pkg.baidu.pack_request(
            pkg.tbus.Meta(service="svc", method="nope"), b"", correlation_id=11
        )
        resp = self._roundtrip(srv.port, req)
        frame, consumed = pkg.baidu.try_parse_frame(resp)
        assert consumed == len(resp)
        assert frame.error_code == ErrorCode.ENOMETHOD
        assert frame.correlation_id == 11
        assert frame.meta.error_text
        again = pkg.baidu.pack_response(
            frame.meta,
            frame.payload,
            frame.correlation_id,
            error_code=frame.error_code,
        )
        assert again == resp

    def test_padded_varint_correlation_id_accepted(self, pkg, native_server):
        # non-minimal varints are wire-legal proto2; the C++ parser (and
        # the pump's fixed-width cid template relies on this) must accept
        # them and echo the decoded cid back minimally encoded
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        sub = pkg.baidu.encode_request_submeta("svc", "echo")
        cid = 5
        cid10 = bytes(
            ((cid >> (7 * i)) & 0x7F) | 0x80 for i in range(9)
        ) + bytes([(cid >> 63) & 0x7F])
        meta = b"\x0a" + bytes([len(sub)]) + sub + b"\x20" + cid10
        wire = (
            b"PRPC"
            + struct.pack(">II", len(meta) + 3, len(meta))
            + meta
            + b"abc"
        )
        resp = self._roundtrip(srv.port, wire)
        frame, _ = pkg.baidu.try_parse_frame(resp)
        assert frame.correlation_id == 5
        assert frame.payload == b"abc"

    def test_unknown_fixed_width_field_routes_to_python(self, pkg, native_server):
        # fixed64/fixed32 are legal proto2 the RpcMeta tables don't use:
        # the C++ scanner must route such frames to the Python plane (whose
        # _walk_fields skips them), not kill the connection
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        sub = pkg.baidu.encode_request_submeta("svc", "echo")
        meta = (
            b"\x0a" + bytes([len(sub)]) + sub
            + b"\x20\x08"  # correlation_id = 8
            + b"\x79" + b"\x00" * 8  # field 15, wire type 1 (fixed64)
        )
        wire = (
            b"PRPC"
            + struct.pack(">II", len(meta) + 2, len(meta))
            + meta
            + b"hi"
        )
        resp = self._roundtrip(srv.port, wire)
        frame, _ = pkg.baidu.try_parse_frame(resp)
        assert frame.correlation_id == 8
        assert frame.error_code == 0
        assert frame.payload == b"hi"
        assert srv._native_plane.stats()["cb_frames"] >= 1

    def test_overflowing_field_length_kills_conn_only(self, pkg, native_server):
        # a length-delimited meta field claiming a ~2^64 length must fail
        # the bounds check (subtraction form), not wrap past it into an
        # out-of-bounds read — the connection dies, the server survives
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        evil = b"\x0a" + b"\xff" * 9 + b"\x01"  # field 1, len ≈ 2^64-1
        wire = b"PRPC" + struct.pack(">II", len(evil) + 2, len(evil)) + evil + b"xx"
        s = socket.create_connection(("127.0.0.1", srv.port))
        s.sendall(wire)
        s.settimeout(5)
        assert s.recv(1) == b""  # killed cleanly
        s.close()
        ch = pkg.rpc.Channel()
        assert ch.init(
            f"127.0.0.1:{srv.port}",
            options=pkg.rpc.ChannelOptions(native_plane=True, protocol="baidu_std"),
        )
        c = ch.call_method("svc", "echo", b"alive")
        assert c.ok() and c.response_payload == b"alive"

    def test_garbage_after_prpc_magic_kills_conn_only(self, pkg, native_server):
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        s = socket.create_connection(("127.0.0.1", srv.port))
        # meta_size > body_size: unrecoverable
        s.sendall(b"PRPC" + struct.pack(">II", 1, 99))
        s.settimeout(5)
        assert s.recv(1) == b""  # server closed the connection
        s.close()
        # the server survives and keeps answering
        ch = pkg.rpc.Channel()
        assert ch.init(
            f"127.0.0.1:{srv.port}",
            options=pkg.rpc.ChannelOptions(native_plane=True, protocol="baidu_std"),
        )
        c = ch.call_method("svc", "echo", b"still-alive")
        assert c.ok(), c.error_text
        assert c.response_payload == b"still-alive"


class TestClientWireExactness:
    """The native client's PRPC frames must be byte-identical to
    pack_request for the same service/method/payload/attachment."""

    def _capture_one_call(self, pkg, payload: bytes, attachment: bytes, **ids):
        lst = socket.socket()
        lst.bind(("127.0.0.1", 0))
        lst.listen(1)
        port = lst.getsockname()[1]
        got = {}

        def server():
            conn, _ = lst.accept()
            req = _read_prpc_frame(conn)
            got["req"] = req
            frame, _ = pkg.baidu.try_parse_frame(req)
            conn.sendall(
                pkg.baidu.pack_response(None, b"ok", frame.correlation_id)
            )
            conn.close()

        t = threading.Thread(target=server)
        t.start()
        nch = pkg.np.NativeClientChannel(
            "127.0.0.1", port, protocol="baidu_std"
        )
        try:
            # the first cid a channel mints is 1 in its own shard's cid
            # partition (top 8 bits carry the client reactor shard pinned
            # at connect) — the comparison frame must use the same cid
            first_cid = (nch.reactor << 56) | 1
            rc, ec, meta, body = nch.call(
                "svc", "mth", payload, attachment, timeout_ms=5000, **ids
            )
            t.join(timeout=10)
        finally:
            nch.close()
            lst.close()
        assert rc >= 0 and ec == 0, (rc, ec)
        assert body.to_bytes() == b"ok"
        return got["req"], first_cid

    # every call stamps its remaining deadline budget on the wire
    # (RpcRequestMeta.timeout_ms, field 8) — the expected frames carry
    # the capture helper's timeout_ms=5000

    def test_request_frame_byte_exact(self, pkg):
        req, cid = self._capture_one_call(pkg, b"the-payload", b"")
        assert req == pkg.baidu.pack_request(
            pkg.tbus.Meta(service="svc", method="mth", timeout_ms=5000),
            b"the-payload",
            correlation_id=cid,
        )

    def test_request_frame_with_attachment_byte_exact(self, pkg):
        att = b"ATTACH" * 20
        req, cid = self._capture_one_call(pkg, b"pp", att)
        assert req == pkg.baidu.pack_request(
            pkg.tbus.Meta(service="svc", method="mth", timeout_ms=5000), b"pp",
            correlation_id=cid, attachment=att,
        )

    def test_traced_request_carries_dapper_ids_byte_exact(self, pkg):
        # log_id + trace/span ids must reach the wire exactly as the
        # Python packer sends them — the server parents its rpcz span
        # into the client's trace off these fields
        ids = dict(log_id=42, trace_id=0xDEADBEEF01, span_id=7)
        req, cid = self._capture_one_call(pkg, b"pp", b"", **ids)
        assert req == pkg.baidu.pack_request(
            pkg.tbus.Meta(service="svc", method="mth", timeout_ms=5000, **ids),
            b"pp", correlation_id=cid,
        )


class TestCrossClientEcho:
    """native↔Python cross-client echo over ONE port, both wire protocols
    live on the same native server (the reference's one-port-every-
    protocol story, input_messenger.cpp:60-129)."""

    def test_native_and_python_clients_one_port(self, pkg, native_server):
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        port = srv.port
        # native client, baidu_std wire
        ch_native = pkg.rpc.Channel()
        assert ch_native.init(
            f"127.0.0.1:{port}",
            options=pkg.rpc.ChannelOptions(native_plane=True, protocol="baidu_std"),
        )
        # pure-Python client, baidu_std wire (Socket reactor + Python codec)
        ch_py = pkg.rpc.Channel()
        assert ch_py.init(
            f"127.0.0.1:{port}", options=pkg.rpc.ChannelOptions(protocol="baidu_std")
        )
        # native client, tbus_std wire — the same server answers each
        # connection in its own protocol
        ch_tbus = pkg.rpc.Channel()
        assert ch_tbus.init(
            f"127.0.0.1:{port}", options=pkg.rpc.ChannelOptions(native_plane=True)
        )
        for ch, tag in ((ch_native, b"n"), (ch_py, b"p"), (ch_tbus, b"t")):
            c = ch.call_method("svc", "echo", b"x-" + tag, attachment=b"A" + tag)
            assert c.ok(), c.error_text
            assert c.response_payload == b"x-" + tag
            assert c.response_attachment == b"A" + tag
        # ALL three echoes were served without the interpreter — the
        # pure-Python client's frames carry rpcz trace ids, and the C++
        # parser now decodes them natively (trace context is a fast-path
        # citizen; the drain parents the server spans).  Nobody was
        # handed off: baidu_std is a native protocol.
        stats = srv._native_plane.stats()
        assert stats["native_reqs"] >= 3
        assert stats["cb_frames"] == 0
        assert stats["handoffs"] == 0

    def test_native_baidu_client_against_python_server(self, pkg):
        # the native client's PRPC bytes parse on the pure-Python plane
        # (protocol scan + baidu_std codec) and its response parses back
        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(usercode_inline=True, **pkg.server_kw))
        srv.add_service("svc", {"echo": pkg.rpc.native_echo})
        assert srv.start(0)
        try:
            nch = pkg.np.NativeClientChannel(
                "127.0.0.1", srv.port, protocol="baidu_std"
            )
            try:
                rc, ec, meta, body = nch.call(
                    "svc", "echo", b"cross", b"att-bytes", timeout_ms=5000
                )
                assert rc >= 0 and ec == 0, (rc, ec)
                m = nch.decode_resp_meta(meta)
                blen = len(body)
                assert m.attachment_size == len(b"att-bytes")
                assert body.to_bytes(blen - m.attachment_size) == b"cross"
                assert (
                    body.to_bytes(
                        m.attachment_size, pos=blen - m.attachment_size
                    )
                    == b"att-bytes"
                )
            finally:
                nch.close()
        finally:
            srv.stop()


class TestPythonRouteSemantics:
    def test_python_handler_error_text_over_prpc(self, pkg, native_server):
        def boom(cntl, req):
            cntl.set_failed(ErrorCode.EINTERNAL, "prpc boom")
            return b""

        srv = native_server({"svc": {"boom": boom}})
        ch = pkg.rpc.Channel()
        assert ch.init(
            f"127.0.0.1:{srv.port}",
            options=pkg.rpc.ChannelOptions(native_plane=True, protocol="baidu_std"),
        )
        c = ch.call_method("svc", "boom", b"")
        assert c.failed()
        assert c.error_code == ErrorCode.EINTERNAL
        assert "prpc boom" in c.error_text

    def test_compress_type_passthrough(self, pkg, native_server):
        # a compressed request from the PURE-PYTHON client still round-
        # trips: its frames carry rpcz trace ids, which route them to the
        # Python plane regardless of compression — the Python route's
        # codecs must keep working now that the native plane has its own
        # (TestNativeCompressAuth covers the native codec table)

        srv = native_server({"svc": {"echo": lambda cntl, req: req}})
        ch = pkg.rpc.Channel()
        assert ch.init(
            f"127.0.0.1:{srv.port}",
            options=pkg.rpc.ChannelOptions(protocol="baidu_std"),
        )
        cntl = pkg.rpc.Controller()
        cntl.compress_type = "gzip"
        payload = b"z" * 4096
        c = ch.call_method("svc", "echo", payload, cntl=cntl)
        assert c.ok(), c.error_text
        assert c.response_payload == payload
        assert srv._native_plane.stats()["cb_frames"] >= 1

    def test_correlation_ids_interleave(self, pkg, native_server):
        # concurrent callers over ONE shared PRPC connection: the varint
        # correlation ids must land each response on its own caller
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        ch = pkg.rpc.Channel()
        assert ch.init(
            f"127.0.0.1:{srv.port}",
            options=pkg.rpc.ChannelOptions(native_plane=True, protocol="baidu_std"),
        )
        errs = []

        def worker(i):
            for j in range(25):
                body = b"w%d-%d" % (i, j)
                c = ch.call_method("svc", "echo", body)
                if c.failed() or c.response_payload != body:
                    errs.append((i, j, c.error_text, c.response_payload))

        threads = [
            threading.Thread(target=worker, args=(i,)) for i in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs[:3]


class TestPrpcFuzzRobustness:
    """Fuzz-shaped adversarial wire input against the C++ PRPC cutter:
    truncated headers, oversized body_size, garbage and overflowing
    RpcMeta varints, mid-frame connection close. The invariant is always
    the same — the SERVER survives (no crash, no wedge): bad frames cost
    at most their own connection (clean teardown) or route harmlessly to
    the Python plane; the port keeps answering well-formed traffic."""

    def _assert_still_serving(self, pkg, srv):
        ch = pkg.rpc.Channel()
        assert ch.init(
            f"127.0.0.1:{srv.port}",
            options=pkg.rpc.ChannelOptions(native_plane=True, protocol="baidu_std"),
        )
        c = ch.call_method("svc", "echo", b"probe")
        assert c.ok(), c.error_text
        assert c.response_payload == b"probe"

    def _open(self, srv):
        s = socket.create_connection(("127.0.0.1", srv.port))
        s.settimeout(5)
        return s

    def test_truncated_header_then_close(self, pkg, native_server):
        # every prefix of a valid 12-byte header, connection closed
        # mid-header: the cutter must just drop the conn state
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        whole = b"PRPC" + struct.pack(">II", 10, 4)
        for cut in range(1, len(whole)):
            s = self._open(srv)
            s.sendall(whole[:cut])
            s.close()
        self._assert_still_serving(pkg, srv)

    def test_oversized_body_size_rejected(self, pkg, native_server):
        # body_size beyond the configured max: the connection dies
        # without the server ever allocating/buffering the claimed blob
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        s = self._open(srv)
        s.sendall(b"PRPC" + struct.pack(">II", 0xFFFFFFF0, 8))
        assert s.recv(1) == b""  # killed cleanly
        s.close()
        self._assert_still_serving(pkg, srv)

    def test_garbage_meta_varints(self, pkg, native_server):
        # RpcMeta bytes that are pure garbage: unknown tags, truncated
        # varints, wire-type soup — at most the connection dies; several
        # of these decode as unknown-field frames and route to Python,
        # which answers ENOSERVICE/EREQUEST instead of crashing
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        metas = [
            b"\xff" * 16,  # unterminated varint tag run
            b"\x0a\xff",  # length-delimited field, truncated length
            b"\x20" + b"\x80" * 11,  # cid varint longer than 10 bytes
            b"\x07\x01\x02",  # wire type 7 (invalid)
            bytes(range(1, 32)),  # tag/wire-type soup
        ]
        for meta in metas:
            s = self._open(srv)
            wire = b"PRPC" + struct.pack(">II", len(meta) + 2, len(meta))
            s.sendall(wire + meta + b"xx")
            try:
                s.recv(4096)  # server may answer an error or close; both fine
            except (TimeoutError, socket.timeout):
                pass
            s.close()
        self._assert_still_serving(pkg, srv)

    def test_overflowing_varint_field_length(self, pkg, native_server):
        # a nested submeta whose length varint overflows 64 bits: bounds
        # math must not wrap into an out-of-bounds read
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        evil = b"\x0a" + b"\xff" * 10 + b"\x7f"
        s = self._open(srv)
        s.sendall(b"PRPC" + struct.pack(">II", len(evil) + 1, len(evil)) + evil + b"y")
        assert s.recv(1) == b""
        s.close()
        self._assert_still_serving(pkg, srv)

    def test_mid_frame_close_after_header(self, pkg, native_server):
        # header promises 1000 body bytes; the peer dies after 100: the
        # half-read frame must be discarded with the connection
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        sub = pkg.baidu.encode_request_submeta("svc", "echo")
        meta = b"\x0a" + bytes([len(sub)]) + sub + b"\x20\x05"
        s = self._open(srv)
        s.sendall(b"PRPC" + struct.pack(">II", len(meta) + 1000, len(meta)))
        s.sendall(meta + b"z" * 100)  # 900 bytes short
        s.close()
        self._assert_still_serving(pkg, srv)

    def test_mid_frame_close_inside_meta(self, pkg, native_server):
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        s = self._open(srv)
        s.sendall(b"PRPC" + struct.pack(">II", 600, 500) + b"\x0a\x10garb")
        s.close()
        self._assert_still_serving(pkg, srv)

    def test_interleaved_garbage_and_valid_connections(self, pkg, native_server):
        # a hostile client must not degrade service for a well-behaved
        # neighbor connection open at the same time
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        good = pkg.rpc.Channel()
        assert good.init(
            f"127.0.0.1:{srv.port}",
            options=pkg.rpc.ChannelOptions(native_plane=True, protocol="baidu_std"),
        )
        assert good.call_method("svc", "echo", b"a").ok()
        for i in range(8):
            s = self._open(srv)
            s.sendall(b"PRPC" + struct.pack(">II", 0xFFFFFFF0, i))
            s.close()
            c = good.call_method("svc", "echo", b"b%d" % i)
            assert c.ok(), c.error_text
            assert c.response_payload == b"b%d" % i


class TestNativeCompressAuth:
    """Production-shaped PRPC traffic on the C++ plane: compressed and/or
    authenticated frames are cut, verified, decompressed, dispatched and
    recompressed natively — and the bytes answered are IDENTICAL to what
    the pure-Python plane answers for the same wire input (the planes'
    byte-identity extended to codecs and auth), including the
    ERPCAUTH reject frame and the deterministic decompress errors."""

    TOKEN = "sekrit-token"

    def _twin_roundtrip(self, pkg, wire: bytes, auth=None, services=None):
        """Send the SAME wire bytes to a native-plane server and a
        pure-Python server (same services/auth) and return both raw
        responses."""

        services = services or {"svc": {"echo": pkg.rpc.native_echo}}
        out = []
        for native in (True, False):
            srv = pkg.rpc.Server(
                pkg.rpc.ServerOptions(
                    native_plane=native, usercode_inline=True, auth=auth, **pkg.server_kw
                )
            )
            for name, handlers in services.items():
                srv.add_service(name, handlers)
            assert srv.start(0)
            try:
                if native:
                    assert srv._native_plane is not None
                s = socket.create_connection(("127.0.0.1", srv.port))
                s.settimeout(10)
                try:
                    s.sendall(wire)
                    out.append(_read_prpc_frame(s))
                finally:
                    s.close()
                if native:
                    out.append(srv._native_plane.stats())
            finally:
                srv.stop()
        return out  # [native_resp, native_stats, python_resp]

    def _auth(self, pkg):

        return pkg.rpc.TokenAuthenticator([self.TOKEN])

    @pytest.mark.parametrize("codec", ["snappy", "gzip", "zlib1"])
    def test_compressed_authed_echo_byte_identical(self, pkg, codec):
        compress_mod = pkg.compress

        payload = b"compressible payload " * 300
        meta = pkg.tbus.Meta(service="svc", method="echo", compress=codec)
        meta.extra["auth"] = self.TOKEN
        wire = pkg.baidu.pack_request(
            meta, compress_mod.compress(codec, payload), correlation_id=77
        )
        native_resp, stats, python_resp = self._twin_roundtrip(pkg, 
            wire, auth=self._auth(pkg)
        )
        assert native_resp == python_resp
        # the native plane answered without the interpreter
        assert stats["native_reqs"] >= 1 and stats["cb_frames"] == 0
        frame, _ = pkg.baidu.try_parse_frame(native_resp)
        assert frame.error_code == 0
        assert frame.meta.compress == codec
        assert compress_mod.decompress(codec, frame.payload) == payload

    def test_compressed_echo_with_attachment_byte_identical(self, pkg):
        compress_mod = pkg.compress

        payload, att = b"pp" * 600, b"ATTACH" * 40
        meta = pkg.tbus.Meta(service="svc", method="echo", compress="snappy")
        wire = pkg.baidu.pack_request(
            meta,
            compress_mod.compress("snappy", payload),
            correlation_id=5,
            attachment=att,
        )
        native_resp, stats, python_resp = self._twin_roundtrip(pkg, wire)
        assert native_resp == python_resp
        assert stats["cb_frames"] == 0
        frame, _ = pkg.baidu.try_parse_frame(native_resp)
        # the attachment travels uncompressed on both planes
        assert frame.attachment == att
        assert (
            compress_mod.decompress("snappy", frame.payload) == payload
        )

    def test_response_compression_floor_byte_identical(self, pkg):
        # a payload below native_compress_min_bytes answers UNCOMPRESSED
        # on both planes (the reference's response_compress_type
        # discipline) — and still byte-identically
        compress_mod = pkg.compress
        get_flag, set_flag_unchecked = pkg.flags.get_flag, pkg.flags.set_flag_unchecked

        old = get_flag("native_compress_min_bytes")
        set_flag_unchecked("native_compress_min_bytes", 1024)
        try:
            payload = b"tiny"
            meta = pkg.tbus.Meta(service="svc", method="echo", compress="snappy")
            wire = pkg.baidu.pack_request(
                meta,
                compress_mod.compress("snappy", payload),
                correlation_id=3,
            )
            native_resp, stats, python_resp = self._twin_roundtrip(pkg, wire)
            assert native_resp == python_resp
            assert stats["cb_frames"] == 0
            frame, _ = pkg.baidu.try_parse_frame(native_resp)
            assert frame.meta.compress == ""  # floor skipped the codec
            assert frame.payload == payload
        finally:
            set_flag_unchecked("native_compress_min_bytes", old)

    def test_erpcauth_reject_byte_identical(self, pkg):
        meta = pkg.tbus.Meta(service="svc", method="echo")
        meta.extra["auth"] = "wrong-token"
        wire = pkg.baidu.pack_request(meta, b"x", correlation_id=9)
        native_resp, stats, python_resp = self._twin_roundtrip(pkg, 
            wire, auth=self._auth(pkg)
        )
        assert native_resp == python_resp
        assert stats["auth_rejects"] == 1
        frame, _ = pkg.baidu.try_parse_frame(native_resp)
        assert frame.error_code == ErrorCode.ERPCAUTH
        assert frame.meta.error_text == "Unauthorized"

    def test_unknown_compress_type_byte_identical(self, pkg):
        # out-of-enum compress_type: a clean EREQUEST with the same
        # deterministic text on both planes, connection survives
        rm = pkg.baidu.RpcMeta(
            service_name="svc",
            method_name="echo",
            compress_type=9,
            correlation_id=4,
        )
        wire = pkg.baidu.pack_frame(rm, b"zzzz")
        native_resp, _stats, python_resp = self._twin_roundtrip(pkg, wire)
        assert native_resp == python_resp
        frame, _ = pkg.baidu.try_parse_frame(native_resp)
        assert frame.error_code == ErrorCode.EREQUEST
        assert "unknown compression codec 'wire-9'" in frame.meta.error_text

    def test_decompress_ceiling_byte_identical(self, pkg):
        # a tiny bomb claiming a huge expansion rejects EREQUEST on both
        # planes with the identical ceiling text — server memory never
        # grows past max_decompress_bytes
        compress_mod = pkg.compress
        get_flag, set_flag_unchecked = pkg.flags.get_flag, pkg.flags.set_flag_unchecked

        old = get_flag("max_decompress_bytes")
        set_flag_unchecked("max_decompress_bytes", 4096)
        try:
            # gzip: a real deflate bomb (1 MB of zeros in ~1 KB).  snappy:
            # a stream whose length PREAMBLE claims 1 GiB — the decoder
            # must reject on the claim, before any expansion.
            gzip_bomb = compress_mod.compress("gzip", b"\0" * 1_000_000)
            assert len(gzip_bomb) < 5000  # it IS a bomb
            claim = 1 << 30
            pre = bytearray()
            v = claim
            while v >= 0x80:
                pre.append((v & 0x7F) | 0x80)
                v >>= 7
            pre.append(v)
            snappy_bomb = bytes(pre) + b"\x00a"  # 1-byte literal follows
            for codec, bomb in (("gzip", gzip_bomb), ("snappy", snappy_bomb)):
                meta = pkg.tbus.Meta(service="svc", method="echo", compress=codec)
                wire = pkg.baidu.pack_request(meta, bomb, correlation_id=6)
                native_resp, _stats, python_resp = self._twin_roundtrip(pkg, wire)
                assert native_resp == python_resp, codec
                frame, _ = pkg.baidu.try_parse_frame(native_resp)
                assert frame.error_code == ErrorCode.EREQUEST
                assert (
                    "exceeds max_decompress_bytes (4096)"
                    in frame.meta.error_text
                )
        finally:
            set_flag_unchecked("max_decompress_bytes", old)

    def test_ceiling_disabled_still_serves(self, pkg):
        # max_decompress_bytes=0 means UNLIMITED: the bounded-inflate
        # chunk math must not wrap to a zero budget (a wrap starves
        # inflate of output space and spins the reactor forever), and a
        # hostile snappy length claim must not become a giant up-front
        # allocation
        compress_mod = pkg.compress
        get_flag, set_flag_unchecked = pkg.flags.get_flag, pkg.flags.set_flag_unchecked

        old = get_flag("max_decompress_bytes")
        set_flag_unchecked("max_decompress_bytes", 0)
        try:
            payload = b"unlimited " * 400
            for codec in ("gzip", "snappy"):
                meta = pkg.tbus.Meta(service="svc", method="echo", compress=codec)
                wire = pkg.baidu.pack_request(
                    meta,
                    compress_mod.compress(codec, payload),
                    correlation_id=8,
                )
                native_resp, stats, python_resp = self._twin_roundtrip(pkg, wire)
                assert native_resp == python_resp, codec
                frame, _ = pkg.baidu.try_parse_frame(native_resp)
                assert frame.error_code == 0, codec
                assert (
                    compress_mod.decompress(codec, frame.payload) == payload
                )
            # snappy claiming 2^60 bytes: rejected as corrupt (the stream
            # is shorter than its claim), never allocated up front
            claim = 1 << 60
            pre = bytearray()
            v = claim
            while v >= 0x80:
                pre.append((v & 0x7F) | 0x80)
                v >>= 7
            pre.append(v)
            meta = pkg.tbus.Meta(service="svc", method="echo", compress="snappy")
            wire = pkg.baidu.pack_request(
                meta, bytes(pre) + b"\x00a", correlation_id=9
            )
            native_resp, _stats, python_resp = self._twin_roundtrip(pkg, wire)
            assert native_resp == python_resp
            frame, _ = pkg.baidu.try_parse_frame(native_resp)
            assert frame.error_code == ErrorCode.EREQUEST
        finally:
            set_flag_unchecked("max_decompress_bytes", old)

    def test_native_client_compressed_authed_request_byte_exact(self, pkg):
        # the C++ channel's compressed+authenticated request frames are
        # byte-identical to protocol/pkg.baidu.py pack_request — and the
        # credential stops stamping once the connection is proven
        compress_mod = pkg.compress

        lst = socket.socket()
        lst.bind(("127.0.0.1", 0))
        lst.listen(1)
        port = lst.getsockname()[1]
        got = {}

        def server():
            conn, _ = lst.accept()
            buf = b""
            for key in ("first", "second"):
                req = _read_prpc_frame(conn, buf)
                buf = b""
                got[key] = req
                frame, _ = pkg.baidu.try_parse_frame(req)
                conn.sendall(
                    pkg.baidu.pack_response(None, b"ok", frame.correlation_id)
                )
            conn.close()

        t = threading.Thread(target=server)
        t.start()
        payload = b"data to compress " * 100
        comp = compress_mod.compress("snappy", payload)
        nch = pkg.np.NativeClientChannel(
            "127.0.0.1", port, protocol="baidu_std"
        )
        try:
            nch.set_auth(self.TOKEN)
            shard = nch.reactor
            for _ in range(2):
                rc, ec, _m, body = nch.call(
                    "svc", "mth", comp, timeout_ms=5000, compress="snappy"
                )
                assert rc >= 0 and ec == 0, (rc, ec)
            t.join(timeout=10)
        finally:
            nch.close()
            lst.close()
        m1 = pkg.tbus.Meta(service="svc", method="mth", compress="snappy",
                  timeout_ms=5000)
        m1.extra["auth"] = self.TOKEN
        assert got["first"] == pkg.baidu.pack_request(
            m1, comp, correlation_id=(shard << 56) | 1
        )
        # proven connection: the second frame carries NO credential
        m2 = pkg.tbus.Meta(service="svc", method="mth", compress="snappy",
                  timeout_ms=5000)
        assert got["second"] == pkg.baidu.pack_request(
            m2, comp, correlation_id=(shard << 56) | 2
        )

    def test_python_authenticator_trampoline(self, pkg, native_server):
        # an arbitrary Python Authenticator still guards the native
        # plane: the verifier crosses into the interpreter ONCE per
        # connection (callback deferral, not the frame route — cb_frames
        # stays 0) and the verdict caches on the conn

        auth = pkg.rpc.SharedSecretAuthenticator("shh", identity="press")
        srv = native_server(
            {"svc": {"echo": pkg.rpc.native_echo}},
            options=pkg.rpc.ServerOptions(
                native_plane=True, usercode_inline=True, auth=auth
            ),
        )
        ch = pkg.rpc.Channel()
        assert ch.init(
            f"127.0.0.1:{srv.port}",
            options=pkg.rpc.ChannelOptions(
                native_plane=True,
                protocol="baidu_std",
                auth=pkg.rpc.SharedSecretAuthenticator("shh", identity="press"),
            ),
        )
        for i in range(3):
            c = ch.call_method("svc", "echo", b"n%d" % i)
            assert c.ok(), c.error_text
        stats = srv._native_plane.stats()
        assert stats["native_reqs"] >= 3
        assert stats["cb_frames"] == 0
        # wrong secret: rejected natively through the same trampoline
        bad = pkg.rpc.Channel()
        assert bad.init(
            f"127.0.0.1:{srv.port}",
            options=pkg.rpc.ChannelOptions(
                native_plane=True,
                protocol="baidu_std",
                auth=pkg.rpc.SharedSecretAuthenticator("not-it", identity="x"),
            ),
        )
        c = bad.call_method("svc", "echo", b"x")
        assert c.failed() and c.error_code == ErrorCode.ERPCAUTH
        assert srv._native_plane.stats()["auth_rejects"] >= 1

    def test_compressed_authed_pump_interpreter_free(self, pkg, native_server):
        # the compressed+authenticated flood never enters the
        # interpreter, as the plain pump does not
        compress_mod = pkg.compress

        srv = native_server(
            {"svc": {"echo": pkg.rpc.native_echo}},
            options=pkg.rpc.ServerOptions(
                native_plane=True, usercode_inline=True, auth=self._auth(pkg)
            ),
        )
        payload = b"flood payload " * 300  # ~4 KiB
        comp = compress_mod.compress("snappy", payload)
        nch = pkg.np.NativeClientChannel(
            "127.0.0.1", srv.port, protocol="baidu_std"
        )
        try:
            nch.set_auth(self.TOKEN)
            nch.set_request_compress("snappy")
            ns = nch.pump("svc", "echo", comp, 3000, inflight=64)
            assert ns > 0
            stats = srv._native_plane.stats()
            assert stats["native_reqs"] >= 3000
            assert stats["cb_frames"] == 0
            cs = srv._native_plane.compress_stats()
            # every request decompressed and every response recompressed
            assert cs["in_raw"] > cs["in_wire"] > 0
            assert cs["out_raw"] > cs["out_wire"] > 0
        finally:
            nch.close()

    def test_python_route_after_native_auth(self, pkg, native_server):
        # a natively-authenticated connection's Python-routed frames
        # (trace ids) must NOT be re-challenged: the verdict rides the
        # callback flags into sock.context

        def py_echo(cntl, request):
            return request

        srv = native_server(
            {"svc": {"echo": pkg.rpc.native_echo, "pyecho": py_echo}},
            options=pkg.rpc.ServerOptions(
                native_plane=True, usercode_inline=True, auth=self._auth(pkg)
            ),
        )
        ch = pkg.rpc.Channel()
        assert ch.init(
            f"127.0.0.1:{srv.port}",
            options=pkg.rpc.ChannelOptions(
                native_plane=True, protocol="baidu_std", auth=self._auth(pkg)
            ),
        )
        # first call authenticates natively (traced frames stay native
        # now, so a plain-Python-handler method is the route trigger)
        assert ch.call_method("svc", "echo", b"a").ok()
        # a Python-dispatched method's frame carries no credential (the
        # first response proved the connection), so only the cached
        # verdict can admit it
        c = ch.call_method("svc", "pyecho", b"pyroute")
        assert c.ok(), (c.error_code, c.error_text)
        assert srv._native_plane.stats()["cb_frames"] >= 1


class TestCompressFuzzRobustness:
    """Adversarial compressed frames against the native codec round:
    truncated/corrupt bodies, bombs, out-of-enum codec ids, attachment
    disagreements, and oversized auth data.  Invariant: the server
    answers a clean error (or kills at most the offending connection)
    and keeps serving — never crashes, never expands a bomb."""

    def _assert_still_serving(self, pkg, srv):
        ch = pkg.rpc.Channel()
        assert ch.init(
            f"127.0.0.1:{srv.port}",
            options=pkg.rpc.ChannelOptions(native_plane=True, protocol="baidu_std"),
        )
        c = ch.call_method("svc", "echo", b"probe")
        assert c.ok(), c.error_text
        assert c.response_payload == b"probe"

    def _send(self, pkg, srv, wire: bytes) -> bytes:
        s = socket.create_connection(("127.0.0.1", srv.port))
        s.settimeout(5)
        try:
            s.sendall(wire)
            try:
                return _read_prpc_frame(s)
            except AssertionError:
                return b""  # connection killed: also acceptable
        finally:
            s.close()

    def _compressed_req(self, pkg, codec_wire: int, body: bytes, cid: int = 1,
                        attachment_size: int = 0) -> bytes:
        rm = pkg.baidu.RpcMeta(
            service_name="svc",
            method_name="echo",
            compress_type=codec_wire,
            correlation_id=cid,
            attachment_size=attachment_size,
        )
        mb = rm.encode()
        hdr = b"PRPC" + struct.pack(">II", len(mb) + len(body), len(mb))
        return hdr + mb + body

    @pytest.mark.parametrize("codec_wire", [1, 2, 3])
    def test_corrupt_bodies_clean_error(self, pkg, native_server, codec_wire):
        compress_mod = pkg.compress

        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        name = {1: "snappy", 2: "gzip", 3: "zlib1"}[codec_wire]
        good = compress_mod.compress(name, b"payload " * 200)
        # (body, strict): strict cases MUST reject EREQUEST; a flipped
        # byte mid-stream may legally still decode (snappy has no
        # checksum in the block format), so those only require a clean
        # answer — the invariant throughout is "no crash, keeps serving"
        bodies = [
            (b"\xff" * 64, True),                 # garbage
            (good[: len(good) // 2], True),        # truncated
            (good[:-1] + b"\x00", False),          # corrupted tail
            (bytes([good[0] ^ 0xFF]) + good[1:], False),  # corrupted head
            (b"", True),                           # empty compressed body
        ]
        for i, (body, strict) in enumerate(bodies):
            resp = self._send(
                pkg, srv, self._compressed_req(pkg, codec_wire, body, cid=i + 1)
            )
            if resp:
                frame, _ = pkg.baidu.try_parse_frame(resp)
                assert frame.error_code in (
                    (ErrorCode.EREQUEST,)
                    if strict
                    else (0, ErrorCode.EREQUEST)
                ), (name, i, frame.error_code, frame.meta.error_text)
        self._assert_still_serving(pkg, srv)

    def test_attachment_size_vs_decompressed_length(self, pkg, native_server):
        # attachment_size larger than the wire body routes off the fast
        # path; attachment_size eating INTO the compressed payload makes
        # the codec see a truncated stream — a clean error either way
        compress_mod = pkg.compress

        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        comp = compress_mod.compress("snappy", b"data " * 400)
        # claim the last 32 compressed bytes are attachment: the codec
        # input is truncated mid-stream
        wire = self._compressed_req(pkg, 1, comp, cid=2, attachment_size=32)
        resp = self._send(pkg, srv, wire)
        if resp:
            frame, _ = pkg.baidu.try_parse_frame(resp)
            assert frame.error_code == ErrorCode.EREQUEST
        # attachment_size beyond the whole body
        wire = self._compressed_req(pkg, 
            1, comp, cid=3, attachment_size=len(comp) + 1000
        )
        self._send(pkg, srv, wire)
        self._assert_still_serving(pkg, srv)

    def test_auth_data_at_meta_bound(self, pkg, native_server):
        # a 64 KiB credential (the meta scratch boundary) must be read,
        # rejected, and survived — on an auth server AND a no-auth one

        srv = native_server(
            {"svc": {"echo": pkg.rpc.native_echo}},
            options=pkg.rpc.ServerOptions(
                native_plane=True,
                usercode_inline=True,
                auth=pkg.rpc.TokenAuthenticator(["short"]),
            ),
        )
        big_cred = b"A" * (64 * 1024)
        rm = pkg.baidu.RpcMeta(
            service_name="svc",
            method_name="echo",
            correlation_id=5,
            authentication_data=big_cred,
        )
        wire = pkg.baidu.pack_frame(rm, b"x")
        resp = self._send(pkg, srv, wire)
        assert resp
        frame, _ = pkg.baidu.try_parse_frame(resp)
        assert frame.error_code == ErrorCode.ERPCAUTH
        # correct token still admitted afterwards on a fresh conn
        rm2 = pkg.baidu.RpcMeta(
            service_name="svc",
            method_name="echo",
            correlation_id=6,
            authentication_data=b"short",
        )
        resp = self._send(pkg, srv, pkg.baidu.pack_frame(rm2, b"ok"))
        frame, _ = pkg.baidu.try_parse_frame(resp)
        assert frame.error_code == 0 and frame.payload == b"ok"

    def test_snappy_decoder_fuzz_no_crash(self, pkg):
        # the decoder itself against random tags: errors, never crashes,
        # and the native decoder agrees with the pure-Python twin on
        # accept/reject for every case
        import random

        compress_mod = pkg.compress
        snappy_codec = pkg.snappy

        rng = random.Random(11)
        for _ in range(300):
            blob = bytes(
                rng.getrandbits(8) for _ in range(rng.randrange(1, 80))
            )
            native_err = python_err = False
            try:
                native_out = compress_mod.decompress("snappy", blob)
            except ValueError:
                native_err = True
            try:
                python_out = snappy_codec.decompress(blob)
            except ValueError:
                python_err = True
            assert native_err == python_err, blob.hex()
            if not native_err:
                assert native_out == python_out, blob.hex()


class TestPrpcPump:
    def test_pump_interpreter_free(self, pkg, native_server):
        srv = native_server({"svc": {"echo": pkg.rpc.native_echo}})
        nch = pkg.np.NativeClientChannel(
            "127.0.0.1", srv.port, protocol="baidu_std"
        )
        try:
            ns = nch.pump("svc", "echo", b"x" * 64, 3000, inflight=64)
            assert ns > 0
            # every request of the pump dispatched natively
            stats = srv._native_plane.stats()
            assert stats["native_reqs"] >= 3000
            assert stats["cb_frames"] == 0
            # the scrapeable record landed in the prpc recorder
            prpc_pump_ns = pkg.np.prpc_pump_ns

            assert prpc_pump_ns.sum() > 0
        finally:
            nch.close()


# -- tests/test_wire_differential.py on both packages ----------------------------

_M64 = (1 << 64) - 1
_CAP = 4096  # name caps handed to the native scanner


def _native_scan(pkg, meta: bytes):
    """Run the C++ scanner; None on reject, else a comparable dict."""
    LIB = pkg.native.LIB

    cid = ctypes.c_uint64()
    att = ctypes.c_long()
    tmo = ctypes.c_long()
    comp = ctypes.c_uint32()
    ec = ctypes.c_uint32()
    svc = ctypes.create_string_buffer(_CAP)
    mth = ctypes.create_string_buffer(_CAP)
    sl = ctypes.c_size_t()
    ml = ctypes.c_size_t()
    log_id = ctypes.c_uint64()
    trace_id = ctypes.c_uint64()
    span_id = ctypes.c_uint64()
    parent_span_id = ctypes.c_uint64()
    sampled = ctypes.c_uint32()
    rc = LIB.tb_scan_prpc_meta(
        meta, len(meta), ctypes.byref(cid), ctypes.byref(att),
        ctypes.byref(tmo), ctypes.byref(comp), ctypes.byref(ec),
        svc, _CAP, ctypes.byref(sl), mth, _CAP, ctypes.byref(ml),
        ctypes.byref(log_id), ctypes.byref(trace_id), ctypes.byref(span_id),
        ctypes.byref(parent_span_id), ctypes.byref(sampled),
    )
    if rc == -1:
        return None
    assert rc >= 0, f"name cap too small for fuzz meta ({rc})"
    return {
        "cid": cid.value,
        "attachment": att.value,
        "timeout_ms": tmo.value,
        "compress": comp.value,
        "error_code": ec.value,
        "svc": svc.raw[: sl.value],
        "mth": mth.raw[: ml.value],
        "log_id": log_id.value,
        "trace_id": trace_id.value,
        "span_id": span_id.value,
        "parent_span_id": parent_span_id.value,
        "sampled": sampled.value,
        "to_python": bool(rc & 1),
        "is_response": bool(rc & 2),
    }


def _python_scan(pkg, meta: bytes):
    try:
        return pkg.baidu.RpcMeta.decode(meta)
    except pkg.tbus.ParseError:
        return None


def _native_stricter_cap(rm) -> bool:
    """The documented clamps where the C++ scanner rejects metas the
    permissive Python decoder still represents: values beyond the widths
    the native plane can carry (u32 compress, 2^31 attachment/timeout).
    Compared mod 2^64 because the C++ varint reader wraps there."""
    return (
        (rm.compress_type & _M64) > 0xFFFFFFFF
        or (rm.attachment_size & _M64) > (1 << 31)
        or (rm.timeout_ms & _M64) > (1 << 31)
    )


def _assert_agree(pkg, meta: bytes):
    nat = _native_scan(pkg, meta)
    py = _python_scan(pkg, meta)
    label = meta.hex()
    if nat is None:
        # native reject: Python rejected too, or the meta trips a
        # documented native-stricter width clamp — nothing else
        assert py is None or _native_stricter_cap(py), (
            f"native rejected a meta Python accepts with in-range "
            f"fields: {label}"
        )
        return
    # native accept ⇒ Python accept, fields agree (mod the wraps)
    assert py is not None, f"Python rejected a native-accepted meta: {label}"
    assert nat["cid"] == py.correlation_id & _M64, label
    assert nat["attachment"] == py.attachment_size & _M64, label
    assert nat["compress"] == py.compress_type & _M64, label
    assert nat["timeout_ms"] == py.timeout_ms & _M64, label
    assert nat["error_code"] == py.error_code & 0xFFFFFFFF, label
    assert nat["is_response"] == py.is_response, label
    # trace context decodes field-exactly on both planes (the Python
    # decoder masks to u64 exactly like the C++ scanner's arithmetic)
    assert nat["log_id"] == py.log_id & _M64, label
    assert nat["trace_id"] == py.trace_id & _M64, label
    assert nat["span_id"] == py.span_id & _M64, label
    assert nat["parent_span_id"] == py.parent_span_id & _M64, label
    assert nat["sampled"] == py.sampled, label
    assert nat["svc"].decode("utf-8", errors="replace") == py.service_name, (
        label
    )
    assert nat["mth"].decode("utf-8", errors="replace") == py.method_name, (
        label
    )


class TestMetaScannerDifferential:
    def test_structured_request_metas_agree_exactly(self, pkg):
        rng = random.Random(0x12A)
        for _ in range(200):
            rm = pkg.baidu.RpcMeta(
                service_name="".join(
                    rng.choice("abcXYZ_09.") for _ in range(rng.randrange(1, 24))
                ),
                method_name="".join(
                    rng.choice("abcXYZ_09") for _ in range(rng.randrange(1, 24))
                ),
                compress_type=rng.choice([0, 1, 2, 3, 17, 0xFFFFFFFF]),
                correlation_id=rng.getrandbits(rng.choice([8, 32, 63, 64])),
                attachment_size=rng.choice([0, 1, 4096, 1 << 31]),
                timeout_ms=rng.choice([0, 1, 250, 1 << 31]),
            )
            blob = rm.encode()
            nat = _native_scan(pkg, blob)
            assert nat is not None, blob.hex()
            assert not nat["is_response"], blob.hex()
            _assert_agree(pkg, blob)

    def test_structured_response_metas_agree_exactly(self, pkg):
        rng = random.Random(0x12B)
        for _ in range(200):
            rm = pkg.baidu.RpcMeta(
                is_response=True,
                error_code=rng.choice([0, 1, 1007, (1 << 31) - 1]),
                error_text=rng.choice(["", "boom", "x" * 200]),
                correlation_id=rng.getrandbits(64),
                compress_type=rng.choice([0, 1, 2, 3]),
            )
            blob = rm.encode()
            nat = _native_scan(pkg, blob)
            assert nat is not None, blob.hex()
            assert nat["is_response"], blob.hex()
            _assert_agree(pkg, blob)

    def test_mutated_valid_metas_agree(self, pkg):
        # byte flips, truncations, insertions, splices of real metas —
        # the classic decoder-differential recipe
        rng = random.Random(0x12C)
        bases = [
            pkg.baidu.RpcMeta(
                service_name="EchoService",
                method_name="Echo",
                correlation_id=0x1122334455667788,
                attachment_size=64,
                compress_type=1,
                timeout_ms=1500,
            ).encode(),
            pkg.baidu.RpcMeta(
                is_response=True,
                error_code=1004,
                error_text="deadline",
                correlation_id=99,
            ).encode(),
            pkg.baidu.RpcMeta(
                service_name="s",
                method_name="m",
                authentication_data=b"tok\x00en",
            ).encode(),
        ]
        for _ in range(600):
            blob = bytearray(rng.choice(bases))
            for _ in range(rng.randrange(1, 4)):
                op = rng.randrange(4)
                if op == 0 and blob:  # flip
                    i = rng.randrange(len(blob))
                    blob[i] ^= 1 << rng.randrange(8)
                elif op == 1 and blob:  # truncate
                    del blob[rng.randrange(len(blob)):]
                elif op == 2:  # insert
                    blob.insert(
                        rng.randrange(len(blob) + 1), rng.getrandbits(8)
                    )
                else:  # splice a random run
                    junk = bytes(
                        rng.getrandbits(8) for _ in range(rng.randrange(1, 9))
                    )
                    at = rng.randrange(len(blob) + 1)
                    blob[at:at] = junk
            _assert_agree(pkg, bytes(blob))

    def test_random_streams_agree(self, pkg):
        rng = random.Random(0x12D)
        for _ in range(800):
            blob = bytes(
                rng.getrandbits(8) for _ in range(rng.randrange(0, 96))
            )
            _assert_agree(pkg, blob)

    def test_adversarial_shapes_agree(self, pkg):
        tag = pkg.baidu._tag
        varint = pkg.baidu._varint
        cases = [
            b"",  # empty meta: both accept, all defaults
            tag(1, 2) + varint((1 << 64) - 1),  # wrap-length submessage
            tag(1, 2) + varint(1 << 32) + b"x",  # length beyond buffer
            tag(4, 0) + b"\xff" * 10,  # overlong varint (11 bytes w/ key)
            tag(4, 0) + b"\xff" * 9 + b"\x01",  # 10-byte cid, bit 63
            tag(4, 0) + b"\x80" * 9 + b"\x7f",  # cid with bits beyond 64
            tag(3, 0) + varint(1 << 33),  # compress beyond u32 (native cap)
            tag(5, 0) + varint((1 << 31) + 1),  # attachment beyond clamp
            tag(1, 2)
            + varint(len(varint((1 << 31) + 1)) + 1)
            + tag(8, 0)
            + varint((1 << 31) + 1),  # timeout beyond clamp, in the sub
            tag(6, 1) + b"\x01" * 8,  # fixed64: skipped by both
            tag(6, 1) + b"\x01" * 7,  # truncated fixed64
            tag(6, 5) + b"\x01" * 4,  # fixed32
            tag(6, 5) + b"\x01",  # truncated fixed32
            tag(6, 3),  # group-start: rejected by both
            tag(6, 4),  # group-end
            b"\x0f",  # wire type 7
            tag(1, 2) + varint(2) + tag(1, 2) + varint(5),  # nested overrun
            tag(2, 2) + varint(2) + tag(1, 0) + b"\x80",  # sub truncated varint
            tag(7, 2) + varint(3) + b"a\x00b",  # auth with NUL
            tag(1, 2) + b"\x00",  # empty request sub
            tag(2, 2) + b"\x00" + tag(1, 2) + b"\x00",  # response + request
        ]
        for blob in cases:
            _assert_agree(pkg, blob)

    def test_traced_metas_agree_exactly(self, pkg):
        # structured metas with Dapper trace fields: the trace decode
        # branches ride the fast path, so the differential pins them
        # field-exact
        rng = random.Random(0x15A)
        for _ in range(300):
            rm = pkg.baidu.RpcMeta(
                service_name="TraceSvc",
                method_name="Echo",
                log_id=rng.choice([0, 1, rng.getrandbits(63)]),
                trace_id=rng.choice([0, 1, rng.getrandbits(63),
                                     rng.getrandbits(64)]),
                span_id=rng.choice([0, rng.getrandbits(64)]),
                parent_span_id=rng.choice([0, rng.getrandbits(63)]),
                sampled=rng.choice([0, 1]),
                correlation_id=rng.getrandbits(32),
            )
            blob = rm.encode()
            nat = _native_scan(pkg, blob)
            assert nat is not None, blob.hex()
            assert not nat["to_python"], (
                f"a traced meta fell off the fast path: {blob.hex()}"
            )
            _assert_agree(pkg, blob)

    def test_traced_meta_fuzz_huge_zero_duplicate_varints(self, pkg):
        # the satellite's adversarial trio — huge (overlong/10-byte)
        # trace varints, zero-valued fields, and DUPLICATED fields
        # (proto2 last-wins on both planes) — through the differential
        tag = pkg.baidu._tag
        varint = pkg.baidu._varint

        def sub(fields: bytes) -> bytes:
            return tag(1, 2) + varint(len(fields)) + fields

        cases = [
            # huge: 10-byte varints with bits at/beyond 64 (both planes
            # reduce mod 2^64)
            sub(tag(4, 0) + b"\xff" * 9 + b"\x01"),
            sub(tag(5, 0) + b"\x80" * 9 + b"\x7f"),
            sub(tag(3, 0) + b"\xff" * 9 + b"\x7f"),
            # overlong-but-small: non-minimal zero (wire-legal)
            sub(tag(4, 0) + b"\x80\x80\x80\x00"),
            # zero-valued trace fields: present but 0 — must NOT route
            # to Python (both the zero and the non-zero case are native)
            sub(tag(4, 0) + varint(0) + tag(5, 0) + varint(0)),
            sub(tag(9, 0) + varint(0)),
            # duplicates: last wins on both planes
            sub(tag(4, 0) + varint(111) + tag(4, 0) + varint(222)),
            sub(tag(5, 0) + varint(1) + tag(5, 0) + varint(0)),
            sub(tag(9, 0) + varint(1) + tag(9, 0) + varint(0)),
            # sampled with a huge value: both planes normalize to 1
            sub(tag(9, 0) + b"\xff" * 9 + b"\x01"),
            # trace fields with the WRONG wire type (fixed64/fixed32):
            # ignored by Python, to_python'd by the scanner — values 0
            sub(tag(4, 1) + b"\x01" * 8),
            sub(tag(5, 5) + b"\x01" * 4),
            # truncated trace varint: reject on both planes
            sub(tag(4, 0) + b"\x80"),
        ]
        for blob in cases:
            _assert_agree(pkg, blob)
        # the duplicate case decodes last-wins, pinned explicitly
        nat = _native_scan(pkg, cases[6])
        assert nat is not None and nat["trace_id"] == 222
        # and randomized trace-field soup
        rng = random.Random(0x15B)
        for _ in range(400):
            fields = b""
            for _ in range(rng.randrange(1, 6)):
                f = rng.choice([3, 4, 5, 6, 9])
                v = rng.choice([
                    0, 1, rng.getrandbits(7), rng.getrandbits(63),
                    rng.getrandbits(64),
                ])
                fields += tag(f, 0) + varint(v)
            _assert_agree(pkg, sub(fields))

    def test_native_stricter_rejects_are_exactly_the_caps(self, pkg):
        # the three documented clamps DO reject natively while Python
        # accepts — pinned so a future widening shows up here
        tag = pkg.baidu._tag
        varint = pkg.baidu._varint
        for blob in (
            tag(3, 0) + varint(1 << 33),
            tag(5, 0) + varint((1 << 31) + 1),
            tag(1, 2)
            + varint(len(varint((1 << 31) + 1)) + 1)
            + tag(8, 0)
            + varint((1 << 31) + 1),
        ):
            assert _native_scan(pkg, blob) is None, blob.hex()
            py = _python_scan(pkg, blob)
            assert py is not None and _native_stricter_cap(py), blob.hex()


class TestPumpHostileFrameCap:
    """Regression for a wire-bounds violation: the pump's tbus read path
    must reject a
    hostile claimed body_len instead of growing rbuf toward ~4 GiB."""

    def test_pump_rejects_oversized_body_claim(self, pkg):
        tbus_std = pkg.tbus

        hostile_header = struct.pack(
            "<8I",
            tbus_std.MAGIC,
            600 << 20,  # claimed body: beyond the 512 MiB client cap
            tbus_std.FLAG_RESPONSE,
            1, 0,  # cid lo/hi
            0, 0, 0,  # meta_len / crc / error
        )
        lst = socket.socket()
        lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lst.bind(("127.0.0.1", 0))
        lst.listen(1)
        port = lst.getsockname()[1]

        def serve():
            conn, _ = lst.accept()
            try:
                conn.recv(4096)  # whatever the pump sent first
                conn.sendall(hostile_header)
                # keep the conn open: without the cap the client would
                # sit in "wait for the full frame" until timeout
                conn.recv(4096)
            except OSError:
                pass
            finally:
                conn.close()

        th = threading.Thread(target=serve, daemon=True)
        th.start()
        nch = pkg.np.NativeClientChannel("127.0.0.1", port)
        try:
            with pytest.raises(OSError) as ei:
                nch.pump("svc", "echo", b"x", 4, inflight=2, timeout_ms=8000)
            import errno

            # -EPROTO promptly — NOT -ETIMEDOUT after buffering the claim
            assert ei.value.errno == errno.EPROTO
        finally:
            nch.close()
            lst.close()
            th.join(timeout=5)


# -- tests/test_parser_robustness.py's parse_conn case on both packages ----------


def _valid_seeds(pkg):
    return [
        pkg.tbus.pack_frame(pkg.tbus.Meta(service="s", method="m"), b"payload" * 10, 3),
        b"POST /a/b HTTP/1.1\r\nHost: t\r\nContent-Length: 5\r\n\r\nhello",
        b"GET /x HTTP/1.1\r\n\r\n",
        pkg.baidu.pack_request(pkg.tbus.Meta(service="svc", method="mth"), b"body", 7),
    ]


@pytest.mark.parametrize("seed", range(4))
def test_http_parse_conn_never_leaks_exceptions(pkg, seed):
    """The stateful pinned path (chunked decode) under garbage: only the
    contract exceptions may escape, and consumed is never negative; both
    packages answer every input alike (frame or not, consumed, and the
    exception's type)."""

    class FakeSock:
        def __init__(self):
            self.context = {}
            self.on_failed = []

    allowed = (pkg.tbus.ParseError, pkg.tbus.FatalParseError)
    rng = random.Random(2000 + seed)
    bases = _valid_seeds(pkg) + [
        b"POST /u HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n",
    ]
    for base in bases:
        for _ in range(25):
            data = bytearray(base)
            i = rng.randrange(len(data))
            if rng.random() < 0.5:
                data = data[:i]
            else:
                data[i] ^= 1 << rng.randrange(8)
            sock = FakeSock()
            buf = pkg.IOBuf()
            buf.append(bytes(data))
            for _round in range(2):
                try:
                    frame, consumed = pkg.http.parse_conn(sock, buf)
                except allowed:
                    break
                except Exception as e:  # noqa: BLE001
                    raise AssertionError(
                        f"parse_conn leaked {type(e).__name__}: {e!r} on {bytes(data)[:40]!r}"
                    ) from e
                assert consumed >= 0


def _conn_trace(pkg, data):
    """parse_conn over ``data`` in two windows: what it cut, or raised."""

    class FakeSock:
        def __init__(self):
            self.context = {}
            self.on_failed = []

    sock, buf, out = FakeSock(), pkg.IOBuf(), []
    buf.append(data)
    for _round in range(3):
        try:
            frame, consumed = pkg.http.parse_conn(sock, buf)
        except pkg.tbus.FatalParseError:
            out.append("fatal")
            break
        except pkg.tbus.ParseError:
            out.append("parse")
            break
        out.append((consumed, None if frame is None else (
            type(frame).__name__, getattr(frame, "path", None), getattr(frame, "status", None),
            frame.body if isinstance(frame.body, bytes) else None)))
    return out


def test_http_parse_conn_alike_on_both_packages():
    rng = random.Random(77)
    bases = _valid_seeds(PKGS["torch"]) + [
        b"POST /u HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n",
        b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n3\r\nabc\r\n0\r\n\r\n",
        b"HTTP/1.1 404 Not Found\r\nContent-Length: 3\r\n\r\nnah",
    ]
    for base in bases:
        for _ in range(60):
            data = bytearray(base)
            i = rng.randrange(len(data))
            if rng.random() < 0.5:
                data = data[:i]
            else:
                data[i] ^= 1 << rng.randrange(8)
            assert _conn_trace(PKGS["jax"], bytes(data)) == _conn_trace(PKGS["torch"], bytes(data))


def test_scanners_of_both_packages_agree():
    """The two packages' C++ scanners and Python decoders on one seeded set
    of fuzzed metas: the same verdict and the same fields."""
    rng = random.Random(0x23)
    base = PKGS["torch"].baidu.RpcMeta(
        service_name="EchoService", method_name="Echo", correlation_id=0x1122334455667788,
        attachment_size=64, compress_type=1, timeout_ms=1500, log_id=3, trace_id=9,
        authentication_data=b"tok",
    ).encode()
    for _ in range(500):
        blob = bytearray(base)
        for _ in range(rng.randrange(0, 4)):
            if blob and rng.random() < 0.5:
                blob[rng.randrange(len(blob))] ^= 1 << rng.randrange(8)
            else:
                blob.insert(rng.randrange(len(blob) + 1), rng.getrandbits(8))
        blob = bytes(blob)
        nat = [_native_scan(p, blob) for p in PKGS.values()]
        assert nat[0] == nat[1], blob.hex()
        py = [_python_scan(p, blob) for p in PKGS.values()]
        assert (py[0] is None) == (py[1] is None), blob.hex()
        if py[0] is not None:
            assert vars(py[0]) == vars(py[1]), blob.hex()


# -- both packages' servers answer one script of raw PRPC frames alike -----------

TOKEN = "twin-token"


def _script(pkg):
    """(label, wire) pairs, packed with ``pkg``'s own packers."""
    M, B, C = pkg.tbus.Meta, pkg.baidu, pkg.compress
    out = []

    def req(label, svc, mth, body, cid, att=b"", auth=TOKEN, codec=""):
        m = M(service=svc, method=mth, compress=codec)
        if auth:
            m.extra["auth"] = auth
        out.append((label, B.pack_request(m, C.compress(codec, body) if codec else body, cid,
                                          attachment=att)))

    req("native echo", "svc", "echo", b"payload" * 30, 1)
    req("native echo att", "svc", "echo", b"pp", 2, att=b"AT" * 100)
    req("native nop", "svc", "nop", b"ignored", 3)
    req("python echo", "svc", "pyecho", b"through python", 4, att=b"att")
    req("python error", "svc", "boom", b"", 5)
    req("unknown method", "svc", "nope", b"", 6)
    req("unknown service", "nosvc", "echo", b"", 7)
    for i, codec in enumerate(("snappy", "gzip", "zlib1")):
        req(f"native {codec}", "svc", "echo", b"compressible payload " * 100, 10 + i, codec=codec)
        req(f"python {codec}", "svc", "pyecho", b"compressible payload " * 100, 20 + i,
            codec=codec)
    req("wrong token", "svc", "echo", b"x", 30, auth="wrong")
    req("no token", "svc", "echo", b"x", 31, auth="")
    out.append(("wire-9", B.pack_frame(B.RpcMeta(service_name="svc", method_name="echo",
                                                 compress_type=9, correlation_id=32,
                                                 authentication_data=TOKEN.encode()), b"zz")))
    return out


def _answers(pkg, native):
    def boom(cntl, req):
        cntl.set_failed(ErrorCode.EINTERNAL, "twin boom")
        return b""

    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(
        native_plane=native, usercode_inline=True, auth=pkg.rpc.TokenAuthenticator([TOKEN]),
        **pkg.server_kw))
    srv.add_service("svc", {"echo": pkg.rpc.native_echo, "nop": pkg.rpc.native_nop,
                            "pyecho": lambda cntl, req: (setattr(
                                cntl, "response_attachment", cntl.request_attachment), req)[1],
                            "boom": boom})
    _OPEN.append(srv)
    assert srv.start(0)
    assert (srv._native_plane is not None) == native
    got = []
    for label, wire in _script(pkg):
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        try:
            s.sendall(wire)
            got.append((label, _read_prpc_frame(s)))
        finally:
            s.close()
    stats = srv._native_plane.stats() if native else None
    return got, stats


@pytest.mark.parametrize("native", [True, False], ids=["native_plane", "python_plane"])
def test_both_packages_answer_one_prpc_script_alike(native):
    jax_got, jax_stats = _answers(PKGS["jax"], native)
    port_got, port_stats = _answers(PKGS["torch"], native)
    assert [w for _l, w in _script(PKGS["jax"])] == [w for _l, w in _script(PKGS["torch"])]
    for (label, a), (_, b) in zip(jax_got, port_got):
        assert a == b, label
    if native:
        for key in ("native_reqs", "auth_rejects"):
            assert jax_stats[key] == port_stats[key], key
        assert port_stats["auth_rejects"] == 2
