"""Framed thrift (``protocol/thrift.py``) of the port on the CPU, held against
the JAX package's:

- ``tests/test_thrift.py``'s 15 cases on both packages (the codec on
  hand-built frames, the seqid-matched client against the mock, malformed
  lengths, ``ServerOptions(thrift_service=...)`` on the shared port);
- the bytes: seeded calls, replies and exceptions pack to the same frames
  in both packages, and each package's cut and server header read them
  alike at every prefix length;
- interop over TCP both ways: each package's ``ThriftClient`` against the
  other's server and mock;
- the registry: both packages register thrift's server row, gated on the
  option, in the same place of the scan;
- the native plane: a thrift call to a ``native_plane=True`` server is
  handed to the Python plane and answered there, the C++ dispatch counting
  none of it;
- ``chip_smoke.py``'s phase 3m at a small scale on the CPU.

The port's servers run on ``ServerOptions(device="cpu")``. After each test
the port's host plane is shut down and no ``tbtorch-*`` thread is left.
Tolerance: none; every comparison is of bytes, integers or strings."""

from __future__ import annotations

import struct
import threading
import types

import numpy as np
import pytest

import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu_torch.rpc as port_rpc
from incubator_brpc_tpu.protocol import registry as jax_registry
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu.protocol import thrift as jax_tt
from incubator_brpc_tpu.utils import status as jax_status
from incubator_brpc_tpu_torch.protocol import registry as port_registry
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.protocol import thrift as port_tt
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.utils import status as port_status

PKGS = {
    "jax": types.SimpleNamespace(name="jax", rpc=jax_rpc, tt=jax_tt, registry=jax_registry,
                                 ParseError=jax_tbus.ParseError, ErrorCode=jax_status.ErrorCode,
                                 package="incubator_brpc_tpu", server_kw={}),
    "torch": types.SimpleNamespace(name="torch", rpc=port_rpc, tt=port_tt, registry=port_registry,
                                   ParseError=port_tbus.ParseError,
                                   ErrorCode=port_status.ErrorCode,
                                   package="incubator_brpc_tpu_torch",
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


def thrift_service(pkg):
    def service(cntl, method, payload):
        if method == "echo":
            return payload
        if method == "upper":
            return payload.upper()
        cntl.set_failed(pkg.ErrorCode.ENOMETHOD, f"unknown method {method}")
        return b""
    return service


# -- tests/test_thrift.py on both packages -------------------------------------


class TestCodec:
    def test_call_roundtrip(self, pkg):
        tt = pkg.tt
        frame = tt.pack_call("echo", b"payload", 7)
        msg, consumed = tt.parse_frame(frame)
        assert consumed == len(frame)
        assert msg["type"] == tt.T_CALL
        assert msg["method"] == "echo"
        assert msg["seqid"] == 7
        assert msg["payload"] == b"payload"

    def test_reply_and_exception(self, pkg):
        tt = pkg.tt
        msg, _ = tt.parse_frame(tt.pack_reply("m", b"out", 3))
        assert msg["type"] == tt.T_REPLY and msg["payload"] == b"out"
        msg, _ = tt.parse_frame(tt.pack_exception("m", "boom", 3, type_id=6))
        assert isinstance(msg["error"], tt.TApplicationException)
        assert msg["error"].type_id == 6

    def test_incomplete_frames(self, pkg):
        frame = pkg.tt.pack_call("echo", b"x" * 100, 1)
        for cut in (0, 2, 10, len(frame) - 1):
            assert pkg.tt.parse_frame(frame[:cut]) == (None, -1)

    def test_bad_version_raises(self, pkg):
        body = struct.pack(">I", 0xDEAD0001) + b"junk"
        with pytest.raises(pkg.tt.ThriftError):
            pkg.tt.parse_frame(struct.pack(">i", len(body)) + body)

    def test_unknown_field_skipped(self, pkg):
        tt = pkg.tt
        # a reply with an extra i32 field 5 before the result field
        body = (
            struct.pack(">I", tt.VERSION_1 | tt.T_REPLY)
            + struct.pack(">i", 1) + b"m"
            + struct.pack(">i", 9)
            + struct.pack(">bh", tt.TT_I32, 5) + struct.pack(">i", 42)
            + struct.pack(">bh", tt.TT_STRING, 0) + struct.pack(">i", 2) + b"ok"
            + struct.pack(">b", tt.TT_STOP)
        )
        frame = struct.pack(">i", len(body)) + body
        msg, consumed = tt.parse_frame(frame)
        assert consumed == len(frame)
        assert msg["payload"] == b"ok"


@pytest.fixture
def pair(pkg):
    srv = pkg.tt.MockThriftServer()
    assert srv.start()
    client = pkg.tt.ThriftClient(f"127.0.0.1:{srv.port}")
    yield srv, client
    client.close()
    srv.stop()


class TestClient:
    def test_echo_roundtrip(self, pair):
        _, c = pair
        assert c.call("echo", b"hello-thrift") == b"hello-thrift"

    def test_unknown_method_raises(self, pkg, pair):
        _, c = pair
        with pytest.raises(pkg.tt.TApplicationException):
            c.call("nosuch", b"")

    def test_concurrent_calls_matched_by_seqid(self, pair):
        _, c = pair
        errs = []

        def worker(i):
            try:
                for j in range(25):
                    body = b"t%d-%d" % (i, j)
                    assert c.call("echo", body) == body
            except Exception as e:  # pragma: no cover
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs


class TestMalformedFrames:
    def test_negative_string_length_raises(self, pkg):
        # frame: version|T_REPLY, method "m", seqid, then a field header
        # claiming a string with negative length — must raise, not loop
        body = (
            struct.pack(">I", pkg.tt.VERSION_1 | 2)
            + struct.pack(">i", 1)
            + b"m"
            + struct.pack(">i", 7)
            + struct.pack(">bh", 11, 0)  # TT_STRING, fid 0
            + struct.pack(">i", -5)  # poisoned length
        )
        buf = struct.pack(">i", len(body)) + body
        with pytest.raises(pkg.tt.ThriftError):
            pkg.tt.parse_frame(buf)

    def test_overlong_skip_length_raises(self, pkg):
        body = (
            struct.pack(">I", pkg.tt.VERSION_1 | 2)
            + struct.pack(">i", 1)
            + b"m"
            + struct.pack(">i", 7)
            + struct.pack(">bh", 11, 9)  # unknown fid → skipped
            + struct.pack(">i", 1 << 20)  # claims 1MiB that isn't there
        )
        buf = struct.pack(">i", len(body)) + body
        with pytest.raises(pkg.tt.ThriftError):
            pkg.tt.parse_frame(buf)


class TestThriftServer:
    """ServerOptions.thrift_service (reference ThriftService +
    ProcessThriftRequest thrift_protocol.cpp:314): framed thrift served on
    the shared port next to tbus_std."""

    @pytest.fixture
    def thrift_server(self, pkg):
        return server(pkg, {"svc": {"echo": lambda cntl, req: req}}, usercode_inline=True,
                      thrift_service=thrift_service(pkg))

    def test_call_through_real_server(self, pkg, thrift_server):
        c = pkg.tt.ThriftClient(f"127.0.0.1:{thrift_server.port}")
        assert c.call("echo", b"framed") == b"framed"
        assert c.call("upper", b"abc") == b"ABC"
        c.close()

    def test_unknown_method_maps_to_exception(self, pkg, thrift_server):
        c = pkg.tt.ThriftClient(f"127.0.0.1:{thrift_server.port}")
        with pytest.raises(pkg.tt.TApplicationException) as ei:
            c.call("nope", b"x")
        assert ei.value.type_id == 1  # UNKNOWN_METHOD
        c.close()

    def test_thrift_and_tbus_share_the_port(self, pkg, thrift_server):
        c = pkg.tt.ThriftClient(f"127.0.0.1:{thrift_server.port}")
        assert c.call("echo", b"t") == b"t"
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{thrift_server.port}")
        r = ch.call_method("svc", "echo", b"b")
        assert r.ok() and r.response_payload == b"b"
        c.close()

    def test_no_service_rejects_thrift_bytes(self, pkg):
        srv = server(pkg, {"svc": {"echo": lambda cntl, req: req}}, usercode_inline=True)
        c = pkg.tt.ThriftClient(f"127.0.0.1:{srv.port}")
        with pytest.raises((pkg.tt.ThriftError, TimeoutError)):
            c.call("echo", b"x", timeout=2)
        c.close()

    def test_registered_without_explicit_import(self, pkg):
        # the package __init__ must register the server protocol: apps
        # construct ServerOptions(thrift_service=...) without importing
        # protocol.thrift themselves
        __import__(f"{pkg.package}.protocol")
        assert "thrift" in pkg.registry.protocol_registry


# -- the bytes -------------------------------------------------------------------


def _blob(rng, hi):
    return rng.integers(0, 256, int(rng.integers(0, hi)), dtype=np.uint8).tobytes()


def _method(rng):
    return rng.integers(97, 123, int(rng.integers(1, 12)), dtype=np.uint8).tobytes().decode()


def seeded_frames(seed=28, n=40):
    """(kind, args) of seeded calls, replies and exceptions."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        seqid = int(rng.integers(-(1 << 31), 1 << 31))
        out.append(("pack_call", (_method(rng), _blob(rng, 600), seqid)))
        out.append(("pack_reply", (_method(rng), _blob(rng, 600), seqid)))
        out.append(("pack_exception", (_method(rng), _method(rng), seqid,
                                       int(rng.integers(0, 11)))))
    return out


def _msg(msg):
    if msg is None:
        return None
    err = msg.get("error")
    rest = {k: v for k, v in msg.items() if k != "error"}
    return rest, (str(err), err.type_id) if err is not None else None


def test_frames_identical_across_packages():
    for kind, args in seeded_frames():
        wire = getattr(jax_tt, kind)(*args)
        assert getattr(port_tt, kind)(*args) == wire
        for cut in sorted({0, 3, 4, 5, 6, 7, 12, len(wire) - 1, len(wire)}):
            part = wire[:cut]
            j, jn = jax_tt.parse_frame(part)
            p, pn = port_tt.parse_frame(part)
            assert pn == jn and _msg(p) == _msg(j)
            try:
                want = jax_tt._server_parse_header(part)
            except jax_tbus.ParseError:
                with pytest.raises(port_tbus.ParseError):
                    port_tt._server_parse_header(part)
            else:
                assert port_tt._server_parse_header(part) == want
        assert jn == len(wire)


def test_server_cut_refuses_what_the_jax_packages_does():
    """The server's cut takes only CALLs, and both packages refuse a reply,
    a foreign version word and an impossible length alike."""
    call = jax_tt.pack_call("echo", b"x", 5)
    j, jn = jax_tt._server_try_parse(call)
    p, pn = port_tt._server_try_parse(call)
    assert (pn, p.method, p.seqid, p.payload) == (jn, j.method, j.seqid, j.payload)
    assert p.wire_protocol == j.wire_protocol == "thrift" and not p.is_response

    def outcome(fn, err, arg):
        try:
            return fn(arg)
        except err:
            return "refused"

    # a reply (refused by the cut), a foreign version word (by the header),
    # an impossible length (by both)
    for bad, refused_by in ((jax_tt.pack_reply("echo", b"x", 5), ("cut",)),
                            (b"\x00\x00\x00\x08\x12\x34\x00\x00", ("header",)),
                            (b"\xff\xff\xff\xff\x80\x01\x00\x01", ("cut", "header"))):
        for what, name in (("cut", "_server_try_parse"), ("header", "_server_parse_header")):
            j = outcome(getattr(jax_tt, name), jax_tbus.ParseError, bad)
            p = outcome(getattr(port_tt, name), port_tbus.ParseError, bad)
            assert (p == "refused") == (j == "refused") == (what in refused_by)


# -- interop over TCP both ways ------------------------------------------------


@pytest.mark.parametrize("client,srv_pkg", [("torch", "jax"), ("jax", "torch")],
                         ids=["port-client-jax-server", "jax-client-port-server"])
def test_interop_both_ways(client, srv_pkg):
    cp, sp = PKGS[client], PKGS[srv_pkg]
    srv = server(sp, {"svc": {"echo": lambda cntl, req: req}}, usercode_inline=True,
                 thrift_service=thrift_service(sp))
    mock = sp.tt.MockThriftServer()
    assert mock.start()
    try:
        rng = np.random.default_rng(31)
        for port in (srv.port, mock.port):
            c = cp.tt.ThriftClient(f"127.0.0.1:{port}")
            for _ in range(8):
                body = _blob(rng, 4000)
                assert c.call("echo", body) == body
            with pytest.raises(cp.tt.TApplicationException) as ei:
                c.call("nosuch", b"x")
            assert ei.value.type_id == 1
            c.close()
    finally:
        mock.stop()


# -- the registry ------------------------------------------------------------------


def test_registry_order_is_the_jax_packages():
    """mongo then thrift, between nshead and rtmp (then the legacy
    family), each with its option gate: the JAX package's order, the scan's
    order."""
    jax_names = [p.name for p in jax_registry.protocol_registry.ordered()]
    port_names = [p.name for p in port_registry.protocol_registry.ordered()]
    assert port_names == [name for name in jax_names if name in port_names]
    i = port_names.index("nshead")
    assert port_names[i + 1:i + 4] == ["mongo", "thrift", "rtmp"]
    assert port_names[i + 4] == "hulu_pbrpc"
    for name in ("mongo", "thrift"):
        row = port_registry.protocol_registry.get(name)
        assert row.enabled_for is not None and row.process_request is not None
        assert row.pack_request is None and row.pack_response is None


# -- the native plane ----------------------------------------------------------------


def test_native_plane_hands_thrift_off(pkg):
    """A thrift connection to a native-plane server is handed to the Python
    plane (its first four bytes, the frame length, are neither tbus_std's
    nor baidu_std's magic) and answered there; the C++ dispatch counts
    none of it."""
    srv = server(pkg, {"svc": {"echo": lambda cntl, req: req}}, native_plane=True,
                 thrift_service=thrift_service(pkg))
    plane = srv._native_plane
    assert plane is not None
    before = plane.stats()
    c = pkg.tt.ThriftClient(f"127.0.0.1:{srv.port}")
    assert c.call("upper", b"handed-off") == b"HANDED-OFF"
    assert c.call("echo", b"x" * 5000) == b"x" * 5000
    c.close()
    after = plane.stats()
    assert after["native_reqs"] == before["native_reqs"]
    assert after["handoffs"] - before["handoffs"] == 1


# -- chip_smoke.py's phase 3m on the CPU ---------------------------------------


def test_chip_smoke_phase_3m_on_the_cpu():
    """Phase 3m's parts (a)-(d) at a small scale on the CPU: every echo over
    thrift, mongo and tbus_std bitwise ``expected()``, each wire's frames
    counted by its server equal to the calls made (no fallback to
    tbus_std), the native plane's two handoffs, the cache clients' replies
    checked, and no launch counted (no card). Its counts are of calls and
    frames, never of time."""
    import torch

    import chip_smoke
    from incubator_brpc_tpu_torch.ops import kernels

    out, k1 = chip_smoke.cache_thrift_mongo_phase(torch, kernels, device="cpu", scale=0.1)
    assert set(k1) == set("abc")
    assert all(row == {"frame_rows": 0, "verify_rows": 0, "echo_step_rows": 0}
               for row in k1.values())
    calls = chip_smoke.CACHE_TURNS * chip_smoke.CACHE_SEQ_MIN
    burst = chip_smoke.CACHE_BURST[0] * chip_smoke.CACHE_BURST_MIN
    for part, wires in (("a", ("thrift", "tbus_std")), ("b", ("mongo", "tbus_std"))):
        assert set(out[part]) == set(wires)
        for wire in wires:
            row = out[part][wire]
            assert row["calls"] == row["right"] == calls
            assert row["burst_calls"] == row["burst_right"] == burst
            assert row["server_frames"] == row["calls"] + row["burst_calls"], (part, wire)
    c = out["c"]
    assert c["thrift_right"] and c["mongo_right"]
    assert c["handoffs"] == 2 and c["native_reqs_moved"] == 0
    d = out["d"]
    assert d["redis"]["replies_right"] == d["redis"]["batches"] * chip_smoke.CACHE_PIPELINE
    assert d["memcache"]["replies_right"] == d["memcache"]["calls"] > 0
    assert d["memcache_binary"]["replies_right"] == d["memcache_binary"]["calls"] > 0
    assert d["redis"]["auth_refused"] and d["memcache_binary"]["auth_refused"]
