"""Distributed tracing in the port (ROADMAP A12) on the CPU, held against the
JAX package's: the client and server spans of both planes, the native
telemetry drain's sampled spans, the head-based sampled bit, and the
session plane's session, step and chunk spans.

- ``tests/test_tracing.py`` on both packages (``pkg``): traced frames
  byte for byte (the native client's against ``baidu_std.pack_request``,
  the native and Python planes' answers), traced floods kept off the
  interpreter (``cb_frames == 0``; the traced pump within 2x of the bare
  one, the oracle's bound), coherent sampling (the wire's bit overrides the
  ring's election and a dry token bucket, forced records survive refused
  elected ones, the client decides the bit once), the trace index of the
  span store, the fleet assembly across two processes (the second node a
  subprocess of the same package; both nodes' spans read from
  ``/rpcz?trace_id=&json=1`` and ``span_from_dict``, where the JAX test
  uses ``tools/rpc_view``, ROADMAP A5), and ``/hotspots``' 503 with
  Retry-After and its clamped window;
- the traced frames of each package's Channel on tbus_std and baidu_std
  (Python route) and of the native client are byte-identical to the JAX
  package's packers given the same ids (the correlation id read back from
  the captured frame);
- interop both ways: a traced JAX-package client against a port server and
  the reverse leave the server span in the client's trace, parented to the
  client's span, on both wires;
- one seeded script of traced calls (a relay cascading to a second server,
  a caller continuing an external trace, the HTTP gateway, a traced call
  to a native-plane server, an error) gives the same span forest on both
  packages: kinds, parent links, annotations, method identity, sizes and
  error codes, with the ids relabelled by their place in the tree;
- the session plane: ``tests/test_mc_dispatch.py``'s
  ``test_party_spans_carry_proposer_trace`` and
  ``test_span_carries_method_identity``, ``tests/test_overlap.py``'s
  ``TestOverlapRpczProof`` (but the rpc_view case, ROADMAP A5), and a
  session proposed inside a traced caller's handler, whose parties' spans
  form one tree under the caller's server span.

Servers of the port run on ``ServerOptions(device="cpu")``; sessions use
party ids 1 and 2 on both packages (the JAX package's virtual CPU devices,
the port's row labels). Tolerance: none; every comparison is of integers,
strings or bytes."""

import json
import os
import random
import socket
import struct
import subprocess
import sys
import threading
import time

import pytest

import incubator_brpc_tpu.protocol.baidu_std as jax_baidu
import incubator_brpc_tpu.protocol.tbus_std as jax_tbus
from tests.test_torch_observability import (  # noqa: F401  (fixtures)
    _OPEN,
    PKGS,
    channel,
    clean_spans,
    fetch,
    nothing_outlives_the_test,
    pkg,
    server,
    tuned,
    wait_until,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRACE_META = dict(log_id=7, trace_id=0x1F00DBEEF, span_id=0xABCDEF, parent_span_id=0x77, sampled=1)


def native_server(pkg, services, **opts):
    opts.setdefault("usercode_inline", True)
    srv = server(pkg, services, native_plane=True, **opts)
    assert srv._native_plane is not None
    return srv


def read_frame(conn, protocol, buf=b""):
    """One whole tbus_std or baidu_std frame from ``conn``."""
    hdr = 32 if protocol == "tbus_std" else 12
    while True:
        if len(buf) >= hdr:
            body = (struct.unpack_from("<I", buf, 4)[0] if protocol == "tbus_std"
                    else struct.unpack(">I", buf[4:8])[0])
            if len(buf) >= hdr + body:
                return buf[:hdr + body]
        data = conn.recv(65536)
        assert data, "connection closed mid-frame"
        buf += data


def capture_request(send, protocol):
    """Start a listener that reads one request frame and closes; ``send(port)``
    issues the call. Returns the frame's bytes."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    got = {}

    def accept():
        conn, _ = lst.accept()
        conn.settimeout(10)
        try:
            got["raw"] = read_frame(conn, protocol)
        finally:
            conn.close()

    t = threading.Thread(target=accept)
    t.start()
    try:
        send(lst.getsockname()[1])
    finally:
        t.join(timeout=20)
        lst.close()
    return got["raw"]


# -- TestTracedWireByteIdentity ---------------------------------------------------------


def test_native_client_traced_request_matches_pack_request(pkg):
    def send(port):
        nch = pkg.np.NativeClientChannel("127.0.0.1", port, protocol="baidu_std")
        try:
            rc, _err, _m, _b = nch.call("svc", "echo", b"traced-payload", attachment=b"AT",
                                        timeout_ms=200, **TRACE_META)
            assert rc < 0  # nobody answered
        finally:
            nch.close()

    wire = capture_request(send, "baidu_std")
    rm = pkg.baidu.RpcMeta.decode(wire[12:12 + struct.unpack(">I", wire[8:12])[0]])
    assert (rm.trace_id, rm.span_id, rm.parent_span_id, rm.log_id, rm.sampled) == (
        TRACE_META["trace_id"], TRACE_META["span_id"], TRACE_META["parent_span_id"],
        TRACE_META["log_id"], 1)
    for baidu, tbus in ((pkg.baidu, pkg.tbus), (jax_baidu, jax_tbus)):
        expected = baidu.pack_request(
            tbus.Meta(service="svc", method="echo", timeout_ms=200, **TRACE_META),
            b"traced-payload", correlation_id=rm.correlation_id, attachment=b"AT")
        assert wire == expected


def test_native_and_python_servers_answer_traced_identically(pkg):
    req = pkg.baidu.pack_request(pkg.tbus.Meta(service="svc", method="echo", **TRACE_META),
                                 b"traced", correlation_id=55)

    def roundtrip(port):
        with socket.create_connection(("127.0.0.1", port)) as s:
            s.settimeout(10)
            s.sendall(req)
            return read_frame(s, "baidu_std")

    nsrv = native_server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
    native_resp = roundtrip(nsrv.port)
    stats = nsrv._native_plane.stats()
    assert stats["native_reqs"] >= 1 and stats["cb_frames"] == 0
    psrv = server(pkg, {"svc": {"echo": pkg.rpc.native_echo}}, usercode_inline=True)
    assert roundtrip(psrv.port) == native_resp


def test_traced_tbus_frame_stays_native(pkg):
    srv = native_server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
    ch = channel(pkg, srv, native_plane=True)
    cntl = pkg.rpc.Controller()
    cntl.trace_id, cntl.span_id, cntl.trace_sampled = 0x5151, 0x52, 1
    c = ch.call_method("svc", "echo", b"t", cntl=cntl)
    assert c.ok(), c.error_text
    stats = srv._native_plane.stats()
    assert stats["native_reqs"] >= 1 and stats["cb_frames"] == 0


@pytest.mark.parametrize("protocol", ["tbus_std", "baidu_std"])
def test_channel_traced_frames_are_the_jax_packers(pkg, protocol):
    """A Channel's traced request on the Python route, with the caller's
    ids preset, is the JAX package's packer output for those ids."""
    def send(port):
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{port}", options=pkg.rpc.ChannelOptions(protocol=protocol,
                                                                          max_retry=0))
        cntl = pkg.rpc.Controller(timeout_ms=2000)
        cntl.trace_id, cntl.span_id = TRACE_META["trace_id"], TRACE_META["span_id"]
        cntl.parent_span_id, cntl.trace_sampled = TRACE_META["parent_span_id"], 1
        cntl.log_id = TRACE_META["log_id"]
        assert ch.call_method("svc", "echo", b"traced-payload", cntl=cntl).failed()

    wire = capture_request(send, protocol)
    parse = jax_tbus.try_parse_frame if protocol == "tbus_std" else jax_baidu.try_parse_frame
    frame, _ = parse(wire)
    # the correlation id and the remaining budget (the propagated deadline)
    # are the call's own: read back from the wire
    meta = jax_tbus.Meta(service="svc", method="echo", timeout_ms=frame.meta.timeout_ms,
                         **TRACE_META)
    if protocol == "tbus_std":
        want = jax_tbus.pack_frame(meta, b"traced-payload", frame.correlation_id, flags=frame.flags)
    else:
        want = jax_baidu.pack_request(meta, b"traced-payload", correlation_id=frame.correlation_id)
    assert (frame.meta.trace_id, frame.meta.span_id, frame.meta.sampled) == (
        TRACE_META["trace_id"], TRACE_META["span_id"], 1)
    assert wire == want


# -- TestTracedFloodStaysNative -------------------------------------------------------------


def test_traced_pump_zero_cb_frames(pkg, tuned, clean_spans):
    tuned("enable_rpcz", True)
    srv = native_server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
    nch = pkg.np.NativeClientChannel("127.0.0.1", srv.port, protocol="baidu_std")
    try:
        nch.set_trace(trace_id=0xF00D, span_id=100, parent_span_id=9, sampled=1, every=1)
        nch.pump("svc", "echo", b"x" * 64, 3000, inflight=32)
    finally:
        nch.close()
    stats = srv._native_plane.stats()
    assert stats["native_reqs"] >= 3000 and stats["cb_frames"] == 0
    srv._native_plane.drain_telemetry()
    spans = clean_spans.by_trace(0xF00D)
    assert len(spans) > 100
    assert len({sp.parent_span_id for sp in spans}) == len(spans)


def test_traced_pump_close_to_bare_pump(pkg, tuned):
    tuned("enable_rpcz", False)
    srv = native_server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
    nch = pkg.np.NativeClientChannel("127.0.0.1", srv.port, protocol="baidu_std")
    # the oracle's pumps, bare then traced three times each, here in turns
    # (bare, traced, traced, bare, ...) on one channel, so a load change on
    # a shared host falls on both sides alike; the best of each is compared
    bare, traced = [], []
    try:
        nch.pump("svc", "echo", b"x" * 64, 2000, inflight=64)  # warm
        for traced_turn in (False, True, True, False, False, True):
            if traced_turn:
                nch.set_trace(trace_id=0xBEE, span_id=1, sampled=1, every=1)
            else:
                nch.set_trace(trace_id=0, every=0)
            ns = nch.pump("svc", "echo", b"x" * 64, 20000, inflight=64)
            (traced if traced_turn else bare).append(ns)
    finally:
        nch.close()
    bare, traced = min(bare), min(traced)
    assert srv._native_plane.stats()["cb_frames"] == 0
    assert traced < bare * 2.0, f"traced pump {traced:.0f} ns vs bare {bare:.0f} ns"


def test_set_trace_rejected_on_tbus_channel(pkg):
    srv = native_server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
    nch = pkg.np.NativeClientChannel("127.0.0.1", srv.port)
    try:
        with pytest.raises(ValueError):
            nch.set_trace(trace_id=1, every=1)
    finally:
        nch.close()


# -- TestCoherentSampling -------------------------------------------------------------------


def test_wire_sampled_bit_overrides_ring_election(pkg, tuned, clean_spans):
    tuned("enable_rpcz", True)
    tuned("native_telemetry_sample_every", 1_000_000)
    srv = native_server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
    nch = pkg.np.NativeClientChannel("127.0.0.1", srv.port, protocol="baidu_std")
    try:
        for i in range(50):
            rc, err, _m, _b = nch.call("svc", "echo", b"x", trace_id=0xCAFE, span_id=i + 1,
                                       sampled=1, timeout_ms=2000)
            assert rc >= 0 and err == 0
        for i in range(50):
            rc, err, _m, _b = nch.call("svc", "echo", b"x", trace_id=0xD00D, span_id=i + 1,
                                       timeout_ms=2000)
            assert rc >= 0 and err == 0
    finally:
        nch.close()
    srv._native_plane.drain_telemetry()
    assert len(clean_spans.by_trace(0xCAFE)) == 50
    assert len(clean_spans.by_trace(0xD00D)) == 0
    assert srv._native_plane.stats()["cb_frames"] == 0


def test_forced_records_survive_refused_elected_ones(pkg, tuned, clean_spans):
    tuned("enable_rpcz", True)
    tuned("native_telemetry_sample_every", 2)
    tuned("rpcz_samples_per_second", 0.000001)
    srv = native_server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
    nch = pkg.np.NativeClientChannel("127.0.0.1", srv.port, protocol="baidu_std")
    try:
        for i in range(20):
            rc, err, _m, _b = nch.call("svc", "echo", b"x", timeout_ms=2000)
            assert rc >= 0 and err == 0
            rc, err, _m, _b = nch.call("svc", "echo", b"x", trace_id=0xFACE, span_id=i + 1,
                                       sampled=1, timeout_ms=2000)
            assert rc >= 0 and err == 0
    finally:
        nch.close()
    srv._native_plane.drain_telemetry()
    assert len(clean_spans.by_trace(0xFACE)) == 20


class _Cntl:
    _request_payload = b""
    _service = "s"
    _method = "m"
    log_id = 0
    trace_id = 0
    span_id = 0
    parent_span_id = 0
    trace_sampled = 0


def test_server_span_forced_by_meta_sampled(pkg, tuned):
    rpcz = pkg.rpcz
    tuned("enable_rpcz", True)
    tuned("rpcz_samples_per_second", 0.000001)
    meta_plain = pkg.tbus.Meta(service="s", method="m", trace_id=5, span_id=6)
    meta_forced = pkg.tbus.Meta(service="s", method="m", trace_id=5, span_id=6, sampled=1)
    assert rpcz.start_server_span(_Cntl(), meta_plain) is None
    span = rpcz.start_server_span(_Cntl(), meta_forced)
    assert span is not None
    assert span.trace_id == 5 and span.parent_span_id == 6
    rpcz.clear_parent_span(span)


def test_client_span_decides_sampled_bit_once(pkg, tuned):
    rpcz = pkg.rpcz
    tuned("enable_rpcz", True)
    tuned("rpcz_samples_per_second", 10_000_000)
    time.sleep(0.01)
    c1 = _Cntl()
    span = rpcz.start_client_span(c1)
    assert span is not None and c1.trace_sampled == 1
    tuned("rpcz_samples_per_second", 0.000001)
    c2 = _Cntl()
    assert rpcz.start_client_span(c2) is None
    assert c2.trace_sampled == 0
    meta = pkg.tbus.Meta(service="s", method="m", trace_id=9, span_id=8, sampled=1)
    server_span = rpcz.start_server_span(_Cntl(), meta)
    assert server_span is not None
    try:
        c3 = _Cntl()
        assert rpcz.start_client_span(c3) is None
        assert c3.trace_sampled == 1
        assert c3.trace_id == 9
        assert c3.parent_span_id == server_span.span_id
    finally:
        rpcz.clear_parent_span(server_span)


# -- TestSpanStoreTraceIndex ----------------------------------------------------------------


def _span(pkg, trace, span_id, start=1):
    return pkg.rpcz.Span(trace_id=trace, span_id=span_id, start_real_us=start)


def test_index_tracks_submit_and_ring_eviction(pkg, tuned, clean_spans):
    tuned("rpcz_max_spans", 10)
    store = clean_spans
    for i in range(10):
        store.submit(_span(pkg, 1000 + i, i + 1))
    assert [sp.span_id for sp in store.by_trace(1000)] == [1]
    store.submit(_span(pkg, 2000, 99))
    assert store.by_trace(1000) == []
    assert [sp.span_id for sp in store.by_trace(2000)] == [99]
    for i in range(3):
        store.submit(_span(pkg, 3000, 200 + i))
    assert [sp.span_id for sp in store.by_trace(3000)] == [200, 201, 202]


def test_index_survives_maxlen_shrink_and_clear(pkg, tuned, clean_spans):
    store = clean_spans
    tuned("rpcz_max_spans", 100)
    for i in range(20):
        store.submit(_span(pkg, 7000, i + 1))
    tuned("rpcz_max_spans", 5)
    store.submit(_span(pkg, 7000, 500))
    assert [sp.span_id for sp in store.by_trace(7000)] == [17, 18, 19, 20, 500]
    store.clear()
    assert store.by_trace(7000) == []
    assert len(store) == 0


def test_index_matches_scan_semantics(pkg, tuned, clean_spans):
    rng = random.Random(99)
    tuned("rpcz_max_spans", 50)
    store = clean_spans
    for i in range(300):
        store.submit(_span(pkg, rng.randrange(1, 9), i + 1))
    with store._lock:
        ring = list(store._spans)
    for t in range(1, 9):
        assert store.by_trace(t) == [sp for sp in ring if sp.trace_id == t]
    assert store.by_trace(0) == []


# -- TestMultiHopFleetAssembly ----------------------------------------------------------------


def _start_node_b(pkg, tmp_path):
    """A second process running a native-plane echo server of ``pkg`` with
    rpcz on: the second live node of the fleet."""
    root = "incubator_brpc_tpu" if pkg.name == "jax" else "incubator_brpc_tpu_torch"
    opts = "" if pkg.name == "jax" else ", device='cpu'"
    script = tmp_path / "node_b.py"
    script.write_text(
        "import sys, time\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"from {root}.utils.flags import set_flag_unchecked\n"
        "set_flag_unchecked('enable_rpcz', True)\n"
        "set_flag_unchecked('native_telemetry_drain_ms', 20)\n"
        f"from {root}.rpc import Server, ServerOptions\n"
        f"from {root}.transport.native_plane import native_echo\n"
        f"srv = Server(ServerOptions(native_plane=True, usercode_inline=True{opts}))\n"
        "srv.add_service('svc', {'echo': native_echo})\n"
        "assert srv.start(0)\n"
        "print(srv.port, flush=True)\n"
        "sys.stdin.read()\n"
        "srv.stop()\n"
    )
    proc = subprocess.Popen([sys.executable, str(script)], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            env=dict(os.environ, JAX_PLATFORMS="cpu"), text=True)
    line = proc.stdout.readline().strip()
    assert line.isdigit(), "node B did not start"
    return proc, int(line)


def scrape_trace(pkg, port, trace_id):
    status, _, body = pkg.http.http_call("127.0.0.1", port, f"/rpcz?trace_id={trace_id:x}&json=1",
                                         timeout=10)
    assert status == 200
    return [pkg.rpcz.span_from_dict(d) for d in json.loads(body)]


def test_one_trace_across_two_processes(pkg, tmp_path, tuned, clean_spans):
    tuned("enable_rpcz", True)
    proc_b, port_b = _start_node_b(pkg, tmp_path)
    try:
        down = pkg.rpc.Channel()
        assert down.init(f"127.0.0.1:{port_b}",
                         options=pkg.rpc.ChannelOptions(native_plane=True, protocol="baidu_std"))

        def relay(cntl, request):
            c = down.call_method("svc", "echo", request)
            assert c.ok(), c.error_text
            return c.response_payload

        srv_a = server(pkg, {"front": {"relay": relay}}, usercode_inline=True)
        cntl = pkg.rpc.Controller(timeout_ms=10000)
        c = channel(pkg, srv_a).call_method("front", "relay", b"fleet", cntl=cntl)
        assert c.ok(), c.error_text
        trace_id = cntl.trace_id
        assert trace_id != 0
        spans_a = spans_b = []
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            spans_a = scrape_trace(pkg, srv_a.port, trace_id)
            spans_b = scrape_trace(pkg, port_b, trace_id)
            if spans_b and len(spans_a) >= 3:
                break
            time.sleep(0.1)
        assert spans_b, "node B never surfaced the traced hop"
        for sp in spans_a + spans_b:
            assert sp.trace_id == trace_id
        by_id = {sp.span_id: sp for sp in spans_a}
        assert [sp for sp in spans_a if sp.span_type == "client" and sp.parent_span_id in by_id]
        assert any(spans_b[0].parent_span_id == sp.span_id for sp in spans_a)
        lines = pkg.rpcz.render_trace_tree(spans_a + spans_b)
        assert lines[0].startswith(f"trace={trace_id:x}") and len(lines) == len(spans_a + spans_b)
        assert any(line.startswith("      ") and "server svc.echo" in line for line in lines)
    finally:
        proc_b.stdin.close()
        proc_b.wait(timeout=30)


# -- TestHotspotsRetry --------------------------------------------------------------------------


class _Frame:
    path = "/hotspots"
    query = {"seconds": "0.2"}
    method = "GET"
    headers = {}


def _hold_profile_lock(hotspots, hold_s, until_s):
    started = threading.Event()

    def hold():
        with hotspots._profile_lock:
            hotspots._profile_until = time.monotonic() + until_s
            started.set()
            time.sleep(hold_s)
        hotspots._profile_until = 0.0

    t = threading.Thread(target=hold)
    t.start()
    started.wait(5)
    return t


def test_profile_in_progress_is_503_with_retry(pkg):
    t = _hold_profile_lock(pkg.hotspots, 0.4, 0.5)
    try:
        resp = pkg.pages._hotspots(None, _Frame())
    finally:
        t.join()
    assert resp[0] == 503
    assert len(resp) == 4 and "Retry-After" in resp[3]
    assert int(resp[3]["Retry-After"]) >= 1


def test_seconds_clamped(pkg, monkeypatch):
    seen = {}

    def fake_sample(seconds):
        seen["seconds"] = seconds
        return {"samples": 0, "stacks": [], "flat": []}

    monkeypatch.setattr(pkg.hotspots, "sample_cpu", fake_sample)
    frame = _Frame()
    frame.query = {"seconds": "600"}
    assert pkg.pages._hotspots(None, frame)[0] == 200
    assert seen["seconds"] == 10.0
    frame.query = {"seconds": "nan"}
    assert pkg.pages._hotspots(None, frame)[0] == 400


def test_retry_after_header_reaches_the_wire(pkg):
    srv = native_server(pkg, {"svc": {"echo": pkg.rpc.native_echo}})
    t = _hold_profile_lock(pkg.hotspots, 0.8, 1.0)
    try:
        status, headers, _ = fetch(pkg, srv, "/hotspots?seconds=0.2")
    finally:
        t.join()
    assert status == 503
    assert "retry-after" in {k.lower() for k in headers}


# -- the same trace both ways, and one script on both packages ------------------------------------


@pytest.mark.parametrize("protocol", ["tbus_std", "baidu_std"])
@pytest.mark.parametrize("direction", ["jax-client-port-server", "port-client-jax-server"])
def test_traced_interop(direction, protocol):
    client_pkg, server_pkg = ((PKGS["jax"], PKGS["torch"]) if direction.startswith("jax")
                              else (PKGS["torch"], PKGS["jax"]))
    flags = [(p.flags, p.flags.flag_registry.get("enable_rpcz")) for p in PKGS.values()]
    for p in PKGS.values():
        p.flags.set_flag_unchecked("enable_rpcz", True)
        p.rpcz.span_store.clear()
    try:
        srv = server(server_pkg, {"svc": {"echo": lambda c, r: r}})
        ch = client_pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{srv.port}",
                       options=client_pkg.rpc.ChannelOptions(protocol=protocol))
        cntl = client_pkg.rpc.Controller()
        cntl.trace_id, cntl.trace_sampled = 0x7ACE, 1
        assert ch.call_method("svc", "echo", b"interop", cntl=cntl).ok()
        # the server ends its span after it wrote the answer
        assert wait_until(lambda: server_pkg.rpcz.span_store.by_trace(0x7ACE))
        client = client_pkg.rpcz.span_store.by_trace(0x7ACE)
        served = server_pkg.rpcz.span_store.by_trace(0x7ACE)
    finally:
        for f, v in flags:
            f.set_flag_unchecked("enable_rpcz", v)
        for p in PKGS.values():
            p.rpcz.span_store.clear()
    (cspan,) = client
    (sspan,) = served
    assert (cspan.span_type, sspan.span_type) == ("client", "server")
    assert sspan.parent_span_id == cspan.span_id == cntl.span_id
    assert (sspan.service, sspan.method, sspan.request_size) == ("svc", "echo", 7)
    assert [t for _, t in sspan.annotations] == ["processing"]


def canonical_forest(spans):
    """The span forest with every id replaced by its place in the tree: a
    sorted list of traces, each a sorted list of root trees, each node
    (type, service, method, error, sizes, annotation texts, children)."""
    by_trace = {}
    for sp in spans:
        by_trace.setdefault(sp.trace_id, []).append(sp)

    def node(sp, children):
        kids = sorted(node(c, children) for c in children.get(sp.span_id, ()))
        return (sp.span_type, sp.service, sp.method, sp.error_code, sp.request_size,
                sp.response_size, tuple(t for _, t in sp.annotations), tuple(kids))

    out = []
    for group in by_trace.values():
        ids = {sp.span_id for sp in group}
        children = {}
        for sp in group:
            if sp.parent_span_id in ids:
                children.setdefault(sp.parent_span_id, []).append(sp)
        out.append(tuple(sorted(node(sp, children) for sp in group if sp.parent_span_id not in ids)))
    return sorted(out)


def traced_script(pkg, seed):
    """One seeded script of traced calls; returns the spans it left."""
    rng = random.Random(seed)
    back = server(pkg, {"back": {"echo": lambda c, r: r,
                                 "fail": lambda c, r: c.set_failed(1003, "scripted") or b""}})
    down = channel(pkg, back, timeout_ms=30000)

    def relay(cntl, request):
        c = down.call_method("back", "echo", request)
        if c.failed():
            cntl.set_failed(c.error_code, c.error_text)
        return c.response_payload

    # the relay's handler blocks on its nested call: it runs on the worker
    # pool, never on a reactor that may own the nested call's connection
    front = server(pkg, {"front": {"relay": relay}})
    nat = native_server(pkg, {"nat": {"echo": pkg.rpc.native_echo}})
    edge = channel(pkg, front, timeout_ms=30000)
    direct = channel(pkg, back, protocol="baidu_std", timeout_ms=30000)
    nat_ch = channel(pkg, nat, native_plane=True, protocol="baidu_std", timeout_ms=30000)
    # untraced warm-up: every connection is up (a port reused from an
    # earlier test's server may leave a stale pooled connection to retire)
    # before rpcz turns on and the script's calls count
    pkg.flags.set_flag_unchecked("enable_rpcz", False)
    for ch, svc, method in ((edge, "front", "relay"), (down, "back", "echo"), (direct, "back", "echo"),
                            (nat_ch, "nat", "echo")):
        assert wait_until(lambda: ch.call_method(svc, method, b"warm").ok(), timeout=30)
    nat._native_plane.drain_telemetry()
    pkg.rpcz.span_store.clear()
    pkg.flags.set_flag_unchecked("enable_rpcz", True)
    for i in range(3):
        payload = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 64)))
        assert edge.call_method("front", "relay", payload).response_payload == payload
        cntl = pkg.rpc.Controller(timeout_ms=30000, log_id=i + 1)
        cntl.trace_id, cntl.span_id, cntl.trace_sampled = 0x5000 + i, 0x60 + i, 1
        assert direct.call_method("back", "echo", payload, cntl=cntl).ok()
        status, _, body = pkg.http.http_call("127.0.0.1", back.port, "/back/echo", method="POST",
                                             body=payload)
        assert (status, body) == (200, payload)
        cntl = pkg.rpc.Controller(timeout_ms=30000)
        cntl.trace_id, cntl.span_id, cntl.trace_sampled = 0x7000 + i, 0x70 + i, 1
        assert nat_ch.call_method("nat", "echo", payload, cntl=cntl).ok()
    assert edge.call_method("front", "relay", b"").ok()
    assert channel(pkg, back, timeout_ms=30000).call_method("back", "fail", b"boom").error_code == 1003
    nat._native_plane.drain_telemetry()
    # servers end their spans after they wrote the answer: 4 relays of 4
    # spans, 3 continued traces of 2, 3 gateway calls, 3 native calls of 2
    # and the error's 2
    assert wait_until(lambda: len(pkg.rpcz.span_store) == 4 * 4 + 3 * 2 + 3 + 3 * 2 + 2, timeout=30)
    return pkg.rpcz.span_store.recent(limit=10000)


def test_seeded_script_gives_the_same_span_forest():
    forests = {}
    for p in PKGS.values():
        saved = {k: p.flags.flag_registry.get(k) for k in (
            "enable_rpcz", "rpcz_samples_per_second", "native_telemetry_sample_every")}
        p.flags.set_flag_unchecked("enable_rpcz", True)
        p.flags.set_flag_unchecked("rpcz_samples_per_second", 10_000_000)
        p.flags.set_flag_unchecked("native_telemetry_sample_every", 1_000_000)
        p.rpcz.span_store.clear()
        try:
            forests[p.name] = canonical_forest(traced_script(p, seed=11))
        finally:
            for k, v in saved.items():
                p.flags.set_flag_unchecked(k, v)
            p.rpcz.span_store.clear()
            while _OPEN:
                srv = _OPEN.pop()
                srv.stop()
                srv.join(timeout=10)
    assert forests["jax"] == forests["torch"]
    # 3 relays (client, server, nested client, nested server) + the empty
    # one, 3 continued traces, 3 gateway calls, 3 native calls, one error
    assert len(forests["torch"]) == 4 + 3 + 3 + 3 + 1
    relay = [t for t in forests["torch"] if t[0][1:3] == ("front", "relay")]
    assert len(relay) == 4 and all(len(t) == 1 for t in relay)


def test_seeded_id_generator_reproduces_ids(pkg):
    """The port draws its ids from the generator set_id_rng names; the
    JAX package from ``random``'s global one: both seeded alike, they draw
    the same ids."""
    if pkg.name == "jax":
        random.seed(1234)
        ids = [pkg.rpcz._new_id() for _ in range(4)]
    else:
        old = pkg.rpcz.set_id_rng(random.Random(1234))
        try:
            ids = [pkg.rpcz._new_id() for _ in range(4)]
        finally:
            pkg.rpcz.set_id_rng(old)
    gen = random.Random(1234)
    assert ids == [gen.getrandbits(63) | 1 for _ in range(4)]


# -- the session plane ---------------------------------------------------------------------------


@pytest.fixture
def scale(pkg):
    """("dsvc", "scale") registered chunk-safe in the package's registry."""
    dmod = sys.modules[f"{pkg.rpc.__name__}.device_method"]
    dm = dmod.DeviceMethod(pkg.worker._scale_psum_kernel, width=pkg.worker.SESSION_WIDTH,
                           chunkable=True)
    prev = dmod.lookup_device_method("dsvc", "scale")
    dmod.register_device_method("dsvc", "scale", dm)
    yield dm
    if prev is not None:
        dmod.register_device_method("dsvc", "scale", prev)
    else:
        dmod.unregister_device_method("dsvc", "scale")


def session_servers(pkg, n):
    out = []
    for i in range(n):
        srv = server(pkg, {"dsvc": {"scale": pkg.rpc.device_method(
            pkg.worker._scale_psum_kernel, width=pkg.worker.SESSION_WIDTH, chunkable=True)}},
            device_index=1 + i, usercode_inline=True, enable_collective_service=True,
            collective_max_concurrency=0)
        out.append(srv)
    return out


OPS = [bytes(range(40)), bytes(range(100, 180))]


def test_party_spans_carry_proposer_trace(pkg, scale, tuned, clean_spans):
    tuned("enable_rpcz", True)
    chans = [channel(pkg, s) for s in session_servers(pkg, 2)]
    out = pkg.mcd.propose_dispatch(chans, [1, 2], "dsvc", "scale", OPS, steps=2,
                                   proposer_index=None, timeout_ms=60000)
    assert out["final_steps"] == 2
    collective = [sp for sp in clean_spans.recent(limit=1000) if sp.span_type == "collective"]
    assert len(collective) >= 2
    traces = {sp.trace_id for sp in collective}
    assert len(traces) == 1 and 0 not in traces


def test_span_carries_method_identity(pkg, scale, tuned, clean_spans):
    tuned("enable_rpcz", True)
    chans = [channel(pkg, s) for s in session_servers(pkg, 1)]
    pkg.mcd.propose_dispatch(chans, [0, 1], "dsvc", "scale",
                             [b"x" * 8, b"y" * 8], steps=1, proposer_index=0, timeout_ms=60000,
                             **({"device": "cpu"} if pkg.name == "torch" else {}))
    spans = [s for s in clean_spans.recent(limit=500) if s.span_type == "collective"]
    assert spans
    notes = " ".join(text for s in spans for _, text in s.annotations)
    assert "method=dsvc.scale" in notes
    assert "fingerprint=" in notes


def _overlap_session(pkg, double_buffer, steps=4):
    chans = [channel(pkg, s) for s in session_servers(pkg, 2)]
    out = pkg.mcd.propose_dispatch(chans, [1, 2], "dsvc", "scale", OPS, steps=steps,
                                   proposer_index=None, timeout_ms=60000, chunks=4,
                                   double_buffer=double_buffer)
    assert out["results"] == pkg.worker.session_expected(OPS, steps)


def _session_spans(store):
    return [sp for sp in store.recent(limit=10000)
            if any(t.startswith(("chunk=", "compute step=")) for _off, t in sp.annotations)]


def test_double_buffered_chunks_overlap_next_compute(pkg, scale, tuned, clean_spans):
    tuned("enable_rpcz", True)
    tuned("rpcz_samples_per_second", 1_000_000)
    _overlap_session(pkg, double_buffer=True)
    spans = _session_spans(clean_spans)
    assert spans
    by_id = {sp.span_id: sp for sp in spans}
    computes = {}
    for sp in spans:
        for _off, t in sp.annotations:
            m = pkg.rpcz._COMPUTE_ANN_RE.match(t)
            if m:
                computes[(sp.parent_span_id, int(m.group(1)))] = (
                    sp.start_real_us, sp.start_real_us + sp.latency_us)
    overlapped = 0
    for sp in spans:
        for _off, t in sp.annotations:
            m = pkg.rpcz._CHUNK_ANN_RE.match(t)
            if not m:
                continue
            parent = by_id.get(sp.parent_span_id)
            party = parent.parent_span_id if parent is not None else 0
            nxt = computes.get((party, int(m.group(3)) + 1))
            if nxt and min(sp.start_real_us + sp.latency_us, nxt[1]) - max(sp.start_real_us, nxt[0]) > 0:
                overlapped += 1
    assert overlapped > 0
    report = pkg.rpcz.overlap_report(spans)
    assert report and report[-1].endswith("OVERLAPPED")


def test_serialized_schedule_reads_serialized(pkg, scale, tuned, clean_spans):
    tuned("enable_rpcz", True)
    tuned("rpcz_samples_per_second", 1_000_000)
    _overlap_session(pkg, double_buffer=False)
    spans = _session_spans(clean_spans)
    assert spans
    report = pkg.rpcz.overlap_report(spans)
    assert report and report[-1].endswith("SERIALIZED")


def test_overlap_report_unit(pkg):
    def mk(start, lat, ann):
        sp = pkg.rpcz.Span(start_real_us=start, latency_us=lat)
        sp.annotations.append((0.0, ann))
        return sp

    base = [mk(1000, 100, "compute step=0/2 chunks=2 schedule=double_buffer"),
            mk(1200, 100, "compute step=1/2 chunks=2 schedule=double_buffer")]
    report = pkg.rpcz.overlap_report(base + [mk(1050, 200, "chunk=0/2 step=0")])
    assert any("overlapped" in line for line in report)
    assert report[-1].endswith("OVERLAPPED")
    report = pkg.rpcz.overlap_report(base + [mk(1050, 100, "chunk=0/2 step=0")])
    assert any("serialized" in line for line in report)
    assert report[-1].endswith("SERIALIZED")
    assert pkg.rpcz.overlap_report([mk(0, 1, "plain annotation")]) == []


def test_session_inside_a_traced_caller_is_one_tree(pkg, scale, tuned, clean_spans):
    """A caller with its own trace asks a server to run a session: the
    session's control RPCs, every party's session span and its step and
    chunk spans join the caller's trace, in one tree under the handler's
    server span."""
    tuned("enable_rpcz", True)
    tuned("rpcz_samples_per_second", 1_000_000)
    chans = [channel(pkg, s) for s in session_servers(pkg, 2)]

    def run(cntl, request):
        out = pkg.mcd.propose_dispatch(chans, [1, 2], "dsvc", "scale", OPS, steps=2,
                                       proposer_index=None, timeout_ms=60000, chunks=2,
                                       double_buffer=True)
        return json.dumps(out["final_steps"]).encode()

    front = server(pkg, {"sess": {"run": run}})
    cntl = pkg.rpc.Controller(timeout_ms=60000)
    cntl.trace_id, cntl.trace_sampled = 0x5E55, 1
    assert channel(pkg, front).call_method("sess", "run", b"", cntl=cntl).response_payload == b"2"

    def read():
        spans = clean_spans.by_trace(0x5E55)
        lines = pkg.rpcz.render_trace_tree(spans)
        roots = [ln for ln in lines if not ln.startswith(" ")]
        notes = [t for sp in spans if sp.span_type == "collective" for _, t in sp.annotations]
        # one session span per party (a pure scheduler's audit span is index=-1)
        counts = (sum(t.startswith("method=dsvc.scale") and " index=-1 " not in t for t in notes),
                  sum(t.startswith("compute step=") for t in notes),
                  sum(t.startswith("chunk=") for t in notes))
        return lines, roots, counts

    # a server ends its span after it wrote the answer: wait (10 s at most)
    # for every server span, or a child's parent is missing from the tree
    deadline = time.monotonic() + 10
    lines, roots, counts = read()
    while (len(roots) != 1 or counts != (2, 2 * 2, 2 * 2 * 2)) and time.monotonic() < deadline:
        time.sleep(0.01)
        lines, roots, counts = read()
    assert len(roots) == 1 and " client sess.run " in roots[0]
    assert lines[1].startswith("  ") and " server sess.run " in lines[1]
    assert counts == (2, 2 * 2, 2 * 2 * 2)
