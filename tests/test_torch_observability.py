"""The observability layer of the port (ROADMAP A12: ``builtin/rpcz.py``,
``builtin/prometheus.py``, ``builtin/portal.py``, ``builtin/pages.py``, the
span hooks of the channel, the server, the native plane's telemetry drain
and the session plane) on the CPU, held against the JAX package's.

``tests/test_observability.py`` runs here on both packages (``pkg``), but
for ``TestRpcViewMetrics``, whose tool waits for ROADMAP A5: the exposition
rendering (counters, gauges, summaries, escaping, the numeric flag mirror),
the live ``/brpc_metrics`` scrape (typed, by prefix, under load), the
device link's bvars on a ``transport="tpu"`` channel, the collective
service's opt-in and its session span parented into the proposing RPC,
the async-response reap, the lazy stream payload, the native telemetry
ring (pure-native floods summarised, spans sampled at the configured
rate, the limiter moved, the ring's overflow dropped and counted), the
span store's reload, persistence and retention, and the ``/rpcz``
queries (the trace tree, latency order, errors only, JSON, bad values).
The validator of the exposition is the JAX test's ``validate_exposition``.

Beyond the oracle: the scrape pages (``/vars``, ``/vars.json``,
``/vars/series.json``, ``/status``, ``/flags``, ``/connections``,
``/sockets``, ``/fibers``, ``/ids``, ``/protobufs``, ``/circuit_breakers``,
``/threads``, ``/vlog``) name the served method on both packages, the
process-wide native gauges sum every live plane, and a span's dictionary
written by one package's store is read back by the other's loader.

This file also holds the harness the other two A12 files import
(``PKGS``, ``pkg``, ``tuned``, ``clean_spans``, the cleanup fixture). The
servers of the port run on ``ServerOptions(device="cpu")``. Each test stops
and joins what it started, and after each the port's host plane is shut
down and no ``tbtorch-*`` thread is left. Tolerance: none; every comparison
is of integers, strings or bytes."""

import json
import threading
import time
import types

import numpy as np
import pytest

import incubator_brpc_tpu.builtin.hotspots as jax_hotspots
import incubator_brpc_tpu.builtin.pages as jax_pages
import incubator_brpc_tpu.builtin.prometheus as jax_prom
import incubator_brpc_tpu.builtin.rpcz as jax_rpcz
import incubator_brpc_tpu.bvar as jax_bvar
import incubator_brpc_tpu.iobuf as jax_iobuf
import incubator_brpc_tpu.parallel.mc_collective as jax_mcc
import incubator_brpc_tpu.parallel.mc_dispatch as jax_mcd
import incubator_brpc_tpu.protocol.baidu_std as jax_baidu
import incubator_brpc_tpu.protocol.http as jax_http
import incubator_brpc_tpu.protocol.tbus_std as jax_tbus
import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu.runtime as jax_runtime
import incubator_brpc_tpu.transport.device_link as jax_dl
import incubator_brpc_tpu.transport.mc_worker as jax_worker
import incubator_brpc_tpu.transport.native_plane as jax_np
import incubator_brpc_tpu.utils.flags as jax_flags
import incubator_brpc_tpu.utils.logging as jax_logging
import incubator_brpc_tpu_torch.builtin.hotspots as port_hotspots
import incubator_brpc_tpu_torch.builtin.pages as port_pages
import incubator_brpc_tpu_torch.builtin.prometheus as port_prom
import incubator_brpc_tpu_torch.builtin.rpcz as port_rpcz
import incubator_brpc_tpu_torch.bvar as port_bvar
import incubator_brpc_tpu_torch.iobuf as port_iobuf
import incubator_brpc_tpu_torch.parallel.mc_collective as port_mcc
import incubator_brpc_tpu_torch.parallel.mc_dispatch as port_mcd
import incubator_brpc_tpu_torch.protocol.baidu_std as port_baidu
import incubator_brpc_tpu_torch.protocol.http as port_http
import incubator_brpc_tpu_torch.protocol.tbus_std as port_tbus
import incubator_brpc_tpu_torch.rpc as port_rpc
import incubator_brpc_tpu_torch.runtime as port_runtime
import incubator_brpc_tpu_torch.transport.device_link as port_dl
import incubator_brpc_tpu_torch.transport.mc_worker as port_worker
import incubator_brpc_tpu_torch.transport.native_plane as port_np
import incubator_brpc_tpu_torch.utils.flags as port_flags
import incubator_brpc_tpu_torch.utils.logging as port_logging
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.utils.status import ErrorCode
from tests.test_observability import validate_exposition

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", rpc=jax_rpc, http=jax_http, prom=jax_prom, rpcz=jax_rpcz, pages=jax_pages,
        hotspots=jax_hotspots, bvar=jax_bvar, flags=jax_flags, np=jax_np, tbus=jax_tbus,
        baidu=jax_baidu, dl=jax_dl, mcd=jax_mcd, mcc=jax_mcc, worker=jax_worker,
        runtime=jax_runtime, logging=jax_logging, iobuf=jax_iobuf, root_logger="incubator_brpc_tpu",
        server_kw={},
    ),
    "torch": types.SimpleNamespace(
        name="torch", rpc=port_rpc, http=port_http, prom=port_prom, rpcz=port_rpcz,
        pages=port_pages, hotspots=port_hotspots, bvar=port_bvar, flags=port_flags, np=port_np,
        tbus=port_tbus, baidu=port_baidu, dl=port_dl, mcd=port_mcd, mcc=port_mcc,
        worker=port_worker, runtime=port_runtime, logging=port_logging, iobuf=port_iobuf,
        root_logger="incubator_brpc_tpu_torch", server_kw={"device": "cpu"},
    ),
}

_OPEN = []  # servers the test started, stopped at teardown


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def nothing_outlives_the_test():
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


@pytest.fixture
def tuned(pkg):
    """tuned(name, value): set a flag of ``pkg`` for one test, restored after."""
    touched = {}

    def tune(name, value):
        if name not in touched:
            touched[name] = pkg.flags.flag_registry.get(name)
        pkg.flags.set_flag_unchecked(name, value)

    yield tune
    for name, value in touched.items():
        pkg.flags.set_flag_unchecked(name, value)


@pytest.fixture
def clean_spans(pkg):
    pkg.rpcz.span_store.clear()
    yield pkg.rpcz.span_store
    pkg.rpcz.span_store.clear()


@pytest.fixture
def hidden():
    """Hides the bvars a test created, so the registry stays clean."""
    created = []
    yield created.append
    for var in created:
        var.hide()


def server(pkg, services=None, **opts):
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**opts, **pkg.server_kw))
    for name, handlers in (services or {}).items():
        srv.add_service(name, handlers)
    assert srv.start(0)
    _OPEN.append(srv)
    return srv


def channel(pkg, srv, **opts):
    ch = pkg.rpc.Channel()
    assert ch.init(f"127.0.0.1:{srv.port}",
                   options=pkg.rpc.ChannelOptions(**opts) if opts else None)
    return ch


def fetch(pkg, srv, path, timeout=10.0):
    return pkg.http.http_call("127.0.0.1", srv.port, path, timeout=timeout)


def wait_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def sample_value(text, name):
    """Value of the (unlabelled) sample ``name`` in an exposition body."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    return None


def echo_server(pkg, service="obsdemo"):
    return server(pkg, {service: {"echo": lambda cntl, req: req}})


# -- tests/test_observability.py TestRendering ----------------------------------


def test_adder_renders_as_counter(pkg, hidden):
    a = pkg.bvar.Adder(name="obsx_requests_total")
    hidden(a)
    a << 7
    text = pkg.prom.render_metrics(prefix="obsx_")
    assert "# TYPE obsx_requests_total counter" in text
    assert "obsx_requests_total 7" in text
    validate_exposition(text)


def test_passive_status_and_recorders_render_as_gauges(pkg, hidden):
    ps = pkg.bvar.PassiveStatus(lambda: 2.5, name="obsx_gauge")
    rec = pkg.bvar.IntRecorder(name="obsx_avg")
    mx = pkg.bvar.Maxer(name="obsx_max")
    mn = pkg.bvar.Miner(name="obsx_min")
    for v in (ps, rec, mx, mn):
        hidden(v)
    rec << 10
    rec << 20
    mx << 42
    mn << 3
    text = pkg.prom.render_metrics(prefix="obsx_")
    assert "# TYPE obsx_gauge gauge" in text
    assert "obsx_gauge 2.5" in text
    assert "obsx_avg 15.0" in text
    assert "obsx_max 42" in text
    assert "# TYPE obsx_min gauge" in text and "obsx_min 3" in text
    validate_exposition(text)


def test_window_renders_as_gauge(pkg, hidden):
    rate = pkg.bvar.PerSecond(pkg.bvar.Adder(), name="obsx_rate")
    hidden(rate)
    text = pkg.prom.render_metrics(prefix="obsx_")
    assert "# TYPE obsx_rate gauge" in text
    validate_exposition(text)


def test_latency_recorder_renders_as_summary(pkg, hidden):
    lr = pkg.bvar.LatencyRecorder(name="obsx_latency")
    hidden(lr)
    for v in (100, 200, 300, 400):
        lr << v
    text = pkg.prom.render_metrics(prefix="obsx_")
    assert "# TYPE obsx_latency summary" in text
    for q in ("0.5", "0.9", "0.99", "0.999"):
        assert f'obsx_latency{{quantile="{q}"}}' in text
    assert "obsx_latency_sum 1000" in text
    assert "obsx_latency_count 4" in text
    assert "obsx_latency_max_latency 400.0" in text
    assert "# TYPE obsx_latency_qps gauge" in text
    validate_exposition(text)


def test_non_numeric_values_are_skipped(pkg, hidden):
    s = pkg.bvar.PassiveStatus(lambda: "not-a-number", name="obsx_stringy")
    hidden(s)
    text = pkg.prom.render_metrics(prefix="obsx_")
    assert "obsx_stringy" not in text
    validate_exposition(text)


def test_numeric_flags_mirrored_as_gauges(pkg):
    text = pkg.prom.render_metrics(prefix="flag_max_body_size")
    assert "# TYPE flag_max_body_size gauge" in text
    assert sample_value(text, "flag_max_body_size") == float(pkg.flags.flag_registry.get("max_body_size"))
    validate_exposition(text)


def test_escape_label_value(pkg):
    esc = pkg.prom.escape_label_value
    assert esc('a"b') == 'a\\"b'
    assert esc("a\\b") == "a\\\\b"
    assert esc("a\nb") == "a\\nb"
    assert esc('q"\\' + "\n") == 'q\\"\\\\\\n'


def test_sanitize_metric_name(pkg):
    san = pkg.prom.sanitize_metric_name
    assert san("ok_name") == "ok_name"
    assert san("9starts_with_digit") == "_9starts_with_digit"
    assert san("dots.and-dashes") == "dots_and_dashes"


def test_prefix_filters(pkg, hidden):
    a = pkg.bvar.Adder(name="obsx_inside")
    hidden(a)
    text = pkg.prom.render_metrics(prefix="obsx_inside")
    assert "obsx_inside" in text
    assert "\nprocess_" not in text and "flag_max_body_size" not in text


def test_content_type_constant_is_the_jax_packages():
    assert port_prom.CONTENT_TYPE == jax_prom.CONTENT_TYPE
    assert port_prom.CONTENT_TYPE.startswith("text/plain")


def test_same_registry_renders_the_same_exposition(hidden):
    """One script of bvars, made in each package's registry, renders the
    same exposition text (the quantile samples of a recorder whose
    reservoir holds every value, the counters, gauges and escapes)."""
    texts = []
    for pkg in PKGS.values():
        b = pkg.bvar
        a = b.Adder(name="obsy_calls")
        g = b.PassiveStatus(lambda: 1.25, name="obsy_gauge")
        r = b.LatencyRecorder(name="obsy_lat")
        for var in (a, g, r):
            hidden(var)
        a << 11
        for v in (5, 10, 15, 20, 25):
            r << v
        texts.append("\n".join(ln for ln in pkg.prom.render_metrics(prefix="obsy_").splitlines()
                               if not ln.startswith("obsy_lat_qps")))
    assert texts[0] == texts[1]


# -- TestPortalScrape -------------------------------------------------------------


def test_scrape_is_valid_and_typed(pkg):
    srv = echo_server(pkg)
    status, headers, body = fetch(pkg, srv, "/brpc_metrics")
    assert status == 200
    assert headers.get("content-type", "").startswith("text/plain")
    text = body.decode()
    validate_exposition(text)
    assert "# TYPE" in text


def test_index_links_brpc_metrics(pkg):
    srv = echo_server(pkg)
    status, _, body = fetch(pkg, srv, "/")
    assert status == 200 and b"/brpc_metrics" in body


def test_method_summary_advances_with_traffic(pkg):
    srv = echo_server(pkg, "obstraffic")
    ch = channel(pkg, srv)
    for i in range(5):
        assert ch.call_method("obstraffic", "echo", b"x%d" % i).ok()
    text = fetch(pkg, srv, "/brpc_metrics")[2].decode()
    name = "method_obstraffic_echo_latency"
    assert f"# TYPE {name} summary" in text
    assert sample_value(text, f"{name}_count") >= 5
    assert f'{name}{{quantile="0.99"}}' in text


def test_prefix_query(pkg):
    srv = echo_server(pkg)
    text = fetch(pkg, srv, "/brpc_metrics?prefix=method_obsdemo")[2].decode()
    validate_exposition(text)
    for line in text.splitlines():
        if not line.startswith("#"):
            assert line.startswith("method_obsdemo")


def test_scrape_under_load(pkg):
    srv = echo_server(pkg)
    stop = threading.Event()
    errs = []

    def pound():
        ch = channel(pkg, srv)
        i = 0
        while not stop.is_set():
            c = ch.call_method("obsdemo", "echo", b"load-%d" % i)
            if c.failed():
                errs.append(c.error_text)
            i += 1

    threads = [threading.Thread(target=pound) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for _ in range(5):
            status, _, body = fetch(pkg, srv, "/brpc_metrics")
            assert status == 200
            validate_exposition(body.decode())
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errs, errs[:3]


# -- TestDeviceLinkMetrics --------------------------------------------------------


def _link_channel(pkg, srv):
    return channel(pkg, srv, transport="tpu", timeout_ms=30000)


def test_link_bvars_appear_and_advance(pkg):
    srv = echo_server(pkg)
    ch = _link_channel(pkg, srv)
    body = b"device-plane payload " * 64
    for _ in range(3):
        cntl = ch.call_method("obsdemo", "echo", body)
        assert cntl.ok(), cntl.error_text
    link = ch._device_sock.link
    assert link._m_rtt.count() > 0
    assert link._m_flush.count() > 0
    assert link._m_pump.count() > 0
    assert link._m_out_bytes.get_value() >= len(body) * 3
    assert link._m_in_bytes.get_value() >= len(body) * 3
    text = fetch(pkg, srv, "/brpc_metrics")[2].decode()
    validate_exposition(text)
    pfx = f"device_link_{link.link_id}"
    assert f"# TYPE {pfx}_step_rtt_us summary" in text
    assert sample_value(text, f"{pfx}_step_rtt_us_count") > 0
    assert f"# TYPE {pfx}_out_bytes_second gauge" in text
    assert f"# TYPE {pfx}_in_bytes_second gauge" in text
    assert sample_value(text, "device_link_bytes") > 0


def test_link_metrics_retire_on_clean_close(pkg):
    srv = echo_server(pkg)
    ch = _link_channel(pkg, srv)
    assert ch.call_method("obsdemo", "echo", b"x").ok()
    pfx = f"device_link_{ch._device_sock.link.link_id}"
    assert f"{pfx}_step_rtt_us" in pkg.prom.render_metrics(prefix=pfx)
    ch._device_sock.set_failed(ErrorCode.ECLOSE, "clean close")
    assert wait_until(lambda: pkg.prom.render_metrics(prefix=pfx) == "")


def test_link_metrics_retire_on_failure(pkg):
    srv = echo_server(pkg)
    ch = _link_channel(pkg, srv)
    assert ch.call_method("obsdemo", "echo", b"x").ok()
    link = ch._device_sock.link
    pfx = f"device_link_{link.link_id}"
    assert f"{pfx}_step_rtt_us" in pkg.prom.render_metrics(prefix=pfx)
    link.fail("test-induced failure")
    assert pkg.prom.render_metrics(prefix=pfx) == ""
    assert pkg.dl.link_errors.get_value() > 0


# -- TestCollectiveObservability --------------------------------------------------


def test_collective_registration_is_opt_in(pkg):
    srv = server(pkg)
    assert not srv.has_method("_tpu_transport.collective")
    assert srv.has_method("_tpu_transport.handshake")


def test_collective_opt_in_gets_concurrency_limit(pkg):
    srv = server(pkg, enable_collective_service=True, collective_max_concurrency=2)
    assert srv.has_method("_tpu_transport.collective")
    # the port limits the session runs (mc_dispatch.RunLimit), not the
    # method: its aborts and accepts pass a run that holds the slot (ROADMAP
    # C, tests/test_torch_session_rpc.py::test_aborts_and_accepts_pass_the_limit)
    want = 2 if pkg.name == "jax" else 0
    assert srv.method_max_concurrency("_tpu_transport.collective") == want


def test_session_span_parented_to_proposing_rpc(pkg, monkeypatch, tuned, clean_spans):
    monkeypatch.setattr(pkg.mcc, "run_collective_session",
                        lambda parties, idx, steps, width, seed, **kw: (np.zeros(width, np.float32), 0.001))
    srv = server(pkg, enable_collective_service=True)
    tuned("enable_rpcz", True)
    ch = channel(pkg, srv)
    payload = json.dumps({"parties": [0, 1], "index": 1, "steps": 3, "width": 4, "seed": 7}).encode()
    cntl = ch.call_method("_tpu_transport", "collective", payload)
    assert cntl.ok(), cntl.error_text
    assert cntl.trace_id
    spans = [s for s in clean_spans.recent(limit=500) if s.span_type == "collective"]
    assert spans, "no collective span sampled"
    span = spans[-1]
    assert span.trace_id == cntl.trace_id
    assert span.parent_span_id == cntl.span_id
    notes = " ".join(text for _, text in span.annotations)
    assert "steps=3" in notes and "width=4" in notes
    assert "parties=[0, 1]" in notes
    _, _, body = fetch(pkg, srv, f"/rpcz?trace_id={cntl.trace_id:x}")
    assert b"collective" in body
    raw = fetch(pkg, srv, "/brpc_metrics")[2].decode()
    assert "# TYPE mc_collective_sessions counter" in raw


def test_session_bvars_count_real_sessions(pkg):
    before = pkg.mcc.collective_sessions.get_value()
    steps_before = pkg.mcc.collective_steps.get_value()
    if pkg.name == "jax":
        import jax

        own, _ = pkg.mcc.run_collective_session([jax.devices()[0].id], 0, steps=2, width=8, seed=3)
    else:
        own, _ = pkg.mcc.run_collective_session([0], 0, steps=2, width=8, seed=3, device="cpu")
    assert own.shape == (8,)
    assert pkg.mcc.collective_sessions.get_value() == before + 1
    assert pkg.mcc.collective_steps.get_value() == steps_before + 2


# -- TestAsyncResponseReap ----------------------------------------------------------


class _CountingFactory:
    def __init__(self):
        self.created, self.destroyed = [], []

    def create(self):
        obj = object()
        self.created.append(obj)
        return obj

    def destroy(self, obj):
        self.destroyed.append(obj)


def test_async_handler_without_response_is_reaped(pkg, tuned):
    held = []

    def never_responds(cntl, req):
        cntl.session_local_data()
        cntl.set_async()
        held.append(cntl)
        return None

    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(session_local_data_factory=_CountingFactory(),
                                               **pkg.server_kw))
    srv.add_service("leak", {"never": never_responds}, max_concurrency=1)
    assert srv.start(0)
    _OPEN.append(srv)
    tuned("async_response_timeout_s", 0.3)
    ch = channel(pkg, srv, timeout_ms=10000)
    cntl = ch.call_method("leak", "never", b"x")
    assert cntl.error_code == ErrorCode.ERPCTIMEDOUT
    assert "async handler" in cntl.error_text
    st = srv.method_status("leak", "never")
    assert wait_until(lambda: st.processing == 0)
    sock = held[0]._sock
    assert wait_until(lambda: sock.context.get("_session_nhandlers", 0) == 0)
    assert ch.call_method("leak", "never", b"y").error_code == ErrorCode.ERPCTIMEDOUT
    sock.set_failed(ErrorCode.ECLOSE, "test closes")
    assert wait_until(lambda: "_session_local_data" not in sock.context)


def test_send_response_then_return_finishes_once(pkg):
    def double_finisher(cntl, req):
        cntl.send_response(b"first")
        return b"second"  # ignored: the finish is once-only

    srv = server(pkg, {"once": {"both": double_finisher}})
    cntl = channel(pkg, srv).call_method("once", "both", b"x")
    assert cntl.ok(), cntl.error_text
    assert cntl.response_payload == b"first"
    assert wait_until(lambda: srv._nprocessing == 0)


# -- TestLazyStreamPayload ----------------------------------------------------------


def test_stream_frame_payload_materializes_lazily(pkg):
    t = pkg.tbus
    payload = b"stream-bytes-" * 37
    raw = t.pack_frame(t.Meta(stream_id=9), payload, 0x77, flags=t.FLAG_STREAM)
    buf = pkg.iobuf.IOBuf()
    buf.append(raw)
    frame, consumed = t.parse_frame_iobuf(buf)
    assert consumed == len(raw)
    assert frame.is_stream
    assert frame.payload_iobuf is not None
    assert frame._payload == b""
    assert frame.payload == payload
    assert frame.payload == payload


def test_payload_setter_still_works(pkg):
    frame = pkg.tbus.ParsedFrame(meta=pkg.tbus.Meta(), payload=b"abc")
    assert frame.payload == b"abc"
    frame.payload = b"xyz"
    assert frame.payload == b"xyz"


# -- TestNativeTelemetry --------------------------------------------------------------


def native_server(pkg, service, **opts):
    srv = server(pkg, {service: {"echo": pkg.rpc.native_echo}}, native_plane=True, **opts)
    assert srv._native_plane is not None
    return srv


def test_per_method_summary_advances_pure_native(pkg, tuned):
    tuned("native_telemetry", True)
    tuned("native_telemetry_sample_every", 0)
    srv = native_server(pkg, "telsvc1")
    ch = pkg.np.NativeClientChannel("127.0.0.1", srv.port, protocol="baidu_std")
    try:
        ch.pump("telsvc1", "echo", b"y" * 64, 1000, inflight=32)
    finally:
        ch.close()
    text = fetch(pkg, srv, "/brpc_metrics?prefix=native_method_")[2].decode()
    name = "native_method_telsvc1_echo_latency_us"
    assert f"# TYPE {name} summary" in text
    assert sample_value(text, f"{name}_count") == 1000
    assert f'{name}{{quantile="0.99"}}' in text
    stats = srv._native_plane.stats()
    assert stats["native_reqs"] >= 1000
    assert stats["cb_frames"] == 0


def test_sampled_spans_land_at_configured_rate(pkg, tuned, clean_spans):
    tuned("native_telemetry", True)
    tuned("native_telemetry_sample_every", 8)
    tuned("enable_rpcz", True)
    tuned("rpcz_samples_per_second", 10_000_000)
    srv = native_server(pkg, "telsvc2")
    ch = pkg.np.NativeClientChannel("127.0.0.1", srv.port, protocol="baidu_std")
    try:
        ch.pump("telsvc2", "echo", b"z" * 32, 800, inflight=32)
    finally:
        ch.close()
    srv._native_plane.drain_telemetry()
    spans = [sp for sp in clean_spans.recent(limit=20000) if sp.service == "telsvc2"]
    assert len(spans) == 800 // 8
    sp = spans[0]
    assert sp.span_type == "server" and sp.method == "echo"
    assert sp.trace_id != 0 and sp.span_id != 0
    assert sp.request_size == 32 and sp.response_size == 32
    assert sp.latency_us >= 0
    assert srv._native_plane.stats()["cb_frames"] == 0


def test_adaptive_limit_moves_without_python_route(pkg, tuned):
    tuned("native_telemetry", True)
    tuned("native_telemetry_sample_every", 0)
    tuned("auto_cl_initial_max_concurrency", 40)
    tuned("auto_cl_sampling_interval_us", 20)
    tuned("auto_cl_min_sample_count", 20)
    tuned("auto_cl_max_sample_count", 100)
    tuned("auto_cl_sample_window_size_ms", 50)
    srv = native_server(pkg, "telsvc3", max_concurrency="auto")
    plane = srv._native_plane
    assert "telsvc3.echo" in plane.native_method_names()
    assert srv.max_concurrency == 40
    assert plane.native_max_concurrency("telsvc3.echo") == 40
    ch = pkg.np.NativeClientChannel("127.0.0.1", srv.port, protocol="baidu_std")
    try:
        for _ in range(4):
            ch.pump("telsvc3", "echo", b"q" * 16, 5000, inflight=16)
            plane.drain_telemetry()
    finally:
        ch.close()
    assert srv.max_concurrency != 40
    assert plane.native_max_concurrency("telsvc3.echo") == srv.max_concurrency
    assert plane.stats()["cb_frames"] == 0


def test_ring_overflow_drops_instead_of_stalling(pkg, tuned):
    tuned("native_telemetry", True)
    tuned("native_telemetry_sample_every", 0)
    tuned("native_telemetry_ring_size", 64)
    tuned("native_telemetry_drain_ms", 60000)
    srv = native_server(pkg, "telsvc4")
    plane = srv._native_plane
    ch = pkg.np.NativeClientChannel("127.0.0.1", srv.port, protocol="baidu_std")
    try:
        ch.pump("telsvc4", "echo", b"w" * 8, 2000, inflight=32)
        assert plane.telemetry_dropped() > 0
        drained = plane.drain_telemetry()
        assert 0 < drained <= 64
        rc, err, _, body = ch.call("telsvc4", "echo", b"alive")
        assert rc >= 0 and err == 0 and body.to_bytes() == b"alive"
    finally:
        ch.close()
    assert plane.telemetry_dropped() + plane._tel_drained >= 2000


def test_telemetry_disabled_records_nothing(pkg, tuned):
    tuned("native_telemetry", False)
    srv = native_server(pkg, "telsvc5")
    plane = srv._native_plane
    ch = pkg.np.NativeClientChannel("127.0.0.1", srv.port, protocol="baidu_std")
    try:
        ch.pump("telsvc5", "echo", b"n" * 8, 200, inflight=16)
    finally:
        ch.close()
    assert plane.drain_telemetry() == 0
    assert plane.telemetry_dropped() == 0
    assert plane._tel_recorders == {}


def test_process_gauges_sum_every_live_plane(pkg, tuned):
    """native_auth_rejects counts the ERPCAUTH answers of every live plane
    and keeps a stopped plane's (the retired tally)."""
    before = pkg.np.native_auth_rejects.get_value()
    srv = native_server(pkg, "telsvc6", auth=pkg.rpc.TokenAuthenticator(["good"]))
    ch = pkg.np.NativeClientChannel("127.0.0.1", srv.port, protocol="baidu_std")
    try:
        ch.set_auth("bad")
        rc, err, _, _ = ch.call("telsvc6", "echo", b"x", timeout_ms=2000)
        assert err == ErrorCode.ERPCAUTH
    finally:
        ch.close()
    assert wait_until(lambda: pkg.np.native_auth_rejects.get_value() == before + 1)
    _OPEN.remove(srv)
    srv.stop()
    srv.join(timeout=10)
    assert pkg.np.native_auth_rejects.get_value() == before + 1
    assert pkg.np.native_compress_bytes_saved.get_value() >= 0


# -- TestSpanStoreSatellites ----------------------------------------------------------


def test_rpcz_max_spans_reload_applies(pkg, tuned):
    Span, SpanStore = pkg.rpcz.Span, pkg.rpcz.SpanStore
    tuned("rpcz_max_spans", 10)
    store = SpanStore()
    for i in range(10):
        store.submit(Span(trace_id=i + 1, span_id=i + 1))
    assert len(store) == 10
    tuned("rpcz_max_spans", 4)
    store.submit(Span(trace_id=100, span_id=100))
    assert len(store) == 4
    assert store.recent(limit=10)[-1].trace_id == 100
    tuned("rpcz_max_spans", 6)
    for i in range(6):
        store.submit(Span(trace_id=200 + i, span_id=200 + i))
    assert len(store) == 6


def test_json_mode_rejects_cleanly_when_rpcz_off(pkg, tuned):
    srv = echo_server(pkg)
    tuned("enable_rpcz", False)
    status, headers, body = fetch(pkg, srv, "/rpcz?json=1")
    assert status == 503
    assert "json" in headers.get("content-type", "")
    assert "rpcz is off" in json.loads(body.decode())["error"]


def _persisted_span(rpcz):
    span = rpcz.Span(
        trace_id=0xFEED, span_id=0xBEEF, parent_span_id=0x1, span_type="server",
        service="persist", method="echo", remote_side="127.0.0.1:9", log_id=7, error_code=3,
        start_real_us=123456789, latency_us=42.5, request_size=10, response_size=20,
    )
    span.annotations.append((1.25, "queued"))
    span.annotations.append((2.5, "done"))
    return span


def test_load_spans_round_trips_persisted_spans(pkg, tuned, tmp_path):
    tuned("rpcz_database_dir", str(tmp_path))
    store = pkg.rpcz.SpanStore()
    span = _persisted_span(pkg.rpcz)
    store.submit(span)
    store.close_db()
    loaded = pkg.rpcz.load_spans(str(tmp_path / "rpcz.jsonl"))
    assert len(loaded) == 1
    assert loaded[0] == span
    assert isinstance(loaded[0].annotations[0], tuple)


def test_load_spans_skips_torn_lines(pkg, tmp_path):
    p = tmp_path / "rpcz.jsonl"
    p.write_text('{"trace_id": 1, "span_id": 2, "type": "server"}\n{"trace_id": 3, "span_id":')
    loaded = pkg.rpcz.load_spans(str(p))
    assert len(loaded) == 1 and loaded[0].trace_id == 1
    assert pkg.rpcz.load_spans(str(tmp_path / "missing.jsonl")) == []


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_persisted_spans_read_back_by_both_packages(writer, tmp_path):
    """One package's rpcz.jsonl line is the other's: the same key set and
    the same values, read back equal by both loaders."""
    w = PKGS[writer]
    saved = w.flags.flag_registry.get("rpcz_database_dir")
    w.flags.set_flag_unchecked("rpcz_database_dir", str(tmp_path))
    try:
        store = w.rpcz.SpanStore()
        store.submit(_persisted_span(w.rpcz))
        store.close_db()
    finally:
        w.flags.set_flag_unchecked("rpcz_database_dir", saved)
    line = (tmp_path / "rpcz.jsonl").read_text()
    assert line == json.dumps(jax_rpcz.span_to_dict(_persisted_span(jax_rpcz))) + "\n"
    for r in PKGS.values():
        (got,) = r.rpcz.load_spans(str(tmp_path / "rpcz.jsonl"))
        assert r.rpcz.span_to_dict(got) == jax_rpcz.span_to_dict(_persisted_span(jax_rpcz))


# -- TestRpczQueries -------------------------------------------------------------------


@pytest.fixture
def trace_server(pkg, tuned, clean_spans):
    srv = echo_server(pkg)
    tuned("enable_rpcz", True)
    mk = pkg.rpcz.Span
    clean_spans.submit(mk(trace_id=0xABC, span_id=1, parent_span_id=0, span_type="server",
                          service="q", method="root", latency_us=900, start_real_us=100))
    clean_spans.submit(mk(trace_id=0xABC, span_id=2, parent_span_id=1, span_type="client",
                          service="q", method="child1", latency_us=300, start_real_us=200))
    clean_spans.submit(mk(trace_id=0xABC, span_id=3, parent_span_id=1, span_type="client",
                          service="q", method="child2", latency_us=100, error_code=7,
                          start_real_us=300))
    clean_spans.submit(mk(trace_id=0xABC, span_id=4, parent_span_id=2, span_type="server",
                          service="q", method="grandchild", latency_us=50, start_real_us=400))
    return srv


def test_trace_id_renders_parent_child_tree(pkg, trace_server):
    lines = fetch(pkg, trace_server, "/rpcz?trace_id=abc")[2].decode().splitlines()
    assert len(lines) == 4
    assert lines[0].startswith("trace=abc span=1")
    assert lines[1].startswith("  trace=abc span=2")
    assert lines[2].startswith("    trace=abc span=4")
    assert lines[3].startswith("  trace=abc span=3")


def test_min_latency_filter_is_latency_ordered(pkg, trace_server):
    lines = fetch(pkg, trace_server, "/rpcz?min_latency_us=200")[2].decode().splitlines()
    assert len(lines) == 2
    assert "span=1" in lines[0] and "span=2" in lines[1]


def test_error_only_filter(pkg, trace_server):
    lines = [ln for ln in fetch(pkg, trace_server, "/rpcz?error_only=1")[2].decode().splitlines() if ln]
    assert len(lines) == 1 and "error=7" in lines[0]


def test_json_mode_serves_span_dicts(pkg, trace_server):
    status, headers, body = fetch(pkg, trace_server, "/rpcz?json=1")
    assert status == 200 and "json" in headers.get("content-type", "")
    rows = json.loads(body.decode())
    assert len(rows) == 4
    by_span = {r["span_id"]: r for r in rows}
    assert by_span[3]["error_code"] == 7
    assert by_span[1]["type"] == "server"
    assert by_span[1]["latency_us"] == 900


def test_bad_query_values_rejected(pkg, trace_server):
    assert fetch(pkg, trace_server, "/rpcz?min_latency_us=abc")[0] == 400
    assert fetch(pkg, trace_server, "/rpcz?trace_id=zzz")[0] == 400


def test_rpcz_pages_answer_alike():
    """The same four spans in both packages' stores: every /rpcz query form
    answers the same bytes on both."""
    bodies = {}
    for pkg in PKGS.values():
        saved = pkg.flags.flag_registry.get("enable_rpcz")
        pkg.flags.set_flag_unchecked("enable_rpcz", True)
        store = pkg.rpcz.span_store
        store.clear()
        try:
            mk = pkg.rpcz.Span
            for sid, parent, lat, err in ((1, 0, 900, 0), (2, 1, 300, 0), (3, 1, 100, 7), (4, 2, 50, 0)):
                sp = mk(trace_id=0xABC, span_id=sid, parent_span_id=parent, span_type="server",
                        service="q", method=f"m{sid}", latency_us=lat, error_code=err,
                        start_real_us=100 * sid)
                sp.annotations.append((1.5, "processing"))
                store.submit(sp)
            srv = echo_server(pkg)
            bodies[pkg.name] = [fetch(pkg, srv, path)[::2] for path in (
                "/rpcz?trace_id=abc", "/rpcz?min_latency_us=200", "/rpcz?error_only=1",
                "/rpcz?json=1", "/rpcz")]
        finally:
            store.clear()
            pkg.flags.set_flag_unchecked("enable_rpcz", saved)
    assert bodies["jax"] == bodies["torch"]


# -- TestSpanRetention ----------------------------------------------------------------------


def _aged_span(rpcz, start_us, span_id):
    return rpcz.Span(trace_id=0xF0, span_id=span_id, parent_span_id=0, span_type="server",
                     service="r", method="m", latency_us=10, start_real_us=start_us)


def test_wall_clock_spans_age_out_synthetic_spans_survive(pkg, tuned):
    tuned("rpcz_keep_span_seconds", 60)
    store = pkg.rpcz.SpanStore()
    now_us = time.time() * 1e6
    store.submit(_aged_span(pkg.rpcz, 100, 1))
    store.submit(_aged_span(pkg.rpcz, now_us - 120e6, 2))
    store.submit(_aged_span(pkg.rpcz, now_us - 1e6, 3))
    store.submit(_aged_span(pkg.rpcz, now_us, 4))
    ids = [s.span_id for s in store.recent()]
    assert 2 not in ids, ids
    assert {1, 3, 4} <= set(ids), ids


def test_skewed_future_span_cannot_purge_the_store(pkg, tuned):
    tuned("rpcz_keep_span_seconds", 60)
    store = pkg.rpcz.SpanStore()
    now_us = time.time() * 1e6
    store.submit(_aged_span(pkg.rpcz, now_us, 1))
    store.submit(_aged_span(pkg.rpcz, now_us + 36000e6, 2))
    assert {s.span_id for s in store.recent()} == {1, 2}


# -- the scrape pages name the served method ------------------------------------------------


PAGES_NAMING_THE_METHOD = ("/vars", "/vars.json", "/status", "/brpc_metrics", "/protobufs")


@pytest.mark.parametrize("path", PAGES_NAMING_THE_METHOD)
def test_scrape_pages_name_the_method(pkg, path):
    srv = echo_server(pkg, "obspages")
    ch = channel(pkg, srv)
    for i in range(3):
        assert ch.call_method("obspages", "echo", b"p%d" % i).ok()
    status, headers, body = fetch(pkg, srv, path)
    assert status == 200
    assert b"obspages" in body
    if path == "/vars.json":
        assert "method_obspages_echo_latency" in json.loads(body)
    if path == "/status":
        # the JAX package counts a call after it wrote the answer
        assert wait_until(lambda: b"obspages.echo: processing=0 count=3" in fetch(pkg, srv, path)[2])


def test_status_counts_every_finished_call(pkg):
    """The port releases a call's admission slot before it writes the
    answer (ROADMAP A7's recorded difference): /status still reads zero
    calls in flight and every finished call once a caller has its answers."""
    srv = echo_server(pkg, "obsstatus")
    ch = channel(pkg, srv)
    for i in range(7):
        assert ch.call_method("obsstatus", "echo", b"%d" % i).ok()
    body = fetch(pkg, srv, "/status")[2]
    assert b"  requests: " in body and b"  errors: 0" in body
    assert wait_until(lambda: b"obsstatus.echo: processing=0 count=7" in fetch(pkg, srv, "/status")[2])


@pytest.mark.parametrize("path", ["/connections", "/sockets", "/fibers", "/ids", "/threads", "/vlog",
                                  "/circuit_breakers", "/flags", "/flags/enable_rpcz",
                                  "/vars/series.json", "/vars/socket_in_bytes"])
def test_portal_pages_answer_with_their_rows(pkg, path):
    srv = echo_server(pkg)
    assert channel(pkg, srv).call_method("obsdemo", "echo", b"x").ok()
    status, headers, body = fetch(pkg, srv, path)
    assert status == 200
    want = {
        "/connections": b"connections=", "/sockets": b"live sockets:",
        "/fibers": b":", "/ids": b"call_ids: slots=", "/threads": b"-- thread ",
        "/vlog": b"<root> ", "/circuit_breakers": b"", "/flags": b"enable_rpcz ",
        "/flags/enable_rpcz": b"enable_rpcz ", "/vars/series.json": b"{",
        "/vars/socket_in_bytes": b"socket_in_bytes",
    }[path]
    assert want in body


def test_flags_page_sets_a_reloadable_flag(pkg, tuned):
    srv = echo_server(pkg)
    tuned("enable_rpcz", False)
    status, _, body = fetch(pkg, srv, "/flags/enable_rpcz?setvalue=true")
    assert (status, body) == (200, b"enable_rpcz set to True\n")
    assert pkg.flags.flag_registry.get("enable_rpcz") is True
    assert fetch(pkg, srv, "/flags/no_such_flag_here")[0] == 404


def test_vars_series_carries_the_socket_rates(pkg):
    """The per-second socket rates the portal plots exist once a socket did
    (the 1 Hz sampler fills their series)."""
    srv = echo_server(pkg)
    assert channel(pkg, srv).call_method("obsdemo", "echo", b"x").ok()
    text = fetch(pkg, srv, "/vars?prefix=socket_")[2].decode()
    assert "socket_in_bytes_per_second : " in text and "socket_out_bytes_per_second : " in text


# -- chip_smoke.py's phase 3i on the CPU --------------------------------------------------------


def test_chip_smoke_phase_3i_on_the_cpu():
    """Phase 3i's parts (a)-(f) at a small scale on the CPU: every device
    echo checks itself bitwise and its spans linked, the native flood's
    sampled spans land at one in RPCZ_SAMPLE_EVERY, every page holds its
    row, and the contention page names the loop (no card, so no launch is
    counted)."""
    import torch

    import chip_smoke
    from incubator_brpc_tpu_torch.ops import kernels

    out, k1 = chip_smoke.rpcz_phase(torch, kernels, device="cpu", scale=0.1)
    assert set(k1) == set("abce")
    assert all(row == {"frame_rows": 0, "verify_rows": 0, "echo_step_rows": 0} for row in k1.values())
    assert out["b"]["sampled_spans"] == out["b"]["pump"] // chip_smoke.RPCZ_SAMPLE_EVERY
    assert len(out["d"]) == len(chip_smoke.RPCZ_PAGES)
    assert len(out["e"]["off_us"]) == len(out["e"]["on_us"]) == chip_smoke.RPCZ_TURNS // 2
    assert out["f"]["contended"] > 0
    assert port_flags.flag_registry.get("enable_rpcz") is False  # put back


def test_chip_smoke_exposition_validator_is_the_oracles():
    import chip_smoke
    import tests.test_observability as oracle

    assert chip_smoke._EXPO_COMMENT.pattern == oracle._COMMENT_RE.pattern
    assert chip_smoke._EXPO_SAMPLE.pattern == oracle._SAMPLE_RE.pattern
    good = port_prom.render_metrics(prefix="flag_")
    chip_smoke.validate_exposition(good)
    with pytest.raises(AssertionError):
        chip_smoke.validate_exposition("bad line here\n")


def test_chip_smoke_span_code_fills_the_store():
    """The span-cost timing runs the real span code: with rpcz on, each
    loop leaves its client and server span linked in the store."""
    import chip_smoke
    from incubator_brpc_tpu_torch.protocol.tbus_std import Meta

    saved = port_flags.flag_registry.get("enable_rpcz"), port_flags.flag_registry.get("rpcz_samples_per_second")
    port_flags.set_flag_unchecked("enable_rpcz", True)
    port_flags.set_flag_unchecked("rpcz_samples_per_second", 10_000_000)
    port_rpcz.span_store.clear()
    try:
        assert chip_smoke.span_code_us(port_rpcz, port_rpc.Controller, Meta, 10) > 0
        spans = port_rpcz.span_store.recent()
    finally:
        port_flags.set_flag_unchecked("enable_rpcz", saved[0])
        port_flags.set_flag_unchecked("rpcz_samples_per_second", saved[1])
        port_rpcz.span_store.clear()
    assert len(spans) == 20
    clients = {sp.span_id: sp for sp in spans if sp.span_type == "client"}
    servers = [sp for sp in spans if sp.span_type == "server"]
    assert len(clients) == len(servers) == 10
    assert all(clients[sp.parent_span_id].trace_id == sp.trace_id for sp in servers)
