"""The port's runtime tools (ROADMAP A5: ``incubator_brpc_tpu_torch/tools``
``rpc_press``, ``rpc_view``, ``rpc_replay``, ``parallel_http``) on the CPU,
held against the JAX package's ``tools/``.

On both packages (``pkg``), each package's tool against its own servers:

- ``tests/test_tools.py``'s 15 cases: rpc_dump's sampling, budget and
  rotation, ``rpc_replay``'s re-issue, ``rpc_press`` (the Python route,
  ``--reactors`` with the per-reactor distribution, ``--transport tpu``),
  ``rpc_view``'s dump printer (plain, filtered, JSON), its portal relay,
  its ``--rpcz`` modes (recent spans, one trace tree, filters, bad targets)
  and ``parallel_http``;
- ``tests/test_observability.py``'s ``TestRpcViewMetrics`` (4: the
  exposition parse, the delta rows, ``metrics_mode`` against a live server
  once and over a window with traffic);
- ``tests/test_robustness.py``'s ``test_lame_duck_drill_tool``,
  ``tests/test_quantized.py``'s ``test_rpc_view_links_table`` and
  ``tests/test_overlap.py``'s ``test_rpc_view_trace_tree_appends_overlap_report``.

Beyond the oracle, across the packages: a dump file written by one
package's server prints byte-identically through both ``rpc_view``s and
is replayed by the other package's ``rpc_replay``; the same exposition
text (written and scraped live) gives the same ``parse_exposition`` and
``metrics_delta_lines``; one package's ``rpc_press`` floods the other's
server, both ways; the press's result dictionaries carry the JAX keys;
each tool's ``main`` prints the JAX tool's lines; and chip_smoke.py's phase
3j and its ``--drills`` mode run on the CPU. On the port alone: the drill
counts the calls a grace-expiry hard stop cut as resets (ROADMAP C13).

Servers of the port run on ``ServerOptions(device="cpu")``; each test
stops and joins what it started and leaves no ``tbtorch-*`` thread.
Tolerance: none; every comparison is of integers, strings or bytes.
"""

import json
import os
import re
import sys
import threading
import time
import types

import pytest

import incubator_brpc_tpu.rpc.dump as jax_dump
import incubator_brpc_tpu_torch.rpc.dump as port_dump
import incubator_brpc_tpu_torch.tools.parallel_http as port_parallel_http
import incubator_brpc_tpu_torch.tools.rpc_press as port_press
import incubator_brpc_tpu_torch.tools.rpc_replay as port_replay
import incubator_brpc_tpu_torch.tools.rpc_view as port_view
import tools.parallel_http as jax_parallel_http
import tools.rpc_press as jax_press
import tools.rpc_replay as jax_replay
import tools.rpc_view as jax_view
from tests.test_torch_observability import (  # noqa: F401  (fixtures)
    _OPEN,
    PKGS,
    channel,
    clean_spans,
    nothing_outlives_the_test,
    pkg,
    server,
    tuned,
    wait_until,
)
from tests.test_torch_tracing import (  # noqa: F401  (fixtures)
    _overlap_session,
    _session_spans,
    scale,
)

TOOLS = {
    "jax": types.SimpleNamespace(press=jax_press, view=jax_view, replay=jax_replay,
                                 http=jax_parallel_http, dump=jax_dump),
    "torch": types.SimpleNamespace(press=port_press, view=port_view, replay=port_replay,
                                   http=port_parallel_http, dump=port_dump),
}


def tools_of(pkg):
    return TOOLS[pkg.name]


def other(pkg):
    return PKGS["torch" if pkg.name == "jax" else "jax"]


@pytest.fixture
def echo_server(pkg):
    seen = []

    def echo(cntl, request):
        seen.append(request)
        return request

    return server(pkg, {"dump": {"echo": echo}}), seen


def make_dump(pkg, directory, samples):
    """A dump file of ``samples`` [(service, method, payload)] written by
    ``pkg``'s RpcDumper."""
    d = tools_of(pkg).dump.RpcDumper(directory=str(directory))
    for service, method, payload in samples:
        assert d.sample(pkg.tbus.Meta(service=service, method=method), payload)
    d.close()
    return os.path.join(str(directory), sorted(os.listdir(directory))[0])


# -- tests/test_tools.py TestRpcDump ----------------------------------------------------------


def test_server_samples_when_enabled(pkg, echo_server, tmp_path, tuned):
    srv, _ = echo_server
    tuned("rpc_dump_dir", str(tmp_path))
    tuned("rpc_dump", True)
    try:
        ch = channel(pkg, srv)
        for i in range(5):
            assert ch.call_method("dump", "echo", b"req-%d" % i).ok()
    finally:
        pkg.flags.set_flag_unchecked("rpc_dump", False)
        tools_of(pkg).dump.reset_global_dumper()  # drop the handle into tmp_path
    files = [f for f in os.listdir(tmp_path) if f.startswith("requests.")]
    assert files
    samples = []
    for f in files:
        samples.extend(tools_of(pkg).dump.load_dump_file(str(tmp_path / f)))
    assert {b"req-%d" % i for i in range(5)} <= {p for _, p, _ in samples}
    assert (samples[0][0].service, samples[0][0].method) == ("dump", "echo")


def test_sampling_budget_caps_rate(pkg, tmp_path, tuned):
    d = tools_of(pkg).dump.RpcDumper(directory=str(tmp_path))
    tuned("rpc_dump_max_requests_per_second", 3)
    taken = [d.sample(pkg.tbus.Meta(service="s", method="m"), b"x") for _ in range(10)]
    assert taken.count(True) == 3
    d.close()


def test_file_rotation(pkg, tmp_path, tuned):
    tuned("rpc_dump_max_requests_in_one_file", 2)
    d = tools_of(pkg).dump.RpcDumper(directory=str(tmp_path))
    for i in range(5):
        assert d.sample(pkg.tbus.Meta(service="s", method="m"), b"%d" % i)
    d.close()
    assert len(os.listdir(tmp_path)) == 3  # 2 + 2 + 1


# -- TestReplay, TestPress ---------------------------------------------------------------------


def test_replay_reissues_samples(pkg, echo_server, tmp_path):
    srv, seen = echo_server
    make_dump(pkg, tmp_path, [("dump", "echo", b"replay-%d" % i) for i in range(4)])
    requests = tools_of(pkg).replay.load_requests(str(tmp_path))
    assert len(requests) == 4
    stats = tools_of(pkg).replay.run_replay(requests, f"127.0.0.1:{srv.port}", threads=2, times=2,
                                            timeout_ms=15000)
    assert stats == {"ok": 8, "fail": 0, "total": 8}
    assert sorted(seen) == sorted([b"replay-%d" % i for i in range(4)] * 2)


def test_press_drives_load(pkg, echo_server):
    srv, _ = echo_server
    stats = tools_of(pkg).press.run_press(f"127.0.0.1:{srv.port}", "dump", "echo", b"press",
                                          threads=2, duration=0.5)
    assert stats["fail"] == 0
    assert stats["ok"] > 10
    assert stats["latency_us_p99"] >= stats["latency_us_p50"] > 0


def test_press_reactor_mode_reports_distribution(pkg):
    if not pkg.np.NET_AVAILABLE:
        pytest.skip("native runtime unavailable")
    srv = server(pkg, {"demo": {"echo": pkg.rpc.native_echo}}, native_plane=True,
                 usercode_inline=True, num_reactors=4)
    stats = tools_of(pkg).press.run_reactor_press(
        f"127.0.0.1:{srv.port}", "demo", "echo", b"press", reactors=4, conns_per_reactor=1,
        duration=0.5, timeout_ms=15000)
    assert stats["fail"] == 0
    assert stats["ok"] > 10
    assert stats["cid_misroutes"] == 0
    # round-robin accept sharding: 4 conns spread one per reactor
    assert stats["reactor_conns"] == {0: 1, 1: 1, 2: 1, 3: 1}
    assert len(stats["client_shards"]) == 4


def test_press_over_device_links(pkg, echo_server):
    srv, _ = echo_server
    stats = tools_of(pkg).press.run_press(f"127.0.0.1:{srv.port}", "dump", "echo", b"press-tpu",
                                          threads=2, duration=0.5, timeout_ms=60000,
                                          transport="tpu")
    assert stats["fail"] == 0
    assert stats["ok"] > 5


# -- TestView ------------------------------------------------------------------------------


def test_view_prints_samples(pkg, tmp_path, capsys):
    path = make_dump(pkg, tmp_path, [("v", "m", b"hello-view")])
    assert tools_of(pkg).view.main([path]) == 0
    out = capsys.readouterr().out
    assert "v.m" in out and "hello-view" in out and "1/1 samples" in out


def test_view_filters_and_json(pkg, tmp_path, capsys):
    path = make_dump(pkg, tmp_path, [("a", "m1", b"one"), ("b", "m2", b"two")])
    assert tools_of(pkg).view.main(["--service", "b", "--json", path]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert len(rows) == 1 and rows[0]["service"] == "b"


def test_view_proxies_target_portal(pkg, echo_server):
    view = tools_of(pkg).view
    target, _ = echo_server
    assert view.make_proxy_server("not-a-target") is None
    assert view.serve_proxy(0, "not-a-target") == 2
    front = view.make_proxy_server(f"127.0.0.1:{target.port}")
    assert front is not None and front.start(0)
    _OPEN.append(front)
    status, _, body = pkg.http.http_call("127.0.0.1", front.port, "/health")
    assert status == 200
    assert b"OK" in body and b"rpc_view of" in body  # tagged relay
    status, _, body = pkg.http.http_call("127.0.0.1", front.port, "/vars")
    assert status == 200 and b"socket_in_bytes" in body
    status, _, body = pkg.http.http_call("127.0.0.1", front.port, "/")
    assert status == 200 and b"rpc_view of" in body  # html tag


# -- TestViewRpcz ------------------------------------------------------------------------------


@pytest.fixture
def traced_server(pkg, echo_server, tuned, clean_spans):
    srv, _ = echo_server
    tuned("enable_rpcz", True)
    Span = pkg.rpcz.Span
    clean_spans.submit(Span(trace_id=0xBEE, span_id=1, parent_span_id=0, span_type="server",
                            service="tool", method="root", latency_us=500, start_real_us=10))
    clean_spans.submit(Span(trace_id=0xBEE, span_id=2, parent_span_id=1, span_type="client",
                            service="tool", method="leaf", latency_us=100, error_code=9,
                            start_real_us=20))
    return srv


def test_rpcz_mode_prints_recent_spans(pkg, traced_server, capsys):
    rc = tools_of(pkg).view.main(["--rpcz", "--target", f"127.0.0.1:{traced_server.port}"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "2 spans" in out
    assert "tool.root" in out and "tool.leaf" in out


def test_rpcz_mode_assembles_trace_tree(pkg, traced_server, capsys):
    rc = tools_of(pkg).view.main(["--rpcz", "--target", f"127.0.0.1:{traced_server.port}",
                                  "--trace-id", "bee"])
    out = capsys.readouterr().out
    assert rc == 0
    lines = [ln for ln in out.splitlines() if "trace=" in ln]
    assert lines[0].startswith("trace=bee span=1")
    assert lines[1].startswith("  trace=bee span=2")  # child indented


def test_rpcz_mode_filters(pkg, traced_server, capsys):
    rc = tools_of(pkg).view.main(["--rpcz", "--target", f"127.0.0.1:{traced_server.port}",
                                  "--error-only"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "1 spans" in out and "error=9" in out


def test_rpcz_mode_bad_target(pkg, capsys):
    view = tools_of(pkg).view
    assert view.main(["--rpcz", "--target", "not-a-target"]) == 2
    # unreachable port: a clean error, not a traceback
    assert view.main(["--rpcz", "--target", "127.0.0.1:1"]) == 1


# -- TestParallelHttp ----------------------------------------------------------------------------


def test_fetches_portal_urls_concurrently(pkg, echo_server):
    srv, _ = echo_server
    urls = [f"http://127.0.0.1:{srv.port}{path}"
            for path in ("/health", "/version", "/vars.json", "/does-not-exist")]
    results = tools_of(pkg).http.fetch_all(urls, threads=4, timeout_ms=5000)
    by_url = {r[0]: r for r in results}
    assert by_url[urls[0]][1] == 200
    assert by_url[urls[1]][1] == 200
    assert by_url[urls[2]][1] == 200 and by_url[urls[2]][2] > 2
    # a 404 is a completed fetch with an error status, not a crash
    assert by_url[urls[3]][1] in (None, 404)


# -- tests/test_observability.py TestRpcViewMetrics ---------------------------------------------

TEXT1 = ("# TYPE c counter\nc 5\n"
         "# TYPE g gauge\ng 2.5\n"
         "# TYPE s summary\n"
         's{quantile="0.5"} 100.0\ns_sum 300\ns_count 3\n')
TEXT2 = ("# TYPE c counter\nc 15\n"
         "# TYPE g gauge\ng 2.5\n"
         "# TYPE s summary\n"
         's{quantile="0.5"} 150.0\ns_sum 900\ns_count 6\n')


def test_parse_exposition(pkg):
    values, types_ = tools_of(pkg).view.parse_exposition(TEXT1)
    assert values["c"] == 5.0
    assert values['s{quantile="0.5"}'] == 100.0
    assert types_ == {"c": "counter", "g": "gauge", "s": "summary"}


def test_delta_lines(pkg):
    view = tools_of(pkg).view
    v1, t = view.parse_exposition(TEXT1)
    v2, _ = view.parse_exposition(TEXT2)
    joined = "\n".join(view.metrics_delta_lines(v1, v2, t, seconds=2.0))
    assert "c 5 -> 15  (+10, 5.0/s)" in joined
    assert "s_count 3 -> 6" in joined  # summary counters rate too
    assert 's{quantile="0.5"} 150' in joined  # traffic: quantiles shown
    assert "\ng " not in joined and not joined.startswith("g ")  # unchanged


def test_metrics_mode_against_live_server(pkg, capsys):
    service = f"toolview1{pkg.name}"
    srv = server(pkg, {service: {"echo": lambda cntl, req: req}})
    ch = channel(pkg, srv)
    for i in range(3):
        assert ch.call_method(service, "echo", b"m%d" % i).ok()
    rc = tools_of(pkg).view.metrics_mode(f"127.0.0.1:{srv.port}", 0, prefix=f"method_{service}")
    out = capsys.readouterr().out
    assert rc == 0
    assert f"method_{service}_echo_latency_count" in out


def test_metrics_mode_delta_against_live_server(pkg, capsys):
    service = f"toolview2{pkg.name}"
    srv = server(pkg, {service: {"echo": lambda cntl, req: req}})
    ch = channel(pkg, srv)
    assert ch.call_method(service, "echo", b"warm").ok()
    # traffic flows WHILE metrics_mode sits between its two scrapes, so the
    # second scrape sees a real delta
    stop = threading.Event()

    def drive():
        i = 0
        while not stop.is_set():
            ch.call_method(service, "echo", b"d%d" % i)
            i += 1

    t = threading.Thread(target=drive)
    t.start()
    try:
        rc = tools_of(pkg).view.metrics_mode(f"127.0.0.1:{srv.port}", 0.3,
                                             prefix=f"method_{service}")
    finally:
        stop.set()
        t.join()
    out = capsys.readouterr().out
    assert rc == 0
    assert f"method_{service}_echo_latency_count" in out
    assert "/s)" in out  # rate column rendered


# -- the lame duck drill, the links table, the overlap report -----------------------------------


def test_lame_duck_drill_tool(pkg, tuned):
    """The one-command drain-under-load run: rpc_press --lame-duck-drill
    against a live server reports a clean drain."""
    tuned("enable_quitquitquit", True)
    srv = server(pkg, {"S": {"echo": lambda c, r: r}})
    counts = tools_of(pkg).press.run_lame_duck_drill(f"127.0.0.1:{srv.port}", "S", "echo",
                                                     b"x" * 32, threads=3, duration=2.0,
                                                     timeout_ms=3000)
    assert counts["drained_clean"], counts
    assert counts["ok"] > 0
    assert counts["reset"] == 0
    assert wait_until(lambda: srv._stopping, timeout=10)  # the drill terminated the target


@pytest.mark.parametrize("pkg", ["torch"], indirect=True)
def test_lame_duck_drill_counts_a_hard_stop_as_reset(pkg, tuned):
    """A drain whose grace expires under in-flight handlers cuts admitted
    calls: the drill counts them as resets although nothing was served
    after them (ROADMAP C13: the fixed 50 ms band alone saw no served call
    to measure from and reported this drain clean)."""
    tuned("enable_quitquitquit", True)

    def slow(cntl, req):
        time.sleep(1.0)
        return req

    srv = server(pkg, {"S": {"echo": slow}})
    counts = tools_of(pkg).press.run_lame_duck_drill(f"127.0.0.1:{srv.port}", "S", "echo",
                                                     b"x" * 32, threads=3, duration=2.0,
                                                     timeout_ms=3000, grace_s=0.1)
    assert not counts["drained_clean"], counts
    assert counts["reset"] == 3 and counts["ok"] == 0, counts
    assert wait_until(lambda: srv._stopping, timeout=10)


def test_rpc_view_links_table(pkg):
    values = {
        'device_link_3_step_rtt_us{quantile="0.99"}': 450.0,
        "device_link_3_step_rtt_us_sum": 1000.0,
        "device_link_3_step_rtt_us_count": 10.0,
        "device_link_3_out_bytes_second": 2.0e6,
        "device_link_3_in_bytes_second": 1.0e6,
        "device_link_7_step_rtt_us_sum": 90.0,
        "device_link_7_step_rtt_us_count": 3.0,
        "unrelated_metric": 1.0,
    }
    rows = tools_of(pkg).view.links_table(values)
    assert len(rows) == 2
    assert rows[0].startswith("device_link_3:")
    assert "rtt=100.0us" in rows[0]
    assert "p99=450.0us" in rows[0]
    assert "gbps=0.003000" in rows[0]
    assert rows[1].startswith("device_link_7:")
    assert "rtt=30.0us" in rows[1]
    assert rows == TOOLS["jax"].view.links_table(values)


def test_rpc_view_trace_tree_appends_overlap_report(pkg, scale, tuned, clean_spans):
    """The operator pipe end to end: a double-buffered session's spans
    scraped from a live server's /rpcz, and the trace-tree rendering
    carries the verdict line."""
    tuned("enable_rpcz", True)
    tuned("rpcz_samples_per_second", 1_000_000)
    _overlap_session(pkg, double_buffer=True)
    trace_ids = {sp.trace_id for sp in _session_spans(clean_spans)}
    assert trace_ids
    srv = server(pkg)
    scraped = tools_of(pkg).view.scrape_rpcz(f"127.0.0.1:{srv.port}",
                                             trace_id=f"{trace_ids.pop():x}")
    assert scraped, "live /rpcz scrape returned no spans"
    report = pkg.rpcz.overlap_report(scraped)
    assert report, "scraped trace carries no chunk annotations"


# -- beyond the oracle: across the packages ----------------------------------------------------


def _dump_from_server(pkg, tmp_path, tuned, payloads):
    """Requests sampled by ``pkg``'s server with rpc_dump on: the files."""
    srv = server(pkg, {"dump": {"echo": lambda cntl, req: req}})
    tuned("rpc_dump_dir", str(tmp_path))
    tuned("rpc_dump", True)
    try:
        ch = channel(pkg, srv)
        for p in payloads:
            assert ch.call_method("dump", "echo", p).ok()
    finally:
        pkg.flags.set_flag_unchecked("rpc_dump", False)
        tools_of(pkg).dump.reset_global_dumper()
    return sorted(str(tmp_path / f) for f in os.listdir(tmp_path) if f.startswith("requests."))


@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
def test_a_servers_dump_views_alike_and_replays_on_the_other(pkg, tmp_path, tuned, capsys,
                                                            as_json):
    payloads = [b"cross-%d" % i + bytes(range(i * 7 % 50)) for i in range(6)]
    files = _dump_from_server(pkg, tmp_path, tuned, payloads)
    assert files
    outs = {}
    for name in ("jax", "torch"):
        argv = (["--json"] if as_json else []) + ["--max-payload", "12", *files]
        assert TOOLS[name].view.main(argv) == 0
        captured = capsys.readouterr()
        outs[name] = (captured.out, captured.err)
    assert outs["jax"] == outs["torch"]
    assert f"{len(payloads)}/{len(payloads)} samples" in "".join(outs["jax"])
    # the other package's replay re-issues the samples against its server
    peer = other(pkg)
    seen = []
    srv = server(peer, {"dump": {"echo": lambda cntl, req: seen.append(req) or req}})
    requests = TOOLS[peer.name].replay.load_requests(str(tmp_path))
    assert sorted(p for _m, p, _a in requests) == sorted(payloads)
    stats = TOOLS[peer.name].replay.run_replay(requests, f"127.0.0.1:{srv.port}", threads=3,
                                               times=2, timeout_ms=15000)
    assert stats == {"ok": 12, "fail": 0, "total": 12}
    assert sorted(seen) == sorted(payloads * 2)


def test_the_same_exposition_gives_the_same_rows(pkg):
    """``parse_exposition`` and ``metrics_delta_lines`` of both packages on
    the oracle's texts and on two live scrapes of ``pkg``'s server."""
    service = f"toolexpo{pkg.name}"
    srv = server(pkg, {service: {"echo": lambda cntl, req: req}})
    ch = channel(pkg, srv)

    def scrape():
        status, _, body = pkg.http.http_call("127.0.0.1", srv.port, "/brpc_metrics", timeout=15)
        assert status == 200
        return body.decode()

    assert ch.call_method(service, "echo", b"a").ok()
    first = scrape()
    for i in range(5):
        assert ch.call_method(service, "echo", b"b%d" % i).ok()
    second = scrape()
    for before, after in ((TEXT1, TEXT2), (first, second)):
        rows = {}
        for name in ("jax", "torch"):
            view = TOOLS[name].view
            v1, t1 = view.parse_exposition(before)
            v2, t2 = view.parse_exposition(after)
            rows[name] = (v1, t1, v2, view.metrics_delta_lines(v1, v2, {**t1, **t2}, 1.5))
        assert rows["jax"] == rows["torch"]
        assert rows["jax"][3]
    assert any(line.startswith(f"method_{service}_echo_latency_count ") for line in rows["jax"][3])


def test_one_packages_press_floods_the_others_server(pkg):
    """``pkg``'s rpc_press against the other package's server, on the
    Python route and over the reactor path."""
    peer = other(pkg)
    seen = []
    srv = server(peer, {"dump": {"echo": lambda cntl, req: seen.append(req) or req}})
    stats = tools_of(pkg).press.run_press(f"127.0.0.1:{srv.port}", "dump", "echo", b"interop",
                                          threads=3, duration=0.5, timeout_ms=15000)
    assert stats["fail"] == 0 and stats["ok"] > 5
    assert len(seen) == stats["ok"] and set(seen) == {b"interop"}
    if not (pkg.np.NET_AVAILABLE and peer.np.NET_AVAILABLE):
        pytest.skip("native runtime unavailable")
    nat = server(peer, {"demo": {"echo": peer.rpc.native_echo}}, native_plane=True,
                 usercode_inline=True, num_reactors=2)
    stats = tools_of(pkg).press.run_reactor_press(f"127.0.0.1:{nat.port}", "demo", "echo",
                                                  b"interop", reactors=2, conns_per_reactor=1,
                                                  duration=0.5, timeout_ms=15000)
    assert stats["fail"] == 0 and stats["ok"] > 5 and stats["cid_misroutes"] == 0
    assert sum(stats["reactor_conns"].values()) == 2


def test_press_results_carry_the_jax_keys():
    keys = {}
    for name in ("jax", "torch"):
        pkg_ = PKGS[name]
        srv = server(pkg_, {"demo": {"echo": pkg_.rpc.native_echo}}, native_plane=True,
                     usercode_inline=True, num_reactors=2)
        target = f"127.0.0.1:{srv.port}"
        press = TOOLS[name].press
        keys[name] = (
            sorted(press.run_press(target, "demo", "echo", b"k", threads=1, duration=0.2)),
            sorted(press.run_reactor_press(target, "demo", "echo", b"k", reactors=1,
                                           duration=0.2)),
        )
    assert keys["torch"] == keys["jax"]
    assert "trace_id" in keys["jax"][0] and "reactor_conns" in keys["jax"][1]


_PRESS_LINE = re.compile(r"^qps=\d+ ok=\d+ fail=0 avg=\d+us p50=\d+us p99=\d+us max=\d+us$")


def test_each_main_prints_the_jax_lines(pkg, echo_server, tmp_path, capsys, monkeypatch):
    """``main`` of rpc_press, rpc_replay and parallel_http (the URLs on
    stdin) print the JAX tools' lines, numbers aside."""
    srv, _ = echo_server
    target = f"127.0.0.1:{srv.port}"
    tools = tools_of(pkg)
    assert tools.press.main(["--server", target, "--method", "dump.echo", "--threads", "2",
                             "--duration", "0.3"]) == 0
    assert _PRESS_LINE.match(capsys.readouterr().out.strip())
    make_dump(pkg, tmp_path, [("dump", "echo", b"main-%d" % i) for i in range(3)])
    assert tools.replay.main(["--dir", str(tmp_path), "--server", target]) == 0
    assert capsys.readouterr().out == "replayed=3 ok=3 fail=0\n"
    import io

    monkeypatch.setattr(sys, "stdin", io.StringIO(f"http://{target}/health\n{target}/version\n"))
    monkeypatch.setattr(sys, "argv", ["parallel_http"])
    assert tools.http.main() == 0
    captured = capsys.readouterr()
    rows = captured.out.splitlines()
    assert len(rows) == 2 and all(re.match(r"^200 \d+ \d+\.\d ", r) for r in rows)
    assert re.match(r"^# 2/2 ok in \d+ ms \(\d+ urls/s\)$", captured.err.strip())


def test_the_port_tools_run_as_modules(tmp_path):
    """``python -m incubator_brpc_tpu_torch.tools.<name>``: each answers
    ``--help`` with the JAX tool's flags."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("rpc_press", "rpc_view", "rpc_replay", "parallel_http"):
        helps = {}
        for mod in (f"incubator_brpc_tpu_torch.tools.{name}", f"tools.{name}"):
            proc = subprocess.run([sys.executable, "-m", mod, "--help"], cwd=repo,
                                  capture_output=True, text=True, timeout=120,
                                  env=dict(os.environ, JAX_PLATFORMS="cpu"))
            assert proc.returncode == 0, proc.stderr[-2000:]
            helps[mod] = sorted(set(re.findall(r"(--[a-z][a-z0-9-]*)", proc.stdout)))
        assert helps[f"incubator_brpc_tpu_torch.tools.{name}"] == helps[f"tools.{name}"]


# -- chip_smoke.py's phase 3j on the CPU -------------------------------------------------------


def test_chip_smoke_phase_3j_on_the_cpu():
    """Phase 3j's parts (a)-(g) at a small scale on the CPU: every press
    without a failed call, the seeded samples bitwise, the fleet tree
    holding every sampled call, the dump replayed and printed, the portal
    pages 200 with their content types, the drain clean with the oracle
    test's 3 callers (no card, so no launch is counted)."""
    import torch

    import chip_smoke
    from incubator_brpc_tpu_torch.ops import kernels

    t0 = time.monotonic()
    out, k1 = chip_smoke.tools_phase(torch, kernels, device="cpu", scale=0.1)
    assert set(k1) == set("abcdeg")
    assert all(row == {"frame_rows": 0, "verify_rows": 0, "echo_step_rows": 0} for row in k1.values())
    assert out["c"]["tree_spans"] == out["c"]["traced_calls"] > 0
    assert out["e"]["replayed"] == out["e"]["samples"] * chip_smoke.TOOLS_REPLAY[1]
    assert out["f"]["pages"] == len(chip_smoke.TOOLS_PAGES)
    assert out["g"]["drained_clean"] and out["g"]["reset"] == 0
    assert PKGS["torch"].flags.flag_registry.get("rpc_dump") is False  # put back
    assert PKGS["torch"].flags.flag_registry.get("enable_quitquitquit") is False
    assert time.monotonic() - t0 < 120


def test_chip_smoke_drills_on_the_cpu(tmp_path):
    """``chip_smoke.py --drills``'s body on the CPU: 16 callers, two drills,
    each drained clean with a band of at least 50 ms, the flag put
    back."""
    import chip_smoke

    out = tmp_path / "drills.json"
    assert chip_smoke.drills_only(2, str(out), device="cpu") == 0
    drills = json.loads(out.read_text())["drills"]
    assert len(drills) == 2
    for counts in drills:
        assert counts["drained_clean"] and counts["reset"] == 0 and counts["ok"] > 0
        assert counts["guard_ms"] >= 50.0
    assert PKGS["torch"].flags.flag_registry.get("enable_quitquitquit") is False
