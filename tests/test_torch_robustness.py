"""Overload control, failure isolation and the lame duck of the port
(ROADMAP A7) on the CPU, held against the JAX package's
tests/test_robustness.py and tests/test_rpc.py:

- admission: ``TestAdmission``, ``TestRuntimeConcurrencyReset`` and
  ``test_native_plane_method_limit_retunes_live`` of tests/test_rpc.py,
  and ``TestServerAutoLimiter`` and ``TestNativePlaneAdaptiveLimit`` of
  tests/test_robustness.py, on both packages. Where the JAX tests hold a
  call in flight by sleeping in the handler, the port's copies hold it on
  a gate and wait until the server counts it, so the second call meets
  the limit by order, not by timing;
- the flood (``test_flood_sheds_with_bounded_latency_then_converges``,
  which fails on a loaded host in the JAX package's own runs) is held by
  counts: callers make a fixed number of attempts, shed > 0, every
  admitted reply correct, the limit converged to at most twice the
  backend's capacity and no ELIMIT in a serial tail. Its p99 bound on the
  wall clock is not copied;
- native completions drained from the telemetry ring move the adaptive
  limit and reach the C++ table, with no Python-routed call at all;
- ``TestBrownoutRecovery``'s five cases that need a ``FaultInjector`` and
  ``test_backup_superseded_original_spares_breaker``, ``TestFaultSeams``,
  ``TestNativeFaultSeam`` and the integration half of ``TestRetryBudget``
  on both;
- the lame duck: ``TestLameDuck.test_drains_inflight_flood_cleanly`` held
  by order (every in-flight call is counted by the server before the drain
  begins: all answer code 0, then a new call gets ELOGOFF, then the drain
  thread ends; the JAX test's sleeps are not copied),
  ``test_sigterm_flag_installs_handler``, a drain that waits for a
  response still being written (ROADMAP C10), the listener closed to new
  connections, the native plane's lame duck, and
  ``TestLameDuckStreamDrain`` on both. The ``/health`` and
  ``/quitquitquit`` pages of the JAX tests run in tests/test_torch_http.py,
  and its drill tool (``rpc_press --lame-duck-drill``, the port's
  ``tools/rpc_press.py``) in tests/test_torch_tools.py;
- ``TestNativeIdleReap`` on both, over tbus_std (the JAX test speaks
  baidu_std, ROADMAP A11 for the port);
- chip_smoke.py's phase 3g on the CPU (``policy_phase(device="cpu")``).

The servers of the port run on ``ServerOptions(device="cpu")``. Each test
stops and joins what it started, and after each the port's host plane is
shut down and no ``tbtorch-*`` thread is left. Tolerance: none."""

import signal
import socket as pysocket
import threading
import time
import types

import pytest

import incubator_brpc_tpu.bvar as jax_bvar
import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu.rpc.channel as jax_channel
import incubator_brpc_tpu.rpc.server as jax_server
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu.transport import native_plane as jax_np
from incubator_brpc_tpu.transport.socket_map import global_socket_map as jax_socket_map
from incubator_brpc_tpu.utils import flags as jax_flags
import incubator_brpc_tpu_torch.bvar as port_bvar
import incubator_brpc_tpu_torch.rpc as port_rpc
import incubator_brpc_tpu_torch.rpc.channel as port_channel
import incubator_brpc_tpu_torch.rpc.server as port_server
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.transport import native_plane as port_np
from incubator_brpc_tpu_torch.utils import flags as port_flags
from incubator_brpc_tpu_torch.utils.status import ErrorCode
# holds handlers on a butex wait, which the port's worker pool counts as
# blocked (and grows past), as it does a handler waiting on the card
from chip_smoke import Gate

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", rpc=jax_rpc, server=jax_server, channel=jax_channel, np=jax_np,
        tbus=jax_tbus, flags=jax_flags, bvar=jax_bvar, server_kw={},
    ),
    "torch": types.SimpleNamespace(
        name="torch", rpc=port_rpc, server=port_server, channel=port_channel, np=port_np,
        tbus=port_tbus, flags=port_flags, bvar=port_bvar, server_kw={"device": "cpu"},
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
        drain = getattr(srv, "_lame_duck_thread", None)
        if drain is not None:
            drain.join(timeout=60)
    # no JAX client socket left redialing a stopped server's port, where a
    # later test's server may listen (ROADMAP C11)
    jax_socket_map().recycle_all()
    port_rpc.shutdown_host_plane()
    assert shutdown_watchers(timeout=60)
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


@pytest.fixture
def flags(pkg):
    """flags(name, value): set a flag of the test's package, restored after."""
    touched = []

    def tune(name, value):
        touched.append((name, pkg.flags.get_flag(name)))
        pkg.flags.set_flag_unchecked(name, value)

    yield tune
    for name, value in reversed(touched):
        pkg.flags.set_flag_unchecked(name, value)


def server(pkg, services, **opts):
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**opts, **pkg.server_kw))
    for name, handlers in services.items():
        srv.add_service(name, handlers)
    assert srv.start(0)
    _OPEN.append(srv)
    return srv


def connect(pkg, target, lb_name="", **opts):
    ch = pkg.rpc.Channel()
    if isinstance(target, int):
        target = f"127.0.0.1:{target}"
    assert ch.init(target, lb_name, pkg.rpc.ChannelOptions(**opts))
    return ch


def wait_until(cond, timeout=20.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def refuses_connections(port):
    """True when a new TCP connection to ``port`` is refused."""
    try:
        pysocket.create_connection(("127.0.0.1", port), timeout=2).close()
    except OSError:
        return True
    return False


def hold_then(srv, ch, n, method=("S", "hold")):
    """Start ``n`` calls of ``method`` on threads and wait until the server
    counts them all in flight. Returns (threads, results)."""
    results = []
    threads = [threading.Thread(target=lambda: results.append(ch.call_method(*method, b"")))
               for _ in range(n)]
    for t in threads:
        t.start()
    assert wait_until(lambda: srv._nprocessing >= n), srv._nprocessing
    return threads, results


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


class TestAdmission:
    def _server(self, pkg, gate, **opts):
        return server(pkg, {"S": {"hold": lambda c, r: (gate.wait(), b"held")[1],
                                  "echo": lambda c, r: r}}, **opts)

    @pytest.mark.parametrize("opt,method", [("method_max_concurrency", "hold"),
                                            ("max_concurrency", "echo")])
    def test_limit_one(self, pkg, opt, method):
        gate = Gate()
        srv = self._server(pkg, gate, **{opt: 1})
        ch = connect(pkg, srv.port, timeout_ms=10000, max_retry=0)
        threads, results = hold_then(srv, ch, 1)
        try:
            c = ch.call_method("S", method, b"x")
            assert c.error_code == ErrorCode.ELIMIT
        finally:
            gate.set()
            for t in threads:
                t.join(10)
        assert [r.error_code for r in results] == [0]

    def test_method_status_bvars_live(self, pkg):
        srv = server(pkg, {"Echo": {"echo": lambda c, r: r}})
        ch = connect(pkg, srv.port)
        for _ in range(5):
            assert ch.call("Echo", "echo", b"x").ok()
        st = srv.method_status("Echo", "echo")
        assert wait_until(lambda: st.latency.count() >= 5)
        assert st.latency.latency() > 0


class TestRuntimeConcurrencyReset:
    def test_server_level_reset_takes_effect_live(self, pkg):
        gate = Gate()
        srv = server(pkg, {"S": {"hold": lambda c, r: (gate.wait(), b"held")[1],
                                 "echo": lambda c, r: r}})
        ch = connect(pkg, srv.port, timeout_ms=10000, max_retry=0)
        assert ch.call("S", "echo", b"warm").ok()
        assert srv.reset_max_concurrency(1) == 0
        threads, results = hold_then(srv, ch, 1)
        try:
            assert ch.call("S", "echo", b"x").error_code == ErrorCode.ELIMIT
            srv.reset_max_concurrency(0)  # back to unlimited, live
            assert ch.call("S", "echo", b"y").ok()
        finally:
            gate.set()
            for t in threads:
                t.join(10)
        assert results[0].ok()

    def test_method_level_setter(self, pkg):
        srv = server(pkg, {"Echo": {"echo": lambda c, r: r}})
        assert srv.method_max_concurrency("Echo.echo") == 0
        assert srv.set_method_max_concurrency("Echo.echo", 7)
        assert srv.method_max_concurrency("Echo.echo") == 7
        assert not srv.set_method_max_concurrency("Echo.nope", 3)
        assert srv.method_max_concurrency("Echo.nope") is None


def test_native_plane_method_limit_retunes_live(pkg):
    srv = server(pkg, {"n": {"echo": pkg.rpc.native_echo}}, native_plane=True,
                 usercode_inline=True)
    assert srv._native_plane is not None
    ch = connect(pkg, srv.port, native_plane=True)
    assert ch.call_method("n", "echo", b"a").ok()
    assert srv.set_method_max_concurrency("n.echo", 3)
    assert srv._native_plane.native_max_concurrency("n.echo") == 3
    assert ch.call_method("n", "echo", b"b").ok()  # under the limit
    assert srv.set_method_max_concurrency("n.echo", 0)
    assert srv._native_plane.native_max_concurrency("n.echo") == 0


class TestServerAutoLimiter:
    def test_flood_sheds_then_converges(self, pkg, flags):
        """A server whose real capacity is 2 concurrent requests (a
        semaphore models the backend) behind ``max_concurrency="auto"``:
        a serial baseline, a 4x flood of 8 callers making 25 attempts
        each, then a serial tail."""
        flags("auto_cl_sampling_interval_us", 0)
        flags("auto_cl_min_sample_count", 10)
        flags("auto_cl_max_sample_count", 20)
        # windows settle by count alone (the JAX test's 2 s window discards
        # a baseline window whose first 10 calls take over 2 s on a loaded
        # host, and then no window settles)
        flags("auto_cl_sample_window_size_ms", 600_000)
        flags("auto_cl_initial_max_concurrency", 6)
        flags("auto_cl_noload_latency_remeasure_interval_ms", 3600 * 1000)
        flags("auto_cl_qps_alpha_factor_for_ema", 0.3)
        flags("auto_cl_change_rate_of_explore_ratio", 0.06)
        capacity, work_s = 2, 0.05
        sem = threading.Semaphore(capacity)

        def handler(cntl, req):
            with sem:
                time.sleep(work_s)
            return b"ok:" + req

        srv = server(pkg, {"cap": {"work": handler}}, max_concurrency="auto")
        ch = connect(pkg, srv.port, timeout_ms=30000, max_retry=0)
        for i in range(20):
            c = ch.call_method("cap", "work", b"%d" % i)
            assert c.ok(), c.error_text
            assert c.response_payload == b"ok:%d" % i
        # the 20th sample settles the baseline window; the JAX package
        # feeds it after writing the 20th response, so poll for it
        assert wait_until(lambda: srv._server_limiter.describe()["min_latency_us"] > 0)
        codes = []
        lock = threading.Lock()

        def flood(k):
            for j in range(25):
                req = b"f%d-%d" % (k, j)
                c = ch.call_method("cap", "work", req)
                with lock:
                    codes.append(c.error_code)
                if c.ok():
                    assert c.response_payload == b"ok:" + req
                else:
                    time.sleep(0.02)  # a shed caller backs off a tick

        errors = []

        def run(k):
            try:
                flood(k)
            except AssertionError as e:
                errors.append(e)

        threads = [threading.Thread(target=run, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors[:1]
        assert len(codes) == 200
        assert set(codes) <= {0, ErrorCode.ELIMIT}, set(codes)
        assert codes.count(ErrorCode.ELIMIT) > 0, srv._server_limiter.describe()
        assert codes.count(0) > 0
        # converged toward the true capacity, below the 6 it started from
        assert srv.max_concurrency <= capacity * 2, srv._server_limiter.describe()
        # the flood is gone: serial traffic is never shed by the port, which
        # frees a call's slot before writing its response; the JAX package
        # frees it after, so under a limit of 1 its serial caller can meet
        # its own previous call (ROADMAP A7's recorded difference)
        tail = [ch.call_method("cap", "work", b"t%d" % i).error_code for i in range(10)]
        if pkg.name == "torch":
            assert tail == [0] * 10, tail
        else:
            assert set(tail) <= {0, ErrorCode.ELIMIT}, tail

    def test_constant_limit_still_works(self, pkg):
        gate = Gate()
        srv = server(pkg, {"s": {"m": lambda cntl, req: (gate.wait(), b"")[1]}},
                     max_concurrency=1)
        ch = connect(pkg, srv.port, max_retry=0, timeout_ms=8000)
        threads, _ = hold_then(srv, ch, 1, ("s", "m"))
        try:
            c = ch.call_method("s", "m", b"")
            assert c.failed() and c.error_code == ErrorCode.ELIMIT
        finally:
            gate.set()
            for t in threads:
                t.join(10)

    def test_runtime_reset_to_auto(self, pkg, flags):
        flags("auto_cl_initial_max_concurrency", 9)
        srv = server(pkg, {"s": {"m": lambda cntl, req: b""}})
        assert srv.max_concurrency == 0
        assert srv.reset_max_concurrency("auto") == 0
        assert srv.max_concurrency == 9
        assert srv.reset_max_concurrency(25) == "auto"
        assert srv.max_concurrency == 25

    def test_per_method_auto_spec(self, pkg, flags):
        flags("auto_cl_initial_max_concurrency", 6)
        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
        srv.add_service("s", {"m": lambda cntl, req: b""}, max_concurrency="auto")
        status = srv.method_status("s", "m")
        assert isinstance(status.limiter, pkg.rpc.AutoConcurrencyLimiter)
        assert status.max_concurrency == 6
        assert srv.set_method_max_concurrency("s.m", 3)
        assert status.max_concurrency == 3

    def test_limit_gauges_exposed_while_running(self, pkg, flags):
        flags("auto_cl_initial_max_concurrency", 11)
        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(max_concurrency="auto", **pkg.server_kw))
        srv.add_service("s", {"m": lambda cntl, req: b""}, max_concurrency="auto")
        assert srv.start(0)
        _OPEN.append(srv)
        names = pkg.bvar.dump_exposed()
        assert names[f"server_{srv.port}_max_concurrency"] == "11"
        assert names[f"server_{srv.port}_s_m_max_concurrency"] == "11"
        srv.stop()
        assert f"server_{srv.port}_max_concurrency" not in pkg.bvar.dump_exposed()


class TestNativePlaneAdaptiveLimit:
    def test_adaptive_limit_reaches_native_dispatch(self, pkg, flags):
        flags("auto_cl_sampling_interval_us", 0)
        flags("auto_cl_min_sample_count", 20)
        flags("auto_cl_max_sample_count", 40)
        flags("auto_cl_initial_max_concurrency", 16)
        srv = server(pkg, {"svc": {"echo": pkg.rpc.native_echo}}, max_concurrency="auto",
                     native_plane=True)
        plane = srv._native_plane
        assert plane is not None
        assert "svc.echo" in plane.native_method_names()
        assert plane.native_max_concurrency("svc.echo") == 16
        now = 1_000_000
        for _ in range(20):
            for _ in range(50):
                now += 400
                srv._server_limiter.on_responded(0, 6000.0, now_us=now)
        new_limit = srv.max_concurrency
        assert new_limit != 16, srv._server_limiter.describe()
        assert plane.native_max_concurrency("svc.echo") == new_limit
        assert plane.set_native_max_concurrency("svc.echo", 1)
        assert plane.native_max_concurrency("svc.echo") == 1
        c = connect(pkg, srv.port, native_plane=True).call_method("svc", "echo", b"x")
        assert c.ok(), c.error_text

    def test_numeric_string_limit_keeps_python_route(self, pkg):
        srv = server(pkg, {"svc": {"echo": pkg.rpc.native_echo}}, max_concurrency="12",
                     native_plane=True)
        assert srv._native_plane is not None
        assert srv._native_plane.native_method_names() == []
        assert srv.max_concurrency == 12

    def test_runtime_method_limit_stops_following_server_pushes(self, pkg, flags):
        flags("auto_cl_initial_max_concurrency", 8)
        srv = server(pkg, {"svc": {"echo": pkg.rpc.native_echo}}, max_concurrency="auto",
                     native_plane=True)
        plane = srv._native_plane
        assert "svc.echo" in plane.auto_limit_targets()
        assert srv.set_method_max_concurrency("svc.echo", 5)
        assert plane.native_max_concurrency("svc.echo") == 5
        assert "svc.echo" not in plane.auto_limit_targets()
        srv._on_server_limit_change(80)
        assert plane.native_max_concurrency("svc.echo") == 5
        assert srv.set_method_max_concurrency("svc.echo", 0)
        assert "svc.echo" in plane.auto_limit_targets()

    def test_reset_away_from_auto_clears_native_ceiling(self, pkg, flags):
        flags("auto_cl_initial_max_concurrency", 5)
        srv = server(pkg, {"svc": {"echo": pkg.rpc.native_echo}}, max_concurrency="auto",
                     native_plane=True)
        plane = srv._native_plane
        assert plane.native_max_concurrency("svc.echo") == 5
        srv.reset_max_concurrency(0)
        assert plane.native_max_concurrency("svc.echo") == 0
        srv.reset_max_concurrency("auto")
        assert plane.native_max_concurrency("svc.echo") == 5

    def test_telemetry_completions_move_the_limit(self, pkg, flags):
        """No Python-routed call at all: the native completions drained
        from the telemetry ring settle the limiter's windows, and the new
        limit lands in the C++ table."""
        flags("auto_cl_sampling_interval_us", 0)
        flags("auto_cl_min_sample_count", 10)
        flags("auto_cl_max_sample_count", 20)
        flags("auto_cl_initial_max_concurrency", 40)
        srv = server(pkg, {"svc": {"echo": pkg.rpc.native_echo}}, max_concurrency="auto",
                     native_plane=True)
        plane = srv._native_plane
        assert srv._server_limiter.describe()["min_latency_us"] < 0
        nch = pkg.np.NativeClientChannel("127.0.0.1", srv.port)
        try:
            for _ in range(300):
                rc, err, _m, _b = nch.call("svc", "echo", b"x" * 32, timeout_ms=5000)
                assert rc >= 0 and err in (0, ErrorCode.ELIMIT)
        finally:
            nch.close()
        plane.drain_telemetry()
        assert srv.nrequest.get_value() == 0  # nothing took the Python route
        d = srv._server_limiter.describe()
        assert d["min_latency_us"] > 0, d
        assert srv.max_concurrency != 40
        assert plane.native_max_concurrency("svc.echo") == srv.max_concurrency


# ---------------------------------------------------------------------------
# brownout recovery through the circuit breaker
# ---------------------------------------------------------------------------


class TestBrownoutRecovery:
    def _echo_server(self, pkg, **opts):
        hits = []
        srv = server(pkg, {"e": {"m": lambda cntl, req: (hits.append(1), b"ok")[1]}}, **opts)
        return srv, hits

    def test_breaker_isolates_brownout_and_revives(self, pkg, flags):
        flags("circuit_breaker_short_window_size", 30)
        flags("circuit_breaker_long_window_size", 300)
        flags("circuit_breaker_min_isolation_duration_ms", 400)
        flags("fault_injection", True)
        flags("enable_circuit_breaker", True)
        a, _ = self._echo_server(pkg)
        b, _ = self._echo_server(pkg)
        c, hits_c = self._echo_server(pkg, fault_injector=pkg.rpc.FaultInjector(error_rate=0.5))
        url = "list://" + ",".join(f"127.0.0.1:{s.port}" for s in (a, b, c))
        ch = connect(pkg, url, "rr", max_retry=0, timeout_ms=4000)
        lb = ch._lb
        try:
            fails_before = 0
            for _ in range(120):
                if lb.isolated_servers():
                    break
                if ch.call_method("e", "m", b"x").failed():
                    fails_before += 1
            iso = lb.isolated_servers()
            assert len(iso) == 1 and iso[0].port == c.port, (iso, fails_before)
            assert fails_before >= 3
            window = 30
            fails_after = sum(1 for _ in range(window) if ch.call_method("e", "m", b"x").failed())
            assert fails_after / window < 0.02, fails_after
            assert lb.breaker_states()[f"127.0.0.1:{c.port}"]["state"] == "isolated"
            c.fault_injector = None
            assert wait_until(
                lambda: not (ch.call_method("e", "m", b"x") and lb.isolated_servers()), 10.0)
            before_c = len(hits_c)
            fails_revived = sum(1 for _ in range(60) if ch.call_method("e", "m", b"x").failed())
            assert fails_revived == 0
            assert len(hits_c) > before_c, "revived backend got no traffic"
            state = lb.breaker_states()[f"127.0.0.1:{c.port}"]["state"]
            assert state in ("half_open", "closed"), state
        finally:
            lb.stop()

    def test_all_isolated_is_ehostdown(self, pkg, flags):
        flags("circuit_breaker_short_window_size", 20)
        flags("circuit_breaker_min_isolation_duration_ms", 2000)
        flags("fault_injection", True)
        flags("enable_circuit_breaker", True)
        srv, _ = self._echo_server(pkg, fault_injector=pkg.rpc.FaultInjector(error_rate=1.0))
        ch = connect(pkg, f"list://127.0.0.1:{srv.port}", "rr", max_retry=0, timeout_ms=2000)
        try:
            for _ in range(10):
                ch.call_method("e", "m", b"x")
                if ch._lb.isolated_servers():
                    break
            assert ch._lb.isolated_servers()
            c = ch.call_method("e", "m", b"x")
            assert c.failed() and c.error_code == ErrorCode.EHOSTDOWN, (c.error_code, c.error_text)
        finally:
            ch._lb.stop()

    def test_breaker_disabled_by_flag(self, pkg, flags):
        flags("fault_injection", True)
        flags("enable_circuit_breaker", False)
        flags("circuit_breaker_short_window_size", 10)
        srv, _ = self._echo_server(pkg, fault_injector=pkg.rpc.FaultInjector(error_rate=1.0))
        ch = connect(pkg, f"list://127.0.0.1:{srv.port}", "rr", max_retry=0, timeout_ms=2000)
        try:
            codes = [ch.call_method("e", "m", b"x").error_code for _ in range(30)]
            assert codes == [ErrorCode.EINTERNAL] * 30
            assert not ch._lb.isolated_servers()
        finally:
            ch._lb.stop()

    def test_stragglers_do_not_reisolate_or_extend(self, pkg, flags):
        flags("circuit_breaker_short_window_size", 10)
        flags("circuit_breaker_min_isolation_duration_ms", 5000)
        flags("fault_injection", True)
        srv, _ = self._echo_server(pkg, fault_injector=pkg.rpc.FaultInjector(error_rate=1.0))
        ch = connect(pkg, f"list://127.0.0.1:{srv.port}", "rr", max_retry=0, timeout_ms=2000)
        lb = ch._lb
        try:
            for _ in range(5):
                ch.call_method("e", "m", b"x")
            ep = lb.isolated_servers()[0]
            deadline = lb._isolated[ep]
            sid = next(iter(lb._ep_by_sid))
            lb.feedback(types.SimpleNamespace(id=sid), 1000.0, ErrorCode.EINTERNAL)
            assert lb._isolated[ep] == deadline
        finally:
            lb.stop()

    def test_extended_isolation_reschedules_revival_timer(self, pkg, flags):
        flags("circuit_breaker_short_window_size", 10)
        flags("circuit_breaker_min_isolation_duration_ms", 300)
        flags("fault_injection", True)
        srv, _ = self._echo_server(pkg, fault_injector=pkg.rpc.FaultInjector(error_rate=1.0))
        ch = connect(pkg, f"list://127.0.0.1:{srv.port}", "rr", max_retry=0, timeout_ms=2000)
        lb = ch._lb
        try:
            for _ in range(5):
                ch.call_method("e", "m", b"x")
            assert lb.isolated_servers()
            ep = lb.isolated_servers()[0]
            lb._isolate(ep)  # a straggler error extends the isolation
            # no traffic at all from here on: revival must be TIMER-driven
            assert wait_until(lambda: ep not in lb._isolated, timeout=5.0), lb._isolated
        finally:
            lb.stop()

    def test_backup_superseded_original_spares_breaker(self, pkg, flags):
        """The backup-raced ORIGINAL attempt settles as EBACKUPREQUEST in
        the LB's feedback: a healthy-but-slow node accrues no error cost
        from backup accounting."""
        flags("enable_circuit_breaker", True)
        flags("circuit_breaker_short_window_size", 10)
        slow_evt = threading.Event()
        s1 = server(pkg, {"e": {"m": lambda cntl, req: (slow_evt.wait(0.2), b"slow")[1]}})
        s2 = server(pkg, {"e": {"m": lambda cntl, req: b"fast"}})
        ch = connect(pkg, f"list://127.0.0.1:{s1.port},127.0.0.1:{s2.port}", "rr",
                     max_retry=1, timeout_ms=4000, backup_request_ms=20)
        try:
            raced = 0
            for _ in range(12):
                c = ch.call_method("e", "m", b"x")
                assert c.ok(), c.error_text
                raced += c.has_backup_request
            slow_evt.set()
            assert raced >= 1
            row = ch._lb.breaker_states().get(f"127.0.0.1:{s1.port}")
            if row is not None:
                assert row["state"] == "closed", row
                assert row["short_window"]["errors"] == 0, row
            assert not ch._lb.isolated_servers()
        finally:
            slow_evt.set()
            ch._lb.stop()


# ---------------------------------------------------------------------------
# fault-injection seams
# ---------------------------------------------------------------------------


class TestFaultSeams:
    def test_socket_write_seam(self, pkg, flags):
        flags("fault_injection", True)
        srv = server(pkg, {"e": {"m": lambda cntl, req: b"ok"}})
        ch = connect(pkg, srv.port, max_retry=0, timeout_ms=2000)
        assert ch.call_method("e", "m", b"x").ok()
        pkg.rpc.install_socket_injector(pkg.rpc.FaultInjector(error_rate=1.0))
        try:
            c = ch.call_method("e", "m", b"x")
            assert c.failed(), "injected write error did not surface"
        finally:
            pkg.rpc.install_socket_injector(None)
        c = ch.call_method("e", "m", b"x")
        assert c.ok(), c.error_text

    def test_master_flag_gates_everything(self, pkg, flags):
        flags("fault_injection", False)
        srv = server(pkg, {"e": {"m": lambda cntl, req: b"ok"}},
                     fault_injector=pkg.rpc.FaultInjector(error_rate=1.0))
        pkg.rpc.install_socket_injector(pkg.rpc.FaultInjector(error_rate=1.0))
        try:
            c = connect(pkg, srv.port, max_retry=0, timeout_ms=2000).call_method("e", "m", b"x")
            assert c.ok(), c.error_text  # both seams dormant
        finally:
            pkg.rpc.install_socket_injector(None)

    def test_dispatch_delay_seam(self, pkg, flags):
        flags("fault_injection", True)
        inj = pkg.rpc.FaultInjector(delay_rate=1.0, delay_ms=30)
        srv = server(pkg, {"e": {"m": lambda cntl, req: b"ok"}}, fault_injector=inj)
        ch = connect(pkg, srv.port, max_retry=0, timeout_ms=4000)
        t0 = time.perf_counter()
        c = ch.call_method("e", "m", b"x")
        dt = time.perf_counter() - t0
        assert c.ok() and dt >= 0.03, dt
        assert inj.injected["delay"] >= 1

    def test_dispatch_close_seam(self, pkg, flags):
        flags("fault_injection", True)
        inj = pkg.rpc.FaultInjector(close_rate=1.0)
        srv = server(pkg, {"e": {"m": lambda cntl, req: b"ok"}}, fault_injector=inj)
        c = connect(pkg, srv.port, max_retry=0, timeout_ms=4000).call_method("e", "m", b"x")
        assert c.failed()
        assert c.error_code in (ErrorCode.EFAILEDSOCKET, ErrorCode.EEOF, ErrorCode.ECLOSE)
        assert inj.injected["close"] == 1


class TestNativeFaultSeam:
    def test_deterministic_fail_schedule(self, pkg, flags):
        flags("fault_injection", True)
        pkg.np.install_native_client_fault(fail_every=4)
        srv = server(pkg, {"svc": {"echo": pkg.np.native_echo}}, native_plane=True)
        nch = None
        try:
            nch = pkg.np.NativeClientChannel("127.0.0.1", srv.port)
            codes = [nch.call("svc", "echo", b"x", timeout_ms=2000)[1] for _ in range(12)]
            assert [i for i, ec in enumerate(codes) if ec] == [3, 7, 11]
            assert all(ec == ErrorCode.EINTERNAL for ec in codes if ec)
        finally:
            pkg.np.install_native_client_fault()
            if nch is not None:
                nch.close()

    def test_master_flag_gates_arming(self, pkg, flags):
        flags("fault_injection", False)
        pkg.np.install_native_client_fault(fail_every=2)
        srv = server(pkg, {"svc": {"echo": pkg.np.native_echo}}, native_plane=True)
        nch = None
        try:
            nch = pkg.np.NativeClientChannel("127.0.0.1", srv.port)
            for _ in range(6):
                assert nch.call("svc", "echo", b"x", timeout_ms=2000)[1] == 0
        finally:
            pkg.np.install_native_client_fault()
            if nch is not None:
                nch.close()


# ---------------------------------------------------------------------------
# the retry budget on a live channel
# ---------------------------------------------------------------------------


class TestRetryBudget:
    def test_exhaustion_fails_fast_with_original_error(self, pkg):
        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
        srv.add_service("e", {"m": lambda c, r: b"ok"})
        assert srv.start(0)
        port = srv.port
        srv.stop()
        assert srv.join(timeout=5)  # the port now refuses connections
        ch = connect(pkg, port, max_retry=3, timeout_ms=2000, connect_timeout=0.25)
        cntl = ch.call_method("e", "m", b"x")
        assert cntl.failed()
        assert cntl.retried_count == 3
        before = pkg.channel.retry_budget_exhausted.get_value()
        with ch._retry_budget._lock:
            ch._retry_budget._tokens = 0.2
        cntl = ch.call_method("e", "m", b"x")
        assert cntl.failed()
        assert cntl.retried_count == 0, "budget-exhausted call retried"
        assert "retry budget exhausted" in cntl.error_text
        assert pkg.channel.retry_budget_exhausted.get_value() > before

    def test_budget_visible_in_vars(self, pkg):
        names = pkg.bvar.dump_exposed()
        assert "retry_budget_tokens" in names
        assert "retry_budget_exhausted" in names
        srv = server(pkg, {"e": {"m": lambda c, r: b"ok"}})
        ch = connect(pkg, srv.port)
        assert ch.call_method("e", "m", b"x").ok()
        assert pkg.channel.retry_budget_tokens.get_value() >= 50.0


# ---------------------------------------------------------------------------
# the lame duck
# ---------------------------------------------------------------------------


class TestLameDuck:
    def test_drains_inflight_flood_cleanly(self, pkg):
        """Six calls the server counts in flight, then the lame duck: a new
        call gets ELOGOFF, the six answer code 0, the drain thread ends and
        the server has stopped."""
        gate = Gate()
        srv = server(pkg, {"S": {"slow": lambda c, r: (gate.wait(), b"done")[1]}})
        ch = connect(pkg, srv.port, timeout_ms=30000)
        threads, results = hold_then(srv, ch, 6, ("S", "slow"))
        drain = srv.enter_lame_duck(grace_s=30)
        try:
            assert drain is not None
            assert srv.lame_duck
            assert srv.enter_lame_duck() is drain  # idempotent
            c2 = ch.call_method("S", "slow", b"y", cntl=pkg.rpc.Controller(max_retry=0))
            assert c2.error_code == ErrorCode.ELOGOFF
        finally:
            gate.set()
            for t in threads:
                t.join(30)
        drain.join(timeout=30)
        assert not drain.is_alive()
        assert [r.error_code for r in results] == [0] * 6
        assert all(r.response_payload == b"done" for r in results)
        assert srv._stopping
        assert srv.enter_lame_duck() is None  # stopped: nothing to drain

    def test_lame_duck_closes_the_listener(self, pkg):
        gate = Gate()
        srv = server(pkg, {"S": {"slow": lambda c, r: (gate.wait(), b"done")[1],
                                 "echo": lambda c, r: r}})
        ch = connect(pkg, srv.port, timeout_ms=30000)
        threads, results = hold_then(srv, ch, 1, ("S", "slow"))
        drain = srv.enter_lame_duck(grace_s=30)
        try:
            assert wait_until(lambda: refuses_connections(srv.port))  # the listener closed
            # the existing connection keeps serving the drain: retriable ELOGOFF
            c = ch.call_method("S", "echo", b"x", cntl=pkg.rpc.Controller(max_retry=0))
            assert c.error_code == ErrorCode.ELOGOFF
        finally:
            gate.set()
            for t in threads:
                t.join(30)
        drain.join(timeout=30)
        assert results[0].ok()

    def test_native_plane_lame_duck(self, pkg):
        gate = Gate()
        srv = server(pkg, {"S": {"slow": lambda c, r: (gate.wait(), b"done")[1],
                                 "echo": pkg.rpc.native_echo}}, native_plane=True)
        ch = connect(pkg, srv.port, timeout_ms=30000)
        threads, results = hold_then(srv, ch, 2, ("S", "slow"))
        drain = srv.enter_lame_duck(grace_s=30)
        try:
            c = ch.call_method("S", "slow", b"x", cntl=pkg.rpc.Controller(max_retry=0))
            assert c.error_code == ErrorCode.ELOGOFF
            # the reactors close their listeners on their next turn
            assert wait_until(lambda: refuses_connections(srv.port))
        finally:
            gate.set()
            for t in threads:
                t.join(30)
        drain.join(timeout=30)
        assert not drain.is_alive()
        assert [r.error_code for r in results] == [0, 0]
        assert srv._stopping

    def test_drain_waits_for_a_response_being_written(self, pkg):
        """A call whose handler returned but whose response is still being
        written is in-flight work: the drain does not stop the server under
        it, and the caller gets its answer. (The port releases the
        admission slot before the write, the JAX package after it; the
        drain waits for the write in both.)"""
        gate = Gate()
        srv = server(pkg, {"S": {"echo": lambda c, r: r}})
        send = srv._send_response
        writing = threading.Event()

        def held_send(sock, cntl, response):
            if response == b"held":
                writing.set()
                gate.wait()
            return send(sock, cntl, response)

        srv._send_response = held_send
        ch = connect(pkg, srv.port, timeout_ms=30000)
        result = []
        t = threading.Thread(target=lambda: result.append(ch.call_method("S", "echo", b"held")))
        t.start()
        try:
            assert writing.wait(20)
            drain = srv.enter_lame_duck(grace_s=30)
            assert drain is not None
            # the drain lingers at most 0.25 s once it sees no work; it must
            # not see none while the write is held
            assert not wait_until(lambda: srv._stopping, timeout=1.0)
        finally:
            gate.set()
            t.join(30)
        drain.join(timeout=30)
        assert not drain.is_alive() and srv._stopping
        assert result[0].error_code == 0 and result[0].response_payload == b"held"

    def test_sigterm_flag_installs_handler(self, pkg, flags):
        flags("graceful_quit_on_sigterm", True)
        prev_state = dict(pkg.server._sigterm_state)
        prev_handler = signal.getsignal(signal.SIGTERM)
        pkg.server._sigterm_state["installed"] = False
        try:
            srv = server(pkg, {"S": {"m": lambda c, r: b"ok"}})
            assert signal.getsignal(signal.SIGTERM) is pkg.server._on_sigterm
            srv.stop()
        finally:
            signal.signal(signal.SIGTERM, prev_handler)
            pkg.server._sigterm_state.update(prev_state)

    def test_sigterm_flag_off_leaves_the_handler(self, pkg, flags):
        flags("graceful_quit_on_sigterm", False)
        prev_state = dict(pkg.server._sigterm_state)
        prev_handler = signal.getsignal(signal.SIGTERM)
        pkg.server._sigterm_state["installed"] = False
        try:
            server(pkg, {"S": {"m": lambda c, r: b"ok"}})
            assert signal.getsignal(signal.SIGTERM) is prev_handler
        finally:
            signal.signal(signal.SIGTERM, prev_handler)
            pkg.server._sigterm_state.update(prev_state)


class TestLameDuckStreamDrain:
    def _stream_server(self, pkg):
        class Recorder(pkg.rpc.StreamHandler):
            def __init__(self):
                self.closed = threading.Event()

            def on_closed(self, stream):
                self.closed.set()

        def open_stream(cntl, request):
            s = pkg.rpc.stream_accept(cntl, pkg.rpc.StreamOptions(handler=Recorder()))
            assert s is not None
            return b"accepted"

        return server(pkg, {"t": {"open_stream": open_stream}}), Recorder

    def _open(self, pkg, srv, Recorder):
        rec = Recorder()
        s = pkg.rpc.stream_create(pkg.rpc.StreamOptions(handler=rec))
        cntl = connect(pkg, srv.port).call_method("t", "open_stream", b"", request_stream=s)
        assert cntl.ok(), cntl.error_text
        assert s.wait_connected(5)
        return s, rec

    def test_drain_waits_for_stream_close(self, pkg):
        srv, Recorder = self._stream_server(pkg)
        s, _rec = self._open(pkg, srv, Recorder)
        assert srv._open_streams(), "server does not see its stream"
        t = srv.enter_lame_duck(grace_s=20.0)
        assert t is not None
        time.sleep(0.4)
        assert t.is_alive(), "drain finished under an open stream"
        assert not srv._stopping
        s.close()
        t.join(timeout=15)
        assert not t.is_alive()
        assert srv._stopping

    def test_grace_expiry_rsts_open_streams(self, pkg):
        srv, Recorder = self._stream_server(pkg)
        s, rec = self._open(pkg, srv, Recorder)
        t = srv.enter_lame_duck(grace_s=0.6)
        assert t is not None
        t.join(timeout=15)
        assert not t.is_alive()
        assert rec.closed.wait(5), "client never saw the stream end"
        assert s.state == pkg.rpc.stream.CLOSED
        assert srv._stopping


# ---------------------------------------------------------------------------
# the idle reaper on the native plane
# ---------------------------------------------------------------------------


def _read_tbus_frames(pkg, sock, n):
    buf = b""
    frames = []
    while len(frames) < n:
        chunk = sock.recv(65536)
        assert chunk, "connection closed before the response"
        buf += chunk
        while True:
            frame, used = pkg.tbus.try_parse_frame(buf)
            if frame is None:
                break
            frames.append(frame)
            buf = buf[used:]
    return frames


def test_idle_native_connection_reaped(pkg):
    srv = server(pkg, {"svc": {"echo": pkg.np.native_echo}}, native_plane=True,
                 idle_timeout_s=0.4)
    s = pysocket.create_connection(("127.0.0.1", srv.port), timeout=10)
    try:
        s.sendall(pkg.tbus.pack_frame(pkg.tbus.Meta(service="svc", method="echo"), b"hi", 1))
        (frame,) = _read_tbus_frames(pkg, s, 1)
        assert frame.error_code == 0 and frame.payload == b"hi"
        assert srv._native_plane.stats()["native_reqs"] == 1
        # now idle: the reap (a scan at idle/2) closes it
        s.settimeout(10.0)
        assert s.recv(1) == b"", "idle native connection was not reaped"
    finally:
        s.close()


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 3g on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_phase_3g_on_the_cpu():
    """Phase 3g's parts (a)-(f) at a small scale on the CPU: the
    assertions the phase makes on the card hold here too (no card, so no
    launch is counted)."""
    import torch

    import chip_smoke
    from incubator_brpc_tpu_torch.ops import kernels

    before = {name: port_flags.get_flag(name) for name in chip_smoke.POLICY_FLAGS}
    out, k1 = chip_smoke.policy_phase(torch, kernels, device="cpu", scale=0.25)
    assert {name: port_flags.get_flag(name) for name in chip_smoke.POLICY_FLAGS} == before
    assert set(k1) == set("abcdef")
    assert all(row == {"frame_rows": 0, "verify_rows": 0, "echo_step_rows": 0}
               for row in k1.values())
    a = out["a"]
    assert a["elimit"] > 0 and a["admitted"] + a["elimit"] == a["attempts"]
    assert a["attempts"] == chip_smoke.POLICY_FLOOD * 10
    assert a["trajectory"][0][1] == chip_smoke.POLICY_FLAGS["auto_cl_initial_max_concurrency"]
    assert out["b"] == {"limit": chip_smoke.POLICY_METHOD_LIMIT, "over_limit_code": ErrorCode.ELIMIT}
    c = out["c"]
    assert c["seeded"] == c["initial"] != c["limit_after"] == c["table_after"]
    assert c["native_calls"] == chip_smoke.POLICY_NATIVE[0] * 125
    d = out["d"]
    assert d["new_call_code"] == ErrorCode.ELOGOFF and not d["drain_alive"] and d["stopped"]
    e = out["e"]
    assert 1 <= e["backup_wins"] <= e["backups_fired"] <= e["calls"] == 15
    f = out["f"]
    for label in ("python_plane", "native_plane"):
        assert f[label]["right"] == 10
        assert f[label]["wrong"] == f[label]["missing"] == ErrorCode.ERPCAUTH
    assert f["native_plane"]["native_client_missing"] == ErrorCode.ERPCAUTH
    assert f["native_plane"]["native_reqs"] == 0
    assert f["link"]["right"] == 10 and f["link"]["linked"]


# ---------------------------------------------------------------------------
# tests/test_robustness.py's cases that no case above twins, on both
# packages: the breakers page and the auto-limit gauge, the device link's
# re-handshake backoff, deadline propagation and the native plane's shed,
# the resume barrier's min-join and the checkpoint rings. The two
# ``/quitquitquit`` cases of TestLameDuck run in tests/test_torch_http.py
# (``test_quitquitquit_drives_the_lame_duck``). Where the JAX cases sleep
# (A's handler burning 0.12 s of budget before its downstream hop), the
# port's copy keeps the sleep: the budget is what it measures, and the
# assertion is on the budgets the servers saw, not on a clock.
# ---------------------------------------------------------------------------

import importlib  # noqa: E402
import subprocess  # noqa: E402


def _mod(pkg, name):
    return importlib.import_module(f"{pkg.rpc.__name__.rsplit('.', 1)[0]}.{name}")


class TestObservability:
    def test_circuit_breakers_page_renders(self, pkg, flags):
        flags("fault_injection", True)
        flags("circuit_breaker_short_window_size", 10)
        flags("circuit_breaker_min_isolation_duration_ms", 5000)
        fi = _mod(pkg, "rpc.fault_injector").FaultInjector(error_rate=1.0)
        srv = server(pkg, {"e": {"m": lambda cntl, req: b"ok"}}, fault_injector=fi)
        ch = connect(pkg, f"list://127.0.0.1:{srv.port}", "rr", max_retry=0, timeout_ms=2000)
        try:
            for _ in range(6):
                ch.call_method("e", "m", b"x")
            assert ch._lb.isolated_servers()
            pages = _mod(pkg, "builtin.pages")

            class Frame:
                path = "/circuit_breakers"
                query = {}

            status, ctype, body = pages.handle(None, Frame())
            text = body.decode()
            assert status == 200
            assert f"127.0.0.1:{srv.port}" in text
            assert "[isolated]" in text

            class JsonFrame:
                path = "/circuit_breakers"
                query = {"json": "1"}

            status, ctype, body = pages.handle(None, JsonFrame())
            assert status == 200 and ctype == "application/json"
            assert b"isolated" in body
            metrics = _mod(pkg, "builtin.prometheus").render_metrics("circuit_breaker")
            assert "circuit_breaker_isolated_count 1" in metrics, metrics
        finally:
            ch._lb.stop()

    def test_auto_limit_gauge_scrapeable(self, pkg, flags):
        flags("auto_cl_initial_max_concurrency", 11)
        render = _mod(pkg, "builtin.prometheus").render_metrics
        srv = server(pkg, {"e": {"m": lambda cntl, req: b"ok"}}, max_concurrency="auto")
        port = srv.port
        assert f"server_{port}_max_concurrency 11" in render(f"server_{port}")
        _OPEN.remove(srv)
        srv.stop()
        assert srv.join(5)
        # gauges hidden at stop: the name is free for the next server
        assert f"server_{port}_max_concurrency" not in render(f"server_{port}")


class TestDeviceLinkBackoff:
    def test_rehandshake_backs_off_exponentially(self, pkg, flags):
        flags("device_link_backoff_initial_ms", 200)
        flags("device_link_backoff_max_ms", 1000)
        # a port with NOTHING listening: the bootstrap dial fails fast
        probe = pysocket.socket()
        probe.bind(("127.0.0.1", 0))
        dead_port = probe.getsockname()[1]
        probe.close()
        dlm = _mod(pkg, "transport.device_link").DeviceLinkMap()
        ep = _mod(pkg, "utils.endpoint").EndPoint(ip="127.0.0.1", port=dead_port)
        with pytest.raises((OSError, ConnectionError)):
            dlm.get_or_create(ep, timeout_ms=500)
        # the SECOND attempt inside the backoff window fails without dialing
        with pytest.raises(ConnectionError, match="backing off"):
            dlm.get_or_create(ep, timeout_ms=500)
        key = next(iter(dlm._backoff))
        assert dlm._backoff[key][0] == 1
        # after the window, a real (failing) attempt doubles the backoff
        assert wait_until(lambda: time.monotonic() >= dlm._backoff[key][1], timeout=2.0)
        with pytest.raises((OSError, ConnectionError)):
            dlm.get_or_create(ep, timeout_ms=500)
        assert dlm._backoff[key][0] == 2


class _CaptureSock:
    """Duck-typed connection for driving Server.process_request directly:
    captures response bytes in wire order."""

    def __init__(self):
        self.remote = None
        self.context = {}
        self.written = []

    def write(self, data, **kw):
        self.written.append(data.to_bytes() if hasattr(data, "to_bytes") else bytes(data))
        return 0


class TestDeadlinePropagation:
    def test_expired_at_arrival_is_shed_without_dispatch(self, pkg):
        hits = []
        srv = server(pkg, {"S": {"m": lambda c, r: (hits.append(1), b"ok")[1]}})
        t = pkg.tbus
        sock = _CaptureSock()
        frame = t.ParsedFrame(meta=t.Meta(service="S", method="m", timeout_ms=50),
                              payload=b"x", correlation_id=7)
        frame.arrival_ts = time.monotonic() - 0.2  # 200 ms in queue
        shed = pkg.server.deadline_shed_count
        before = shed.get_value()
        srv.process_request(sock, frame)
        assert not hits, "a shed request must never invoke the method"
        resp, _ = t.try_parse_frame(sock.written[0])
        assert resp.error_code == ErrorCode.EDEADLINE
        assert resp.meta.error_text == "Deadline expired before dispatch"
        assert shed.get_value() == before + 1

    def test_unexpired_budget_dispatches_and_sets_deadline_left(self, pkg):
        seen = {}

        def handler(cntl, req):
            seen["left"] = cntl.deadline_left_ms()
            seen["timeout"] = cntl.timeout_ms
            return b"ok"

        srv = server(pkg, {"S": {"m": handler}})
        t = pkg.tbus
        frame = t.ParsedFrame(meta=t.Meta(service="S", method="m", timeout_ms=5000),
                              payload=b"x", correlation_id=8)
        frame.arrival_ts = time.monotonic()
        srv.process_request(_CaptureSock(), frame)
        assert seen["timeout"] == 5000
        assert 0 < seen["left"] <= 5000

    def test_budget_decrements_across_hops(self, pkg):
        """edge -> A -> B: B sees strictly less budget than A stamped,
        shrunk by at least A's handler time (the Controller decrement)."""
        seen = {}
        srv_b = server(pkg, {"B": {"m": lambda c, r: (
            seen.__setitem__("b_budget", c.request_meta.timeout_ms), b"ok")[1]}})

        def a_handler(cntl, req):
            seen["a_budget"] = cntl.request_meta.timeout_ms
            time.sleep(0.12)  # burn budget before the downstream hop
            # no explicit timeout: the downstream call inherits what is
            # LEFT of the caller's propagated budget
            c2 = connect(pkg, srv_b.port).call_method("B", "m", b"y")
            assert c2.ok(), c2.error_text
            return b"ok"

        srv_a = server(pkg, {"A": {"m": a_handler}})
        c = connect(pkg, srv_a.port, timeout_ms=2000).call_method("A", "m", b"x")
        assert c.ok(), c.error_text
        assert 0 < seen["a_budget"] <= 2000
        assert seen["b_budget"] < seen["a_budget"] - 100, seen

    def test_spent_budget_fails_fast_without_wire_traffic(self, pkg):
        hits = []
        srv = server(pkg, {"S": {"m": lambda c, r: (hits.append(1), b"ok")[1]}})
        dl = _mod(pkg, "rpc.deadline")
        ch = connect(pkg, srv.port)
        prev = dl.push_deadline(time.monotonic() - 0.01)
        try:
            c = ch.call_method("S", "m", b"x")
        finally:
            dl.pop_deadline(prev)
        assert c.error_code == ErrorCode.EDEADLINE
        assert not hits, "an expired budget must not reach the wire"


def _build_slow_native_lib(tmp_path):
    """A tb_native_fn that sleeps 80 ms: the burst delay that makes the
    SECOND frame of a batch expire mid-queue on the C++ plane."""
    src = tmp_path / "slow.c"
    src.write_text(
        "#include <stddef.h>\n#include <stdlib.h>\n#include <unistd.h>\n"
        "int tb_slow80(void* ud, const char* req, size_t n, char** resp,\n"
        "              size_t* resp_len) {\n"
        "    usleep(80000);\n"
        "    *resp = (char*)malloc(1);\n"
        "    (*resp)[0] = 's';\n"
        "    *resp_len = 1;\n"
        "    return 0;\n"
        "}\n"
    )
    so = tmp_path / "slow.so"
    try:
        subprocess.run(["cc", "-shared", "-fPIC", "-O1", "-o", str(so), str(src)],
                       check=True, capture_output=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        pytest.skip("no C toolchain for the slow native method")
    return so


def _read_prpc_frames(sock, n):
    import struct

    out, buf = [], b""
    for _ in range(n):
        while len(buf) < 12:
            buf += sock.recv(4096)
        body, _meta = struct.unpack_from(">II", buf, 4)
        total = 12 + body
        while len(buf) < total:
            buf += sock.recv(4096)
        out.append(buf[:total])
        buf = buf[total:]
    return out


class TestNativeDeadlineShed:
    """The C++ cutter sheds expired-mid-queue work natively: EDEADLINE
    byte-identical to the Python route, counted and drained."""

    @pytest.fixture
    def native_shed(self, pkg, tmp_path):
        so = _build_slow_native_lib(tmp_path)
        slow = pkg.np.native_method_lib(str(so), "tb_slow80", lambda c, r: b"s")
        srv = server(pkg, {"svc": {"slow": slow, "echo": pkg.np.native_echo}}, native_plane=True)
        assert "svc.slow" in srv._native_plane.native_method_names()
        return srv

    def test_native_shed_byte_identical_to_python_plane(self, pkg, native_shed):
        baidu = _mod(pkg, "protocol.baidu_std")
        t = pkg.tbus
        srv = native_shed
        shed_count = pkg.server.deadline_shed_count
        before = shed_count.get_value()
        # one burst: [slow (80 ms, no deadline), echo (30 ms budget)]: the
        # second frame expires while the first holds the loop
        f1 = baidu.pack_request(t.Meta(service="svc", method="slow"), b"a", correlation_id=1)
        f2 = baidu.pack_request(t.Meta(service="svc", method="echo", timeout_ms=30), b"b",
                                correlation_id=2)
        with pysocket.create_connection(("127.0.0.1", srv.port), timeout=10) as s:
            s.sendall(f1 + f2)
            r1, r2 = _read_prpc_frames(s, 2)
        ok1, _ = baidu.try_parse_frame(r1)
        shed, _ = baidu.try_parse_frame(r2)
        assert ok1.error_code == 0
        assert shed.error_code == ErrorCode.EDEADLINE
        assert shed.meta.error_text == "Deadline expired before dispatch"
        # the Python plane's shed of the SAME request: byte-identical
        py_srv = server(pkg, {"svc": {"echo": lambda c, r: r}})
        cap = _CaptureSock()
        frame = t.ParsedFrame(meta=t.Meta(service="svc", method="echo", timeout_ms=30),
                              payload=b"b", correlation_id=2)
        frame.wire_protocol = "baidu_std"
        frame.arrival_ts = time.monotonic() - 0.08
        py_srv.process_request(cap, frame)
        assert cap.written[0] == r2, "native and Python sheds differ"
        # counted: the per-port C++ counter at once; the global count once
        # the telemetry drain folds it in
        assert srv._native_plane.stats()["deadline_sheds"] == 1
        srv._native_plane.drain_telemetry()
        assert shed_count.get_value() >= before + 1

    def test_fresh_deadline_rides_the_fast_path(self, pkg, native_shed):
        srv = native_shed
        ch = connect(pkg, srv.port, native_plane=True, protocol="baidu_std", timeout_ms=2000)
        base = srv._native_plane.stats()
        c = ch.call_method("svc", "echo", b"hello")
        assert c.ok() and c.response_payload == b"hello"
        after = srv._native_plane.stats()
        assert after["native_reqs"] == base["native_reqs"] + 1
        assert after["cb_frames"] == base["cb_frames"]


def test_native_and_python_deadline_sheds_are_the_same_bytes_in_both_packages():
    frames = []
    for pkg in PKGS.values():
        t = pkg.tbus
        srv = server(pkg, {"svc": {"echo": lambda c, r: r}})
        for wire in ("tbus_std", "baidu_std"):
            cap = _CaptureSock()
            frame = t.ParsedFrame(meta=t.Meta(service="svc", method="echo", timeout_ms=30),
                                  payload=b"b", correlation_id=2)
            frame.wire_protocol = wire
            frame.arrival_ts = time.monotonic() - 0.08
            srv.process_request(cap, frame)
            frames.append((pkg.name, wire, cap.written[0]))
    by_pkg = {}
    for name, wire, data in frames:
        by_pkg.setdefault(name, []).append(data)
    assert by_pkg["torch"] == by_pkg["jax"]


# -- the resume barrier and the checkpoint rings (parallel/mc_dispatch.py) ----

from incubator_brpc_tpu.parallel import mc_dispatch as jax_mcd  # noqa: E402
from incubator_brpc_tpu_torch.parallel import mc_dispatch as port_mcd  # noqa: E402


class _Arr:
    """An array whose completion the JAX ring probes (``is_ready``)."""

    def __init__(self, ready):
        self._r = ready

    def is_ready(self):
        return self._r


class _Event:
    """A recorded event whose completion the port's ring probes (``query``)."""

    def __init__(self, ready):
        self._r = ready

    def query(self):
        return self._r


@pytest.fixture(params=["jax", "torch"])
def rings(request, monkeypatch):
    """The package's mc_dispatch, and ``put(ring, step, x, ready, depth)``:
    a checkpoint whose step the device has (or has not) computed. The JAX
    ring asks the arrays; the port's ring records an event on the row's
    device and asks it."""
    if request.param == "jax":
        def put(ring, step, x, ready, depth):
            ring.put(step, x if ready else _Arr(False), _Arr(True), depth=depth)

        return types.SimpleNamespace(mcd=jax_mcd, put=put)

    def put(ring, step, x, ready, depth):
        monkeypatch.setattr(port_mcd, "_record_event", lambda device: _Event(ready))
        ring.put(step, x, types.SimpleNamespace(device="cpu"), depth=depth)

    return types.SimpleNamespace(mcd=port_mcd, put=put)


class TestResumePointJoin:
    @staticmethod
    def _info(wm, steps):
        return {"watermark": wm, "steps": list(steps)}

    def test_min_join_over_skewed_watermarks(self, rings):
        wms = {0: self._info(4, [2, 4]), 1: self._info(6, [2, 4, 6]), 2: self._info(2, [2])}
        assert rings.mcd.resume_point(wms) == 2

    def test_zero_checkpoint_falls_back_to_full_restart(self, rings):
        rp = rings.mcd.resume_point
        assert rp({0: self._info(6, [2, 4, 6]), 1: self._info(0, [])}) == 0
        assert rp({0: self._info(6, [2, 4, 6]), 1: None}) == 0
        assert rp({}) == 0

    def test_evicted_min_falls_back_to_deepest_common(self, rings):
        rp = rings.mcd.resume_point
        assert rp({0: self._info(4, [2, 4]), 1: self._info(6, [2, 6])}) == 2
        assert rp({0: self._info(4, [4]), 1: self._info(6, [6])}) == 0


class TestCheckpointRings:
    def test_census_release_and_gauge(self, rings):
        mcd = rings.mcd
        sid = "t-ring-census"
        ring = mcd._checkpoint_ring(sid, 1, (10, 11, 12), entry_bytes=100)
        for step in (2, 4, 6):
            rings.put(ring, step, object(), True, 2)
        assert ring.steps() == [4, 6]  # depth 2: step 2 evicted
        wm = mcd.checkpoint_watermarks(sid)
        assert wm[1]["watermark"] == 6 and wm[1]["steps"] == [4, 6]
        assert mcd.checkpoint_bytes_retained() >= 200
        assert mcd.release_checkpoints(sid)
        assert not mcd.checkpoint_watermarks(sid)
        assert not mcd.release_checkpoints(sid)  # idempotent

    def test_unready_entries_excluded_from_census(self, rings):
        mcd = rings.mcd
        sid = "t-ring-ready"
        ring = mcd._checkpoint_ring(sid, 0, (1, 2), entry_bytes=10)
        rings.put(ring, 2, object(), True, 4)
        rings.put(ring, 4, object(), False, 4)
        # a dispatched-but-never-completed step is not a resume point
        assert ring.steps() == [2]
        assert mcd.checkpoint_watermarks(sid)[0]["watermark"] == 2
        mcd.release_checkpoints(sid)

    def test_resumed_replay_replaces_stale_same_step_entry(self, rings):
        mcd = rings.mcd
        sid = "t-ring-replace"
        ring = mcd._checkpoint_ring(sid, 0, (1, 2), entry_bytes=10)
        rings.put(ring, 2, object(), True, 4)
        rings.put(ring, 4, object(), False, 4)  # wedged, never ready
        assert ring.watermark() == 2
        fresh = object()
        rings.put(ring, 4, fresh, True, 4)  # the replayed step 4
        assert ring.steps() == [2, 4]
        assert ring.get(4)[0] is fresh  # not the stale shadow
        assert ring.watermark() == 4
        mcd.release_checkpoints(sid)

    def test_cap_eviction_spares_active_sessions(self, rings):
        mcd = rings.mcd
        sid = "t-ring-active"
        st = mcd._register_session(sid, (1, 2), deadline=0.0)
        churn = [f"t-ring-churn-{i}" for i in range(mcd._MAX_CHECKPOINT_SESSIONS + 4)]
        try:
            mcd._checkpoint_ring(sid, 0, (1, 2), entry_bytes=1)
            for c in churn:
                mcd._checkpoint_ring(c, 0, (1,), entry_bytes=1)
            assert mcd._checkpoint_lookup(sid, 0) is not None, "churn evicted a LIVE session's ring"
        finally:
            mcd._unregister_session(st)
            mcd.release_checkpoints(sid)
            for c in churn:
                mcd.release_checkpoints(c)

    def test_session_cap_evicts_oldest(self, rings):
        mcd = rings.mcd
        sids = [f"t-ring-cap-{i}" for i in range(mcd._MAX_CHECKPOINT_SESSIONS + 2)]
        for sid in sids:
            mcd._checkpoint_ring(sid, 0, (1,), entry_bytes=1)
        assert not mcd.checkpoint_watermarks(sids[0])  # evicted
        assert mcd._checkpoint_lookup(sids[-1], 0) is not None
        for sid in sids:
            mcd.release_checkpoints(sid)
