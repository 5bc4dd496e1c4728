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
  ``test_sigterm_flag_installs_handler``, the listener closed to new
  connections, the native plane's lame duck, and
  ``TestLameDuckStreamDrain`` on both. The ``/health`` and
  ``/quitquitquit`` pages of the JAX tests run in tests/test_torch_http.py,
  and its drill tool waits for A5;
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
