"""The port's load balancers, naming services, circuit breaker and pooled and
short connections (``incubator_brpc_tpu_torch.lb``, ``.naming``,
``.rpc.circuit_breaker``, ``.transport.socket_map``; ROADMAP A8) on the
CPU, held against the JAX package's:

- all 11 tests of tests/test_lb_naming.py, the 8 of
  tests/test_connection_types.py but ``test_backup_request_keeps_original_connection``
  (a backup request: tests/test_torch_policies.py, ROADMAP A7),
  ``TestCircuitBreakerUnit`` of tests/test_robustness.py (4), and the three
  cases of its ``TestBrownoutRecovery`` that need no ``FaultInjector`` and
  no backup request (``test_connect_refused_feeds_breaker``,
  ``test_naming_churn_drops_breaker``,
  ``test_lb_stop_unhooks_revival_callbacks``; the other six are in
  tests/test_torch_robustness.py) — each run on both packages
  with the answers the JAX package's own tests assert. The port's servers
  are built with ``ServerOptions(device="cpu")``;
- LB parity: one seeded script of add, remove, select (with ``excluded``
  and ``request_code``), feedback and settle through each of the five
  policies of both packages (``random`` on the seeded ``random`` module,
  ``la`` given ``random.Random(seed)``): identical pick sequences;
- naming parity: one ``file://`` list rewritten four times (adds, removes,
  a tag change): both packages' observers see the same calls in the same
  order;
- breaker parity: an ``rr`` LB channel over three servers whose handlers
  fail on demand with ``EINTERNAL``, the breaker on by default: both
  packages isolate the failing node after the same calls, answer
  ``EHOSTDOWN`` once every node is isolated, revive after the isolation
  window (doubled for a node that re-trips while half open) and serve again;
- the naming services that speak HTTP (ROADMAP A11a; refused naming A11
  before): ``TestWatchNaming`` and ``TestRemoteFileNaming`` of
  tests/test_watch_nshead.py on both packages (the watch endpoint's
  blocking query, a server-set change reaching a live channel's LB through
  the watch, a list fetched over HTTP), and one ``rr`` channel a scheme on
  both, each following a list change to the same servers.

Each test stops the servers it started; after each the port's host plane
and timer thread are shut down and no ``tbtorch-*`` thread is left."""

import collections
import random
import socket as pysocket
import threading
import time
import types

import pytest

import incubator_brpc_tpu.lb as jax_lb
import incubator_brpc_tpu.naming as jax_naming
import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu.rpc.circuit_breaker as jax_cb
import incubator_brpc_tpu.utils.flags as jax_flags
from incubator_brpc_tpu.utils.endpoint import EndPoint as JaxEndPoint
import incubator_brpc_tpu_torch.lb as port_lb
import incubator_brpc_tpu_torch.naming as port_naming
import incubator_brpc_tpu_torch.rpc as port_rpc
import incubator_brpc_tpu_torch.rpc.circuit_breaker as port_cb
import incubator_brpc_tpu_torch.utils.flags as port_flags
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint
from incubator_brpc_tpu_torch.utils.status import ErrorCode

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", rpc=jax_rpc, lb=jax_lb, naming=jax_naming, cb=jax_cb, flags=jax_flags,
        EndPoint=JaxEndPoint, server_kw={},
    ),
    "torch": types.SimpleNamespace(
        name="torch", rpc=port_rpc, lb=port_lb, naming=port_naming, cb=port_cb,
        flags=port_flags, EndPoint=EndPoint, server_kw={"device": "cpu"},
    ),
}

_OPEN = []  # servers the test started, stopped at teardown


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    while _OPEN:
        srv = _OPEN.pop()
        srv.stop()
        srv.join(timeout=10)
    port_rpc.shutdown_host_plane()
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture
def flags(pkg):
    """Set flags of ``pkg`` for one test; the old values come back after."""
    touched = {}

    def tune(name, value):
        if name not in touched:
            touched[name] = pkg.flags.flag_registry.get(name)
        pkg.flags.set_flag_unchecked(name, value)

    yield tune
    for name, value in touched.items():
        pkg.flags.set_flag_unchecked(name, value)


def make_server(pkg, services, start_port=0):
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
    for name, handlers in services.items():
        srv.add_service(name, handlers)
    assert srv.start(start_port)
    _OPEN.append(srv)
    return srv


def named_server(pkg, name: bytes, delay: float = 0.0):
    def echo(cntl, req):
        if delay:
            time.sleep(delay)
        return name

    return make_server(pkg, {"svc": {"echo": echo}})


def ep(pkg, port):
    return pkg.EndPoint(ip="127.0.0.1", port=port)


def wait_until(cond, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def dead_port():
    probe = pysocket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


# -- tests/test_lb_naming.py ---------------------------------------------------


class TestLbUnits:
    def test_rr_cycles_evenly(self, pkg):
        lb = pkg.lb.RoundRobinLB()
        for p in (1, 2, 3):
            lb.add_server(ep(pkg, p))
        picks = [lb.select().port for _ in range(9)]
        assert collections.Counter(picks) == {1: 3, 2: 3, 3: 3}

    def test_wrr_respects_weights(self, pkg):
        lb = pkg.lb.WeightedRoundRobinLB()
        lb.add_server(ep(pkg, 1), weight=3)
        lb.add_server(ep(pkg, 2), weight=1)
        picks = collections.Counter(lb.select().port for _ in range(80))
        assert picks[1] > picks[2] * 2

    def test_consistent_hash_stability(self, pkg):
        lb = pkg.lb.ConsistentHashLB()
        for p in (1, 2, 3, 4):
            lb.add_server(ep(pkg, p))
        owner = {code: lb.select(request_code=code).port for code in range(200)}
        for code in range(200):
            assert lb.select(request_code=code).port == owner[code]
        # removing one server remaps ONLY its keys (ketama property)
        lb.remove_server(ep(pkg, 3))
        moved = sum(1 for code in range(200) if lb.select(request_code=code).port != owner[code])
        lost = sum(1 for code in range(200) if owner[code] == 3)
        assert moved == lost

    def test_la_prefers_fast_server(self, pkg):
        lb = pkg.lb.LocalityAwareLB(rng=random.Random(42))
        fast, slow = ep(pkg, 1), ep(pkg, 2)
        lb.add_server(fast)
        lb.add_server(slow)
        for _ in range(50):
            chosen = lb.select()
            lb.feedback(chosen, 100.0 if chosen == fast else 50_000.0, 0)
        picks = collections.Counter()
        for _ in range(200):
            chosen = lb.select()
            picks[chosen.port] += 1
            lb.feedback(chosen, 100.0 if chosen == fast else 50_000.0, 0)
        assert picks[1] > picks[2] * 5

    def test_la_punishes_errors(self, pkg):
        lb = pkg.lb.LocalityAwareLB()
        good, bad = ep(pkg, 1), ep(pkg, 2)
        lb.add_server(good)
        lb.add_server(bad)
        for _ in range(50):
            chosen = lb.select()
            lb.feedback(chosen, 200.0, 0 if chosen == good else 1014)
        assert lb.expected_latency_us(bad) > lb.expected_latency_us(good) * 3


class TestNamingMidTraffic:
    def test_add_remove_servers_mid_traffic(self, pkg, tmp_path):
        s1 = named_server(pkg, b"one")
        s2 = named_server(pkg, b"two")
        f = tmp_path / "servers"
        f.write_text(f"127.0.0.1:{s1.port}\n")
        ch = pkg.rpc.Channel()
        assert ch.init(f"file://{f}", "rr")
        for _ in range(4):
            assert ch.call_method("svc", "echo", b"").response_payload == b"one"
        f.write_text(f"127.0.0.1:{s1.port}\n127.0.0.1:{s2.port}\n")
        ch._lb.ns_thread._refresh()
        seen = {ch.call_method("svc", "echo", b"").response_payload for _ in range(10)}
        assert seen == {b"one", b"two"}
        f.write_text(f"127.0.0.1:{s2.port}\n")
        ch._lb.ns_thread._refresh()
        for _ in range(6):
            cntl = ch.call_method("svc", "echo", b"")
            assert cntl.ok(), cntl.error_text
            assert cntl.response_payload == b"two"
        ch._lb.stop()

    def test_la_avoids_injected_slow_server_e2e(self, pkg):
        fast1 = named_server(pkg, b"f1")
        fast2 = named_server(pkg, b"f2")
        slow = named_server(pkg, b"slow", delay=0.08)
        ch = pkg.rpc.Channel()
        assert ch.init(
            f"list://127.0.0.1:{fast1.port},127.0.0.1:{fast2.port},127.0.0.1:{slow.port}",
            "la",
            options=pkg.rpc.ChannelOptions(timeout_ms=5000),
        )
        counts = collections.Counter()
        for _ in range(60):
            cntl = ch.call_method("svc", "echo", b"")
            assert cntl.ok(), cntl.error_text
            counts[cntl.response_payload] += 1
        assert counts[b"slow"] < 60 / 3 / 2, counts
        assert counts[b"f1"] > 0 and counts[b"f2"] > 0
        ch._lb.stop()

    def test_all_servers_removed_fails_cleanly(self, pkg, tmp_path):
        s1 = named_server(pkg, b"solo")
        f = tmp_path / "servers"
        f.write_text(f"127.0.0.1:{s1.port}\n")
        ch = pkg.rpc.Channel()
        assert ch.init(f"file://{f}", "rr")
        assert ch.call_method("svc", "echo", b"").ok()
        f.write_text("\n")
        ch._lb.ns_thread._refresh()
        cntl = ch.call_method("svc", "echo", b"")
        assert cntl.failed()  # no server: fails, doesn't hang
        ch._lb.stop()


class TestAllExcludedAndReconnect:
    def test_all_excluded_fails_selection(self, pkg):
        for lb in (pkg.lb.RoundRobinLB(), pkg.lb.RandomLB()):
            eps = [pkg.EndPoint("127.0.0.1", 7001), pkg.EndPoint("127.0.0.1", 7002)]
            for e in eps:
                lb.add_server(e)
            assert lb.select(excluded=set(eps)) is None
            assert lb.select(excluded={eps[0]}) == eps[1]

    def test_all_excluded_rpc_fails_with_ehostdown(self, pkg, tmp_path):
        srv = make_server(pkg, {"t": {"echo": lambda cntl, req: req}})
        path = tmp_path / "servers.lst"
        path.write_text(f"127.0.0.1:{srv.port}\n")
        ch = pkg.rpc.Channel()
        assert ch.init(f"file://{path}", "rr",
                       options=pkg.rpc.ChannelOptions(timeout_ms=3000, max_retry=2))
        assert ch.call_method("t", "echo", b"warm").ok()
        srv.stop()
        srv.join(timeout=5)
        cntl = ch.call_method("t", "echo", b"x",
                              cntl=pkg.rpc.Controller(timeout_ms=3000, max_retry=2))
        assert cntl.failed()
        assert cntl.error_code in (
            ErrorCode.EHOSTDOWN, ErrorCode.EFAILEDSOCKET, ErrorCode.EEOF, ErrorCode.ERPCTIMEDOUT,
        )
        ch._lb.stop()

    def test_fast_reconnect_without_health_check_wait(self, pkg, flags):
        flags("health_check_interval", 30)
        srv = make_server(pkg, {"t": {"echo": lambda cntl, req: req}})
        port = srv.port
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{port}")
        assert ch.call_method("t", "echo", b"warm").ok()
        srv.stop()
        srv.join(timeout=5)
        ch.call_method("t", "echo", b"probe", cntl=pkg.rpc.Controller(timeout_ms=300, max_retry=0))
        make_server(pkg, {"t": {"echo": lambda cntl, req: req}}, start_port=port)
        cntl = ch.call_method("t", "echo", b"back",
                              cntl=pkg.rpc.Controller(timeout_ms=8000, max_retry=1))
        assert cntl.ok(), f"inline reconnect did not happen: {cntl.error_text}"


# -- tests/test_connection_types.py ---------------------------------------------


@pytest.fixture
def ct_server(pkg):
    def echo(cntl, req):
        time.sleep(0.02)
        return req

    return make_server(pkg, {"ct": {"echo": echo}})


def _wait_conns(server, want, timeout=5.0):
    return wait_until(lambda: server.connection_count() == want, timeout)


class TestConnectionTypes:
    def test_single_shares_one_connection(self, pkg, ct_server):
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{ct_server.port}",
                       options=pkg.rpc.ChannelOptions(connection_type="single"))
        for _ in range(5):
            assert ch.call_method("ct", "echo", b"x").ok()
        assert ct_server.connection_count() == 1

    def test_short_closes_after_each_call(self, pkg, ct_server):
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{ct_server.port}",
                       options=pkg.rpc.ChannelOptions(connection_type="short"))
        for _ in range(3):
            assert ch.call_method("ct", "echo", b"x").ok()
            assert _wait_conns(ct_server, 0)

    def test_pooled_reuses_sequentially(self, pkg, ct_server):
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{ct_server.port}",
                       options=pkg.rpc.ChannelOptions(connection_type="pooled"))
        for _ in range(5):
            assert ch.call_method("ct", "echo", b"x").ok()
        assert ct_server.connection_count() == 1

    def test_lb_target_accepts_non_single(self, pkg, ct_server):
        ch = pkg.rpc.Channel()
        assert ch.init(f"list://127.0.0.1:{ct_server.port}", "rr",
                       options=pkg.rpc.ChannelOptions(connection_type="short"))
        assert ch.call_method("ct", "echo", b"via-short-lb").ok()
        ch2 = pkg.rpc.Channel()
        assert ch2.init(f"list://127.0.0.1:{ct_server.port}", "rr",
                        options=pkg.rpc.ChannelOptions(transport="tpu", timeout_ms=60000))
        cntl = ch2.call_method("ct", "echo", b"via-tpu-lb")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"via-tpu-lb"
        ch._lb.stop()
        ch2._lb.stop()

    def test_pooled_concurrent_calls_use_distinct_connections(self, pkg):
        n = 4
        barrier = threading.Barrier(n)

        def gated_echo(cntl, req):
            barrier.wait(timeout=10)
            return req

        s = make_server(pkg, {"ct": {"echo": gated_echo}})
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{s.port}",
                       options=pkg.rpc.ChannelOptions(connection_type="pooled", timeout_ms=10000))
        errs = []

        def worker():
            c = ch.call_method("ct", "echo", b"y")
            if c.failed():
                errs.append(c.error_text)

        for _ in range(2):  # the second wave reuses the parked connections
            ts = [threading.Thread(target=worker) for _ in range(n)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert not errs
            assert s.connection_count() == n


@pytest.fixture
def two_servers(pkg, tmp_path):
    servers = []
    for _ in range(2):
        servers.append(make_server(pkg, {"ct": {"echo": lambda cntl, req: req}}))
    path = tmp_path / "servers.lst"
    path.write_text("".join(f"127.0.0.1:{s.port}\n" for s in servers))
    return servers, str(path)


class TestConnectionTypesWithNaming:
    @pytest.mark.parametrize("ctype", ["pooled", "short"])
    def test_lb_target_with_secondary_connections(self, pkg, two_servers, ctype):
        servers, path = two_servers
        ch = pkg.rpc.Channel()
        assert ch.init(f"file://{path}", "rr",
                       options=pkg.rpc.ChannelOptions(connection_type=ctype, timeout_ms=5000))
        seen = set()
        for i in range(8):
            cntl = ch.call_method("ct", "echo", f"m{i}".encode())
            assert cntl.ok(), cntl.error_text
            assert cntl.response_payload == f"m{i}".encode()
            seen.add((cntl.remote_side.ip, cntl.remote_side.port))
        assert len(seen) == 2
        ch._lb.stop()

    def test_pooled_lb_parks_per_endpoint(self, pkg, two_servers):
        servers, path = two_servers
        ch = pkg.rpc.Channel()
        assert ch.init(f"file://{path}", "rr",
                       options=pkg.rpc.ChannelOptions(connection_type="pooled", timeout_ms=5000))
        for _ in range(4):
            assert ch.call_method("ct", "echo", b"x").ok()
        pooled_keys = {k for k, v in ch._socket_map._pooled.items() if v}
        ports = {int(k.split("|")[0].rsplit(":", 1)[1]) for k in pooled_keys}
        assert ports >= {s.port for s in servers}
        ch._lb.stop()


# -- tests/test_robustness.py: the breaker -------------------------------------


class TestCircuitBreakerUnit:
    def test_initializing_phase_trips_on_error_count(self, pkg, flags):
        flags("circuit_breaker_short_window_size", 50)
        flags("circuit_breaker_short_window_error_percent", 10)
        flags("circuit_breaker_long_window_size", 1000)
        cb = pkg.cb.CircuitBreaker()
        for _ in range(4):
            assert cb.on_call_end(ErrorCode.EINTERNAL, 1000.0)
        assert not cb.broken
        assert not cb.on_call_end(ErrorCode.EINTERNAL, 1000.0)
        assert cb.broken
        assert cb.isolated_times == 1

    def test_errors_within_budget_stay_closed(self, pkg, flags):
        flags("circuit_breaker_short_window_size", 100)
        flags("circuit_breaker_short_window_error_percent", 10)
        flags("circuit_breaker_long_window_size", 1000)
        cb = pkg.cb.CircuitBreaker()
        for i in range(100):
            code = ErrorCode.EINTERNAL if i % 20 == 0 else 0
            assert cb.on_call_end(code, 1000.0)
        assert not cb.broken

    def test_isolation_duration_doubles_on_fast_retrip(self, pkg, flags):
        flags("circuit_breaker_short_window_size", 20)
        flags("circuit_breaker_min_isolation_duration_ms", 100)
        flags("circuit_breaker_max_isolation_duration_ms", 1000)
        cb = pkg.cb.CircuitBreaker()
        for _ in range(3):
            cb.on_call_end(ErrorCode.EINTERNAL, 1000.0)
        assert cb.broken
        assert cb.isolation_duration_ms == 100
        cb.reset()
        assert cb.state() == "half_open"
        for _ in range(3):
            cb.on_call_end(ErrorCode.EINTERNAL, 1000.0)
        assert cb.broken
        assert cb.isolation_duration_ms == 200
        cb.reset()
        for _ in range(3):
            cb.on_call_end(ErrorCode.EINTERNAL, 1000.0)
        assert cb.isolation_duration_ms == 400

    def test_ema_error_cost_decays_on_success(self, pkg, flags):
        flags("circuit_breaker_short_window_size", 100)
        cb = pkg.cb.CircuitBreaker()
        cb.on_call_end(0, 1000.0)
        cb.on_call_end(ErrorCode.EINTERNAL, 1000.0)
        cost1 = cb._short.describe()["ema_error_cost_us"]
        assert cost1 > 0
        for _ in range(50):
            assert cb.on_call_end(0, 1000.0)
        assert cb._short.describe()["ema_error_cost_us"] < cost1


class TestBrownoutRecovery:
    def test_connect_refused_feeds_breaker(self, pkg, flags):
        flags("enable_circuit_breaker", True)
        flags("circuit_breaker_short_window_size", 20)
        flags("circuit_breaker_min_isolation_duration_ms", 5000)
        up = make_server(pkg, {"e": {"m": lambda cntl, req: b"ok"}})
        down = dead_port()
        ch = pkg.rpc.Channel()
        assert ch.init(f"list://127.0.0.1:{up.port},127.0.0.1:{down}", lb_name="rr",
                       options=pkg.rpc.ChannelOptions(max_retry=1, timeout_ms=2000))
        for _ in range(15):
            c = ch.call_method("e", "m", b"x")
            assert c.ok(), c.error_text
            if ch._lb.isolated_servers():
                break
        iso = ch._lb.isolated_servers()
        assert iso and iso[0].port == down, (iso, ch._lb.breaker_states())
        ch._lb.stop()

    def test_naming_churn_drops_breaker(self, pkg, flags):
        flags("enable_circuit_breaker", True)
        srv = make_server(pkg, {"e": {"m": lambda cntl, req: b"ok"}})
        ch = pkg.rpc.Channel()
        assert ch.init(f"list://127.0.0.1:{srv.port}", lb_name="rr",
                       options=pkg.rpc.ChannelOptions(max_retry=0, timeout_ms=2000))
        assert ch.call_method("e", "m", b"x").ok()
        lb = ch._lb
        ep_key = f"127.0.0.1:{srv.port}"
        assert ep_key in lb.breaker_states()
        lb.remove_server(pkg.EndPoint(ip="127.0.0.1", port=srv.port))
        assert ep_key not in lb.breaker_states()
        assert not any(owner == lb._cb_tag for (owner, _), _cb in pkg.cb.breaker_registry.snapshot())
        lb.stop()

    def test_lb_stop_unhooks_revival_callbacks(self, pkg, flags):
        flags("enable_circuit_breaker", True)
        srv = make_server(pkg, {"e": {"m": lambda cntl, req: b"ok"}})
        ch = pkg.rpc.Channel()
        assert ch.init(f"list://127.0.0.1:{srv.port}", lb_name="rr",
                       options=pkg.rpc.ChannelOptions(max_retry=0, timeout_ms=2000))
        assert ch.call_method("e", "m", b"x").ok()
        hooks = ch._lb._revival_hooks
        assert hooks, "revival hook was never installed"
        sock, cb = hooks[0]
        assert cb in sock.on_revived
        ch._lb.stop()
        assert cb not in sock.on_revived
        assert not ch._lb._revival_hooks


# -- parity between the packages -----------------------------------------------

POLICIES = ("rr", "random", "wrr", "c_hash", "la")


def lb_script(seed=7, n_ops=400):
    """A seeded script of LB operations over ports 1-8."""
    rng = random.Random(seed)
    ops = [("add", p, rng.randint(1, 4)) for p in (1, 2, 3, 4)]
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.06:
            ops.append(("add", rng.randint(1, 8), rng.randint(1, 4)))
        elif r < 0.1:
            ops.append(("remove", rng.randint(1, 8)))
        elif r < 0.7:
            excluded = tuple(sorted(rng.sample(range(1, 9), rng.randint(0, 2))))
            code = rng.getrandbits(64) if rng.random() < 0.5 else None
            ops.append(("select", excluded, code))
        elif r < 0.9:
            ops.append(("feedback", rng.uniform(50, 5000), rng.choice((0, 0, 0, 1014))))
        else:
            ops.append(("settle",))
    return ops


def run_lb_script(pkg, policy, ops, seed=7):
    """Drive ``ops`` through ``pkg``'s ``policy``; returns every select's
    pick and every add/remove's answer. Feedback and settle go to the last
    pick."""
    random.seed(seed)  # rr/wrr ignore it; random and c_hash (no code) draw from it
    if policy == "la":
        lb = pkg.lb.LocalityAwareLB(rng=random.Random(seed))
    else:
        lb = pkg.lb.create_load_balancer(policy)
    out, last = [], None
    for op in ops:
        if op[0] == "add":
            out.append(("add", op[1], lb.add_server(ep(pkg, op[1]), weight=op[2])))
        elif op[0] == "remove":
            out.append(("remove", op[1], lb.remove_server(ep(pkg, op[1]))))
        elif op[0] == "select":
            got = lb.select(excluded={ep(pkg, p) for p in op[1]}, request_code=op[2])
            last = got
            out.append(("select", None if got is None else got.port))
        elif last is not None and op[0] == "feedback":
            lb.feedback(last, op[1], op[2])
        elif last is not None:
            lb.settle(last)
    if policy == "la":
        out.append(("la", sorted((e.port, lb.expected_latency_us(e)) for e in lb.servers())))
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_lb_pick_sequences_match_the_jax_package(policy):
    ops = lb_script()
    want = run_lb_script(PKGS["jax"], policy, ops)
    got = run_lb_script(PKGS["torch"], policy, ops)
    picks = [p for kind, p in ((o[0], o[1]) for o in want) if kind == "select"]
    assert len(set(picks) - {None}) >= 3  # the script exercises several servers
    assert got == want


def naming_observer_calls(pkg, path):
    """Observer calls of a NamingServiceThread over ``path`` through four
    rewrites (the thread's own timer stopped; refreshed by hand)."""
    rewrites = [
        "127.0.0.1:7001 0/2\n127.0.0.1:7002 1/2\n",
        "127.0.0.1:7001 0/2\n127.0.0.1:7002 1/2\n127.0.0.1:7003\n127.0.0.1:7004 x\n",
        "127.0.0.1:7002 1/2\n127.0.0.1:7004 x\n",
        "127.0.0.1:7002 0/2\n127.0.0.1:7004 x\n127.0.0.1:7005\n",
        "# empty\n",
    ]
    path.write_text(rewrites[0])
    nst = pkg.naming.NamingServiceThread(f"file://{path}")
    nst.stop()
    events = []

    class Obs:
        def add_server(self, e):
            events.append(("add", e.port, e.tag))

        def remove_server(self, e):
            events.append(("rm", e.port, e.tag))

    nst._refresh()
    nst.add_observer(Obs())
    for text in rewrites[1:]:
        path.write_text(text)
        nst._refresh()
    return events


def test_naming_observer_calls_match_the_jax_package(tmp_path):
    want = naming_observer_calls(PKGS["jax"], tmp_path / "jax.lst")
    got = naming_observer_calls(PKGS["torch"], tmp_path / "torch.lst")
    assert got == want
    assert want == [
        ("add", 7001, "0/2"), ("add", 7002, "1/2"),
        ("add", 7003, ""), ("add", 7004, "x"),
        ("rm", 7001, "0/2"), ("rm", 7003, ""),
        ("rm", 7002, "1/2"), ("add", 7002, "0/2"), ("add", 7005, ""),
        ("rm", 7002, "0/2"), ("rm", 7004, "x"), ("rm", 7005, ""),
    ]


def breaker_script(pkg):
    """An rr LB channel over three servers whose handlers fail with
    EINTERNAL while their index is in ``failing``; returns what each phase
    saw. Short windows: two errors trip a node, isolation 300 ms."""
    failing = set()

    def handler(i):
        def m(cntl, req):
            if i in failing:
                cntl.set_failed(ErrorCode.EINTERNAL, "failing on demand")
                return b""
            return b"s%d" % i
        return m

    servers = [make_server(pkg, {"e": {"m": handler(i)}}) for i in range(3)]
    index = {s.port: i for i, s in enumerate(servers)}
    ch = pkg.rpc.Channel()
    assert ch.init("list://" + ",".join(f"127.0.0.1:{s.port}" for s in servers), "rr",
                   options=pkg.rpc.ChannelOptions(max_retry=0, timeout_ms=5000))
    lb = ch._lb

    def isolated():
        return sorted(index[e.port] for e in lb.isolated_servers())

    def call():
        c = ch.call_method("e", "m", b"x")
        return (c.error_code, c.response_payload, isolated())

    out = {}
    failing.add(2)
    out["trip"] = [call() for _ in range(8)]
    t_iso = time.monotonic()
    states = lb.breaker_states()
    out["trip_states"] = [(states[f"127.0.0.1:{s.port}"]["state"],
                           states[f"127.0.0.1:{s.port}"]["isolation_duration_ms"]) for s in servers]
    assert wait_until(lambda: not lb.isolated_servers(), timeout=10.0)
    out["revived_after_window"] = time.monotonic() - t_iso >= 0.3 * 0.9
    failing.update({0, 1})
    out["all"] = [call() for _ in range(8)]
    failing.clear()
    assert wait_until(lambda: not lb.isolated_servers(), timeout=10.0)
    out["revived"] = [call() for _ in range(6)]
    states = lb.breaker_states()
    out["revived_states"] = [(states[f"127.0.0.1:{s.port}"]["state"],
                              states[f"127.0.0.1:{s.port}"]["isolated_times"],
                              states[f"127.0.0.1:{s.port}"]["isolation_duration_ms"])
                             for s in servers]
    lb.stop()
    return out


def test_breaker_isolates_and_revives_as_the_jax_package(tuned_flags):
    touched = []
    for pkg in PKGS.values():
        for name, value in (("circuit_breaker_short_window_size", 20),
                            ("circuit_breaker_long_window_size", 1000),
                            ("circuit_breaker_min_isolation_duration_ms", 300)):
            touched.append((pkg, name, pkg.flags.flag_registry.get(name)))
            pkg.flags.set_flag_unchecked(name, value)
    try:
        assert port_flags.get_flag("enable_circuit_breaker") is True  # on by default
        want = breaker_script(PKGS["jax"])
        got = breaker_script(PKGS["torch"])
    finally:
        for pkg, name, value in touched:
            pkg.flags.set_flag_unchecked(name, value)
    assert got == want
    ok, fail, down = 0, ErrorCode.EINTERNAL, ErrorCode.EHOSTDOWN
    # rr: the failing node (index 2) answers the 3rd and 6th calls; its
    # second error trips it, and the rest go to 0 and 1
    assert [c[0] for c in want["trip"]] == [ok, ok, fail, ok, ok, fail, ok, ok]
    assert want["trip"][5][2] == [2] and want["trip"][4][2] == []
    assert want["trip_states"][2] == ("isolated", 300)
    assert want["revived_after_window"]
    # every node failing: each trips on its second error, then EHOSTDOWN
    assert [c[0] for c in want["all"]][-2:] == [down, down]
    assert want["all"][-1][2] == [0, 1, 2]
    assert all(c[0] == ok for c in want["revived"])
    # node 2 re-tripped while half open: its isolation doubled
    assert [s[1:] for s in want["revived_states"]] == [(1, 300), (1, 300), (2, 600)]


def _watch_module(pkg):
    import importlib

    return importlib.import_module(f"{pkg.naming.__name__}.watch")


def _wake_watchers(registry):
    """Answer every parked blocking query (a handler waits up to its
    ``wait``): bump each set's version with the same servers."""
    for name in list(registry._sets):
        registry.update(name, registry.get(name)[1])


def test_port_refuses_http_naming_naming_a11(pkg, flags):
    """Once refused naming A11: both packages serve ``remotefile://`` and
    ``watch://``, and a channel over each follows a list change to the
    same servers."""
    flags("ns_refresh_interval_s", 0.1)
    watch = _watch_module(pkg)
    backends = [make_server(pkg, {"w": {"who": (lambda i: lambda c, r: b"%d" % i)(i)}})
                for i in range(2)]
    listing = {"body": f"127.0.0.1:{backends[0].port}\n".encode()}
    registry = watch.WatchRegistry()
    registry.update("pool", [f"127.0.0.1:{backends[0].port}"])
    host = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
    host.add_http_handler("/servers.lst", lambda f: (200, "text/plain", listing["body"]))
    watch.install_watch_endpoint(host, registry)
    assert host.start(0)
    _OPEN.append(host)
    urls = (f"remotefile://127.0.0.1:{host.port}/servers.lst",
            f"watch://127.0.0.1:{host.port}/pool")
    channels, rows = [], []
    try:
        for url in urls:
            ch = pkg.rpc.Channel()
            assert ch.init(url, "rr")
            channels.append(ch)
            rows.append(sorted({ch.call_method("w", "who", b"").response_payload
                                for _ in range(4)}))
        listing["body"] = b"".join(f"127.0.0.1:{b.port}\n".encode() for b in backends)
        registry.update("pool", [f"127.0.0.1:{b.port}" for b in backends])
        for ch in channels:
            seen = set()
            deadline = time.monotonic() + 10
            while len(seen) < 2 and time.monotonic() < deadline:
                c = ch.call_method("w", "who", b"")
                if c.ok():
                    seen.add(c.response_payload)
                time.sleep(0.02)
            rows.append(sorted(seen))
    finally:
        for ch in channels:
            ch._lb.stop()
        _wake_watchers(registry)
    assert rows == [[b"0"], [b"0"], [b"0", b"1"], [b"0", b"1"]]


# -- tests/test_watch_nshead.py's naming cases on both packages ---------------


@pytest.fixture
def watch_server(pkg):
    watch = _watch_module(pkg)
    registry = watch.WatchRegistry()
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
    watch.install_watch_endpoint(srv, registry)
    assert srv.start(0)
    _OPEN.append(srv)
    yield srv, registry
    _wake_watchers(registry)


def _http_call(pkg):
    import importlib

    return importlib.import_module(pkg.rpc.__name__.replace(".rpc", ".protocol.http")).http_call


class TestWatchNaming:
    def test_blocking_query_returns_on_update(self, pkg, watch_server):
        import json

        srv, registry = watch_server
        registry.update("db", ["127.0.0.1:7001"])
        http_call = _http_call(pkg)
        status, _, body = http_call("127.0.0.1", srv.port, "/naming/db?index=0&wait=5")
        assert status == 200
        obj = json.loads(body)
        assert obj["index"] == 1 and obj["servers"] == ["127.0.0.1:7001"]
        got = {}

        def poll():
            _s, _, b = http_call("127.0.0.1", srv.port, "/naming/db?index=1&wait=10", timeout=15)
            got["resp"] = json.loads(b)

        t = threading.Thread(target=poll)
        t0 = time.monotonic()
        t.start()
        time.sleep(0.2)
        registry.update("db", ["127.0.0.1:7001", "127.0.0.1:7002"])
        t.join(timeout=10)
        dt = time.monotonic() - t0
        assert got["resp"]["index"] == 2
        assert len(got["resp"]["servers"]) == 2
        assert dt < 5, f"watch did not wake on update ({dt:.1f}s)"

    def test_mid_traffic_server_set_change_propagates_fast(self, pkg, watch_server):
        watch_srv, registry = watch_server
        backends = []
        for _ in range(2):
            holder = {}
            b = make_server(pkg, {"w": {"who": lambda c, r, h=holder: str(h["port"]).encode()}})
            holder["port"] = b.port
            backends.append(b)
        registry.update("pool", [f"127.0.0.1:{backends[0].port}"])
        ch = pkg.rpc.Channel()
        assert ch.init(f"watch://127.0.0.1:{watch_srv.port}/pool", "rr")
        seen = set()
        for _ in range(4):
            c = ch.call_method("w", "who", b"")
            assert c.ok(), c.error_text
            seen.add(c.response_payload)
        assert seen == {str(backends[0].port).encode()}
        registry.update("pool", [f"127.0.0.1:{b.port}" for b in backends])
        deadline = time.monotonic() + 5
        seen2 = set()
        while time.monotonic() < deadline and len(seen2) < 2:
            c = ch.call_method("w", "who", b"")
            if c.ok():
                seen2.add(c.response_payload)
            time.sleep(0.05)
        ch._lb.stop()
        assert seen2 == {str(b.port).encode() for b in backends}


class TestRemoteFileNaming:
    def test_remotefile_serves_and_refreshes(self, pkg, flags):
        listing = {"body": b""}
        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
        srv.add_http_handler("/servers.lst", lambda frame: (200, "text/plain", listing["body"]))
        assert srv.start(0)
        _OPEN.append(srv)
        backend = make_server(pkg, {"rf": {"echo": lambda cntl, req: req}})
        listing["body"] = f"127.0.0.1:{backend.port}\n".encode()
        flags("ns_refresh_interval_s", 0.1)
        ch = pkg.rpc.Channel()
        assert ch.init(f"remotefile://127.0.0.1:{srv.port}/servers.lst", "rr")
        c = ch.call_method("rf", "echo", b"via-remotefile")
        assert c.ok(), c.error_text
        assert c.response_payload == b"via-remotefile"
        ch._lb.stop()
