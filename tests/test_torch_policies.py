"""The server and channel policies of the port (ROADMAP A7) on the CPU, held
against the JAX package's:

- the limiters (``rpc/concurrency_limiter.py``): both packages'
  ``AutoConcurrencyLimiter`` fed one seeded script of (error code, latency,
  ``now_us``) samples on a synthetic clock move through identical limits at
  every step, probe-downs and all-fail windows included, with the same
  ``on_limit_change`` calls; ``tests/test_robustness.py``'s
  ``TestAutoLimiterUnit`` and ``create_concurrency_limiter``'s specs on both;
- the fault injector (``rpc/fault_injector.py``): both packages' counter
  schedules decide the same sequence from the same rates, directly and
  through the flag-built socket injector; ``TestFaultInjectorUnit`` on both;
- the retry budget (``rpc/channel.RetryBudget``): one seeded script of
  deposits and draws leaves the same balance and the same verdict at every
  step on both; ``TestRetryBudget``'s unit cases on both;
- auth (``rpc/auth.py``): ``tests/test_auth_dynpart_memcache.py::TestAuth``
  on both, the credential verified once per connection, the request frames
  a credential rides byte for byte alike, and interop both ways (a port
  Channel with credentials against a JAX-package Server, and the reverse);
- ``TestRetryPolicy`` and ``TestRetryAndBackup`` of tests/test_rpc.py and
  ``tests/test_connection_types.py::test_backup_request_keeps_original_
  connection`` on both. Where the JAX test reads the wall clock to see that
  the backup won (``dt < 0.9``), the port's copy reads which server
  answered: the slow one is held on a gate until the call returned;
- session and thread-local data (``rpc/data_pool.py``) and fiber-local
  storage (``runtime/keys.py``): ``TestSessionAndThreadLocalData`` (but for
  the HTTP gateway's case, ROADMAP A11) and
  ``tests/test_keys_hotspots.py::TestFiberKeys`` on both;
- request dumps (``rpc/dump.py``): a server with ``rpc_dump`` on writes the
  requests it admits, and each package's ``load_dump_file`` reads both
  packages' files back to the same (meta, payload, attachment);
- the idle reaper: ``TestIdleReaper`` of tests/test_rpc.py on both.

The servers of the port run on ``ServerOptions(device="cpu")``. Each test
stops and joins what it started, and after each the port's host plane is
shut down and no ``tbtorch-*`` thread is left. Tolerance: none; every
comparison is of integers, codes or bytes."""

import threading
import time
import types

import numpy as np
import pytest

import incubator_brpc_tpu.bvar as jax_bvar
import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu.rpc.auth as jax_auth
import incubator_brpc_tpu.rpc.channel as jax_channel
import incubator_brpc_tpu.rpc.concurrency_limiter as jax_limiter
import incubator_brpc_tpu.rpc.dump as jax_dump
import incubator_brpc_tpu.rpc.fault_injector as jax_fi
import incubator_brpc_tpu.rpc.server as jax_server
import incubator_brpc_tpu.runtime as jax_runtime
import incubator_brpc_tpu.runtime.keys as jax_keys
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu.utils import flags as jax_flags
import incubator_brpc_tpu_torch.bvar as port_bvar
import incubator_brpc_tpu_torch.rpc as port_rpc
import incubator_brpc_tpu_torch.rpc.auth as port_auth
import incubator_brpc_tpu_torch.rpc.channel as port_channel
import incubator_brpc_tpu_torch.rpc.concurrency_limiter as port_limiter
import incubator_brpc_tpu_torch.rpc.dump as port_dump
import incubator_brpc_tpu_torch.rpc.fault_injector as port_fi
import incubator_brpc_tpu_torch.rpc.server as port_server
import incubator_brpc_tpu_torch.runtime as port_runtime
import incubator_brpc_tpu_torch.runtime.keys as port_keys
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.utils import flags as port_flags
from incubator_brpc_tpu_torch.utils.status import ErrorCode

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", rpc=jax_rpc, server=jax_server, channel=jax_channel, limiter=jax_limiter,
        fi=jax_fi, auth=jax_auth, dump=jax_dump, keys=jax_keys, runtime=jax_runtime,
        tbus=jax_tbus, flags=jax_flags, bvar=jax_bvar, server_kw={},
    ),
    "torch": types.SimpleNamespace(
        name="torch", rpc=port_rpc, server=port_server, channel=port_channel,
        limiter=port_limiter, fi=port_fi, auth=port_auth, dump=port_dump, keys=port_keys,
        runtime=port_runtime, tbus=port_tbus, flags=port_flags, bvar=port_bvar,
        server_kw={"device": "cpu"},
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


@pytest.fixture
def tune():
    """tune(pkg, flag, value): set a flag of one package, restored after."""
    touched = []

    def set_(pkg, name, value):
        touched.append((pkg.flags, name, pkg.flags.get_flag(name)))
        pkg.flags.set_flag_unchecked(name, value)

    yield set_
    for flags, name, value in reversed(touched):
        flags.set_flag_unchecked(name, value)


def tune_both(tune, name, value):
    for p in PKGS.values():
        tune(p, name, value)


def server(pkg, services, **opts):
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


def wait_until(cond, timeout=20.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


# ---------------------------------------------------------------------------
# the limiters
# ---------------------------------------------------------------------------


def limiter_script(seed: int):
    """A seeded sample script on a synthetic clock: healthy traffic, a
    brownout (6x latency, a quarter of the throughput), an all-fail burst,
    a gap past the remeasure horizon, recovery, and sprinkled errors."""
    rng = np.random.default_rng(seed)
    now = 1_000_000
    out = []
    phases = [
        (600, 1000.0, 100, 0.02), (400, 6000.0, 400, 0.05), (60, 2000.0, 100, 1.0),
        (0, 0.0, 90_000, 0.0), (600, 1000.0, 100, 0.01), (300, 3000.0, 250, 0.2),
    ]
    for n, latency, interval, err_p in phases:
        if n == 0:
            now += interval
            continue
        for _ in range(n):
            now += int(interval * rng.uniform(0.5, 1.5))
            code = int(ErrorCode.EINTERNAL) if rng.random() < err_p else 0
            out.append((code, float(latency * rng.uniform(0.8, 1.25)), now))
    return out


LIMITER_CONFIGS = {
    "small_windows": dict(auto_cl_sampling_interval_us=0, auto_cl_min_sample_count=10,
                          auto_cl_max_sample_count=20,
                          auto_cl_noload_latency_remeasure_interval_ms=50),
    "sampled": dict(auto_cl_sampling_interval_us=150, auto_cl_min_sample_count=20,
                    auto_cl_max_sample_count=40, auto_cl_sample_window_size_ms=30,
                    auto_cl_noload_latency_remeasure_interval_ms=80),
    "defaults": {},
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("config", sorted(LIMITER_CONFIGS))
def test_auto_limiters_move_alike_on_a_seeded_script(config, seed, tune):
    for name, value in LIMITER_CONFIGS[config].items():
        tune_both(tune, name, value)
    moves = {name: [] for name in PKGS}
    lims = {name: p.limiter.AutoConcurrencyLimiter(on_limit_change=moves[name].append)
            for name, p in PKGS.items()}
    trail = {name: [] for name in PKGS}
    for code, latency, now in limiter_script(seed):
        for name, lim in lims.items():
            lim.on_responded(code, latency, now_us=now)
            trail[name].append(lim.max_concurrency())
    assert trail["jax"] == trail["torch"]
    assert moves["jax"] == moves["torch"]
    assert lims["jax"].describe() == lims["torch"].describe()
    if config != "defaults":
        # the script exercised what it is for: the limit moved both ways,
        # and a probe-down or an all-fail halving took it down
        assert len(set(trail["torch"])) > 3, trail["torch"][-10:]


class TestAutoLimiterUnit:
    def _feed(self, lim, n, latency_us, interval_us, now):
        """n completions, one per interval (so qps == 1e6/interval)."""
        for _ in range(n):
            now += interval_us
            lim.on_responded(0, latency_us, now_us=now)
        return now

    def test_initial_limit_from_flag(self, pkg, tune):
        tune(pkg, "auto_cl_initial_max_concurrency", 17)
        lim = pkg.limiter.AutoConcurrencyLimiter()
        assert lim.max_concurrency() == 17
        assert lim.on_requested(17)
        assert not lim.on_requested(18)

    def test_overload_shrinks_then_recovery_raises(self, pkg, tune):
        tune(pkg, "auto_cl_sampling_interval_us", 0)
        tune(pkg, "auto_cl_initial_max_concurrency", 40)
        tune(pkg, "auto_cl_noload_latency_remeasure_interval_ms", 10**7)
        lim = pkg.limiter.AutoConcurrencyLimiter()
        now = 1_000_000
        now = self._feed(lim, 1500, 1000.0, 100, now)
        healthy = lim.max_concurrency()
        assert 10 <= healthy <= 14, lim.describe()
        for _ in range(15):
            now = self._feed(lim, 250, 6000.0, 400, now)
        overloaded = lim.max_concurrency()
        assert overloaded < healthy, lim.describe()
        assert overloaded <= 6, lim.describe()
        now = self._feed(lim, 1500, 1000.0, 100, now)
        recovered = lim.max_concurrency()
        assert recovered > overloaded, lim.describe()
        assert recovered >= 10, lim.describe()

    def test_all_fail_window_halves(self, pkg, tune):
        tune(pkg, "auto_cl_sampling_interval_us", 0)
        tune(pkg, "auto_cl_initial_max_concurrency", 32)
        lim = pkg.limiter.AutoConcurrencyLimiter()
        now = 1_000_000
        for _ in range(int(pkg.flags.get_flag("auto_cl_max_sample_count"))):
            now += 100
            lim.on_responded(ErrorCode.EINTERNAL, 1000.0, now_us=now)
        assert lim.max_concurrency() == 16

    def test_probe_down_remeasures_floor(self, pkg, tune):
        tune(pkg, "auto_cl_sampling_interval_us", 0)
        tune(pkg, "auto_cl_initial_max_concurrency", 40)
        tune(pkg, "auto_cl_noload_latency_remeasure_interval_ms", 50)
        tune(pkg, "auto_cl_min_sample_count", 100)
        tune(pkg, "auto_cl_max_sample_count", 100)
        lim = pkg.limiter.AutoConcurrencyLimiter()
        now = 1_000_000
        now = self._feed(lim, 100, 1000.0, 100, now)
        settled = lim.max_concurrency()
        assert lim.describe()["min_latency_us"] > 0
        now += 60_000
        now = self._feed(lim, 100, 1000.0, 100, now)
        d = lim.describe()
        assert d["remeasuring"], d
        assert d["max_concurrency"] < settled, d
        now += 10_000
        now = self._feed(lim, 201, 1000.0, 100, now)
        d2 = lim.describe()
        assert not d2["remeasuring"], d2
        assert d2["min_latency_us"] > 0

    def test_sampling_interval_thins_samples(self, pkg, tune):
        tune(pkg, "auto_cl_sampling_interval_us", 1000)
        lim = pkg.limiter.AutoConcurrencyLimiter()
        lim.on_responded(0, 500.0, now_us=5_000_000)
        lim.on_responded(0, 500.0, now_us=5_000_100)
        assert lim._sw_succ == 1

    def test_create_limiter_specs(self, pkg):
        create = pkg.limiter.create_concurrency_limiter
        assert create(0) is None
        assert create(None) is None
        assert create("constant") is None
        assert create("unlimited") is None
        assert isinstance(create(5), pkg.limiter.ConstantConcurrencyLimiter)
        assert isinstance(create("auto"), pkg.limiter.AutoConcurrencyLimiter)
        assert isinstance(create(" AUTO "), pkg.limiter.AutoConcurrencyLimiter)
        assert create("12").max_concurrency() == 12
        assert create(-3) is None
        lim = create(3)
        assert lim.on_requested(3) and not lim.on_requested(4)
        lim.set_max_concurrency(4)
        assert lim.on_requested(4)
        with pytest.raises(ValueError):
            create("sideways")


# ---------------------------------------------------------------------------
# the fault injector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rates", [(0.37, 0.21, 0.13), (0.5, 0.0, 0.0), (0.0, 1.0, 0.0),
                                   (0.1, 0.1, 0.1), (1.0, 1.0, 1.0)])
def test_fault_injectors_decide_alike(rates):
    err, dly, cls = rates
    seqs = {}
    for name, p in PKGS.items():
        inj = p.fi.FaultInjector(error_rate=err, delay_rate=dly, delay_ms=0, close_rate=cls)
        seqs[name] = ([inj.decide() for _ in range(2000)], inj.describe())
    assert seqs["jax"] == seqs["torch"]


def test_flag_built_socket_injectors_decide_alike(tune):
    for p in PKGS.values():
        tune(p, "fault_injection", False)
        p.fi.install_socket_injector(None)
        assert p.fi.socket_injector() is None  # the master flag gates it
    try:
        for name, value in (("fault_injection", True), ("fault_inject_error_rate", 0.25),
                            ("fault_inject_delay_rate", 0.5), ("fault_inject_close_rate", 0.05)):
            tune_both(tune, name, value)
        seqs = {name: [p.fi.socket_injector().decide() for _ in range(400)]
                for name, p in PKGS.items()}
        assert seqs["jax"] == seqs["torch"]
        assert seqs["torch"].count("close") == 20
    finally:
        for p in PKGS.values():
            p.fi.install_socket_injector(None)


class TestFaultInjectorUnit:
    def test_counter_schedule_is_deterministic_and_exact(self, pkg):
        inj = pkg.fi.FaultInjector(error_rate=0.5)
        decisions = [inj.decide() for _ in range(100)]
        assert decisions.count("error") == 50
        inj2 = pkg.fi.FaultInjector(error_rate=0.5)
        assert [inj2.decide() for _ in range(100)] == decisions

    def test_rates_compose(self, pkg):
        inj = pkg.fi.FaultInjector(error_rate=0.25, delay_rate=0.25, delay_ms=0)
        decisions = [inj.decide() for _ in range(400)]
        assert decisions.count("error") == 100
        assert 0 < decisions.count("delay") <= 100

    def test_close_takes_priority(self, pkg):
        inj = pkg.fi.FaultInjector(error_rate=1.0, close_rate=1.0)
        assert inj.decide() == "close"


# ---------------------------------------------------------------------------
# the retry budget
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ratio", [0.1, 0.5, 0.0])
def test_retry_budget_balances_alike(ratio):
    rng = np.random.default_rng(int(ratio * 10) + 7)
    codes = [ErrorCode.EFAILEDSOCKET, ErrorCode.EEOF, ErrorCode.EDEADLINE, ErrorCode.ELIMIT,
             ErrorCode.ESESSION, ErrorCode.EHOSTDOWN]
    script = [("call", None) if rng.random() < 0.45 else ("retry", int(rng.choice(codes)))
              for _ in range(3000)]
    trails = {}
    for name, p in PKGS.items():
        b = p.channel.RetryBudget(ratio)
        trail = []
        for op, code in script:
            if op == "call":
                b.on_call()
                trail.append(b.balance())
            else:
                trail.append((b.acquire(code), b.balance()))
        trails[name] = trail
    assert trails["jax"] == trails["torch"]
    assert port_channel.RETRY_BUDGET_EXEMPT == jax_channel.RETRY_BUDGET_EXEMPT
    assert port_channel._RETRY_BUDGET_CAP == jax_channel._RETRY_BUDGET_CAP


class TestRetryBudgetUnit:
    def test_token_bucket_unit(self, pkg):
        cap = pkg.channel._RETRY_BUDGET_CAP
        b = pkg.channel.RetryBudget(0.5)
        for _ in range(int(cap)):
            assert b.acquire(ErrorCode.EFAILEDSOCKET)
        assert not b.acquire(ErrorCode.EFAILEDSOCKET)
        for _ in range(4):
            b.on_call()
        assert b.balance() == pytest.approx(2.0)
        assert b.acquire(ErrorCode.EFAILEDSOCKET)
        assert b.acquire(ErrorCode.EFAILEDSOCKET)
        assert not b.acquire(ErrorCode.EFAILEDSOCKET)
        for _ in range(10_000):
            b.on_call()
        assert b.balance() == pytest.approx(cap)

    def test_exempt_codes_never_draw(self, pkg):
        b = pkg.channel.RetryBudget(0.1)
        while b.acquire(ErrorCode.EFAILEDSOCKET):
            pass
        for code in pkg.channel.RETRY_BUDGET_EXEMPT:
            assert b.acquire(code)
        assert b.balance() < 1.0
        assert {ErrorCode.EDEADLINE, ErrorCode.ESESSION, ErrorCode.ELIMIT} == set(
            pkg.channel.RETRY_BUDGET_EXEMPT)

    def test_zero_ratio_disables(self, pkg):
        b = pkg.channel.RetryBudget(0.0)
        for _ in range(200):
            assert b.acquire(ErrorCode.EFAILEDSOCKET)


# ---------------------------------------------------------------------------
# auth
# ---------------------------------------------------------------------------


class _Counting:
    """An authenticator that counts the server's verifications."""

    def __init__(self, inner):
        self.inner = inner
        self.verified = 0

    def generate_credential(self):
        return self.inner.generate_credential()

    def verify_credential(self, cred, remote):
        self.verified += 1
        return self.inner.verify_credential(cred, remote)


class TestAuth:
    def _server(self, pkg, auth):
        return server(pkg, {"a": {"echo": lambda c, r: r}}, auth=auth)

    def test_valid_credential_accepted_once_per_connection(self, pkg):
        auth = pkg.rpc.SharedSecretAuthenticator("s3cret")
        s = self._server(pkg, auth)
        ch = connect(pkg, s.port, auth=auth)
        for i in range(3):  # later calls ride the authenticated conn
            cntl = ch.call_method("a", "echo", b"x%d" % i)
            assert cntl.ok(), cntl.error_text

    def test_auth_channels_do_not_share_connections(self, pkg):
        auth = pkg.rpc.SharedSecretAuthenticator("s3cret")
        s = self._server(pkg, auth)
        good = connect(pkg, s.port, auth=auth)
        assert good.call_method("a", "echo", b"1").ok()
        bad = connect(pkg, s.port)  # no credentials
        cntl = bad.call_method("a", "echo", b"2")
        assert cntl.failed()
        assert cntl.error_code == ErrorCode.ERPCAUTH
        assert good.call_method("a", "echo", b"3").ok()

    def test_missing_credential_rejected(self, pkg):
        s = self._server(pkg, pkg.rpc.SharedSecretAuthenticator("s3cret"))
        cntl = connect(pkg, s.port).call_method("a", "echo", b"x")
        assert cntl.failed()
        assert cntl.error_code == ErrorCode.ERPCAUTH

    def test_wrong_secret_rejected(self, pkg):
        s = self._server(pkg, pkg.rpc.SharedSecretAuthenticator("right"))
        ch = connect(pkg, s.port, auth=pkg.rpc.SharedSecretAuthenticator("wrong"))
        cntl = ch.call_method("a", "echo", b"x")
        assert cntl.failed()
        assert cntl.error_code == ErrorCode.ERPCAUTH

    def test_verified_once_per_connection(self, pkg):
        counting = _Counting(pkg.rpc.TokenAuthenticator(["t1", "t2"]))
        s = self._server(pkg, counting)
        ch = connect(pkg, s.port, auth=pkg.rpc.TokenAuthenticator("t2"))
        for i in range(5):
            assert ch.call_method("a", "echo", b"%d" % i).ok()
        assert counting.verified == 1
        assert s.connection_count() == 1
        # a channel with another credential object dials its own
        # connection, and proves it once more
        ch2 = connect(pkg, s.port, auth=pkg.rpc.TokenAuthenticator("t1"))
        assert ch2.call_method("a", "echo", b"x").ok()
        assert counting.verified == 2
        assert s.connection_count() == 2


class _FakeSock:
    def __init__(self):
        self.context = {}
        self.on_revived = []


@pytest.mark.parametrize("kind", ["token", "shared_secret"])
def test_authenticated_frames_are_byte_identical(kind, monkeypatch):
    """The request frame a credential rides, and the frames after the
    connection is proven (no credential), are the same bytes on both
    packages."""
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.25)
    frames = {}
    for name, p in PKGS.items():
        auth = (p.rpc.TokenAuthenticator("tok") if kind == "token"
                else p.rpc.SharedSecretAuthenticator("s3cret", identity="edge"))
        sock = _FakeSock()
        out = []
        for _ in range(2):
            meta = p.tbus.Meta(service="a", method="echo", timeout_ms=500)
            p.auth.attach_credential(meta, sock, auth)
            out.append(p.tbus.pack_frame(meta, b"payload", 7))
            if len(out) == 1:
                assert meta.extra["auth"]
        p.auth.mark_authenticated(sock)
        meta = p.tbus.Meta(service="a", method="echo", timeout_ms=500)
        p.auth.attach_credential(meta, sock, auth)
        out.append(p.tbus.pack_frame(meta, b"payload", 8))
        frames[name] = out
    assert frames["jax"] == frames["torch"]
    assert frames["torch"][0] == frames["torch"][1] != frames["torch"][2]


@pytest.mark.parametrize("client,srv_pkg", [("torch", "jax"), ("jax", "torch")])
def test_auth_interop(client, srv_pkg):
    c, s = PKGS[client], PKGS[srv_pkg]
    srv = server(s, {"a": {"echo": lambda cn, r: r}},
                 auth=s.rpc.SharedSecretAuthenticator("shared", identity="peer"))
    ch = connect(c, srv.port, auth=c.rpc.SharedSecretAuthenticator("shared", identity="peer"))
    for i in range(3):
        out = ch.call_method("a", "echo", b"cross %d" % i)
        assert out.ok(), out.error_text
        assert out.response_payload == b"cross %d" % i
    wrong = connect(c, srv.port, auth=c.rpc.SharedSecretAuthenticator("other"))
    assert wrong.call_method("a", "echo", b"x").error_code == ErrorCode.ERPCAUTH
    bare = connect(c, srv.port)
    assert bare.call_method("a", "echo", b"x").error_code == ErrorCode.ERPCAUTH


# ---------------------------------------------------------------------------
# the retry policy, retries and backup requests
# ---------------------------------------------------------------------------


class TestRetryPolicy:
    def test_custom_policy_retries_a_server_error(self, pkg):
        calls = []

        def flaky(cntl, req):
            calls.append(1)
            if len(calls) < 3:
                cntl.set_failed(ErrorCode.EINTERNAL, "transient")
                return b""
            return req

        srv = server(pkg, {"svc": {"m": flaky}})
        out = connect(pkg, srv.port).call_method("svc", "m", b"a")
        assert out.failed() and out.error_code == ErrorCode.EINTERNAL
        calls.clear()
        ch2 = connect(pkg, srv.port, max_retry=3,
                      retry_policy=lambda c: c.error_code == ErrorCode.EINTERNAL)
        out = ch2.call_method("svc", "m", b"b")
        assert out.ok(), out.error_text
        assert len(calls) == 3

    def test_policy_can_refuse_default_retriables(self, pkg):
        ch = pkg.rpc.Channel()
        assert ch.init("127.0.0.1:1", options=pkg.rpc.ChannelOptions(
            max_retry=3, retry_policy=lambda c: False, timeout_ms=5000))
        out = ch.call_method("svc", "m", b"x", cntl=pkg.rpc.Controller(timeout_ms=5000))
        assert out.failed()
        assert out.retried_count == 0


class TestRetryAndBackup:
    def test_retry_exhaustion_counts(self, pkg):
        ch = connect(pkg, 1, max_retry=2)
        cntl = ch.call("Echo", "echo", b"")
        assert cntl.failed()
        assert cntl.retried_count == 2

    def test_lb_retry_failover(self, pkg):
        srv = server(pkg, {"Echo": {"echo": lambda c, r: r}})
        ch = pkg.rpc.Channel()
        assert ch.init(f"list://127.0.0.1:1,127.0.0.1:{srv.port}", lb_name="rr",
                       options=pkg.rpc.ChannelOptions(max_retry=3, timeout_ms=2000))
        oks = sum(ch.call("Echo", "echo", b"failover").ok() for _ in range(6))
        ch._lb.stop()
        assert oks == 6

    def test_backup_request_wins(self, pkg):
        """Slow primary, fast backup: the duplicate fired at
        backup_request_ms completes the RPC (controller.cpp:565-598). The
        slow server answers only after every call returned, so each reply
        is the fast server's."""
        gate = threading.Event()
        slow = server(pkg, {"Echo": {"echo": lambda c, r: (gate.wait(20), b"slow")[1]}})
        fast = server(pkg, {"Echo": {"echo": lambda c, r: b"fast"}})
        try:
            ch = pkg.rpc.Channel()
            assert ch.init(
                f"list://127.0.0.1:{slow.port},127.0.0.1:{fast.port}", lb_name="rr",
                options=pkg.rpc.ChannelOptions(timeout_ms=15000, backup_request_ms=100,
                                               max_retry=1),
            )
            backups = 0
            for _ in range(4):
                cntl = ch.call("Echo", "echo", b"backup")
                assert cntl.ok(), cntl.error_text
                assert cntl.response_payload == b"fast"
                backups += cntl.has_backup_request
            assert backups >= 1  # the slow server was picked, and raced
            ch._lb.stop()
        finally:
            gate.set()

    def test_backup_request_keeps_original_connection(self, pkg):
        """A backup attempt must NOT settle the original attempt's
        connection mid-call (the original response may still win)."""

        def slow_echo(cntl, req):
            time.sleep(0.3)
            return b"original"

        s = server(pkg, {"ct": {"echo": slow_echo}})
        ch = connect(pkg, s.port, connection_type="short", timeout_ms=5000,
                     backup_request_ms=50, max_retry=1)
        cntl = ch.call_method("ct", "echo", b"x")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"original"
        assert cntl.has_backup_request
        assert wait_until(lambda: s.connection_count() == 0)  # both settled


# ---------------------------------------------------------------------------
# session and thread-local data, fiber-local storage
# ---------------------------------------------------------------------------


class TestSessionAndThreadLocalData:
    class _Factory:
        def __init__(self):
            self.created = 0
            self.destroyed = []
            self.lock = threading.Lock()

        def create(self):
            with self.lock:
                self.created += 1
                return {"id": self.created, "uses": 0}

        def destroy(self, obj):
            with self.lock:
                self.destroyed.append(obj["id"])

    def _server(self, pkg, session_factory=None, thread_factory=None, reserved=0):
        def use(cntl, req):
            sd = cntl.session_local_data()
            td = pkg.rpc.thread_local_data()
            parts = []
            if sd is not None:
                sd["uses"] += 1
                parts.append(b"s%d:%d" % (sd["id"], sd["uses"]))
            if td is not None:
                td["uses"] += 1
                parts.append(b"t%d" % td["id"])
            return b" ".join(parts) or b"none"

        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(
            session_local_data_factory=session_factory,
            reserved_session_local_data=reserved,
            thread_local_data_factory=thread_factory, **pkg.server_kw))
        srv.add_service("d", {"use": use})
        assert srv.start(0)
        return srv

    def test_session_data_sticks_to_connection_and_pools_across(self, pkg):
        f = self._Factory()
        srv = self._server(pkg, session_factory=f)
        try:
            ch = connect(pkg, srv.port)
            for i in range(1, 4):
                c = ch.call_method("d", "use", b"")
                assert c.ok(), c.error_text
                assert c.response_payload == b"s1:%d" % i
            assert f.created == 1
            c = connect(pkg, srv.port, connection_type="short").call_method("d", "use", b"")
            assert c.ok()
            assert c.response_payload.startswith(b"s2:")
            assert wait_until(lambda: srv._session_pool.free_count >= 1, 25), \
                "short conn's data never pooled"
            c = connect(pkg, srv.port, connection_type="short").call_method("d", "use", b"")
            assert c.ok()
            assert c.response_payload.startswith(b"s2:"), c.response_payload
            assert f.created == 2, "pooled object was not reused"
        finally:
            srv.stop()
            assert srv.join(timeout=10)
        assert sorted(f.destroyed) == [1, 2]

    def test_thread_local_data_per_worker_and_destroyed_on_stop(self, pkg):
        f = self._Factory()
        srv = self._server(pkg, thread_factory=f)
        try:
            ch = connect(pkg, srv.port)
            seen = set()
            for _ in range(8):
                c = ch.call_method("d", "use", b"")
                assert c.ok(), c.error_text
                seen.add(c.response_payload)
            assert f.created == len({p.split(b":")[0] for p in seen})
        finally:
            srv.stop()
            assert srv.join(timeout=10)
        assert sorted(f.destroyed) == list(range(1, f.created + 1))

    def test_reserved_session_data_is_prebuilt(self, pkg):
        f = self._Factory()
        srv = self._server(pkg, session_factory=f, reserved=2)
        try:
            assert f.created == 2  # reserved_session_local_data
            c = connect(pkg, srv.port).call_method("d", "use", b"")
            assert c.ok() and c.response_payload.startswith(b"s")
            assert f.created == 2  # served from the reserve
        finally:
            srv.stop()
            assert srv.join(timeout=10)
        assert sorted(f.destroyed) == [1, 2]

    def test_without_factories_accessors_return_none(self, pkg):
        srv = self._server(pkg)
        try:
            c = connect(pkg, srv.port).call_method("d", "use", b"")
            assert c.ok()
            assert c.response_payload == b"none"
            assert pkg.rpc.thread_local_data() is None  # outside a handler
        finally:
            srv.stop()
            assert srv.join(timeout=10)


class TestFiberKeys:
    def test_set_get_on_plain_thread(self, pkg):
        k = pkg.keys.fiber_key_create()
        assert pkg.keys.fiber_getspecific(k) is None
        assert pkg.keys.fiber_setspecific(k, "value")
        assert pkg.keys.fiber_getspecific(k) == "value"

    def test_isolation_between_fibers(self, pkg):
        k = pkg.keys.fiber_key_create()
        out = {}
        gate = threading.Barrier(4)

        def fib(name):
            assert pkg.keys.fiber_getspecific(k) is None  # fresh per fiber
            pkg.keys.fiber_setspecific(k, name)
            gate.wait(10)  # every fiber has set its own value
            out[name] = pkg.keys.fiber_getspecific(k)

        fibers = [pkg.runtime.spawn(fib, f"f{i}") for i in range(4)]
        for f in fibers:
            assert f.join(timeout=10)
            assert f.exception is None
        assert out == {f"f{i}": f"f{i}" for i in range(4)}

    def test_isolation_between_threads(self, pkg):
        k = pkg.keys.fiber_key_create()
        out = {}
        gate = threading.Barrier(3)

        def th(name):
            pkg.keys.fiber_setspecific(k, name)
            gate.wait(10)
            out[name] = pkg.keys.fiber_getspecific(k)

        ts = [threading.Thread(target=th, args=(f"t{i}",)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert out == {f"t{i}": f"t{i}" for i in range(3)}

    def test_destructor_runs_on_fiber_exit(self, pkg):
        destroyed = []
        k = pkg.keys.fiber_key_create(destructor=destroyed.append)
        assert pkg.runtime.spawn(lambda: pkg.keys.fiber_setspecific(k, "resource")).join(timeout=5)
        assert destroyed == ["resource"]

    def test_deleted_key_reads_none_and_skips_destructor(self, pkg):
        destroyed = []
        k = pkg.keys.fiber_key_create(destructor=destroyed.append)

        def fib():
            pkg.keys.fiber_setspecific(k, "gone")
            assert pkg.keys.fiber_key_delete(k)
            assert pkg.keys.fiber_getspecific(k) is None

        f = pkg.runtime.spawn(fib)
        assert f.join(timeout=5)
        assert f.exception is None
        assert destroyed == []

    def test_key_version_prevents_stale_reads(self, pkg):
        k1 = pkg.keys.fiber_key_create()
        pkg.keys.fiber_setspecific(k1, "old")
        assert pkg.keys.fiber_key_delete(k1)
        k2 = pkg.keys.fiber_key_create()  # may reuse the index
        if k2[0] == k1[0]:
            assert pkg.keys.fiber_getspecific(k2) is None  # versioned: no bleed
        assert pkg.keys.fiber_getspecific(k1) is None


def test_fiber_keys_version_alike():
    """One script of creates and deletes hands out the same (index,
    version) keys on both packages' fresh registries."""
    keys = {}
    for name, p in PKGS.items():
        saved = (list(p.keys._versions), list(p.keys._destructors), list(p.keys._free_indexes))
        p.keys._versions[:], p.keys._destructors[:], p.keys._free_indexes[:] = [], [], []
        try:
            got = []
            live = []
            for step in range(40):
                if step % 3 == 2 and live:
                    k = live.pop(step % len(live))
                    got.append(("del", k, p.keys.fiber_key_delete(k), p.keys.fiber_key_delete(k)))
                else:
                    k = p.keys.fiber_key_create()
                    live.append(k)
                    got.append(("new", k))
            keys[name] = got
        finally:
            p.keys._versions[:], p.keys._destructors[:], p.keys._free_indexes[:] = saved
    assert keys["jax"] == keys["torch"]


# ---------------------------------------------------------------------------
# request dumps
# ---------------------------------------------------------------------------


def test_rpc_dump_round_trips_on_both_packages(tmp_path, tune):
    """A server with ``rpc_dump`` on writes each admitted request as a
    tbus_std frame (decompressed, compress cleared); both packages'
    ``load_dump_file`` read both packages' files to the same rows."""
    rows = {}
    files = {}
    for name, p in PKGS.items():
        d = tmp_path / name
        tune(p, "rpc_dump", True)
        tune(p, "rpc_dump_dir", str(d))
        tune(p, "rpc_dump_max_requests_per_second", 1000)
        tune(p, "rpc_dump_max_requests_in_one_file", 4)
        p.dump.reset_global_dumper()
        try:
            srv = server(p, {"D": {"echo": lambda c, r: r}})
            ch = connect(p, srv.port)
            for i in range(6):
                cntl = p.rpc.Controller()
                if i == 2:
                    cntl.compress_type = "gzip"
                out = ch.call_method("D", "echo", b"dumped %d" % i * (i + 1), cntl=cntl,
                                     attachment=b"att%d" % i if i % 2 else b"")
                assert out.ok(), out.error_text
            assert p.dump.global_dumper().sampled_total == 6
        finally:
            tune(p, "rpc_dump", False)
            p.dump.reset_global_dumper()
        files[name] = sorted(d.iterdir())
        assert len(files[name]) == 2  # rotated after 4 requests
    for reader_name, reader in PKGS.items():
        for writer_name, paths in files.items():
            got = []
            for path in paths:
                for meta, payload, att in reader.dump.load_dump_file(str(path)):
                    assert meta.compress == ""
                    got.append((meta.service, meta.method, bytes(payload), bytes(att)))
            rows[(reader_name, writer_name)] = got
    want = [("D", "echo", b"dumped %d" % i * (i + 1), b"att%d" % i if i % 2 else b"")
            for i in range(6)]
    for key, got in rows.items():
        assert got == want, key


def test_rpc_dump_off_writes_nothing(tmp_path, tune, pkg):
    tune(pkg, "rpc_dump", False)
    tune(pkg, "rpc_dump_dir", str(tmp_path / "off"))
    pkg.dump.reset_global_dumper()
    srv = server(pkg, {"D": {"echo": lambda c, r: r}})
    assert connect(pkg, srv.port).call_method("D", "echo", b"x").ok()
    assert not (tmp_path / "off").exists()


# ---------------------------------------------------------------------------
# the idle reaper
# ---------------------------------------------------------------------------


class TestIdleReaper:
    def test_idle_connection_reaped_and_client_recovers(self, pkg):
        srv = server(pkg, {"svc": {"echo": lambda cntl, req: req}}, idle_timeout_s=0.4)
        ch = connect(pkg, srv.port)
        assert ch.call_method("svc", "echo", b"one").ok()
        assert len(srv._acceptor.connections()) == 1
        assert wait_until(lambda: not srv._acceptor.connections()), "idle conn not reaped"
        c = ch.call_method("svc", "echo", b"two", cntl=pkg.rpc.Controller(max_retry=3))
        assert c.ok(), c.error_text
        assert c.response_payload == b"two"

    def test_active_connection_not_reaped(self, pkg):
        # the JAX test's 0.6 s timeout, kept busy for 3x it, widened to
        # 1.5 s: a loaded host can stall one 0.2 s pause past 0.6 s
        srv = server(pkg, {"svc": {"echo": lambda cntl, req: req}}, idle_timeout_s=1.5)
        ch = connect(pkg, srv.port)
        end = time.monotonic() + 4.5  # 3x the timeout, kept busy
        while time.monotonic() < end:
            assert ch.call_method("svc", "echo", b"k").ok()
            time.sleep(0.2)
        assert len(srv._acceptor.connections()) == 1
