"""Lifecycle of the port's timers, observers and pools against the JAX
package's: the 15 cases of tests/test_lifecycle.py, each run on both
packages through the ``pkg`` fixture.

- the LB's circuit-breaker revival timers (``lb/__init__.py``
  ``_revive_timers``): tracked per isolation, unscheduled at stop and on
  re-isolation or naming churn, inert after stop;
- naming observers: ``remove_observer``, and an LB's stop detaching it
  from a shared watcher;
- the server's idle-reap timer (``rpc/server.py``
  ``_idle_reap_timer_id``): cancelled at stop, never re-armed by a scan
  that was mid-flight when stop landed;
- ``SimpleDataPool``'s destroy races (``rpc/data_pool.py``): a borrow that
  raced ``destroy_all`` destroyed exactly once by its late give-back, a
  give-back that lost the race a no-op, a dead pool that still serves
  and leaks nothing, and a borrow/give-back storm across a mid-storm
  teardown.

The private names these cases read are the same in both packages. Servers
of the port run on ``device="cpu"``. Each test stops what it started and
leaves no ``tbtorch-*`` thread behind."""

import threading
import time
import types

import pytest

import incubator_brpc_tpu.lb as jax_lb
import incubator_brpc_tpu.naming as jax_naming
import incubator_brpc_tpu.rpc.circuit_breaker as jax_cb
import incubator_brpc_tpu.rpc.data_pool as jax_pool
import incubator_brpc_tpu.rpc.server as jax_server
import incubator_brpc_tpu.runtime.timer_thread as jax_timer
import incubator_brpc_tpu_torch.lb as port_lb
import incubator_brpc_tpu_torch.naming as port_naming
import incubator_brpc_tpu_torch.rpc as port_rpc
import incubator_brpc_tpu_torch.rpc.circuit_breaker as port_cb
import incubator_brpc_tpu_torch.rpc.data_pool as port_pool
import incubator_brpc_tpu_torch.rpc.server as port_server
import incubator_brpc_tpu_torch.runtime.timer_thread as port_timer
from incubator_brpc_tpu.utils.endpoint import EndPoint as JaxEndPoint
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint as PortEndPoint

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", lb=jax_lb, naming=jax_naming, cb=jax_cb, pool=jax_pool,
        server=jax_server, timer=jax_timer, EndPoint=JaxEndPoint, server_kw={},
    ),
    "torch": types.SimpleNamespace(
        name="torch", lb=port_lb, naming=port_naming, cb=port_cb, pool=port_pool,
        server=port_server, timer=port_timer, EndPoint=PortEndPoint,
        server_kw={"device": "cpu"},
    ),
}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    port_rpc.shutdown_host_plane()
    assert shutdown_watchers(timeout=60)
    port_timer.shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


class _CountingFactory:
    """create/destroy bookkeeping with double-destroy detection."""

    def __init__(self, create_gate: threading.Event = None):
        self.lock = threading.Lock()
        self.created = 0
        self.destroyed = 0
        self.double_destroys = 0
        self.live = set()
        self._gate = create_gate

    def create(self):
        if self._gate is not None:
            self._gate.wait(5.0)
        with self.lock:
            self.created += 1
            obj = object()
            self.live.add(id(obj))
            return obj

    def destroy(self, obj):
        with self.lock:
            if id(obj) in self.live:
                self.live.discard(id(obj))
                self.destroyed += 1
            else:
                self.double_destroys += 1


class TestLBRevivalTimerLifecycle:
    """An isolation arms a revival timer; stop() must unschedule it, or a
    stopped LB stays pinned by (and fired into by) its timers for up to
    the isolation window."""

    @staticmethod
    def _isolated_lb(pkg):
        lb = pkg.lb.LoadBalancerWithNaming(url="list://", circuit_breaker=True)
        ep = pkg.EndPoint("10.9.9.9", 1234)
        lb.lb.add_server(ep)
        lb._isolate(ep)
        return lb, ep

    def test_isolate_tracks_its_timer(self, pkg):
        lb, ep = self._isolated_lb(pkg)
        try:
            assert ep in lb._revive_timers
            assert ep in lb._isolated
        finally:
            lb.stop()

    def test_stop_unschedules_revival_timers(self, pkg):
        lb, ep = self._isolated_lb(pkg)
        tid = lb._revive_timers[ep]
        lb.stop()
        assert lb._revive_timers == {}
        assert lb._isolated == {}
        # gone from the shared TimerThread: a second unschedule finds nothing
        assert pkg.timer.global_timer_thread().unschedule(tid) is False

    def test_straggler_timer_cannot_revive_dead_lb(self, pkg):
        lb, ep = self._isolated_lb(pkg)
        lb.stop()
        # a timer already in flight at stop is a no-op, not a resurrection
        lb._maybe_revive(ep)
        assert lb._isolated == {} and lb._revive_timers == {}

    def test_revival_consumes_the_timer_entry(self, pkg):
        lb, ep = self._isolated_lb(pkg)
        try:
            with lb._cb_lock:
                lb._isolated[ep] = time.monotonic() - 1.0  # force due
            lb._maybe_revive(ep)
            assert ep not in lb._revive_timers
            assert ep not in lb._isolated
        finally:
            lb.stop()

    def test_isolate_racing_stop_is_a_noop(self, pkg):
        # a trip verdict after stop() re-arms no timer, re-populates no
        # isolation and registers no breaker row under the dead owner tag
        lb, ep = self._isolated_lb(pkg)
        lb.stop()
        lb._isolate(ep)
        lb._feed_breaker(ep, 100.0, 1)
        assert lb._revive_timers == {} and lb._isolated == {}
        assert not any(
            tag == lb._cb_tag for (tag, _ep), _cb in pkg.cb.breaker_registry.snapshot()
        )

    def test_reisolation_unschedules_the_superseded_timer(self, pkg):
        lb, ep = self._isolated_lb(pkg)
        try:
            first = lb._revive_timers[ep]
            lb._isolate(ep)  # an extended deadline arms a fresh timer
            second = lb._revive_timers[ep]
            assert second != first
            assert pkg.timer.global_timer_thread().unschedule(first) is False
        finally:
            lb.stop()

    def test_naming_churn_drops_the_timer_with_the_breaker(self, pkg):
        lb, ep = self._isolated_lb(pkg)
        try:
            tid = lb._revive_timers[ep]
            lb._drop_breaker(ep)
            assert ep not in lb._revive_timers
            assert pkg.timer.global_timer_thread().unschedule(tid) is False
        finally:
            lb.stop()


class TestNamingObserverLifecycle:
    """Every LB (and partition channel) on a shared watcher must be able
    to leave its observer list."""

    def test_remove_observer(self, pkg):
        ns = pkg.naming.NamingServiceThread("list://127.0.0.1:7001")
        events = []

        class Obs:
            def add_server(self, ep):
                events.append(("add", ep))

            def remove_server(self, ep):
                events.append(("remove", ep))

        o = Obs()
        ns.add_observer(o)
        assert o in ns._observers
        ns.remove_observer(o)
        assert o not in ns._observers
        ns.remove_observer(o)  # idempotent

    def test_lb_stop_detaches_from_shared_watcher(self, pkg):
        ns = pkg.naming.NamingServiceThread("list://127.0.0.1:7002")
        assert ns.start()
        try:
            lb = pkg.lb.LoadBalancerWithNaming(ns_thread=ns, circuit_breaker=False)
            assert lb.start()
            assert lb in ns._observers
            lb.stop()
            assert lb not in ns._observers
        finally:
            ns.stop()


class TestServerIdleReapTimerLifecycle:
    """The server keeps its idle-reap timer id: a stopped server must not
    stay pinned by the parked scan for up to idle_timeout_s/2."""

    def test_stop_cancels_the_parked_reap(self, pkg):
        srv = pkg.server.Server(pkg.server.ServerOptions(idle_timeout_s=30.0, **pkg.server_kw))
        assert srv.start(0)
        tid = srv._idle_reap_timer_id
        assert tid is not None
        srv.stop()
        srv.join(timeout=5)
        assert srv._idle_reap_timer_id is None
        assert pkg.timer.global_timer_thread().unschedule(tid) is False

    def test_reap_mid_flight_at_stop_does_not_rearm(self, pkg):
        srv = pkg.server.Server(pkg.server.ServerOptions(idle_timeout_s=30.0, **pkg.server_kw))
        assert srv.start(0)
        srv.stop()
        # a scan already spawned when stop() landed re-arms through
        # _schedule_idle_reap; the _stopping guard must refuse it
        srv._schedule_idle_reap()
        assert srv._idle_reap_timer_id is None
        srv.join(timeout=5)


class TestDataPoolDestroyRaces:
    """A borrow() that raced destroy_all() re-registers its object in the
    FRESH outstanding dict, destroy_all never sees it, and the late
    give_back must destroy it, exactly once."""

    def test_borrow_racing_destroy_all_destroys_exactly_once(self, pkg):
        gate = threading.Event()
        fac = _CountingFactory(create_gate=gate)
        pool = pkg.pool.SimpleDataPool(fac)
        got = []
        t = threading.Thread(target=lambda: got.append(pool.borrow()))  # blocks in create()
        t.start()
        # wait until the borrower is inside create (ncreated is bumped
        # under the pool lock before the factory call)
        deadline = time.monotonic() + 5
        while pool.ncreated == 0 and time.monotonic() < deadline:
            time.sleep(0.001)
        pool.destroy_all()  # snapshots BEFORE the borrow lands
        gate.set()
        t.join(5)
        assert len(got) == 1
        assert fac.destroyed == 0  # destroy_all never saw the object
        pool.give_back(got[0])  # the owned path destroys it
        assert fac.destroyed == 1 and fac.double_destroys == 0
        pool.give_back(got[0])  # a second give_back destroys nothing
        assert fac.destroyed == 1 and fac.double_destroys == 0

    def test_give_back_losing_the_race_is_a_noop(self, pkg):
        fac = _CountingFactory()
        pool = pkg.pool.SimpleDataPool(fac)
        obj = pool.borrow()
        pool.destroy_all()  # sees the outstanding borrow and destroys it
        assert fac.destroyed == 1
        pool.give_back(obj)  # lost the race: no double destroy
        assert fac.destroyed == 1 and fac.double_destroys == 0

    def test_dead_pool_borrow_then_give_back_balances(self, pkg):
        fac = _CountingFactory()
        pool = pkg.pool.SimpleDataPool(fac)
        pool.destroy_all()
        obj = pool.borrow()  # a dead pool keeps serving...
        pool.give_back(obj)  # ...but nothing may leak or re-pool
        assert pool.free_count == 0
        assert fac.destroyed == fac.created == 1
        assert fac.double_destroys == 0

    def test_concurrent_borrow_give_back_vs_destroy_all_storm(self, pkg):
        fac = _CountingFactory()
        pool = pkg.pool.SimpleDataPool(fac, reserved=4)
        stop = threading.Event()
        errors = []

        def churn():
            try:
                while not stop.is_set():
                    obj = pool.borrow()
                    time.sleep(0)  # force interleaving
                    pool.give_back(obj)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=churn) for _ in range(6)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        pool.destroy_all()  # mid-storm teardown
        time.sleep(0.02)
        stop.set()
        for t in threads:
            t.join(5)
        assert not errors
        # every churn thread gave its object back before it was joined, so
        # each created object died exactly once
        with fac.lock:
            leaked = set(fac.live)
        assert not leaked, f"{len(leaked)} pooled objects never destroyed"
        assert fac.double_destroys == 0
        assert fac.destroyed == fac.created
