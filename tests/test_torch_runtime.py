"""The port's runtime, bvar, flags and status: its own copies of the JAX
package's JAX-free modules, held to the same behaviour, and the device
completion butex on CUDA events (counterparts of tests/test_runtime.py's
device-completion cases)."""

import threading
import time

import pytest
import torch

from incubator_brpc_tpu.utils import status as jstatus
from incubator_brpc_tpu_torch import bvar
from incubator_brpc_tpu_torch.runtime.butex import ETIMEDOUT, EWOULDBLOCK, WAIT_OK, Butex
from incubator_brpc_tpu_torch.runtime.device_butex import DeviceCompletionButex, shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import TimerThread, shutdown_global_timer_thread
from incubator_brpc_tpu_torch.runtime.worker_pool import shutdown_global_worker_pool
from incubator_brpc_tpu_torch.utils import flags, status


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    """End the completion watchers and the timer each test started, and
    check that no thread of the port is left in this process."""
    yield
    assert shutdown_watchers(timeout=60)
    shutdown_global_worker_pool()
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


def wait_until(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.002)
    return True


# ---------------------------------------------------------------- status ----

def test_error_codes_match_reference():
    assert {c.name: int(c) for c in status.ErrorCode} == {
        c.name: int(c) for c in jstatus.ErrorCode
    }
    for code in (1002, 1003, 1008, 1011, 2001):
        assert status.berror(code) == jstatus.berror(code)


# ----------------------------------------------------------------- flags ----

def test_device_cq_threads_flag():
    assert flags.get_flag("device_cq_threads") == 8
    assert not flags.set_flag("device_cq_threads", 2)  # not reloadable
    flags.set_flag_unchecked("device_cq_threads", 3)
    try:
        assert flags.get_flag("device_cq_threads") == 3
    finally:
        flags.set_flag_unchecked("device_cq_threads", 8)


# ----------------------------------------------------------------- butex ----

def test_butex_wake_before_wait_returns_ewouldblock():
    b = Butex(0)
    b.add(1)
    assert b.wait(0) == EWOULDBLOCK


def test_butex_timed_wait_and_late_wake():
    b = Butex(0)
    t0 = time.monotonic()
    assert b.wait(0, timeout=0.05) == ETIMEDOUT
    assert 0.04 <= time.monotonic() - t0 < 1.0
    assert b.wake(1) == 0  # the timer already dequeued the waiter


def test_butex_wake_n_and_wake_all():
    b = Butex(0)
    results = []

    def waiter():
        results.append(b.wait(0))

    threads = [threading.Thread(target=waiter) for _ in range(4)]
    for t in threads:
        t.start()
    assert wait_until(lambda: len(b._waiters) == 4)
    assert b.wake(1) == 1
    assert b.wake_all() == 3
    for t in threads:
        t.join(timeout=5)
        assert not t.is_alive()
    assert results == [WAIT_OK] * 4


def test_timer_schedule_order_and_unschedule():
    tt = TimerThread("test-torch-timer")
    try:
        fired = []
        tt.schedule(lambda: fired.append("b"), delay=0.04)
        tt.schedule(lambda: fired.append("a"), delay=0.01)
        tid = tt.schedule(lambda: fired.append("never"), delay=0.05)
        assert tt.unschedule(tid) is True
        assert wait_until(lambda: len(fired) == 2)
        time.sleep(0.06)
        assert fired == ["a", "b"]
    finally:
        tt.stop_and_join()


# ------------------------------------------------------------------ bvar ----

def test_adder_and_latency_recorder():
    a = bvar.Adder()
    ts = [threading.Thread(target=lambda: [a << 1 for _ in range(1000)]) for _ in range(4)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert a.get_value() == 4000
    lr = bvar.LatencyRecorder(window_size=2)
    for v in range(1000):
        lr << v
    assert lr.count() == 1000
    assert lr.max_latency() == 999
    assert lr.latency() == sum(range(1000)) / 1000
    assert 0 <= lr.latency_percentile(0.5) <= 999


def test_expose_registry():
    a = bvar.Adder(name="test_torch_expose_adder")
    a << 5
    assert bvar.dump_exposed("test_torch_expose")["test_torch_expose_adder"] == "5"
    assert not bvar.Adder().expose("test_torch_expose_adder")
    assert a.hide()


# ------------------------------------------------------ device completion ----

def test_device_completion_butex_wakes_on_ready():
    cq = DeviceCompletionButex()
    out = torch.arange(1024.0) * 2 + 1
    cq.watch(out)
    assert cq.wait_for(1, timeout=30)
    assert cq.load() == 1
    assert float(out[1]) == 3.0


def test_device_completion_callback_and_multiple_ops():
    cq = DeviceCompletionButex()
    done = []
    outs = [torch.ones(8) + i for i in range(3)]
    for o in outs:
        cq.watch(o, on_complete=lambda arr, err: done.append(err))
    assert cq.wait_for(3, timeout=30)
    assert wait_until(lambda: len(done) == 3)
    assert done == [None, None, None]
    assert cq.inflight == 0
    assert cq.errors == []


def test_device_completion_failure_counts_and_records():
    # A failing event wait must still settle the butex (no hung waiters)
    # and surface the error.
    class _Boom:
        def synchronize(self):
            raise RuntimeError("device melted")

    cq = DeviceCompletionButex()
    cb = []
    cq.watch(_Boom(), on_complete=lambda arr, err: cb.append(type(err).__name__))
    assert cq.wait_for(1, timeout=10)
    assert wait_until(lambda: cb == ["RuntimeError"])
    assert len(cq.errors) == 1


def test_device_completion_raising_callback_does_not_strand_waiters():
    cq = DeviceCompletionButex()

    def bad_cb(arr, err):
        raise ValueError("callback bug")

    cq.watch(torch.ones(4) * 2, on_complete=bad_cb)
    assert cq.wait_for(1, timeout=10)  # bump/wake happened before the callback


def test_device_completion_refuses_unknown_work():
    with pytest.raises(TypeError):
        DeviceCompletionButex().watch(object())


# -------------------------------------------- tests/test_runtime.py on both ----
# The JAX package's runtime oracles that no case above twins: each runs on
# both packages through the ``pkg`` fixture. The butex's timed wait keeps
# the reference's window (0.04 s to 1 s for a 0.05 s timeout); the timer's
# order and preemption are held by order (the first callback to fire), the
# unschedule case by the timer's own pending count.

import types  # noqa: E402

from incubator_brpc_tpu.runtime import butex as jax_butex_mod  # noqa: E402
from incubator_brpc_tpu.runtime import execution_queue as jax_eq  # noqa: E402
from incubator_brpc_tpu.runtime import timer_thread as jax_timer_mod  # noqa: E402
from incubator_brpc_tpu.runtime import worker_pool as jax_pool_mod  # noqa: E402
from incubator_brpc_tpu_torch.runtime import butex as port_butex_mod  # noqa: E402
from incubator_brpc_tpu_torch.runtime import execution_queue as port_eq  # noqa: E402
from incubator_brpc_tpu_torch.runtime import timer_thread as port_timer_mod  # noqa: E402
from incubator_brpc_tpu_torch.runtime import worker_pool as port_pool_mod  # noqa: E402

RT = {
    "jax": types.SimpleNamespace(butex=jax_butex_mod, eq=jax_eq, timer=jax_timer_mod,
                                 pool=jax_pool_mod),
    "torch": types.SimpleNamespace(butex=port_butex_mod, eq=port_eq, timer=port_timer_mod,
                                   pool=port_pool_mod),
}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return RT[request.param]


def test_butex_timed_wait(pkg):
    b = pkg.butex.Butex(0)
    t0 = time.monotonic()
    assert b.wait(0, timeout=0.05) == pkg.butex.ETIMEDOUT
    assert 0.04 <= time.monotonic() - t0 < 1.0


def test_butex_wake_except_skips_token(pkg):
    b = pkg.butex.Butex(0)
    woken = []

    def waiter(tok):
        b.wait(0, token=tok)
        woken.append(tok)

    t1 = threading.Thread(target=waiter, args=("me",))
    t2 = threading.Thread(target=waiter, args=("other",))
    t1.start(), t2.start()
    assert wait_until(lambda: len(b._waiters) >= 2)
    assert b.wake_except("me") == 1
    t2.join(timeout=2)
    assert woken == ["other"]
    b.wake_all()
    t1.join(timeout=2)
    assert not t1.is_alive() and not t2.is_alive()


def test_butex_timeout_then_normal_wake_race(pkg):
    # a wake arriving after the timer fired must not double-release
    b = pkg.butex.Butex(0)
    assert b.wait(0, timeout=0.01) == pkg.butex.ETIMEDOUT
    assert b.wake(1) == 0


def test_butex_requeue_preserves_timeout(pkg):
    b1, b2 = pkg.butex.Butex(0), pkg.butex.Butex(0)
    results = []

    def timed_waiter():
        results.append(b1.wait(0, timeout=0.15))

    def plain_waiter():
        results.append(b1.wait(0))

    t0 = threading.Thread(target=plain_waiter)
    t0.start()
    assert wait_until(lambda: len(b1._waiters) >= 1)
    t1 = threading.Thread(target=timed_waiter)
    t1.start()
    assert wait_until(lambda: len(b1._waiters) >= 2)
    # requeue wakes the first (plain) waiter, moves the timed one to b2
    assert b1.requeue(b2) == 1
    t0.join(timeout=2)
    # the moved timed waiter must still honor its timeout on b2
    t1.join(timeout=2)
    assert not t0.is_alive() and not t1.is_alive()
    assert results == [pkg.butex.WAIT_OK, pkg.butex.ETIMEDOUT]
    assert not b2.has_waiters()


def test_timer_schedule_and_order(pkg):
    tt = pkg.timer.TimerThread("test-timer")
    try:
        fired = []
        tt.schedule(lambda: fired.append("b"), delay=0.04)
        tt.schedule(lambda: fired.append("a"), delay=0.01)
        assert wait_until(lambda: len(fired) == 2)
        assert fired == ["a", "b"]
    finally:
        tt.stop_and_join()


def test_timer_unschedule_prevents_run(pkg):
    tt = pkg.timer.TimerThread("test-timer-2")
    try:
        fired = []
        tid = tt.schedule(lambda: fired.append(1), delay=0.05)
        assert tt.unschedule(tid) is True
        assert tt.unschedule(tid) is False  # already cancelled
        # a later timer fires after the cancelled one's due time
        tt.schedule(lambda: fired.append(2), delay=0.1)
        assert wait_until(lambda: fired == [2])
        assert tt.stats()["pending"] == 0
    finally:
        tt.stop_and_join()


def test_timer_earlier_schedule_preempts(pkg):
    tt = pkg.timer.TimerThread("test-timer-3")
    try:
        fired = []
        tt.schedule(lambda: fired.append("late"), delay=5.0)
        tt.schedule(lambda: fired.append("early"), delay=0.02)
        assert wait_until(lambda: fired == ["early"])
        assert fired == ["early"]  # did not wait behind the 5 s head
    finally:
        tt.stop_and_join()


def test_execution_queue_consumer_exception_does_not_drop_batch_remainder(pkg):
    seen = []

    def consumer(it):
        for item in it:
            if item == 2:
                raise RuntimeError("bad item")
            seen.append(item)

    q = pkg.eq.ExecutionQueue(consumer)
    for i in range(6):
        q.execute(i)
    q.stop()
    assert q.join(timeout=10)
    # item 2 was consumed by the raising call (at-most-once); 3..5 survive
    assert seen == [0, 1, 3, 4, 5]


# --------------------------------- tests/test_runtime_stress.py on both ----
# The scheduler's schedule/unschedule storm racing stop (also the TSan
# harness's scheduler stress, sized down by SCHED_STRESS_*).

import os  # noqa: E402

STRESS_THREADS = int(os.environ.get("SCHED_STRESS_THREADS", "8"))
STRESS_N = int(os.environ.get("SCHED_STRESS_N", "600"))


@pytest.mark.slow
class TestSchedulerContentionStress:
    def test_schedule_unschedule_storm_against_stop(self, pkg):
        timer = pkg.timer.TimerThread(name="stress-timer")
        pool = pkg.pool.WorkerPool(concurrency=4, name="sched_stress")
        fired = []
        fired_lock = threading.Lock()
        stats = [dict(attempts=0, prevented=0, refused=0) for _ in range(STRESS_THREADS)]
        fibers = []
        fibers_lock = threading.Lock()
        start_gate = threading.Event()

        def cb(tag):
            with fired_lock:
                fired.append(tag)

        def producer(idx):
            start_gate.wait(5.0)  # release all producers together
            st = stats[idx]
            for i in range(STRESS_N):
                st["attempts"] += 1
                tag = (idx, i)
                try:
                    tid = timer.schedule(lambda _t=tag: cb(_t),
                                         delay=0.0005 if i % 2 == 0 else 30.0)
                except RuntimeError:
                    st["refused"] += 1  # stopped mid-storm: accounted
                    continue
                if i % 3 == 0:
                    if timer.unschedule(tid):
                        st["prevented"] += 1
                if i % 5 == 0:
                    try:
                        f = pool.spawn(lambda: None)
                        with fibers_lock:
                            fibers.append(f)
                    except RuntimeError:
                        pass  # pool stopped mid-storm

        threads = [threading.Thread(target=producer, args=(i,)) for i in range(STRESS_THREADS)]
        for t in threads:
            t.start()
        start_gate.set()
        # land stop mid-storm
        threading.Event().wait(0.05)
        timer.stop_and_join()
        pool.stop_and_join()
        for t in threads:
            t.join(30)
            assert not t.is_alive(), "producer wedged against stop"

        attempts = sum(s["attempts"] for s in stats)
        prevented = sum(s["prevented"] for s in stats)
        refused = sum(s["refused"] for s in stats)
        assert attempts == STRESS_THREADS * STRESS_N
        with fired_lock:
            nfired = len(fired)
            assert len(set(fired)) == nfired  # no double fire
        pending = timer.stats()["pending"]
        assert nfired + prevented + refused + pending == attempts, (
            f"lost timers: fired={nfired} prevented={prevented} "
            f"refused={refused} pending={pending} attempts={attempts}"
        )
        with fibers_lock:
            snapshot = list(fibers)
        for f in snapshot:
            assert f.join(timeout=10), "fiber join hung after pool stop"
