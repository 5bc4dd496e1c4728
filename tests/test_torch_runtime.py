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
from incubator_brpc_tpu_torch.utils import flags, status


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    """End the completion watchers and the timer each test started, and
    check that no thread of the port is left in this process."""
    yield
    assert shutdown_watchers(timeout=60)
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
