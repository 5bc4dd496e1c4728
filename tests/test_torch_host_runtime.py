"""The port's host runtime on the CPU: the worker-pool and correlation-id
cases of tests/test_runtime.py on the port's copies
(``incubator_brpc_tpu_torch.runtime``), the butex's worker-pool hook (a
fiber parked in a butex wait counts as blocked, and the pool grows past it
when fibers are queued), and the event dispatcher's shutdown. Every test
stops and joins the port threads it started (``tbtorch-*``)."""

import threading
import time

import pytest

from incubator_brpc_tpu_torch.rpc import shutdown_host_plane
from incubator_brpc_tpu_torch.runtime.butex import Butex
from incubator_brpc_tpu_torch.runtime.correlation_id import CallIdSpace
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.runtime.worker_pool import (
    WorkerPool,
    WorkStealingQueue,
    global_worker_pool,
)
from incubator_brpc_tpu_torch.transport.event_dispatcher import global_dispatcher


def spawn(fn, *args, **kwargs):
    return global_worker_pool().spawn(fn, *args, **kwargs)


def wait_until(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.002)
    return True


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    shutdown_host_plane()
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


# ----------------------------------------------------------- worker pool ----


def test_fiber_spawn_join_result():
    f = spawn(lambda a, b: a + b, 2, 3)
    assert f.join(timeout=5)
    assert f.get() == 5


def test_fiber_exception_propagates_via_get():
    def boom():
        raise ValueError("boom")

    f = spawn(boom)
    assert f.join(timeout=5)
    with pytest.raises(ValueError):
        f.get()


def test_fiber_join_timeout():
    gate = threading.Event()
    f = spawn(gate.wait)
    assert f.join(timeout=0.05) is False
    gate.set()
    assert f.join(timeout=5)


def test_pool_runs_many_fibers_and_nested_spawn():
    pool = WorkerPool(concurrency=4, name="test_port_pool_many")
    try:
        total = 64
        done = []
        lock = threading.Lock()

        def leaf(i):
            with lock:
                done.append(i)

        def parent(i):
            # spawn from inside a worker: exercises the local-queue path
            return pool.spawn(leaf, i)

        parents = [pool.spawn(parent, i) for i in range(total)]
        leaves = [p.get(timeout=10) for p in parents]
        for leaf_fiber in leaves:
            assert leaf_fiber.join(timeout=10)
        assert sorted(done) == list(range(total))
        assert int(pool.nfibers_run.get_value()) == 2 * total
    finally:
        pool.stop_and_join()


def test_work_stealing_queue_order():
    q = WorkStealingQueue()
    for i in range(5):
        q.push(i)
    assert q.pop() == 4  # owner: LIFO
    assert q.steal() == 0  # thief: FIFO
    assert len(q) == 3


def test_pool_threads_are_named_for_the_port():
    pool = WorkerPool(concurrency=2, name="test_port_pool_names")
    try:
        names = [w.thread.name for w in pool._workers]
        assert names == ["tbtorch-worker-0", "tbtorch-worker-1"]
    finally:
        pool.stop_and_join()


def test_stopped_pool_fails_unrun_fibers():
    pool = WorkerPool(concurrency=1, name="test_port_pool_orphans")
    gate = threading.Event()
    pool.spawn(gate.wait, 5)
    assert wait_until(lambda: pool.stats()["queued_remote"] == 0)
    orphan = pool.spawn(lambda: 1)
    gate.set()
    pool.stop_and_join()
    assert orphan.join(timeout=5)


# ------------------------------------------------- the butex's pool hook ----


def test_a_parked_fiber_counts_as_blocked():
    pool = WorkerPool(concurrency=2, name="test_port_pool_blocked")
    try:
        b = Butex(0)
        f = pool.spawn(b.wait, 0, 10.0)
        assert wait_until(lambda: pool.stats()["blocked"] - pool.stats()["idle"] >= 1)
        b.add(1)
        b.wake_all()
        assert f.join(timeout=5)
        assert wait_until(lambda: pool.stats()["blocked"] == pool.stats()["idle"])
    finally:
        pool.stop_and_join()


def test_pool_grows_past_fibers_parked_on_a_butex():
    """Eight fibers that all park on one butex finish with a pool of two:
    the pool grows past its parked workers. Without that, the first two
    would hold both workers and the rest would never start."""
    pool = WorkerPool(concurrency=2, name="test_port_pool_grow")
    try:
        b = Butex(0)
        started = []
        lock = threading.Lock()

        def parked(i):
            with lock:
                started.append(i)
            while b.load() == 0:
                b.wait(0, timeout=10.0)

        fibers = [pool.spawn(parked, i) for i in range(8)]
        assert wait_until(lambda: len(started) == 8, timeout=10)
        b.add(1)
        b.wake_all()
        for f in fibers:
            assert f.join(timeout=10)
        assert pool.stats()["workers"] >= 8
    finally:
        pool.stop_and_join()


def test_a_parking_worker_starts_a_replacement_for_queued_fibers():
    """Fibers queued while the one worker is busy (not parked) start once
    it parks on a butex: parking grows the pool when work is queued, with
    no further spawn to trigger growth (the burst of requests one
    connection's read cuts)."""
    pool = WorkerPool(concurrency=1, name="test_port_pool_park_grow")
    try:
        gate = threading.Event()
        b = Butex(0)
        started = []
        lock = threading.Lock()

        def parked(i):
            with lock:
                started.append(i)
            while b.load() == 0:
                b.wait(0, timeout=10.0)

        busy = pool.spawn(gate.wait, 10)  # busy, not parked on a butex
        assert wait_until(lambda: pool.stats()["queued_remote"] == 0)
        fibers = [pool.spawn(parked, i) for i in range(4)]
        assert pool.stats()["workers"] == 1  # no growth at spawn: none parked
        gate.set()
        assert wait_until(lambda: len(started) == 4, timeout=10)
        b.add(1)
        b.wake_all()
        for f in [busy] + fibers:
            assert f.join(timeout=10)
    finally:
        pool.stop_and_join()


def test_global_pool_restarts_after_shutdown():
    first = global_worker_pool()
    assert spawn(lambda: 7).get(timeout=5) == 7
    shutdown_host_plane()
    assert first._stopped
    second = global_worker_pool()
    assert second is not first
    assert spawn(lambda: 8).get(timeout=5) == 8


def test_dispatcher_threads_are_named_and_joined():
    d = global_dispatcher(0)
    assert d._thread.name.startswith("tbtorch-dispatcher-")
    assert d._thread.is_alive()
    shutdown_host_plane()
    assert not d._thread.is_alive()


# -------------------------------------------------------- correlation id ----


def test_call_id_lock_unlock_and_destroy():
    space = CallIdSpace()
    cid = space.create(data={"x": 1})
    code, data = space.lock(cid)
    assert code == 0 and data == {"x": 1}
    assert space.unlock(cid) == 0
    code, _ = space.lock(cid)
    assert code == 0
    assert space.unlock_and_destroy(cid) == 0
    assert not space.valid(cid)
    code, _ = space.lock(cid)
    assert code != 0  # stale id: EINVAL, no fault (never-freed slot)


def test_call_id_error_when_unlocked_runs_handler_inline():
    space = CallIdSpace()
    handled = []

    def on_error(call_id, data, code, text):
        handled.append((data, code, text))
        space.unlock_and_destroy(call_id)

    cid = space.create(data="D", on_error=on_error)
    assert space.error(cid, 1008, "timeout") == 0
    assert handled == [("D", 1008, "timeout")]
    assert not space.valid(cid)


def test_call_id_error_while_locked_is_queued_until_unlock():
    space = CallIdSpace()
    handled = []

    def on_error(call_id, data, code, text):
        handled.append(code)
        space.unlock_and_destroy(call_id)

    cid = space.create(data="D", on_error=on_error)
    code, _ = space.lock(cid)
    assert code == 0
    assert space.error(cid, 1009) == 0  # queued, not delivered
    assert handled == []
    assert space.unlock(cid) == 0  # delivery point
    assert handled == [1009]
    assert not space.valid(cid)


def test_call_id_join_wakes_on_destroy():
    space = CallIdSpace()
    cid = space.create()
    joined = []

    def joiner():
        joined.append(space.join(cid, timeout=10))

    t = threading.Thread(target=joiner)
    t.start()
    time.sleep(0.05)
    assert joined == []  # still parked
    code, _ = space.lock(cid)
    assert code == 0
    space.unlock_and_destroy(cid)
    t.join(timeout=5)
    assert joined == [True]
    assert space.join(cid) is True  # joining a destroyed id returns at once


def test_call_id_ranged_versions_shared_across_retries():
    space = CallIdSpace()
    cid = space.create(data="rpc", version_range=3)
    assert space.valid(cid)
    assert space.valid(cid + 1)
    assert space.valid(cid + 2)
    assert not space.valid(cid + 3)
    code, data = space.lock(cid + 2)  # a retry's version resolves to the slot
    assert code == 0 and data == "rpc"
    space.unlock_and_destroy(cid + 2)
    for d in range(3):
        assert not space.valid(cid + d)


def test_call_id_lock_contention():
    space = CallIdSpace()
    cid = space.create(data=[])
    order = []

    def contender(i):
        code, data = space.lock(cid)
        assert code == 0
        order.append(i)
        time.sleep(0.005)
        space.unlock(cid)

    threads = [threading.Thread(target=contender, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(order) == list(range(6))  # all got the lock exactly once


def test_call_id_unlock_with_pending_error_and_no_handler_destroys():
    space = CallIdSpace()
    cid = space.create(data="d")
    code, _ = space.lock(cid)
    assert code == 0
    assert space.error(cid, 1008) == 0  # queued (locked, no handler)
    assert space.unlock(cid) == 0
    assert not space.valid(cid)  # destroyed, not stuck locked


def test_call_id_lock_nowait_is_ebusy_while_held():
    from incubator_brpc_tpu_torch.runtime.correlation_id import EBUSY

    space = CallIdSpace()
    cid = space.create(data="d")
    assert space.lock(cid)[0] == 0
    assert space.lock(cid, nowait=True) == (EBUSY, None)
    space.unlock_and_destroy(cid)


def test_call_id_slots_are_reused_with_a_new_version():
    space = CallIdSpace()
    a = space.create()
    space.lock(a)
    space.unlock_and_destroy(a)
    b = space.create()
    assert b >> 32 == a >> 32 and b != a
    assert not space.valid(a) and space.valid(b)
