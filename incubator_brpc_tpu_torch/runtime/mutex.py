"""Fiber-aware mutex/cond + the contention profiler
(reference src/bthread/mutex.cpp:52-350, condition_variable.cpp,
countdown_event.cpp).

The reference's subtlest observability trick lives here: every contended
unlock *samples* the wait it caused — stack + cycles — into a collector,
rendered as a pprof-compatible contention profile. Kept: contended
acquires are always counted/timed into bvars; stack capture is
rate-limited (the bvar::Collector speed-limiter role) and aggregated by
call site; ``contention_profile()`` returns the dump (the /dev/contention
analog, mutex.cpp:145).

FiberMutex parks waiters on a Butex (usable from fibers AND plain
threads — the dual-personality butex contract); FiberCond is
wait-morphing-free (wake then relock) which is semantically equivalent,
just cheaper to get right.

The port's copy of the JAX package's ``runtime/mutex.py``. A waiter parked
on a worker-pool thread counts that worker as blocked (the port's butex
hook), so a contended lock never starves the pool. ``/hotspots/contention``
renders ``contention_profile()``.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch.bvar import Adder, LatencyRecorder
from incubator_brpc_tpu_torch.runtime.butex import Butex, ETIMEDOUT

contended_acquires = Adder(name="mutex_contended_acquires")
contention_wait = LatencyRecorder(name="mutex_contention_wait")

_THIS_FILE = __file__.rstrip("c")  # tolerate .pyc paths in tracebacks


class _ContentionCollector:
    """Aggregates sampled contention by call-site stack
    (mutex.cpp g_cp collector + stack hashing)."""

    MAX_SAMPLES_PER_SEC = 100

    def __init__(self):
        self._lock = threading.Lock()
        self._by_stack: Dict[str, List[float]] = {}  # stack -> [count, total_us]
        self._window_start = 0.0
        self._window_count = 0

    def _admit(self) -> bool:
        now = time.monotonic()
        with self._lock:
            if now - self._window_start >= 1.0:
                self._window_start = now
                self._window_count = 0
            if self._window_count >= self.MAX_SAMPLES_PER_SEC:
                return False
            self._window_count += 1
            return True

    def record(self, wait_us: float) -> None:
        contended_acquires << 1
        contention_wait << wait_us
        if not self._admit():
            return
        # keep the caller's site: drop however many trailing frames belong
        # to this module (record/acquire, plus __enter__ when used as a
        # context manager — a fixed count would mis-attribute plain
        # m.acquire() calls one level up)
        frames = traceback.format_stack(limit=10)
        while frames and _THIS_FILE in frames[-1]:
            frames.pop()
        stack = "".join(frames)
        with self._lock:
            entry = self._by_stack.setdefault(stack, [0, 0.0])
            entry[0] += 1
            entry[1] += wait_us

    def profile(self) -> List[Tuple[str, int, float]]:
        """[(stack, count, total_wait_us)] sorted by total wait."""
        with self._lock:
            rows = [(s, int(c), us) for s, (c, us) in self._by_stack.items()]
        return sorted(rows, key=lambda r: -r[2])

    def reset(self) -> None:
        with self._lock:
            self._by_stack.clear()


_collector = _ContentionCollector()


def contention_profile() -> List[Tuple[str, int, float]]:
    return _collector.profile()


def reset_contention_profile() -> None:
    _collector.reset()


class FiberMutex:
    """Butex-backed mutex (bthread_mutex_t over butex, mutex.cpp:615-723).
    Word states: 0 free, 1 locked, 2 locked-with-waiters."""

    def __init__(self):
        self._b = Butex(0)

    def try_acquire(self) -> bool:
        return self._b.compare_exchange(0, 1)

    def acquire(self, timeout: Optional[float] = None) -> bool:
        if self._b.compare_exchange(0, 1):
            return True  # fast path, uncontended
        t0 = time.monotonic()
        deadline = None if timeout is None else t0 + timeout
        while True:
            # advertise waiters: 1 -> 2 (or claim 0 -> 2 directly)
            v = self._b.load()
            if v == 0 and self._b.compare_exchange(0, 2):
                break
            if v == 1 and not self._b.compare_exchange(1, 2):
                continue
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
            if self._b.wait(2, timeout=remaining) == ETIMEDOUT:
                return False
        _collector.record((time.monotonic() - t0) * 1e6)
        return True

    def release(self) -> None:
        # atomic exchange: a plain load+store would race with a waiter
        # upgrading 1→2 in between and lose its wakeup
        old = self._b.exchange(0)
        # the unlock side pays the wake (the reference's contention profiler
        # hooks here; our timing happens on the waiter side instead)
        if old == 2:
            self._b.wake(1)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    locked = property(lambda self: self._b.load() != 0)


class FiberCond:
    """Condition variable over a butex (bthread_cond via butex_requeue;
    here: version-stamped wake, then relock)."""

    def __init__(self):
        self._seq = Butex(0)

    def wait(self, mutex: FiberMutex, timeout: Optional[float] = None) -> bool:
        seq = self._seq.load()
        mutex.release()
        rc = self._seq.wait(seq, timeout=timeout)
        acquired = mutex.acquire(timeout=None)
        assert acquired
        return rc != ETIMEDOUT

    def notify_one(self) -> None:
        self._seq.add(1)
        self._seq.wake(1)

    def notify_all(self) -> None:
        self._seq.add(1)
        self._seq.wake_all()


class CountdownEvent:
    """bthread::CountdownEvent (countdown_event.cpp): N signals release
    every waiter."""

    def __init__(self, count: int = 1):
        assert count >= 0
        self._b = Butex(count)

    def signal(self, n: int = 1) -> None:
        left = self._b.add(-n)
        if left <= 0:
            self._b.wake_all()

    def wait(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            v = self._b.load()
            if v <= 0:
                return True
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
            self._b.wait(v, timeout=remaining)

    def reset(self, count: int) -> None:
        self._b.store(count)
