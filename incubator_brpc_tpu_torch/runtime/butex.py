"""Butex — the keystone blocking primitive (reference src/bthread/butex.cpp).

A butex is a futex-like integer word: ``wait(expected)`` parks the caller
only if the word still equals ``expected`` (checked atomically with the
enqueue, so a concurrent ``wake`` can never be lost); ``wake*`` dequeue and
release waiters. The credit window, the pending-call handshake and the
device-completion butex (device_butex.py) block on these.

Design deviations from the reference (butex.cpp:607-690, :261-446):
- Waiters park on a per-waiter ``threading.Event`` instead of being
  descheduled M:N; under the GIL a user-space context switch buys nothing.
- Timed waits pre-register a TimerThread entry exactly as the reference
  does (butex.cpp:631-646); the timer-vs-wake race is decided by who
  removes the waiter from the queue first, under the butex lock.
- Butex objects are ordinary GC'd objects; Python's GC gives the
  wake-vs-destroy safety the reference's never-freed ObjectPool provides.

This is the port's copy of the JAX package's butex, trimmed to the
operations the device path and the host plane use. A wait on a worker-pool
thread counts that worker as blocked while it parks (the JAX package's
hook, runtime/butex.py:145-160), so the pool's elastic growth keeps
``fiber_concurrency`` workers runnable: a server handler parked on a
device completion or on the endpoint's credit window does not hold a
worker's place.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from incubator_brpc_tpu_torch.runtime.timer_thread import global_timer_thread

# wait() return codes (match the reference's errno contract)
WAIT_OK = 0
EWOULDBLOCK = 11  # value != expected at enqueue time
ETIMEDOUT = 110


class _Waiter:
    __slots__ = ("event", "timed_out", "timer_id")

    def __init__(self):
        self.event = threading.Event()
        self.timed_out = False
        self.timer_id = None


def _timeout_fire(butex: "Butex", w: _Waiter) -> None:
    """Timer callback: time ``w`` out unless a wake already dequeued it."""
    with butex._lock:
        try:
            butex._waiters.remove(w)
        except ValueError:
            return  # a wake won the race
        w.timed_out = True
    w.event.set()


class Butex:
    """A 32-bit-style word with futex wait/wake semantics."""

    __slots__ = ("_lock", "_value", "_waiters")

    def __init__(self, value: int = 0):
        self._lock = threading.Lock()
        self._value = value
        self._waiters: List[_Waiter] = []

    # -- value ops (all atomic wrt wait's enqueue check) --------------------

    def load(self) -> int:
        with self._lock:
            return self._value

    def store(self, value: int) -> None:
        """Set the value WITHOUT waking — pair with wake*() like the
        reference's separate atomic store + butex_wake calls."""
        with self._lock:
            self._value = value

    def add(self, delta: int) -> int:
        with self._lock:
            self._value += delta
            return self._value

    def compare_exchange(self, expected: int, desired: int) -> bool:
        with self._lock:
            if self._value != expected:
                return False
            self._value = desired
            return True

    def exchange(self, desired: int) -> int:
        """Atomically set the value, returning the old one (the unlock fast
        path of FiberMutex — one lock acquisition, no retry loop)."""
        with self._lock:
            old, self._value = self._value, desired
            return old

    # -- wait/wake ----------------------------------------------------------

    def wait(self, expected: int, timeout: Optional[float] = None) -> int:
        """Park until woken, iff value still == expected.

        Returns WAIT_OK on wake, EWOULDBLOCK if value != expected at the
        atomic check, ETIMEDOUT if the pre-registered timer fired first.
        """
        w = _Waiter()
        with self._lock:
            if self._value != expected:
                return EWOULDBLOCK
            self._waiters.append(w)
        if timeout is not None:
            # Pre-register the timeout like butex_wait (butex.cpp:631-646):
            # the timer callback races with wake() and the loser finds the
            # waiter already gone.
            w.timer_id = global_timer_thread().schedule(
                lambda: _timeout_fire(self, w), delay=timeout
            )
        # Tell the worker pool this worker is BLOCKED (not merely busy) so
        # elastic growth can keep `concurrency` runnable workers — the
        # replacement for the reference's M:N descheduling of the caller.
        from incubator_brpc_tpu_torch.runtime import worker_pool as _wp

        worker = getattr(_wp._tls, "worker", None)
        if worker is not None and not w.event.is_set():
            pool = worker.pool
            with pool._grow_lock:
                pool._nblocked += 1
                pool._grow_if_starved()
            try:
                w.event.wait()
            finally:
                with pool._grow_lock:
                    pool._nblocked -= 1
        else:
            w.event.wait()
        if w.timer_id is not None and not w.timed_out:
            global_timer_thread().unschedule(w.timer_id)
        return ETIMEDOUT if w.timed_out else WAIT_OK

    def wake(self, n: int = 1) -> int:
        """Wake up to n waiters (FIFO); returns how many were woken."""
        woken: List[_Waiter] = []
        with self._lock:
            while self._waiters and len(woken) < n:
                woken.append(self._waiters.pop(0))
        for w in woken:
            w.event.set()
        return len(woken)

    def wake_all(self) -> int:
        with self._lock:
            woken, self._waiters = self._waiters, []
        for w in woken:
            w.event.set()
        return len(woken)
