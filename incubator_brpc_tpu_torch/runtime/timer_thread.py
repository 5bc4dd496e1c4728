"""TimerThread — one global timing wheel thread (reference
src/bthread/timer_thread.{h,cpp}).

The reference hashes timers into 13 buckets with a global
``_nearest_run_time`` futex; under the GIL bucket sharding buys nothing, so
this uses a single heap + tombstone map, keeping the properties that matter:

- ``schedule`` returns an id; ``unschedule`` is O(1) (tombstone) and reports
  whether the callback was prevented from running (timer_thread.cpp's
  0 / 1 / -1 contract collapsed to bool).
- Callbacks run inline on the timer thread and must be cheap — they
  typically just wake a butex or push to a worker pool, exactly like the
  reference's ready_to_run_remote convention.
- An earlier-than-nearest schedule wakes the thread immediately.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Dict, Optional


class TimerThread:
    _RUNNING = 1
    _STOPPED = 2

    def __init__(self, name: str = "tbtorch-timer"):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._heap = []  # (run_time, seq, timer_id)
        self._entries: Dict[int, Callable[[], None]] = {}
        self._seq = itertools.count()
        self._next_id = itertools.count(1)
        self._stopped = False
        self._nsignals = 0  # bvar-ish counters
        self._nscheduled = 0
        self._ntriggered = 0
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def schedule(
        self,
        fn: Callable[[], None],
        abstime: Optional[float] = None,
        delay: Optional[float] = None,
    ) -> int:
        """Schedule fn at abstime (time.monotonic()) or after delay seconds."""
        if abstime is None:
            if delay is None:
                raise ValueError("need abstime or delay")
            abstime = time.monotonic() + delay
        with self._lock:
            if self._stopped:
                raise RuntimeError("TimerThread stopped")
            timer_id = next(self._next_id)
            self._entries[timer_id] = fn
            was_nearest = not self._heap or abstime < self._heap[0][0]
            heapq.heappush(self._heap, (abstime, next(self._seq), timer_id))
            self._nscheduled += 1
            if was_nearest:
                self._nsignals += 1
                self._cond.notify()
        return timer_id

    def unschedule(self, timer_id: int) -> bool:
        """Cancel; True iff the callback will not run (O(1) tombstone —
        reference TimerThread::unschedule's fast path)."""
        with self._lock:
            return self._entries.pop(timer_id, None) is not None

    def stop_and_join(self) -> None:
        with self._lock:
            self._stopped = True
            self._cond.notify()
        self._thread.join()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "scheduled": self._nscheduled,
                "triggered": self._ntriggered,
                "signals": self._nsignals,
                "pending": len(self._entries),
            }

    def _run(self) -> None:
        while True:
            with self._lock:
                while True:
                    if self._stopped:
                        return
                    now = time.monotonic()
                    # drop tombstoned heads
                    while self._heap and self._heap[0][2] not in self._entries:
                        heapq.heappop(self._heap)
                    if self._heap and self._heap[0][0] <= now:
                        _, _, timer_id = heapq.heappop(self._heap)
                        fn = self._entries.pop(timer_id, None)
                        break
                    wait = (self._heap[0][0] - now) if self._heap else None
                    self._cond.wait(wait)
            if fn is not None:
                self._ntriggered += 1
                try:
                    fn()  # must be cheap (see module docstring)
                except Exception:  # noqa: BLE001 — a timer cb must not kill the thread
                    import logging

                    logging.getLogger(__name__).exception("timer callback raised")


_global: Optional[TimerThread] = None
_global_lock = threading.Lock()


def global_timer_thread() -> TimerThread:
    """Lazy process-global TimerThread (reference get_or_create_global_timer_thread)."""
    global _global
    if _global is None or _global._stopped:
        with _global_lock:
            if _global is None or _global._stopped:
                _global = TimerThread()
    return _global


def shutdown_global_timer_thread() -> None:
    """Stop and join the process-global TimerThread, if one runs; the next
    timed wait starts a new one. Its pending timers are dropped, so call it
    only when no timed wait is parked."""
    global _global
    with _global_lock:
        t, _global = _global, None
    if t is not None and not t._stopped:
        t.stop_and_join()
