"""ExecutionQueue — MPSC actor queue (reference
src/bthread/execution_queue.{h,cpp}).

Any thread may ``execute()`` items; at most ONE consumer fiber drains them
at a time, receiving batches through an iterator — the reference's
"execute tasks in batch in a single (b)thread" contract. Streams use one
per stream for ordered consumption (stream.cpp:86).

Kept semantics:
- multi-producer push; the producer that transitions the queue from idle
  schedules the single consumer fiber (the reference CASes _head and the
  winner starts the execution bthread, execution_queue_inl.h).
- a high-priority lane whose items are drained before normal ones
  (``execute(..., high_priority=True)``).
- ``stop()`` + ``join()``: producers after stop get EINVAL; join waits for
  the drain to finish; the consumer sees ``iter.is_queue_stopped()`` on the
  final batch.
- the consumer callback gets a TaskIterator; returning normally commits the
  batch. Exceptions are logged and do not kill the queue.

The port's copy of the JAX package's ``runtime/execution_queue.py``, on the
port's worker pool and butex.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Callable, Generic, Iterator, Optional, TypeVar

from incubator_brpc_tpu_torch.runtime.butex import ETIMEDOUT, Butex
from incubator_brpc_tpu_torch.runtime.worker_pool import WorkerPool, global_worker_pool

T = TypeVar("T")
EINVAL = 22

logger = logging.getLogger(__name__)


class TaskIterator(Generic[T]):
    """Batch iterator handed to the consumer (reference TaskIterator)."""

    def __init__(self, items: deque, stopped: bool):
        self._items = items
        self._stopped = stopped

    def __iter__(self) -> Iterator[T]:
        while self._items:
            yield self._items.popleft()

    def is_queue_stopped(self) -> bool:
        return self._stopped


class ExecutionQueue(Generic[T]):
    def __init__(
        self,
        consumer: Callable[[TaskIterator[T]], None],
        pool: Optional[WorkerPool] = None,
        max_batch: int = 256,
    ):
        self._consumer = consumer
        self._pool = pool  # resolved lazily so queues can be built pre-pool
        self._max_batch = max_batch
        self._lock = threading.Lock()
        self._normal: deque = deque()
        self._high: deque = deque()
        self._active = False  # a consumer fiber is scheduled/running
        self._stopped = False
        self._joined_butex = Butex(0)  # 1 == fully drained after stop

    def execute(self, item: T, high_priority: bool = False) -> int:
        """Push one item; returns 0 or EINVAL after stop()."""
        with self._lock:
            if self._stopped:
                return EINVAL
            (self._high if high_priority else self._normal).append(item)
            if self._active:
                return 0
            self._active = True  # we are the scheduling producer
        self._schedule()
        return 0

    def stop(self) -> None:
        """Reject further items; the consumer drains what is queued, then the
        final (possibly empty) batch reports is_queue_stopped()."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            if self._active:
                return
            self._active = True
        self._schedule()

    def join(self, timeout: Optional[float] = None) -> bool:
        while self._joined_butex.load() == 0:
            if self._joined_butex.wait(0, timeout=timeout) == ETIMEDOUT:
                return False
        return True

    # -- consumer side ------------------------------------------------------

    def _schedule(self) -> None:
        (self._pool or global_worker_pool()).spawn(self._drain)

    def _drain(self) -> None:
        while True:
            with self._lock:
                batch: deque = deque()
                while self._high and len(batch) < self._max_batch:
                    batch.append(self._high.popleft())
                while self._normal and len(batch) < self._max_batch:
                    batch.append(self._normal.popleft())
                stopped = self._stopped and not self._high and not self._normal
                if not batch and not stopped:
                    # nothing left: hand the "active" token back
                    self._active = False
                    return
            it = TaskIterator(batch, stopped)
            while True:
                before = len(batch)
                try:
                    self._consumer(it)
                    break
                except Exception:  # noqa: BLE001 — consumer bugs must not kill the actor
                    # The raising item was already consumed (at-most-once for
                    # it); re-deliver the batch remainder so ordered items
                    # behind it are not silently dropped. If the consumer made
                    # no progress at all (raised before its first pop), drop
                    # the head item to guarantee forward progress.
                    logger.exception(
                        "execution queue consumer raised (%d items left in batch)",
                        len(batch),
                    )
                    if batch and len(batch) == before:
                        batch.popleft()
                    if not batch:
                        break
            if stopped:
                self._joined_butex.store(1)
                self._joined_butex.wake_all()
                return


def execution_queue_start(
    consumer: Callable[[TaskIterator[T]], None],
    pool: Optional[WorkerPool] = None,
) -> ExecutionQueue[T]:
    """reference execution_queue_start analog."""
    return ExecutionQueue(consumer, pool=pool)
