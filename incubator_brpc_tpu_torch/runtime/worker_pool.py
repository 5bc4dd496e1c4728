"""WorkerPool — the TaskControl/TaskGroup analog (reference
src/bthread/task_control.cpp, task_group.cpp).

Fibers are lightweight tasks executed by a pool of worker threads with
per-worker run queues, cross-worker stealing, and a ParkingLot where idle
workers sleep. Under the GIL there is no M:N context-switch win, so a fiber
runs to completion on one worker (no mid-fiber descheduling); blocking a
fiber means blocking its worker on a butex — the pool sizes itself
accordingly (``fiber_concurrency`` flag, reference ``bthread_concurrency``
bthread.cpp:30).

Kept semantics:
- spawn from a worker pushes to that worker's local queue (locality,
  task_group.cpp:646-686); spawn from outside goes to the remote queue.
- idle workers steal from victims' queues (task_control.cpp:332-359) and
  park on a ParkingLot futex word when there is nothing to steal
  (parking_lot.h:28-68); producers signal it (capped wakes).
- every fiber has a version butex; join() is a butex wait on it
  (task_group.cpp:467-492), and the exit path wakes all joiners
  (butex_wake_except with the fiber's own token, task_group.cpp:327-347).
- ``urgent=True`` maps bthread_start_urgent: LIFO-push so it runs next on
  the local worker.

The port's copy of the JAX package's pool, with its fiber-local storage
hooks (``runtime/keys.py``: a fiber's key table, its destructors run when
the fiber ends). Workers are named ``tbtorch-worker-N``.
One addition: a worker that parks in a butex wait while fibers are queued
and no worker is idle starts a replacement at once (``_grow_if_starved``),
where the JAX package grows only at the next spawn. A burst of requests cut
off one connection is spawned before any handler parks, so growth at spawn
alone would leave the burst's rest queued behind the parked handlers.
"""

from __future__ import annotations

import random
import threading
from collections import deque
from typing import Any, Callable, List, Optional

from incubator_brpc_tpu_torch.bvar import Adder
from incubator_brpc_tpu_torch.runtime.butex import Butex
from incubator_brpc_tpu_torch.utils.flags import get_flag

_tls = threading.local()  # .worker -> _Worker on a pool thread; .fiber -> the running Fiber


class Fiber:
    """Handle to a spawned task; join() parks on the version butex."""

    __slots__ = ("_fn", "_args", "_kwargs", "_version_butex", "result",
                 "exception", "urgent", "keytable")

    def __init__(self, fn, args, kwargs, urgent: bool):
        self._fn = fn
        self._args = args
        self._kwargs = kwargs
        self._version_butex = Butex(0)
        self.result: Any = None
        self.exception: Optional[BaseException] = None
        self.urgent = urgent
        self.keytable = None  # lazily built by runtime.keys

    @property
    def done(self) -> bool:
        return self._version_butex.load() != 0

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for completion; True iff finished (False = timed out)."""
        from incubator_brpc_tpu_torch.runtime.butex import ETIMEDOUT

        while self._version_butex.load() == 0:
            if self._version_butex.wait(0, timeout=timeout) == ETIMEDOUT:
                return False
        return True

    def get(self, timeout: Optional[float] = None) -> Any:
        if not self.join(timeout):
            raise TimeoutError("fiber not finished")
        if self.exception is not None:
            raise self.exception
        return self.result

    def _run(self) -> None:
        prev_fiber = getattr(_tls, "fiber", None)
        _tls.fiber = self  # fiber-local storage context (runtime.keys)
        try:
            self.result = self._fn(*self._args, **self._kwargs)
        except BaseException as e:  # noqa: BLE001 — stored, re-raised in get()
            self.exception = e
        finally:
            if self.keytable is not None:
                # run key destructors on fiber exit (key.cpp KeyTable dtor)
                # BEFORE restoring _tls.fiber: a destructor reading or
                # writing other keys must still see THIS fiber's table
                from incubator_brpc_tpu_torch.runtime import keys as _keys

                _keys.run_destructors(self.keytable)
            _tls.fiber = prev_fiber
            # exit path: bump version, wake joiners (task_group.cpp:327-347)
            self._version_butex.add(1)
            self._version_butex.wake_all()


class ParkingLot:
    """Futex word where idle workers sleep (reference parking_lot.h:28-68):
    signal() bumps the word and wakes; waiters re-check the word to never
    miss a signal."""

    def __init__(self):
        self._butex = Butex(0)

    def state(self) -> int:
        return self._butex.load()

    def signal(self, n: int) -> None:
        self._butex.add(1)
        self._butex.wake(n)

    def wait(self, expected_state: int, timeout: float = 1.0) -> None:
        self._butex.wait(expected_state, timeout=timeout)

    def stop(self) -> None:
        self._butex.add(1)
        self._butex.wake_all()


class WorkStealingQueue:
    """Per-worker deque: owner pushes/pops LIFO at the bottom, thieves steal
    FIFO from the top (reference work_stealing_queue.h:69-132; the lock
    replaces the Chase-Lev fences — no benefit under the GIL)."""

    def __init__(self):
        self._dq: deque = deque()
        self._lock = threading.Lock()

    def push(self, item) -> None:
        with self._lock:
            self._dq.append(item)

    def pop(self):
        with self._lock:
            return self._dq.pop() if self._dq else None

    def steal(self):
        with self._lock:
            return self._dq.popleft() if self._dq else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)


class _Worker:
    def __init__(self, pool: "WorkerPool", index: int):
        self.pool = pool
        self.index = index
        self.rq = WorkStealingQueue()
        self.steal_seed = random.Random(index * 2654435761 + 1)
        self.thread = threading.Thread(
            target=self._main, name=f"tbtorch-worker-{index}", daemon=True
        )

    def _main(self) -> None:
        _tls.worker = self
        pool = self.pool
        while not pool._stopped:
            fiber = self._next_fiber()
            if fiber is None:
                state = pool._lot.state()
                if self._peek_any():
                    continue
                with pool._grow_lock:
                    pool._nidle += 1
                try:
                    pool._lot.wait(state)
                finally:
                    with pool._grow_lock:
                        pool._nidle -= 1
                continue
            pool.nfibers_run << 1
            fiber._run()
        _tls.worker = None

    def _next_fiber(self) -> Optional[Fiber]:
        fiber = self.rq.pop()
        if fiber is not None:
            return fiber
        fiber = self.pool._pop_remote()
        if fiber is not None:
            return fiber
        # steal round: visit victims in random order (task_control.cpp:332-359)
        workers = self.pool._workers
        n = len(workers)
        start = self.steal_seed.randrange(n) if n else 0
        for i in range(n):
            victim = workers[(start + i) % n]
            if victim is self:
                continue
            fiber = victim.rq.steal()
            if fiber is not None:
                return fiber
        return None

    def _peek_any(self) -> bool:
        if len(self.rq):
            return True
        if self.pool._remote_len():
            return True
        return any(len(w.rq) for w in self.pool._workers if w is not self)


class WorkerPool:
    """TaskControl analog: owns the workers, the remote queue, the lot."""

    def __init__(
        self,
        concurrency: Optional[int] = None,
        max_concurrency: Optional[int] = None,
        name: str = "pool",
    ):
        self._concurrency = concurrency or get_flag("fiber_concurrency")
        self._max_concurrency = max_concurrency or get_flag("fiber_concurrency_max")
        self._remote: deque = deque()
        self._remote_lock = threading.Lock()
        self._lot = ParkingLot()
        self._stopped = False
        self._nidle = 0
        self._nblocked = 0  # workers parked in a butex wait mid-fiber
        self._grow_lock = threading.Lock()
        self.nfibers_run = Adder(name=f"{name}_fibers_run")
        self._workers: List[_Worker] = [
            _Worker(self, i) for i in range(self._concurrency)
        ]
        for w in self._workers:
            w.thread.start()

    # -- producers ----------------------------------------------------------

    def spawn(self, fn: Callable, *args, urgent: bool = False, **kwargs) -> Fiber:
        """start_background / start_urgent analog."""
        if self._stopped:
            raise RuntimeError("pool stopped")
        fiber = Fiber(fn, args, kwargs, urgent)
        worker = getattr(_tls, "worker", None)
        if worker is not None and worker.pool is self:
            worker.rq.push(fiber)  # local push — locality (task_group.cpp:646)
        else:
            with self._remote_lock:
                if urgent:
                    self._remote.appendleft(fiber)
                else:
                    self._remote.append(fiber)
        # capped wake: 1 waiter per spawn (task_control.cpp:361-391 caps at 2)
        self._lot.signal(1)
        # elastic growth (task_control.cpp:382-390 grows from
        # bthread_min_concurrency): fibers here block their worker 1:1, so
        # the pool maintains ~`concurrency` RUNNABLE workers — it grows only
        # when butex-blocked workers eat into that budget (a busy-but-running
        # worker will drain the queue by itself; growing on mere busyness
        # would add one thread per spawn in a burst).
        if self._nidle == 0:
            with self._grow_lock:
                self._grow_locked()
        return fiber

    def _grow_locked(self) -> None:
        """Start one worker if fewer than ``concurrency`` are runnable and
        none is idle. Caller holds ``_grow_lock``."""
        if (
            self._nidle == 0
            and len(self._workers) - self._nblocked < self._concurrency
            and len(self._workers) < self._max_concurrency
            and not self._stopped
        ):
            w = _Worker(self, len(self._workers))
            self._workers.append(w)
            w.thread.start()

    def _grow_if_starved(self) -> None:
        """A worker is about to park in a butex wait: if fibers are queued
        and no worker is idle, start a replacement now rather than at the
        next spawn. Caller holds ``_grow_lock``."""
        if self._nidle == 0 and (
            self._remote_len() or any(len(w.rq) for w in self._workers)
        ):
            self._grow_locked()

    def _pop_remote(self) -> Optional[Fiber]:
        with self._remote_lock:
            return self._remote.popleft() if self._remote else None

    def _remote_len(self) -> int:
        with self._remote_lock:
            return len(self._remote)

    @property
    def concurrency(self) -> int:
        return self._concurrency

    def stats(self) -> dict:
        """Live scheduler stats for the /fibers portal page (the reference
        exposes the same through /bthreads + TaskControl bvars)."""
        with self._grow_lock:
            nworkers = len(self._workers)
        local = sum(len(w.rq) for w in self._workers[:nworkers])
        return {
            "workers": nworkers,
            "target_concurrency": self._concurrency,
            "max_concurrency": self._max_concurrency,
            "idle": self._nidle,
            "blocked": self._nblocked,
            "queued_remote": self._remote_len(),
            "queued_local": local,
            "fibers_run": self.nfibers_run.get_value(),
        }

    def stop_and_join(self) -> None:
        self._stopped = True
        self._lot.stop()
        for w in self._workers:
            w.thread.join(timeout=5)
        # Fibers never picked up must still complete their join()/get()
        # contract: fail them instead of leaving joiners parked forever.
        orphans: List[Fiber] = []
        with self._remote_lock:
            orphans.extend(self._remote)
            self._remote.clear()
        for w in self._workers:
            while True:
                f = w.rq.pop()
                if f is None:
                    break
                orphans.append(f)
        for f in orphans:
            f.exception = RuntimeError("worker pool stopped before fiber ran")
            f._version_butex.add(1)
            f._version_butex.wake_all()


_global_pool: Optional[WorkerPool] = None
_global_lock = threading.Lock()


def shutdown_global_worker_pool() -> None:
    """Stop and join the process-global pool, if one runs; the next
    ``global_worker_pool()`` starts a new one. Sockets and servers keep the
    pool they were built with, so stop them first."""
    global _global_pool
    with _global_lock:
        pool, _global_pool = _global_pool, None
    if pool is not None and not pool._stopped:
        pool.stop_and_join()


def global_worker_pool() -> WorkerPool:
    global _global_pool
    if _global_pool is None or _global_pool._stopped:
        with _global_lock:
            if _global_pool is None or _global_pool._stopped:
                _global_pool = WorkerPool(name="global")
    return _global_pool


def spawn(fn: Callable, *args, urgent: bool = False, **kwargs) -> Fiber:
    """Module-level bthread_start_background analog on the global pool."""
    return global_worker_pool().spawn(fn, *args, urgent=urgent, **kwargs)
