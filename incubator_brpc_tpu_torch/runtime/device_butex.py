"""DeviceCompletionButex — park callers on device completions (the
reference analog is RdmaCompletionQueue delivering CQ events into the event
dispatcher, src/brpc/rdma/rdma_completion_queue.{h,cpp}).

CUDA launches are asynchronous: a call returns once the work is queued on a
stream. The dispatcher records a ``torch.cuda.Event`` after its launches
and after the device->host copy of the result, and watches that event. A
small pool of completion-watcher threads (the CQ poller threads,
rdma_completion_queue.cpp:39-55) waits in ``event.synchronize()`` — which
releases the interpreter lock — and then bumps/wakes the butex. Work on CPU
tensors has already happened when it is watched, so it settles at once.

Callbacks registered via ``on_complete`` run on the watcher thread and must
be cheap — the contract of the reference's HandleCompletion.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

import torch

from incubator_brpc_tpu_torch.runtime.butex import Butex, ETIMEDOUT


class _WatcherPool:
    """Dedicated completion threads (not a worker pool: a watcher blocks in
    the event wait, which would starve the workers)."""

    def __init__(self, nthreads: int = 2):
        self._jobs: List = []
        self._cond = threading.Condition()
        self._active = 0  # jobs currently executing
        self._stopping = False
        self._threads = [
            threading.Thread(target=self._run, name=f"tbtorch-cq-{i}", daemon=True)
            for i in range(nthreads)
        ]
        for t in self._threads:
            t.start()
        # Interpreter-exit quiesce: a watcher still inside a CUDA wait while
        # CPython finalizes races the runtime's own teardown. Outwaiting
        # pending/active jobs first (bounded) removes the race.
        import atexit

        atexit.register(self.quiesce)

    def submit(self, job: Callable[[], None]) -> None:
        with self._cond:
            self._jobs.append(job)
            self._cond.notify()

    def quiesce(self, timeout: float = 10.0) -> bool:
        import time as _time

        deadline = _time.monotonic() + timeout
        with self._cond:
            while self._jobs or self._active:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=min(remaining, 0.1))
        return True

    def stop(self, timeout: float = 10.0) -> bool:
        """Finish the queued jobs, then end and join the threads."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout)
        return not any(t.is_alive() for t in self._threads)

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._jobs:
                    if self._stopping:
                        return
                    self._cond.wait()
                job = self._jobs.pop(0)
                self._active += 1
            try:
                job()
            except Exception:  # noqa: BLE001
                import logging

                logging.getLogger(__name__).exception("completion watcher raised")
            finally:
                with self._cond:
                    self._active -= 1
                    self._cond.notify_all()


_watchers: Optional[_WatcherPool] = None
_watchers_lock = threading.Lock()


def _watcher_pool() -> _WatcherPool:
    global _watchers
    if _watchers is None:
        with _watchers_lock:
            if _watchers is None:
                # sized by flag (the reference's rdma_cq_num): completion
                # handlers parse the host copy, so this bounds how many
                # completions are handled at once
                from incubator_brpc_tpu_torch.utils.flags import get_flag

                _watchers = _WatcherPool(
                    max(1, int(get_flag("device_cq_threads")))
                )
    return _watchers


def shutdown_watchers(timeout: float = 10.0) -> bool:
    """End and join the completion-watcher threads once their queued jobs
    are done; the next watch starts a new pool. False on timeout."""
    global _watchers
    with _watchers_lock:
        pool, _watchers = _watchers, None
    return pool is None or pool.stop(timeout)


def _ready_handles(work: Any) -> List[Any]:
    """What to wait on for ``work``: events (anything with ``synchronize``)
    as given; a CUDA tensor gets an event recorded on its device's current
    stream now; CPU tensors and None need nothing."""
    if work is None:
        return []
    if isinstance(work, torch.Tensor):
        if work.device.type != "cuda":
            return []
        event = torch.cuda.Event(blocking=True)
        event.record(torch.cuda.current_stream(work.device))
        return [event]
    if hasattr(work, "synchronize"):
        return [work]
    raise TypeError(f"cannot watch {type(work).__name__}")


class DeviceCompletionButex(Butex):
    """Butex whose value counts settled (completed OR failed) device ops.

    Failures are counted so waiters never hang; they are recorded in
    ``errors`` and the callback receives the exception (or None) — the
    reference likewise surfaces failed work requests as flushed-error CQ
    entries rather than silence.
    """

    def __init__(self) -> None:
        super().__init__(0)
        self._cb_lock = threading.Lock()
        self._inflight = 0
        self._errors: List[BaseException] = []

    def watch(
        self,
        work: Any,
        on_complete: Optional[Callable[[Any, Optional[BaseException]], None]] = None,
    ):
        """Watch ``work`` (a ``torch.cuda.Event`` or a tensor); when it has settled, value += 1 and waiters wake; then
        on_complete(work, error_or_None) runs on the watcher thread
        (guarded — a raising callback cannot strand waiters, because the
        bump/wake already happened)."""
        handles = _ready_handles(work)
        with self._cb_lock:
            self._inflight += 1

        def job() -> None:
            error: Optional[BaseException] = None
            try:
                for h in handles:
                    h.synchronize()
            except Exception as e:  # noqa: BLE001 — device failure is data here
                error = e
            with self._cb_lock:
                self._inflight -= 1
                if error is not None:
                    self._errors.append(error)
            self.add(1)
            self.wake_all()
            if on_complete is not None:
                try:
                    on_complete(work, error)
                except Exception:  # noqa: BLE001
                    import logging

                    logging.getLogger(__name__).exception(
                        "device completion callback raised"
                    )

        _watcher_pool().submit(job)
        return self

    def wait_for(self, completions: int, timeout: Optional[float] = None) -> bool:
        """Park until at least ``completions`` watched ops completed."""
        while True:
            seen = self.load()
            if seen >= completions:
                return True
            if self.wait(seen, timeout=timeout) == ETIMEDOUT:
                return self.load() >= completions

    @property
    def inflight(self) -> int:
        with self._cb_lock:
            return self._inflight

    @property
    def errors(self) -> List[BaseException]:
        with self._cb_lock:
            return list(self._errors)
