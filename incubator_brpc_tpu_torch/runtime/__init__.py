"""runtime — the blocking primitives and the fiber scheduler: the timer
thread, the butex, the butex woken by device completions, the worker pool
(fibers, ``spawn``) with fiber-local storage (``keys.py``: the bthread_key
API), the execution queue (one ordered consumer fiber, the streams'
per-stream queue), the correlation ids of in-flight calls, and the
butex-backed ``FiberMutex``, ``FiberCond`` and ``CountdownEvent`` with the
contention profile ``/hotspots/contention`` renders (``mutex.py``)."""

from incubator_brpc_tpu_torch.runtime.execution_queue import (
    ExecutionQueue,
    TaskIterator,
    execution_queue_start,
)
from incubator_brpc_tpu_torch.runtime.keys import (
    fiber_getspecific,
    fiber_key_create,
    fiber_key_delete,
    fiber_setspecific,
)
from incubator_brpc_tpu_torch.runtime.mutex import (
    CountdownEvent,
    FiberCond,
    FiberMutex,
    contention_profile,
    reset_contention_profile,
)
from incubator_brpc_tpu_torch.runtime.worker_pool import spawn

__all__ = [
    "CountdownEvent",
    "FiberCond",
    "FiberMutex",
    "contention_profile",
    "reset_contention_profile",
    "ExecutionQueue",
    "TaskIterator",
    "execution_queue_start",
    "fiber_getspecific",
    "fiber_key_create",
    "fiber_key_delete",
    "fiber_setspecific",
    "spawn",
]
