"""runtime — the blocking primitives and the fiber scheduler: the timer
thread, the butex, the butex woken by device completions, the worker pool
(fibers, ``spawn``) with fiber-local storage (``keys.py``: the bthread_key
API), the execution queue (one ordered consumer fiber, the streams'
per-stream queue) and the correlation ids of in-flight calls."""

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
from incubator_brpc_tpu_torch.runtime.worker_pool import spawn

__all__ = [
    "ExecutionQueue",
    "TaskIterator",
    "execution_queue_start",
    "fiber_getspecific",
    "fiber_key_create",
    "fiber_key_delete",
    "fiber_setspecific",
    "spawn",
]
