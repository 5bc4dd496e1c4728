"""runtime — the blocking primitives and the fiber scheduler: the timer
thread, the butex, the butex woken by device completions, the worker pool
(fibers), the execution queue (one ordered consumer fiber, the streams'
per-stream queue) and the correlation ids of in-flight calls."""

from incubator_brpc_tpu_torch.runtime.execution_queue import (
    ExecutionQueue,
    TaskIterator,
    execution_queue_start,
)

__all__ = [
    "ExecutionQueue",
    "TaskIterator",
    "execution_queue_start",
]
