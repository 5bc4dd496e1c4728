"""runtime — the blocking primitives and the fiber scheduler: the timer
thread, the butex, the butex woken by device completions, the worker pool
(fibers) and the correlation ids of in-flight calls."""
