"""DoublyBufferedData — RCU-like read-mostly container (reference
src/butil/containers/doubly_buffered_data.h:53).

Semantics kept from the reference:
- readers take only a *per-thread* mutex on the foreground copy — never a
  shared lock, so reads from different threads don't contend;
- ``modify(fn)`` applies fn to the background copy, atomically flips the
  foreground index, then acquires every reader's thread-mutex once (waiting
  out readers still inside the old foreground), and finally applies fn to
  the other copy — after which both copies are identical and every reader
  sees the new data.

This is the trick behind wait-free-read load balancers: SelectServer reads
a server-list snapshot without blocking AddServer/RemoveServer.

The port's copy of the JAX package's ``utils/doubly_buffered.py``.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Generic, List, TypeVar

T = TypeVar("T")


class DoublyBufferedData(Generic[T]):
    def __init__(self, factory: Callable[[], T]):
        self._data: List[T] = [factory(), factory()]
        self._index = 0  # foreground index; torn reads impossible (int)
        self._modify_lock = threading.Lock()
        self._wrappers_lock = threading.Lock()
        self._wrappers: List[threading.Lock] = []
        self._tls = threading.local()

    def _thread_lock(self) -> threading.Lock:
        lk = getattr(self._tls, "lock", None)
        if lk is None:
            lk = threading.Lock()
            self._tls.lock = lk
            with self._wrappers_lock:
                self._wrappers.append(lk)
        return lk

    @contextmanager
    def read(self):
        """Yield the foreground copy under this thread's private lock."""
        lk = self._thread_lock()
        with lk:
            yield self._data[self._index]

    def modify(self, fn: Callable[[T], None]) -> None:
        """Apply ``fn`` to both copies with the flip-and-wait protocol."""
        with self._modify_lock:
            bg = 1 - self._index
            fn(self._data[bg])
            self._index = bg  # new readers land on the modified copy
            # wait out readers still inside the old foreground
            with self._wrappers_lock:
                wrappers = list(self._wrappers)
            for lk in wrappers:
                lk.acquire()
                lk.release()
            fn(self._data[1 - bg])
