"""SimpleDataPool — pooled user data for session/thread-local factories
(reference src/brpc/simple_data_pool.{h,cpp} behind
ServerOptions{session_local_data_factory, thread_local_data_factory},
server.h:55-239).

A factory is either an object with ``create() -> obj`` / ``destroy(obj)``
(the reference DataFactory::CreateData/DestroyData pair) or a plain
zero-arg callable (destroy is a no-op). Objects are reused: a connection
that dies returns its session data to the pool, and the next connection
borrows it back — the whole point of the reference feature (amortize
expensive per-session state across connections). The port's copy of the
JAX package's ``rpc/data_pool.py``."""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, List, Optional, Union

logger = logging.getLogger(__name__)

Factory = Union[Callable[[], Any], Any]


def _create(factory: Factory) -> Any:
    fn = getattr(factory, "create", None)
    return fn() if fn is not None else factory()


def _destroy(factory: Factory, obj: Any) -> None:
    fn = getattr(factory, "destroy", None)
    if fn is not None:
        try:
            fn(obj)
        except Exception:
            logger.exception("data factory destroy raised")


class SimpleDataPool:
    """Free-list of factory-made objects (simple_data_pool.h). ``borrow``
    pops or creates; ``give_back`` pushes for reuse.

    Teardown is DETERMINISTIC (the reference destroys pooled session data
    in ~Server/simple_data_pool teardown): the pool
    tracks every outstanding borrow, and ``destroy_all`` destroys free AND
    outstanding objects — a connection still mid-teardown when the server
    stops cannot strand its session object past stop/join. A give-back
    that lost that race (its object already destroyed by ``destroy_all``)
    is a no-op instead of a double-destroy."""

    def __init__(self, factory: Factory, reserved: int = 0):
        self._factory = factory
        self._lock = threading.Lock()
        self._free: List[Any] = []
        self._outstanding: dict = {}  # id(obj) -> obj, borrowed not returned
        self._dead = False
        self.ncreated = 0
        for _ in range(max(0, reserved)):
            self._free.append(_create(factory))
            self.ncreated += 1

    def borrow(self) -> Any:
        with self._lock:
            if self._free:
                obj = self._free.pop()
                self._outstanding[id(obj)] = obj
                return obj
            self.ncreated += 1
        obj = _create(self._factory)
        with self._lock:
            # tracked even after death: a borrow that raced destroy_all is
            # destroyed by its own give_back (owned=True below)
            self._outstanding[id(obj)] = obj
        return obj

    def give_back(self, obj: Any) -> None:
        if obj is None:
            return
        with self._lock:
            if not self._dead:
                self._outstanding.pop(id(obj), None)
                self._free.append(obj)
                return
            # dead pool: destroy_all owns every object it could still see
            # at teardown — only destroy here if it had NOT seen this one
            # (give_back won the pop below before destroy_all snapshotted)
            owned = self._outstanding.pop(id(obj), None) is not None
        if owned:
            _destroy(self._factory, obj)

    def destroy_all(self) -> None:
        with self._lock:
            self._dead = True
            free, self._free = self._free, []
            outstanding, self._outstanding = dict(self._outstanding), {}
        for obj in free:
            _destroy(self._factory, obj)
        for obj in outstanding.values():
            _destroy(self._factory, obj)

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)
