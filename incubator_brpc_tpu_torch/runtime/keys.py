"""Fiber-local storage — the bthread_key API (reference
src/bthread/key.cpp: versioned keys, per-bthread KeyTables, destructors on
fiber exit, pthread fallback for non-worker threads).

Keys are (index, version) pairs: ``fiber_key_delete`` bumps the version so
stale keys read None instead of another key's data (the reference's
versioned KeyTable slots). Values set on a fiber live in the Fiber's
keytable and their destructors run when the fiber finishes; values set on
a plain thread live in thread-local storage (destructors run at
interpreter exit only, as pthread TLS would).

The port's copy of the JAX package's ``runtime/keys.py``, on the port's
worker pool (``runtime/worker_pool.py`` sets the running fiber and runs
its table's destructors when the fiber ends)."""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

Key = Tuple[int, int]  # (index, version)

_lock = threading.Lock()
_versions: List[int] = []  # per index; odd = live
_destructors: List[Optional[Callable[[Any], None]]] = []
_free_indexes: List[int] = []

_thread_tables = threading.local()


class KeyTable:
    """Per-fiber (or per-thread) slot table."""

    __slots__ = ("data",)

    def __init__(self):
        self.data: Dict[int, Tuple[int, Any]] = {}  # index -> (version, value)


def fiber_key_create(destructor: Optional[Callable[[Any], None]] = None) -> Key:
    with _lock:
        if _free_indexes:
            idx = _free_indexes.pop()
            _versions[idx] += 1  # even -> odd: live
            _destructors[idx] = destructor
        else:
            idx = len(_versions)
            _versions.append(1)
            _destructors.append(destructor)
        return (idx, _versions[idx])


def fiber_key_delete(key: Key) -> bool:
    """Invalidate the key everywhere (values are NOT destructed eagerly —
    matching the reference, whose delete leaves existing values to table
    destruction)."""
    idx, version = key
    with _lock:
        if idx >= len(_versions) or _versions[idx] != version:
            return False
        _versions[idx] += 1  # odd -> even: dead
        _destructors[idx] = None
        _free_indexes.append(idx)
        return True


def _current_table(create: bool) -> Optional[KeyTable]:
    from incubator_brpc_tpu_torch.runtime import worker_pool as _wp

    fiber = getattr(_wp._tls, "fiber", None)
    if fiber is not None:
        if fiber.keytable is None and create:
            fiber.keytable = KeyTable()
        return fiber.keytable
    table = getattr(_thread_tables, "table", None)
    if table is None and create:
        table = KeyTable()
        _thread_tables.table = table
    return table


def fiber_setspecific(key: Key, value: Any) -> bool:
    idx, version = key
    with _lock:
        live = idx < len(_versions) and _versions[idx] == version
    if not live:
        return False
    table = _current_table(create=True)
    table.data[idx] = (version, value)
    return True


def fiber_getspecific(key: Key) -> Any:
    idx, version = key
    with _lock:
        if idx >= len(_versions) or _versions[idx] != version:
            return None  # deleted or recycled key: never serve stale data
    table = _current_table(create=False)
    if table is None:
        return None
    entry = table.data.get(idx)
    if entry is None or entry[0] != version:
        return None  # unset, or a value written under an older key version
    return entry[1]


def run_destructors(table: KeyTable) -> None:
    """Called when a fiber finishes (KeyTable::~KeyTable, key.cpp). The
    destructor runs only if the key is still live at that version."""
    for idx, (version, value) in list(table.data.items()):
        with _lock:
            live = (
                idx < len(_versions)
                and _versions[idx] == version
            )
            dtor = _destructors[idx] if live else None
        if dtor is not None and value is not None:
            try:
                dtor(value)
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "fiber key destructor raised"
                )
    table.data.clear()
