"""Correlation ids — the bthread_id analog (reference src/bthread/id.h:43-117,
id.cpp).

A CallId is a versioned 64-bit handle naming one in-flight RPC. Properties
the RPC layer depends on (and that this module reproduces):

- **lockable**: response processing locks the id to get exclusive access to
  the Controller; contenders queue (butex) instead of spinning.
- **error queueing**: ``error(id, code)`` invokes ``on_error`` *under the
  lock*; if the id is already locked, the error is queued and delivered by
  ``unlock`` (reference bthread_id_error2 / pending_q).
- **join**: the caller of a sync RPC parks until ``unlock_and_destroy``.
- **ranged versions**: one RPC plus its retries/backup requests share one id
  with a version range (bthread_id_create_ranged, channel.cpp:307 uses
  2+max_retry); stale responses from earlier tries still resolve to the
  same slot until destroy.
- **slots never freed**: ids address a slab that survives destroy; a stale
  id fails with EINVAL instead of faulting (ResourcePool semantics).

Id layout: (slot_index << 32) | version. Ids live on the host and travel
on the wire as two uint32 words (tbus_std header words 3/4).

The port's copy of the JAX package's ``runtime/correlation_id.py``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

from incubator_brpc_tpu_torch.runtime.butex import Butex

EINVAL = 22
EBUSY = 16

# on_error(call_id, data, error_code, error_text) -> None; called with the id
# LOCKED; it must eventually unlock() or unlock_and_destroy().
OnError = Callable[[int, Any, int, str], None]


class _IdSlot:
    __slots__ = (
        "mu", "version", "range", "locked", "data", "on_error",
        "pending", "contenders", "joiners", "destroyed",
    )

    def __init__(self) -> None:
        self.mu = threading.Lock()
        self.version = 1
        self.range = 1
        self.locked = False
        self.data: Any = None
        self.on_error: Optional[OnError] = None
        self.pending: List[tuple] = []
        self.contenders = Butex(0)  # value = epoch; bumped on each unlock
        self.joiners = Butex(0)  # monotonic epoch; bumped on each destroy
        self.destroyed = True

    def holds(self, id_version: int) -> bool:
        return (
            not self.destroyed
            and self.version <= id_version < self.version + self.range
        )


class CallIdSpace:
    """Process-global id table (the reference's id ResourcePool)."""

    def __init__(self) -> None:
        self._slots: List[_IdSlot] = []
        self._free: List[int] = []
        self._lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------

    def create(
        self,
        data: Any = None,
        on_error: Optional[OnError] = None,
        version_range: int = 1,
    ) -> int:
        """bthread_id_create[_ranged]: returns a CallId."""
        with self._lock:
            if self._free:
                idx = self._free.pop()
                slot = self._slots[idx]
            else:
                idx = len(self._slots)
                slot = _IdSlot()
                self._slots.append(slot)
        with slot.mu:
            slot.range = version_range
            slot.locked = False
            slot.data = data
            slot.on_error = on_error
            slot.pending = []
            slot.destroyed = False
            # joiners is a monotonic epoch (NOT reset on reuse): joining a
            # recycled slot can never park past its own destroy (ABA, the
            # reference's version-butex trick).
            return (idx << 32) | slot.version

    def _slot_of(self, call_id: int) -> Optional[_IdSlot]:
        idx = call_id >> 32
        with self._lock:
            if idx >= len(self._slots):
                return None
            return self._slots[idx]

    # -- operations ---------------------------------------------------------

    def lock(self, call_id: int, nowait: bool = False) -> tuple:
        """Lock the id; returns (0, data) or (EINVAL, None) if the version
        is stale/destroyed. Contenders park on the slot butex — unless
        ``nowait``, which returns (EBUSY, None) instead of parking (for
        reactor threads that must not block on another holder)."""
        slot = self._slot_of(call_id)
        if slot is None:
            return EINVAL, None
        ver = call_id & 0xFFFFFFFF
        while True:
            with slot.mu:
                if not slot.holds(ver):
                    return EINVAL, None
                if not slot.locked:
                    slot.locked = True
                    return 0, slot.data
                if nowait:
                    return EBUSY, None
                epoch = slot.contenders.load()
            slot.contenders.wait(epoch)

    def unlock(self, call_id: int) -> int:
        """Release; if errors were queued while locked, deliver ONE to
        on_error while still holding the lock (reference
        bthread_id_unlock's pending_q drain)."""
        slot = self._slot_of(call_id)
        if slot is None:
            return EINVAL
        ver = call_id & 0xFFFFFFFF
        has_pending = False
        with slot.mu:
            if not slot.holds(ver) or not slot.locked:
                return EINVAL
            if slot.pending:
                has_pending = True
                code, text = slot.pending.pop(0)
                on_error, data = slot.on_error, slot.data
            else:
                slot.locked = False
                slot.contenders.add(1)
        if has_pending:
            # still locked: deliver ONE queued error. With no handler, the
            # default is destroy (reference default_bthread_id_on_error).
            if on_error is not None:
                on_error(call_id, data, code, text)
            else:
                self.unlock_and_destroy(call_id)
        else:
            slot.contenders.wake(1)
        return 0

    def unlock_and_destroy(self, call_id: int) -> int:
        """Invalidate the whole version range, wake contenders + joiners."""
        slot = self._slot_of(call_id)
        if slot is None:
            return EINVAL
        ver = call_id & 0xFFFFFFFF
        idx = call_id >> 32
        with slot.mu:
            if not slot.holds(ver) or not slot.locked:
                return EINVAL
            slot.version += slot.range  # stale ids now fail holds()
            slot.destroyed = True
            slot.locked = False
            slot.data = None
            slot.on_error = None
            slot.pending = []
            slot.contenders.add(1)
            slot.joiners.add(1)
        slot.contenders.wake_all()
        slot.joiners.wake_all()
        with self._lock:
            self._free.append(idx)
        return 0

    def error(self, call_id: int, error_code: int, error_text: str = "") -> int:
        """bthread_id_error2: deliver an error to whoever owns the id.
        If unlocked: lock and run on_error now (on this thread). If locked:
        queue; unlock() will deliver."""
        slot = self._slot_of(call_id)
        if slot is None:
            return EINVAL
        ver = call_id & 0xFFFFFFFF
        with slot.mu:
            if not slot.holds(ver):
                return EINVAL
            if slot.locked:
                slot.pending.append((error_code, error_text))
                return 0
            slot.locked = True
            on_error, data = slot.on_error, slot.data
        if on_error is None:
            # no handler: behave like lock+unlock_and_destroy (reference
            # default_bthread_id_on_error)
            return self.unlock_and_destroy(call_id)
        on_error(call_id, data, error_code, error_text)
        return 0

    def join(self, call_id: int, timeout: Optional[float] = None) -> bool:
        """Park until the id is destroyed; True unless timed out. Joining a
        destroyed/stale id returns immediately (reference bthread_id_join)."""
        from incubator_brpc_tpu_torch.runtime.butex import ETIMEDOUT

        slot = self._slot_of(call_id)
        if slot is None:
            return True
        ver = call_id & 0xFFFFFFFF
        while True:
            with slot.mu:
                if not slot.holds(ver):
                    return True
                epoch = slot.joiners.load()
            if slot.joiners.wait(epoch, timeout=timeout) == ETIMEDOUT:
                with slot.mu:
                    if not slot.holds(ver):
                        return True
                return False

    def valid(self, call_id: int) -> bool:
        slot = self._slot_of(call_id)
        if slot is None:
            return False
        with slot.mu:
            return slot.holds(call_id & 0xFFFFFFFF)


call_id_space = CallIdSpace()
