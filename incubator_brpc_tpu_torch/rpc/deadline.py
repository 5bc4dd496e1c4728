"""Propagated deadlines — the fabric-wide failure budget.

A client stamps its REMAINING deadline budget onto every request
(tbus_std JSON meta ``timeout_ms``, the reference's
``RpcRequestMeta.timeout_ms``).  The server records the
request's absolute deadline (arrival + budget) here, in an ambient
per-thread slot, for the duration of the handler — so any downstream
RPC the handler issues through a Channel inherits what is LEFT of the
caller's budget instead of its own full ChannelOptions timeout.  Across
N hops the budget only ever shrinks: a 500 ms edge deadline that burned
300 ms on hop one rides hop two as 200 ms, and a hop whose budget is
already gone fails fast with EDEADLINE without touching the wire.

The slot is thread-local, matching how handlers run (one worker fiber =
one thread for the handler's synchronous body).  Work a handler hands
to OTHER threads does not inherit the budget automatically — pass the
controller's ``deadline_left_ms()`` explicitly there.

The port's copy of the JAX package's ``rpc/deadline.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

_tls = threading.local()


def push_deadline(abs_deadline: Optional[float]):
    """Install ``abs_deadline`` (time.monotonic seconds) as the ambient
    propagated deadline; returns the previous value for the paired
    :func:`pop_deadline`.  ``None`` clears (a request with no budget must
    not inherit an unrelated earlier one on a pooled thread)."""
    prev = getattr(_tls, "deadline", None)
    _tls.deadline = abs_deadline
    return prev


def pop_deadline(prev) -> None:
    _tls.deadline = prev


def current_deadline() -> Optional[float]:
    """The ambient absolute deadline (monotonic seconds), or None."""
    return getattr(_tls, "deadline", None)


def inherited_budget_ms() -> Optional[float]:
    """Milliseconds left of the ambient propagated deadline; None when no
    deadline is ambient.  May be <= 0 — the caller decides whether that
    is fail-fast (EDEADLINE) or shed."""
    d = current_deadline()
    if d is None:
        return None
    return (d - time.monotonic()) * 1000.0
