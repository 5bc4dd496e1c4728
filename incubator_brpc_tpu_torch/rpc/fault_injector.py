"""FaultInjector — deterministic brownout injection (the proof plane the
limiter/breaker tests and ``tools/rpc_press`` drive).

The reference proves its overload/isolation machinery against real
misbehaving backends; this repro needs the misbehavior to be *scripted*:
a test asserting "the breaker isolates the browned-out node within its
short window" cannot ride a random number generator or a sleeping
handler. So injection schedules are **counter-based**, not random: a rate
of ``r`` fires on exactly the calls where ``floor(n*r)`` increments —
every run of the same call sequence injects the same faults.

Two seams, both zero-cost when no injector is installed:

- **socket write** (``transport/sock.Socket.write``): the process-global
  injector — installed programmatically via ``install_socket_injector``
  or built from the ``fault_inject_*`` flags when the ``fault_injection``
  master flag is on — may delay the write, fail it (EFAILEDSOCKET
  returned, as if the kernel refused), or kill the connection mid-frame
  (``close``: the write succeeds partially upstream but the socket dies).
- **frame dispatch** (``rpc/server.Server.process_request``): a
  per-server injector (``server.fault_injector = FaultInjector(...)``)
  may delay the dispatch or fail the request with an injected error
  before the handler runs — the scripted "this backend browns out".

Everything is flag-gated and default off: the master ``fault_injection``
flag gates every seam; per-server injectors act only where a test placed
one.

The port's copy of the JAX package's ``rpc/fault_injector.py``: the same
counter schedules, so both packages' injectors decide the same sequence.
The native client's counter seam (every Nth call fails, closes or waits,
in C++) is ``transport/native_plane.install_native_client_fault``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional

from incubator_brpc_tpu_torch.utils.flags import get_flag
from incubator_brpc_tpu_torch.utils.status import ErrorCode

ACTION_ERROR = "error"
ACTION_DELAY = "delay"
ACTION_CLOSE = "close"


class _Schedule:
    """Counter-based rate schedule: fires on call n iff
    floor(n*rate) > floor((n-1)*rate) — exact long-run rate, fully
    deterministic, evenly interleaved (rate 0.5 fires every 2nd call)."""

    __slots__ = ("rate", "_n", "_lock")

    def __init__(self, rate: float):
        self.rate = max(0.0, min(1.0, float(rate)))
        self._n = 0
        self._lock = threading.Lock()

    def fire(self) -> bool:
        if self.rate <= 0.0:
            return False
        with self._lock:
            self._n += 1
            n = self._n
        return math.floor(n * self.rate) > math.floor((n - 1) * self.rate)


class FaultInjector:
    """One injector = one brownout script. Rates are independent
    schedules; on a given operation ``close`` is checked first, then
    ``error``, then ``delay`` (a delayed operation may still succeed —
    that is the latency-inflation brownout the limiter must absorb)."""

    def __init__(
        self,
        error_rate: float = 0.0,
        delay_rate: float = 0.0,
        delay_ms: float = 0.0,
        close_rate: float = 0.0,
        error_code: int = ErrorCode.EINTERNAL,
    ):
        self._error = _Schedule(error_rate)
        self._delay = _Schedule(delay_rate)
        self._close = _Schedule(close_rate)
        self.delay_ms = float(delay_ms)
        self.error_code = int(error_code)
        self.injected = {ACTION_ERROR: 0, ACTION_DELAY: 0, ACTION_CLOSE: 0}

    def decide(self) -> Optional[str]:
        """The action for this operation (None = pass through). Applies
        the delay itself — callers only need to honor error/close."""
        if self._close.fire():
            self.injected[ACTION_CLOSE] += 1
            return ACTION_CLOSE
        if self._error.fire():
            self.injected[ACTION_ERROR] += 1
            return ACTION_ERROR
        if self._delay.fire():
            self.injected[ACTION_DELAY] += 1
            if self.delay_ms > 0:
                time.sleep(self.delay_ms / 1e3)
            return ACTION_DELAY
        return None

    def describe(self) -> dict:
        return {
            "error_rate": self._error.rate,
            "delay_rate": self._delay.rate,
            "delay_ms": self.delay_ms,
            "close_rate": self._close.rate,
            "injected": dict(self.injected),
        }


# -- the global socket-write seam -------------------------------------------

_socket_injector: Optional[FaultInjector] = None


def install_socket_injector(injector: Optional[FaultInjector]) -> None:
    """Install (or clear, with None) the process-global injector consulted
    by every Socket.write while the ``fault_injection`` flag is on."""
    global _socket_injector
    _socket_injector = injector


def socket_injector() -> Optional[FaultInjector]:
    """The active socket-seam injector, honoring the master flag. Builds
    one lazily from the ``fault_inject_*`` flags when none was installed
    programmatically but the flags describe a fault plan — the path
    ``tools/rpc_press --fault-rate`` uses."""
    if not get_flag("fault_injection"):
        return None
    inj = _socket_injector
    if inj is not None:
        return inj
    err = float(get_flag("fault_inject_error_rate"))
    dly = float(get_flag("fault_inject_delay_rate"))
    cls = float(get_flag("fault_inject_close_rate"))
    if err <= 0 and dly <= 0 and cls <= 0:
        return None
    inj = FaultInjector(
        error_rate=err,
        delay_rate=dly,
        delay_ms=float(get_flag("fault_inject_delay_ms")),
        close_rate=cls,
    )
    install_socket_injector(inj)
    return inj


__all__ = [
    "FaultInjector",
    "install_socket_injector",
    "socket_injector",
    "ACTION_ERROR",
    "ACTION_DELAY",
    "ACTION_CLOSE",
]
