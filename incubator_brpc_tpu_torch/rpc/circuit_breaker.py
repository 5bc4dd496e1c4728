"""Per-node circuit breaker — error-rate failure isolation (reference
src/brpc/circuit_breaker.{h,cpp}).

Every LB-resolved node carries one ``CircuitBreaker`` fed from the
channel's end-of-RPC feedback. Two EMA error-cost windows run in
parallel: a *short* window that trips fast on an acute brownout (10%
errors by default) and a *long* window that catches a slow burn (5%).
A failed call charges its own latency as "error cost"; successes decay
the accumulated cost and refresh the EMA latency that scales the trip
threshold — so the breaker is calibrated in *time wasted on this node*,
not raw counts, exactly the reference's design.

Isolation is owned by the LB layer (lb/__init__.py): a tripped node
leaves the candidate set for ``isolation_duration_ms``, which doubles on
every re-trip that follows a short-lived recovery (up to
``circuit_breaker_max_isolation_duration_ms``) and resets to the minimum
after a durable recovery — the reference's exponential isolation with
half-open probing.

State machine (rendered by the /circuit_breakers builtin page):

    CLOSED --trip--> ISOLATED --duration elapsed--> HALF_OPEN
      ^                                                 |
      |  <--- window_size clean-ish samples ------------+
      +--- (a HALF_OPEN error re-trips with doubled duration)

The port's copy of the JAX package's ``rpc/circuit_breaker.py``; the
``circuit_breaker_isolated_count`` gauge is a ``PassiveStatus`` on the
port's ``bvar``.
"""

from __future__ import annotations

import threading
from time import monotonic as _monotonic
from typing import Dict, List, Optional

from incubator_brpc_tpu_torch.utils.flags import get_flag

# breaker states (describe()/page rendering)
STATE_CLOSED = "closed"
STATE_ISOLATED = "isolated"
STATE_HALF_OPEN = "half_open"


def _now_ms() -> float:
    return _monotonic() * 1e3


class EmaErrorRecorder:
    """One EMA window (circuit_breaker.cpp EmaErrorRecorder): healthy
    while the accumulated error cost stays under
    ``ema_latency * window_size * max_error_percent``."""

    def __init__(self, window_size: int, max_error_percent: int):
        self._window_size = max(1, int(window_size))
        self._max_error_percent = max_error_percent
        epsilon = float(get_flag("circuit_breaker_epsilon_value"))
        # per-sample decay chosen so one window's worth of successes
        # shrinks the error cost to epsilon of itself
        self._smooth = epsilon ** (1.0 / self._window_size)
        self._lock = threading.Lock()
        self._sample_count = 0
        self._error_count = 0
        self._ema_error_cost = 0.0
        self._ema_latency = 0.0

    def on_call_end(self, error_code: int, latency_us: float) -> bool:
        with self._lock:
            if error_code == 0:
                # success: refresh the latency EMA, decay the error cost
                if self._ema_latency == 0.0:
                    self._ema_latency = latency_us
                else:
                    self._ema_latency = (
                        self._ema_latency * self._smooth
                        + latency_us * (1 - self._smooth)
                    )
                self._ema_error_cost *= self._smooth
                healthy = True
            else:
                # failure: its latency (floored at the EMA so instant
                # errors still cost something) charges the window
                cost = max(latency_us, self._ema_latency)
                self._ema_error_cost += cost
                max_cost = (
                    self._ema_latency
                    * self._window_size
                    * (self._max_error_percent / 100.0)
                )
                healthy = self._ema_error_cost <= max_cost
            if self._sample_count < self._window_size:
                # initializing: too few samples for the EMA to mean much —
                # judge on the raw error count against the same percent
                self._sample_count += 1
                if error_code != 0:
                    self._error_count += 1
                return self._error_count < (
                    self._window_size * self._max_error_percent / 100.0
                )
            return healthy

    def reset(self) -> None:
        with self._lock:
            self._sample_count = 0
            self._error_count = 0
            self._ema_error_cost = 0.0
            # keep _ema_latency: the node's speed survives isolation

    def describe(self) -> dict:
        with self._lock:
            return {
                "samples": self._sample_count,
                "errors": self._error_count,
                "ema_error_cost_us": round(self._ema_error_cost, 1),
                "ema_latency_us": round(self._ema_latency, 1),
            }


class CircuitBreaker:
    """The per-node breaker (circuit_breaker.h): feed every call's
    outcome through ``on_call_end``; False means the node just tripped
    and the caller (the LB) must isolate it for ``isolation_duration_ms``.
    """

    def __init__(self):
        self._short = EmaErrorRecorder(
            int(get_flag("circuit_breaker_short_window_size")),
            int(get_flag("circuit_breaker_short_window_error_percent")),
        )
        self._long = EmaErrorRecorder(
            int(get_flag("circuit_breaker_long_window_size")),
            int(get_flag("circuit_breaker_long_window_error_percent")),
        )
        self._lock = threading.Lock()
        self._broken = False
        self._half_open = False
        self._isolated_times = 0
        self._isolation_duration_ms = int(
            get_flag("circuit_breaker_min_isolation_duration_ms")
        )
        self._last_reset_ms = _now_ms()
        self._broken_since_ms: Optional[float] = None
        self._half_open_successes = 0

    def on_call_end(self, error_code: int, latency_us: float) -> bool:
        """Record one completed call. False = the breaker is (now) open."""
        with self._lock:
            if self._broken:
                return False
            half_open = self._half_open
        short_ok = self._short.on_call_end(error_code, latency_us)
        long_ok = self._long.on_call_end(error_code, latency_us)
        if short_ok and long_ok:
            if half_open and error_code == 0:
                self._note_half_open_success()
            return True
        self.mark_as_broken()
        return False

    def _note_half_open_success(self) -> None:
        """Enough clean traffic after a revive ends the half-open phase:
        the NEXT trip then starts from the minimum duration again."""
        with self._lock:
            if not self._half_open:
                return
            min_ms = int(get_flag("circuit_breaker_min_isolation_duration_ms"))
            # durable recovery = survived one short window of live traffic
            window = int(get_flag("circuit_breaker_short_window_size"))
            self._half_open_successes += 1
            if self._half_open_successes >= window:
                self._half_open = False
                self._isolation_duration_ms = min_ms

    def mark_as_broken(self) -> None:
        with self._lock:
            if self._broken:
                return
            self._broken = True
            self._broken_since_ms = _now_ms()
            self._isolated_times += 1
            if self._half_open:
                # re-tripped before a durable recovery: double the penalty
                self._isolation_duration_ms = min(
                    self._isolation_duration_ms * 2,
                    int(get_flag("circuit_breaker_max_isolation_duration_ms")),
                )

    def reset(self) -> None:
        """Revive into HALF_OPEN: candidate again, windows cleared, but
        the doubled duration sticks until a durable recovery."""
        self._short.reset()
        self._long.reset()
        with self._lock:
            self._broken = False
            self._half_open = True
            self._half_open_successes = 0
            self._last_reset_ms = _now_ms()
            self._broken_since_ms = None

    @property
    def broken(self) -> bool:
        return self._broken

    @property
    def isolation_duration_ms(self) -> int:
        return self._isolation_duration_ms

    @property
    def isolated_times(self) -> int:
        return self._isolated_times

    def state(self) -> str:
        with self._lock:
            if self._broken:
                return STATE_ISOLATED
            return STATE_HALF_OPEN if self._half_open else STATE_CLOSED

    def describe(self) -> dict:
        d = {
            "state": self.state(),
            "isolated_times": self._isolated_times,
            "isolation_duration_ms": self._isolation_duration_ms,
            "short_window": self._short.describe(),
            "long_window": self._long.describe(),
        }
        since = self._broken_since_ms
        if since is not None:
            d["isolated_for_ms"] = round(_now_ms() - since, 1)
        return d


class _BreakerRegistry:
    """Process-wide view of every live breaker, keyed by the owning LB's
    tag and the node endpoint — what the /circuit_breakers page and the
    ``circuit_breaker_isolated_count`` bvar render. Owners register and
    unregister; the registry never outlives them (weak values would be
    nicer but the LB's stop() is a natural unregister point)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rows: Dict[tuple, CircuitBreaker] = {}

    def register(self, owner_tag: str, endpoint: str, breaker: CircuitBreaker) -> None:
        with self._lock:
            self._rows[(owner_tag, endpoint)] = breaker

    def unregister_owner(self, owner_tag: str) -> None:
        with self._lock:
            for k in [k for k in self._rows if k[0] == owner_tag]:
                del self._rows[k]

    def unregister(self, owner_tag: str, endpoint: str) -> None:
        with self._lock:
            self._rows.pop((owner_tag, endpoint), None)

    def snapshot(self) -> List[tuple]:
        with self._lock:
            return sorted(self._rows.items())

    def isolated_count(self) -> int:
        with self._lock:
            return sum(1 for b in self._rows.values() if b.broken)


breaker_registry = _BreakerRegistry()

_isolated_gauge = None


def ensure_breaker_gauge() -> None:
    """Expose the process-wide isolated-node gauge lazily (first breaker
    construction): bvar sampler threads must not spawn at import."""
    global _isolated_gauge
    if _isolated_gauge is None:
        from incubator_brpc_tpu_torch.bvar import PassiveStatus

        _isolated_gauge = PassiveStatus(
            breaker_registry.isolated_count,
            name="circuit_breaker_isolated_count",
        )


__all__ = [
    "CircuitBreaker",
    "EmaErrorRecorder",
    "breaker_registry",
    "ensure_breaker_gauge",
    "STATE_CLOSED",
    "STATE_ISOLATED",
    "STATE_HALF_OPEN",
]
