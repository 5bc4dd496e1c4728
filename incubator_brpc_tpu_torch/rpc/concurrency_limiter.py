"""Concurrency limiters — server-side overload control (reference
src/brpc/concurrency_limiter.h + policy/auto_concurrency_limiter.cpp).

``ServerOptions(max_concurrency=...)`` (and the per-method variants)
accept either an int (constant limit, 0 = unlimited) or ``"auto"`` — the
reference's adaptive gradient limiter. The auto algorithm, ported from
policy/auto_concurrency_limiter.cpp:

- Completions are *sampled* (at most one per ``auto_cl_sampling_interval_us``)
  into a window; the window settles when it holds
  ``auto_cl_max_sample_count`` samples or ``auto_cl_sample_window_size_ms``
  elapsed with at least ``auto_cl_min_sample_count`` (else it is discarded).
- Each settled window updates two EMAs: ``min_latency`` (fast to shrink,
  never grows except by remeasure) and ``max_qps`` (fast to grow, slow to
  decay) — the gradient inputs.
- The new limit is ``max_qps * min_latency * (1 + explore_ratio)`` where
  the explore ratio widens while latency stays near the no-load floor (or
  qps sits below the ceiling) and narrows once latency inflates — the
  gradient step.
- Periodically (``auto_cl_noload_latency_remeasure_interval_ms``) the
  limit is pulled down to ``reduce_ratio`` of itself for roughly two
  round trips so ``min_latency`` can be re-measured without queueing —
  the probe-down that keeps the floor honest on drifting backends.

All timestamps are taken from a monotonic microsecond clock but every
entry point accepts ``now_us`` so tests drive the algorithm with a
synthetic clock — the determinism the acceptance tests need.

The port's copy of the JAX package's ``rpc/concurrency_limiter.py``: the
same arithmetic on the same flags, so both packages' limiters move through
identical limits on one script of samples.
"""

from __future__ import annotations

import math
import threading
from time import monotonic as _monotonic
from typing import Callable, Optional, Union

from incubator_brpc_tpu_torch.utils.flags import get_flag


def _now_us() -> int:
    return int(_monotonic() * 1e6)


class ConcurrencyLimiter:
    """Admission interface (concurrency_limiter.h): ``on_requested`` is
    the gate, ``on_responded`` the feedback path."""

    def on_requested(self, current_concurrency: int) -> bool:
        raise NotImplementedError

    def on_responded(self, error_code: int, latency_us: float,
                     now_us: Optional[int] = None) -> None:
        raise NotImplementedError

    def max_concurrency(self) -> int:
        """Current limit; 0 = unlimited."""
        raise NotImplementedError


class ConstantConcurrencyLimiter(ConcurrencyLimiter):
    """The fixed limit every server had before "auto" existed."""

    def __init__(self, limit: int):
        self._limit = max(0, int(limit))

    def on_requested(self, current_concurrency: int) -> bool:
        return not self._limit or current_concurrency <= self._limit

    def on_responded(self, error_code: int, latency_us: float,
                     now_us: Optional[int] = None) -> None:
        pass

    def max_concurrency(self) -> int:
        return self._limit

    def set_max_concurrency(self, limit: int) -> None:
        self._limit = max(0, int(limit))


class AutoConcurrencyLimiter(ConcurrencyLimiter):
    """The gradient limiter (policy/auto_concurrency_limiter.cpp).

    ``on_limit_change(new_limit)`` fires (outside the lock) whenever the
    limit moves — the seam the server uses to push the adaptive limit
    down to natively-registered methods via
    ``tb_server_set_native_max_concurrency``.
    """

    def __init__(self, on_limit_change: Optional[Callable[[int], None]] = None):
        self._lock = threading.Lock()
        self._max_concurrency = int(get_flag("auto_cl_initial_max_concurrency"))
        self._on_limit_change = on_limit_change
        # EMAs (gradient inputs)
        self._min_latency_us = -1.0  # no-load latency floor; -1 = unmeasured
        self._ema_max_qps = -1.0  # qps ceiling; -1 = unmeasured
        self._explore_ratio = float(get_flag("auto_cl_max_explore_ratio"))
        # sampling window
        self._sw_start_us = 0
        self._sw_succ = 0
        self._sw_fail = 0
        self._sw_total_succ_us = 0.0
        self._sw_total_fail_us = 0.0
        self._last_sampling_us = 0
        # probe-down state: _remeasure_start_us = when the next probe-down
        # begins; _reset_latency_us != 0 = probe-down in progress, samples
        # dropped until it passes (the two-round-trip drain window)
        self._remeasure_start_us = 0
        self._reset_latency_us = 0

    # -- admission ----------------------------------------------------------

    def on_requested(self, current_concurrency: int) -> bool:
        return current_concurrency <= self._max_concurrency

    def max_concurrency(self) -> int:
        return self._max_concurrency

    # -- feedback -----------------------------------------------------------

    # fabriclint: hotpath
    def on_responded(self, error_code: int, latency_us: float,
                     now_us: Optional[int] = None) -> None:
        now = _now_us() if now_us is None else int(now_us)
        interval = int(get_flag("auto_cl_sampling_interval_us"))
        # cheap pre-lock rejection of the common no-sample case
        if interval and now < self._last_sampling_us + interval:
            return
        changed = None
        # fabriclint: allow(hotpath-lock) the pre-lock interval check above bounds acquisitions to one per auto_cl_sampling_interval_us, not one per response
        with self._lock:
            if interval and now < self._last_sampling_us + interval:
                return
            self._last_sampling_us = now
            changed = self._add_sample(error_code, latency_us, now)
        if changed is not None and self._on_limit_change is not None:
            try:
                self._on_limit_change(changed)
            except Exception:
                pass

    # everything below runs under self._lock ------------------------------

    def _add_sample(self, error_code: int, latency_us: float,
                    now: int) -> Optional[int]:
        if self._reset_latency_us:
            # probe-down drain: drop samples until the old in-flight
            # requests (admitted at the higher limit) have cleared
            if now < self._reset_latency_us:
                return None
            self._reset_latency_us = 0
            self._min_latency_us = -1.0  # remeasure the floor from scratch
            self._remeasure_start_us = self._next_remeasure_us(now)
            self._reset_window(now)
        if self._sw_start_us == 0:
            self._sw_start_us = now
        if error_code == 0:
            self._sw_succ += 1
            self._sw_total_succ_us += latency_us
        else:
            self._sw_fail += 1
            self._sw_total_fail_us += latency_us
        total = self._sw_succ + self._sw_fail
        window_us = int(get_flag("auto_cl_sample_window_size_ms")) * 1000
        if total < int(get_flag("auto_cl_min_sample_count")):
            if now - self._sw_start_us >= window_us:
                # stale trickle: too few samples to trust — discard
                self._reset_window(now)
            return None
        if (
            now - self._sw_start_us < window_us
            and total < int(get_flag("auto_cl_max_sample_count"))
        ):
            return None
        prev = self._max_concurrency
        if self._sw_succ > 0:
            self._update_max_concurrency(now)
        else:
            # every sample failed: halve and wait for the next window
            self._max_concurrency = max(1, self._max_concurrency // 2)
        self._reset_window(now)
        return self._max_concurrency if self._max_concurrency != prev else None

    def _reset_window(self, now: int) -> None:
        self._sw_start_us = now
        self._sw_succ = 0
        self._sw_fail = 0
        self._sw_total_succ_us = 0.0
        self._sw_total_fail_us = 0.0

    def _next_remeasure_us(self, now: int) -> int:
        return now + int(
            get_flag("auto_cl_noload_latency_remeasure_interval_ms")
        ) * 1000

    def _update_min_latency(self, avg_latency_us: float) -> None:
        ema = float(get_flag("auto_cl_alpha_factor_for_ema"))
        if self._min_latency_us <= 0:
            self._min_latency_us = avg_latency_us
        elif avg_latency_us < self._min_latency_us:
            self._min_latency_us = (
                avg_latency_us * ema + self._min_latency_us * (1 - ema)
            )

    def _update_qps(self, qps: float) -> None:
        ema = float(get_flag("auto_cl_qps_alpha_factor_for_ema"))
        if qps >= self._ema_max_qps:
            self._ema_max_qps = qps
        else:
            self._ema_max_qps = qps * ema + self._ema_max_qps * (1 - ema)

    def _update_max_concurrency(self, now: int) -> None:
        fail_punish = self._sw_total_fail_us * float(
            get_flag("auto_cl_fail_punish_ratio")
        )
        avg_latency = max(
            1.0, (fail_punish + self._sw_total_succ_us) / self._sw_succ
        )
        elapsed = max(1, now - self._sw_start_us)
        qps = 1e6 * self._sw_succ / elapsed
        self._update_qps(qps)
        self._update_min_latency(avg_latency)

        if self._remeasure_start_us == 0:
            self._remeasure_start_us = self._next_remeasure_us(now)
        if self._remeasure_start_us <= now:
            # probe-down: shrink the limit for ~two round trips so queueing
            # drains and the next windows see true no-load latency
            reduce = float(get_flag("auto_cl_reduce_ratio_while_remeasure"))
            next_mc = max(1, math.ceil(self._max_concurrency * reduce))
            self._reset_latency_us = now + int(avg_latency * 2)
        else:
            change = float(get_flag("auto_cl_change_rate_of_explore_ratio"))
            hi = float(get_flag("auto_cl_max_explore_ratio"))
            lo = float(get_flag("auto_cl_min_explore_ratio"))
            if (
                avg_latency <= self._min_latency_us * (1.0 + lo)
                or qps <= self._ema_max_qps / (1.0 + lo)
            ):
                # latency near the floor (or qps below the ceiling):
                # latency is not the bottleneck — explore upward
                self._explore_ratio = min(hi, self._explore_ratio + change)
            else:
                self._explore_ratio = max(lo, self._explore_ratio - change)
            next_mc = max(
                1,
                math.ceil(
                    self._ema_max_qps
                    * self._min_latency_us
                    / 1e6
                    * (1.0 + self._explore_ratio)
                ),
            )
        self._max_concurrency = next_mc

    # -- introspection ------------------------------------------------------

    def describe(self) -> dict:
        with self._lock:
            return {
                "max_concurrency": self._max_concurrency,
                "min_latency_us": self._min_latency_us,
                "ema_max_qps": self._ema_max_qps,
                "explore_ratio": self._explore_ratio,
                "remeasuring": bool(self._reset_latency_us),
            }


def create_concurrency_limiter(
    spec: Union[int, str, None],
    on_limit_change: Optional[Callable[[int], None]] = None,
) -> Optional[ConcurrencyLimiter]:
    """``spec`` is what ServerOptions carries: 0/None → None (unlimited,
    no gate object at all), an int → constant, "auto" → the gradient
    limiter, "constant" → constant 0 (reference AdaptiveMaxConcurrency
    accepts the same spellings)."""
    if spec is None:
        return None
    if isinstance(spec, str):
        s = spec.strip().lower()
        if s == "auto":
            return AutoConcurrencyLimiter(on_limit_change=on_limit_change)
        if s in ("", "constant", "unlimited"):
            return None
        try:
            spec = int(s)
        except ValueError:
            raise ValueError(f"unknown max_concurrency spec {spec!r}") from None
    if int(spec) <= 0:
        return None
    return ConstantConcurrencyLimiter(int(spec))


__all__ = [
    "ConcurrencyLimiter",
    "ConstantConcurrencyLimiter",
    "AutoConcurrencyLimiter",
    "create_concurrency_limiter",
]
