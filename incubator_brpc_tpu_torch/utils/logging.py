"""Logging — the LogSink redirection layer + rate-limited logging
(reference src/butil/logging.{h,cc}: glog-compatible streams with a
pluggable LogSink, LOG_EVERY_SECOND / LOG_EVERY_N / LOG_FIRST_N).

The framework logs through stdlib ``logging`` (the idiomatic Python
"stream"); this module adds what stdlib lacks relative to the reference:

- ``LogSink``: one object that intercepts every framework log record.
  Return True to consume it; False falls through to a default stderr
  handler (butil::LogSink::OnLogMessage contract). While a sink is
  installed the package logger stops propagating, so the sink fully owns
  framework log routing — ``set_log_sink(None)`` restores stock behavior
  and returns the old sink for chaining.
- ``log_every_second`` / ``log_every_n`` / ``log_first_n``: call-site-keyed
  rate limiting (the LOG_EVERY_SECOND family, butil/logging.h).
- per-level bvar counters (``logging_error_count`` etc.) so /vars shows
  log pressure.

The port's copy of the JAX package's ``utils/logging.py``; its sink owns
the records of this package's logger (``incubator_brpc_tpu_torch``).
"""

from __future__ import annotations

import logging as _stdlog
import sys
import threading
import time
from typing import Dict, Optional, Tuple

from incubator_brpc_tpu_torch.bvar import Adder

ROOT_LOGGER_NAME = "incubator_brpc_tpu_torch"

log_counts = {
    _stdlog.DEBUG: Adder(name="logging_debug_count"),
    _stdlog.INFO: Adder(name="logging_info_count"),
    _stdlog.WARNING: Adder(name="logging_warning_count"),
    _stdlog.ERROR: Adder(name="logging_error_count"),
    _stdlog.CRITICAL: Adder(name="logging_fatal_count"),
}


class LogSink:
    """Subclass and override. Return True to consume the record (it will
    not reach the default handler) — butil::LogSink::OnLogMessage."""

    def on_log_message(self, record: _stdlog.LogRecord) -> bool:
        return False


_sink_lock = threading.Lock()
_active_sink: Optional[LogSink] = None

# default handling for records the sink declines (the reference falls back
# to its normal file/stderr writer when OnLogMessage returns false)
_fallback = _stdlog.StreamHandler(sys.stderr)
_fallback.setFormatter(
    _stdlog.Formatter("%(levelname).1s%(asctime)s %(name)s] %(message)s")
)


class _SinkHandler(_stdlog.Handler):
    """Counts per level; routes through the active LogSink; falls back to
    stderr for unconsumed records while a sink owns routing."""

    def emit(self, record: _stdlog.LogRecord) -> None:
        counter = log_counts.get(record.levelno)
        if counter is None:  # non-standard level: bucket to nearest floor
            for lvl in sorted(log_counts, reverse=True):
                if record.levelno >= lvl:
                    counter = log_counts[lvl]
                    break
        if counter is not None:
            counter << 1
        sink = _active_sink
        if sink is None:
            return  # propagation handles default output
        try:
            consumed = sink.on_log_message(record)
        except Exception:
            self.handleError(record)
            return
        if not consumed:
            _fallback.handle(record)


_pkg_logger = _stdlog.getLogger(ROOT_LOGGER_NAME)


def set_log_sink(sink: Optional[LogSink]) -> Optional[LogSink]:
    """Install ``sink`` (None restores default handling); returns the old
    sink (SetLogSink, butil/logging.h)."""
    global _active_sink
    with _sink_lock:
        old, _active_sink = _active_sink, sink
        # with a sink installed, the package logger stops propagating so
        # records don't ALSO hit the application's handlers, and its level
        # opens to DEBUG so the sink truly sees every framework record
        # (otherwise the root's WARNING default drops info/debug before
        # any handler runs); removing the sink restores stock behavior
        _pkg_logger.propagate = sink is None
        _pkg_logger.setLevel(_stdlog.NOTSET if sink is None else _stdlog.DEBUG)
    return old


def _install() -> None:
    if not any(isinstance(h, _SinkHandler) for h in _pkg_logger.handlers):
        handler = _SinkHandler()
        handler.setLevel(_stdlog.DEBUG)
        _pkg_logger.addHandler(handler)


_install()


# -- rate-limited logging (LOG_EVERY_SECOND / LOG_EVERY_N / LOG_FIRST_N) ----

_rl_lock = threading.Lock()
_last_by_site: Dict[Tuple[str, int], float] = {}
_count_by_site: Dict[Tuple[str, int], int] = {}


def _site() -> Tuple[str, int]:
    f = sys._getframe(2)
    return (f.f_code.co_filename, f.f_lineno)


def log_every_second(logger: _stdlog.Logger, level: int, msg: str, *args) -> bool:
    """Emit at most once per second per call site (LOG_EVERY_SECOND).
    Returns True if the record was emitted."""
    site = _site()
    now = time.monotonic()
    with _rl_lock:
        if now - _last_by_site.get(site, -1.0) < 1.0:
            return False
        _last_by_site[site] = now
    logger.log(level, msg, *args)
    return True


def log_every_n(logger: _stdlog.Logger, level: int, n: int, msg: str, *args) -> bool:
    """Emit every n-th call per call site (LOG_EVERY_N)."""
    site = _site()
    with _rl_lock:
        c = _count_by_site.get(site, 0)
        _count_by_site[site] = c + 1
    if c % max(1, n) != 0:
        return False
    logger.log(level, msg, *args)
    return True


def log_first_n(logger: _stdlog.Logger, level: int, n: int, msg: str, *args) -> bool:
    """Emit only the first n calls per call site (LOG_FIRST_N)."""
    site = _site()
    with _rl_lock:
        c = _count_by_site.get(site, 0)
        _count_by_site[site] = c + 1
    if c >= n:
        return False
    logger.log(level, msg, *args)
    return True
