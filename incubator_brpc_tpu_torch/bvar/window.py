"""Window / PerSecond over reducers (reference src/bvar/window.h).

The reference snapshots every reducer once per second from a global sampler
thread (detail/sampler.cpp) and serves window values from the ring of
samples. Same design: a 1 Hz daemon samples registered reducers into a ring
of (timestamp, value). The thread starts with the first Window, not at
import.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Deque, Optional, Tuple

from incubator_brpc_tpu_torch.bvar.variable import Variable

_MAX_WINDOW = 3600


class _SamplerThread:
    """Global 1 Hz sampler (reference detail/sampler.cpp:35). Daemon;
    started lazily on first Window. Holds weakrefs: a dropped Window is
    not pinned (and sampled) forever."""

    def __init__(self) -> None:
        self._samplers: list = []
        self._lock = threading.Lock()
        self._started = False

    def register(self, sampler: "Window") -> None:
        with self._lock:
            self._samplers.append(weakref.ref(sampler))
            if not self._started:
                self._started = True
                t = threading.Thread(target=self._run, name="bvar_sampler", daemon=True)
                t.start()

    def _run(self) -> None:
        while True:
            start = time.monotonic()
            with self._lock:
                refs = list(self._samplers)
            dead = False
            for ref in refs:
                s = ref()
                if s is None:
                    dead = True
                    continue
                try:
                    s._take_sample()
                except Exception:  # noqa: BLE001 — one bad sampler must not stop the rest
                    import logging

                    logging.getLogger(__name__).exception("bvar sampler raised")
            if dead:
                with self._lock:
                    self._samplers = [r for r in self._samplers if r() is not None]
            elapsed = time.monotonic() - start
            time.sleep(max(0.0, 1.0 - elapsed))


_sampler_thread = _SamplerThread()


class Window(Variable):
    """Value accumulated over the last ``window_size`` seconds of a reducer
    with an inverse op (e.g. Adder) — reference bvar::Window."""

    def __init__(self, reducer, window_size: int = 10, name: Optional[str] = None):
        if getattr(reducer, "_inv_op", None) is None:
            raise TypeError("Window requires a reducer with an inverse op (e.g. Adder)")
        self._reducer = reducer
        self._window_size = min(window_size, _MAX_WINDOW)
        self._samples: Deque[Tuple[float, object]] = deque(maxlen=self._window_size + 1)
        self._samples_lock = threading.Lock()
        self._series: Deque[Tuple[float, object]] = deque(maxlen=self.SERIES_POINTS)
        super().__init__(name)
        _sampler_thread.register(self)

    # per-second points kept for plotting (/vars/series.json, off the same
    # 1 Hz sampler as the reference's vars_service series); 3 minutes
    SERIES_POINTS = 180

    def _take_sample(self) -> None:
        now = time.monotonic()
        with self._samples_lock:
            self._samples.append((now, self._reducer.get_value()))
        # the plotted point is the WINDOWED value (what get_value shows);
        # computed outside the lock — get_span re-takes it
        point = self.get_value()
        with self._samples_lock:
            self._series.append((now, point))

    def series(self):
        """[(monotonic_ts, windowed_value)] — newest last."""
        with self._samples_lock:
            return list(self._series)

    def get_span(self) -> Tuple[float, object]:
        """(seconds, delta) actually covered — may be < window_size early on."""
        now_val = self._reducer.get_value()
        now_ts = time.monotonic()
        with self._samples_lock:
            if not self._samples:
                return 0.0, self._reducer._identity
            oldest_ts, oldest_val = self._samples[0]
            for ts, val in self._samples:
                if now_ts - ts <= self._window_size:
                    oldest_ts, oldest_val = ts, val
                    break
        return now_ts - oldest_ts, self._reducer._inv_op(now_val, oldest_val)

    def get_value(self):
        return self.get_span()[1]


class PerSecond(Window):
    """Window divided by elapsed seconds (reference bvar::PerSecond); always
    a float, so 9 events over 10 s read 0.9/s, not 0/s."""

    def get_value(self):
        seconds, delta = self.get_span()
        if seconds <= 0:
            return 0.0
        return delta / seconds if isinstance(delta, (int, float)) else delta
