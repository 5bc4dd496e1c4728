"""IntRecorder + LatencyRecorder (reference src/bvar/latency_recorder.h).

LatencyRecorder is the compound bvar behind every per-method /status row:
average latency (IntRecorder), percentile latencies (Percentile), max
latency (Maxer), qps (PerSecond of a count Adder).
"""

from __future__ import annotations

from typing import Optional

from incubator_brpc_tpu_torch.bvar.variable import Variable
from incubator_brpc_tpu_torch.bvar.reducer import Adder, Maxer
from incubator_brpc_tpu_torch.bvar.window import PerSecond
from incubator_brpc_tpu_torch.bvar.percentile import Percentile


class IntRecorder(Variable):
    """Average of recorded ints; (sum, num) per-thread via Adder agents
    (reference int_recorder.h)."""

    def __init__(self, name: Optional[str] = None):
        self._sum = Adder()
        self._num = Adder()
        super().__init__(name)

    def __lshift__(self, value: int) -> "IntRecorder":
        self._sum << value
        self._num << 1
        return self

    def average(self) -> float:
        n = self._num.get_value()
        return (self._sum.get_value() / n) if n else 0.0

    def get_value(self):
        return self.average()


class LatencyRecorder(Variable):
    """latency/qps/percentile compound (reference latency_recorder.h:40-107).
    ``<< latency_us`` records one call."""

    def __init__(self, name: Optional[str] = None, window_size: int = 10):
        self._latency = IntRecorder()
        self._max = Maxer(identity=0)
        self._count = Adder()
        self._percentile = Percentile()
        self._qps_window = PerSecond(self._count, window_size)
        super().__init__(name)

    def __lshift__(self, latency_us: float) -> "LatencyRecorder":
        self._latency << latency_us
        self._max << latency_us
        self._count << 1
        self._percentile.add(latency_us)
        return self

    def record_batch(self, count: int, total: float, max_value: float, samples) -> None:
        """Aggregate feed for batch consumers (the native telemetry drain):
        ``count`` calls totalling ``total`` µs with max ``max_value``, plus
        ``samples``, a bounded subset for the percentile reservoir.
        count/sum/max/qps stay exact; quantiles see the subset."""
        if count <= 0:
            return
        self._latency._sum << total
        self._latency._num << count
        self._max << max_value
        self._count << count
        for v in samples:
            self._percentile.add(v)

    def latency(self) -> float:
        return self._latency.average()

    def max_latency(self) -> float:
        v = self._max.get_value()
        return 0 if v == float("-inf") else v

    def count(self) -> int:
        return self._count.get_value()

    def qps(self) -> float:
        return self._qps_window.get_value()

    def latency_percentile(self, ratio: float) -> float:
        return self._percentile.get_number(ratio)

    def get_value(self):
        return {
            "latency": self.latency(),
            "max_latency": self.max_latency(),
            "qps": self.qps(),
            "count": self.count(),
            "latency_50": self.latency_percentile(0.5),
            "latency_90": self.latency_percentile(0.9),
            "latency_99": self.latency_percentile(0.99),
            "latency_999": self.latency_percentile(0.999),
        }

    def describe(self) -> str:
        v = self.get_value()
        return (
            f"count={v['count']} qps={v['qps']:.0f} latency={v['latency']:.1f}us "
            f"p50={v['latency_50']:.1f} p99={v['latency_99']:.1f} max={v['max_latency']:.1f}"
        )
