"""bvar — write-mostly, thread-locally aggregated metrics (reference src/bvar/).

The port's copy of the JAX package's bvar, trimmed to what the device path
records: ``Adder`` (``device_transport_calls``, the ``mc_dispatch_*``
session counters) and ``LatencyRecorder`` (``device_transport_latency``),
with the reducers, windows and percentile sketch those are built from, and
``PassiveStatus`` (the ``mc_dispatch_*`` gauges).
"""

from incubator_brpc_tpu_torch.bvar.variable import Variable, expose_registry, dump_exposed
from incubator_brpc_tpu_torch.bvar.reducer import Adder, Maxer, PassiveStatus
from incubator_brpc_tpu_torch.bvar.recorder import IntRecorder, LatencyRecorder
from incubator_brpc_tpu_torch.bvar.window import Window, PerSecond
from incubator_brpc_tpu_torch.bvar.percentile import Percentile

__all__ = [
    "Variable",
    "expose_registry",
    "dump_exposed",
    "Adder",
    "Maxer",
    "PassiveStatus",
    "IntRecorder",
    "LatencyRecorder",
    "Window",
    "PerSecond",
    "Percentile",
]
