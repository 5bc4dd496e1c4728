"""bvar — write-mostly, thread-locally aggregated metrics (reference src/bvar/).

The port's copy of the JAX package's bvar: the reducers (``Adder``,
``Maxer``, ``Miner``), ``PassiveStatus``, ``IntRecorder`` and
``LatencyRecorder``, the 1 Hz windows (``Window``, ``PerSecond``, with the
per-second series ``/vars/series.json`` plots) and the percentile sketch,
and the expose registry the portal's ``/vars`` and ``/brpc_metrics`` read.
The reducers' ``reset`` is not ported: nothing in the port rebases one.
"""

from incubator_brpc_tpu_torch.bvar.variable import Variable, expose_registry, dump_exposed
from incubator_brpc_tpu_torch.bvar.reducer import Adder, Maxer, Miner, PassiveStatus
from incubator_brpc_tpu_torch.bvar.recorder import IntRecorder, LatencyRecorder
from incubator_brpc_tpu_torch.bvar.window import Window, PerSecond
from incubator_brpc_tpu_torch.bvar.percentile import Percentile

__all__ = [
    "Variable",
    "expose_registry",
    "dump_exposed",
    "Adder",
    "Maxer",
    "Miner",
    "PassiveStatus",
    "IntRecorder",
    "LatencyRecorder",
    "Window",
    "PerSecond",
    "Percentile",
]
