"""parallel — the fabric mesh and the party axis (``mesh.py``), the
collective lowerings of the combo channels over a mesh axis
(``collective.py``), block quantized collectives (``quantized.py``), and the
collective session plane (``mc_dispatch.py``, ``mc_collective.py``); every
rank on one card for now.

| reference primitive            | here                                   |
|--------------------------------|----------------------------------------|
| ParallelChannel fan-out/merge  | ``fanout``/``merge`` (all_gather/psum) |
| PartitionChannel sharding      | ``partition_exchange`` (all_to_all)    |
| Streaming RPC credit window    | ``ring_stream`` (ppermute ring)        |
"""

from incubator_brpc_tpu_torch.parallel.collective import (
    fanout,
    merge,
    partition_exchange,
    ring_allgather,
    ring_stream,
)
from incubator_brpc_tpu_torch.parallel.mesh import (
    FABRIC_AXES,
    FabricMesh,
    default_axis_sizes,
    make_fabric_mesh,
)

__all__ = [
    "FABRIC_AXES",
    "FabricMesh",
    "default_axis_sizes",
    "make_fabric_mesh",
    "fanout",
    "merge",
    "partition_exchange",
    "ring_stream",
    "ring_allgather",
]
