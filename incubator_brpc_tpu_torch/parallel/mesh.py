"""Fabric mesh — the named axes every parallel lowering runs over, the
counterpart of ``incubator_brpc_tpu/parallel/mesh.py``.

Axis vocabulary (fixed; sizes may be 1 so every code path exists at any
device count):

    dp — data/replica fan-out (ParallelChannel broadcast+merge)
    pp — pipeline stages (chained streaming RPC)
    tp — tensor/partitioned service shards (PartitionChannel)
    sp — sequence/stream ring (StreamingRPC over neighbors)
    ep — expert/dynamic partition groups (DynamicPartitionChannel)

This slice runs on one card: :func:`make_fabric_mesh` takes one device and
every axis is 1, so each collective of the JAX package is an identity. The
mesh over several ``torch.distributed`` ranks is a later slice. The JAX
package's ``parallel/compat.py`` (the ``shard_map`` seam across JAX
versions) has no counterpart: nothing here is traced.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from incubator_brpc_tpu_torch.utils.device import DeviceLike, resolve_device

FABRIC_AXES = ("dp", "pp", "tp", "sp", "ep")


def default_axis_sizes(n_devices: int) -> Dict[str, int]:
    """Factor ``n_devices`` over the fabric axes.

    Powers of two are split round-robin in priority order dp, tp, pp, sp, ep
    (so 8 devices -> dp2·tp2·pp2, 32 -> all axes 2); any residual odd factor
    lands on dp.
    """
    sizes = {ax: 1 for ax in FABRIC_AXES}
    n = n_devices
    priority = ("dp", "tp", "pp", "sp", "ep")
    while n % 2 == 0 and n > 1:
        for ax in priority:
            if n % 2 != 0 or n == 1:
                break
            sizes[ax] *= 2
            n //= 2
    sizes["dp"] *= n  # odd residue
    return sizes


@dataclasses.dataclass(frozen=True)
class FabricMesh:
    """The axis sizes (``shape``, over :data:`FABRIC_AXES`) and the device."""

    shape: Dict[str, int]
    device: torch.device


def make_fabric_mesh(
    n_devices: int = 1,
    axis_sizes: Optional[Dict[str, int]] = None,
    device: DeviceLike = None,
) -> FabricMesh:
    """The fabric mesh of one card (``cuda`` unless ``device="cpu"``).
    Raises for more than one rank: the multi-rank mesh is a later slice."""
    if axis_sizes is None:
        axis_sizes = default_axis_sizes(n_devices)
    shape = {ax: int(axis_sizes.get(ax, 1)) for ax in FABRIC_AXES}
    n = 1
    for ax in FABRIC_AXES:
        n *= shape[ax]
    if n != n_devices:
        raise ValueError(f"axis sizes {axis_sizes} do not factor {n_devices} devices")
    if n_devices != 1:
        raise ValueError(
            f"a mesh of {n_devices} ranks: this port runs one card; the mesh over "
            "torch.distributed ranks is ROADMAP slice 4"
        )
    return FabricMesh(shape=shape, device=resolve_device(device))
