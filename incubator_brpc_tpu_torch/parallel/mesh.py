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

:class:`PartyAxis` is the party axis of a collective session
(``parallel/mc_dispatch.py``), the axis the JAX kernels name ``"par"``. In
the single-controller form one process holds every party's row: the state
is one tensor whose dim 0 is the party, on one device. A session kernel has
the signature

    kernel(data: uint8[P, width], n: int32[P], axis: PartyAxis)
        -> (uint8[P, width], int32[P])

and computes every party's next row at once, where a JAX kernel computes
one party's row under ``shard_map``. ``axis.all_gather(t)`` is then ``t``
itself, and ``axis.psum(t)`` the sum over dim 0 in party order, handed to
every party's row. The form over ``torch.distributed`` ranks, one party
per rank, is a later slice.
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


@dataclasses.dataclass(frozen=True)
class PartyAxis:
    """The party axis of a single-controller session: ``size`` parties
    whose rows are dim 0 of one tensor on ``device``."""

    size: int
    device: torch.device

    def _check(self, t: torch.Tensor, op: str) -> None:
        if t.dim() < 1 or t.shape[0] != self.size:
            raise ValueError(
                f"PartyAxis.{op}: shape {tuple(t.shape)}; want {self.size} parties on "
                "dim 0 (the form with one party per torch.distributed rank is ROADMAP "
                "slice 6)"
            )
        if t.device != self.device:
            raise ValueError(f"PartyAxis.{op}: tensor on {t.device}, axis on {self.device}")

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every party's row, as every party sees it: ``t`` itself."""
        self._check(t, "all_gather")
        return t

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over parties, added in party order (0, 1, ...), as
        every party's row: ``[P, ...]``, a broadcast view of one sum."""
        self._check(t, "psum")
        acc = t[0].clone()
        for p in range(1, self.size):
            acc += t[p]
        return acc.expand_as(t)


def party_axis(parties: int, device: DeviceLike = None) -> PartyAxis:
    """The party axis of a session of ``parties`` rows on one device
    (``cuda`` unless ``device="cpu"``)."""
    if not 1 <= parties:
        raise ValueError(f"a session needs at least one party, got {parties}")
    return PartyAxis(size=int(parties), device=resolve_device(device))
