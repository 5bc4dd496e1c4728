"""Fabric mesh — the named axes every parallel lowering runs over, the
counterpart of ``incubator_brpc_tpu/parallel/mesh.py``.

Axis vocabulary (fixed; sizes may be 1 so every code path exists at any
device count):

    dp — data/replica fan-out (ParallelChannel broadcast+merge)
    pp — pipeline stages (chained streaming RPC)
    tp — tensor/partitioned service shards (PartitionChannel)
    sp — sequence/stream ring (StreamingRPC over neighbors)
    ep — expert/dynamic partition groups (DynamicPartitionChannel)

One card holds every rank of the mesh, as JAX's eight virtual CPU devices
do in the JAX package's tests: :func:`make_fabric_mesh` takes any factoring
of ``n`` ranks over the axes, and the mesh records the axis sizes, the rank
order (C order over :data:`FABRIC_AXES`, dp slowest, ep fastest, as the JAX
mesh reshapes its devices) and the device. A tensor sharded over an axis
carries that axis's ranks in a leading dimension, in mesh order, and each
collective is a tensor operation over it (``parallel/collective.py``). The
mesh over several ``torch.distributed`` ranks, one rank a process, is a
later slice. The JAX package's ``parallel/compat.py`` (the ``shard_map``
seam across JAX versions) has no counterpart: nothing here is traced.

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
    """The axis sizes (``shape``, over :data:`FABRIC_AXES`) and the one
    device that holds every rank. Rank ``r`` has the coordinates of ``r`` in
    C order over the axes (:meth:`coords`)."""

    shape: Dict[str, int]
    device: torch.device

    @property
    def size(self) -> int:
        """The number of ranks."""
        n = 1
        for ax in FABRIC_AXES:
            n *= self.shape[ax]
        return n

    def coords(self, rank: int) -> Dict[str, int]:
        """The coordinates of ``rank``: dp slowest, ep fastest."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        out = {}
        for ax in reversed(FABRIC_AXES):
            rank, out[ax] = divmod(rank, self.shape[ax])
        return {ax: out[ax] for ax in FABRIC_AXES}


def make_fabric_mesh(
    n_devices: int = 1,
    axis_sizes: Optional[Dict[str, int]] = None,
    device: DeviceLike = None,
) -> FabricMesh:
    """The fabric mesh of ``n_devices`` ranks, all on one device (``cuda``
    unless ``device="cpu"``): ``axis_sizes`` (default
    :func:`default_axis_sizes`) must factor ``n_devices``; an axis it does
    not name is 1."""
    if axis_sizes is None:
        axis_sizes = default_axis_sizes(n_devices)
    unknown = set(axis_sizes) - set(FABRIC_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; the axes are {FABRIC_AXES}")
    shape = {ax: int(axis_sizes.get(ax, 1)) for ax in FABRIC_AXES}
    if any(v < 1 for v in shape.values()):
        raise ValueError(f"axis sizes {axis_sizes}: each must be >= 1")
    mesh = FabricMesh(shape=shape, device=resolve_device(device))
    if mesh.size != n_devices:
        raise ValueError(f"axis sizes {axis_sizes} do not factor {n_devices} devices")
    return mesh


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
