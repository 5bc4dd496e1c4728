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
(``parallel/mc_dispatch.py``), the axis the JAX kernels name ``"par"``, in
two forms. A session kernel has the signature

    kernel(data: uint8[P_local, width], n: int32[P_local], axis)
        -> (uint8[P_local, width], int32[P_local])

where ``P_local`` is the number of party rows this process holds:

- :class:`PartyAxis`, the single-controller form: one process holds every
  party's row, dim 0 of one tensor on one device (``P_local`` = P), and the
  kernel computes every party's next row at once, where a JAX kernel
  computes one party's row under ``shard_map``. ``axis.all_gather(t)`` is
  ``t`` itself, and ``axis.psum(t)`` the sum over dim 0 in party order,
  handed to every party's row.
- :class:`DistributedPartyAxis`: one party per ``torch.distributed`` rank,
  each holding its own row (``P_local`` = 1) over the session's process
  group (``utils/distributed.py`` ``session_group``). ``all_gather(t)``
  returns every party's ``t`` in party order, ``[P, ...]``, and ``psum(t)``
  is that gather summed in party order, ``[1, ...]``: the same additions in
  the same order as the single-controller form, so a float session gives
  the same bytes in both forms (a backend's own reduction, gloo's
  ``all_reduce``, adds in another order).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import time

import torch

from incubator_brpc_tpu_torch.bvar import Adder
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


def party_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over dim 0, added in party order (0, 1, ...): both
    party axes' ``psum``, so the two forms add alike to the byte."""
    acc = t[0].clone()
    for p in range(1, t.shape[0]):
        acc += t[p]
    return acc


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
                "dim 0 (one party per process is DistributedPartyAxis)"
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
        return party_sum(t).expand_as(t)


def party_axis(parties: int, device: DeviceLike = None) -> PartyAxis:
    """The party axis of a session of ``parties`` rows on one device
    (``cuda`` unless ``device="cpu"``)."""
    if not 1 <= parties:
        raise ValueError(f"a session needs at least one party, got {parties}")
    return PartyAxis(size=int(parties), device=resolve_device(device))


# the distributed party axis's gathers in this process, and their host time
# (from the call to its completion, waiting for the slowest peer included)
party_gathers = Adder(name="mc_party_gathers")
party_gather_us = Adder(name="mc_party_gather_us")


class PartyLost(RuntimeError):
    """A collective of a distributed party axis failed: a peer left the
    session group (its process died, or it dropped the group on an abort),
    or the group's timeout passed."""


@dataclasses.dataclass(frozen=True)
class DistributedPartyAxis:
    """The party axis of a session with one party per ``torch.distributed``
    rank: ``size`` parties, this process party ``index``, holding its own
    row ``[1, ...]`` on ``device``; ``group`` is the session's process group,
    its ranks in party order."""

    size: int
    index: int
    group: object
    device: torch.device

    def _check(self, t: torch.Tensor, op: str) -> None:
        if t.dim() < 1 or t.shape[0] != 1:
            raise ValueError(
                f"DistributedPartyAxis.{op}: shape {tuple(t.shape)}; want this party's "
                "own row, 1 on dim 0"
            )
        if t.device != self.device:
            raise ValueError(
                f"DistributedPartyAxis.{op}: tensor on {t.device}, axis on {self.device}"
            )

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every party's ``t`` in party order: ``[size, ...]``. The bytes
        cross the group in ``t``'s own dtype (int8 values cross as int8)."""
        self._check(t, "all_gather")
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(self.size)]
        t0 = time.perf_counter()
        try:
            self.group.allgather([outs], [t]).wait()
        except RuntimeError as e:
            raise PartyLost(f"party {self.index}'s all_gather over the session group failed: "
                            f"{e}") from e
        party_gathers << 1
        party_gather_us << (time.perf_counter() - t0) * 1e6
        return torch.cat(outs, dim=0)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over parties, added in party order (0, 1, ...): this
        party's row, ``[1, ...]``."""
        self._check(t, "psum")
        return party_sum(self.all_gather(t)).unsqueeze(0)
