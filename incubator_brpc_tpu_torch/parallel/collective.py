"""Collective lowerings of the combo channels' semantics over a named axis of
the one-device mesh, the counterpart of
``incubator_brpc_tpu/parallel/collective.py``.

JAX runs each of these inside ``shard_map``: rank ``i`` of the axis holds its
own block and the collective moves blocks between devices. One card holds
every rank here, so a tensor sharded over the axis carries the axis's ranks
in its leading dimension, in mesh order (``x[i]`` is rank ``i``'s block),
and each collective is an exact tensor operation over that dimension, in
the order JAX's lowering gives:

| reference primitive            | JAX               | here                             |
|--------------------------------|-------------------|----------------------------------|
| ParallelChannel fan-out        | ``all_gather``    | :func:`fanout`: the stack itself |
| ParallelChannel ResponseMerger | ``psum`` / ...    | :func:`merge`: over dim 0, in rank order |
| PartitionChannel sharding      | tiled ``all_to_all`` | :func:`partition_exchange`: a transpose of (source, destination) tiles |
| Streaming RPC credit window    | ``ppermute`` ring | :func:`ring_stream`: a roll of dim 0 a hop |

A result that every rank holds alike (a merge, a gather) is returned once,
without the rank dimension, as JAX's ``out_specs=P()`` reads it from one
rank. Each function is differentiable with PyTorch's autograd, which gives
the gradient JAX's ``shard_map(check_vma=False)`` transpose gives the
global function: ``psum`` transposes to ``psum`` with the cotangent of a
replicated output divided among its ranks, so a merge's gradient reaches
every rank whole; ``all_gather`` transposes to ``psum_scatter``, the
``all_to_all`` to the inverse exchange, ``ppermute`` to the reverse ring.
``pmax``/``pmin`` have no transpose in JAX; here they take ``amax``'s and
``amin``'s. The ``axis`` name is checked against ``mesh`` when one is given.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from incubator_brpc_tpu_torch.parallel.mesh import FABRIC_AXES, FabricMesh

MERGERS = ("sum", "mean", "max", "min")


def _ranks(x: torch.Tensor, axis: str, mesh: Optional[FabricMesh], op: str) -> int:
    """The axis size: ``x``'s leading dimension, which ``mesh`` must agree with."""
    if not isinstance(x, torch.Tensor) or x.dim() < 1:
        raise ValueError(f"{op}: want a tensor whose dim 0 is the ranks of {axis!r}")
    if mesh is not None:
        if axis not in FABRIC_AXES:
            raise ValueError(f"{op}: unknown axis {axis!r}; the axes are {FABRIC_AXES}")
        if x.shape[0] != mesh.shape[axis]:
            raise ValueError(f"{op}: dim 0 is {x.shape[0]}; the mesh's {axis} is "
                             f"{mesh.shape[axis]}")
    return x.shape[0]


def fanout(x: torch.Tensor, axis: str, mesh: Optional[FabricMesh] = None) -> torch.Tensor:
    """ParallelChannel broadcast side (``all_gather``): every rank's block,
    as each rank holds it after the gather — the stack ``x`` itself."""
    _ranks(x, axis, mesh, "fanout")
    return x


def merge(x: torch.Tensor, axis: str, merger: str = "sum",
          mesh: Optional[FabricMesh] = None) -> torch.Tensor:
    """ParallelChannel ResponseMerger over ``axis``: the blocks combined in
    rank order, ``((x[0] + x[1]) + x[2]) + ...`` in x's dtype for ``"sum"``;
    ``"mean"`` is that sum divided by the axis size (``lax.pmean``);
    ``"max"``/``"min"`` elementwise. Returned once, without the rank
    dimension."""
    if merger not in MERGERS:
        raise ValueError(f"unknown merger {merger!r}")
    n = _ranks(x, axis, mesh, "merge")
    if merger == "max":
        return x.amax(dim=0)
    if merger == "min":
        return x.amin(dim=0)
    acc = x[0]
    for i in range(1, n):
        acc = acc + x[i]
    return acc / n if merger == "mean" else acc


def partition_exchange(x: torch.Tensor, axis: str, split_dim: int = 0, concat_dim: int = 0,
                       mesh: Optional[FabricMesh] = None) -> torch.Tensor:
    """PartitionChannel (tiled ``all_to_all``): slice ``j`` of rank ``i``'s
    block along ``split_dim`` goes to rank ``j``, which concatenates what it
    receives along ``concat_dim`` in source order. ``split_dim`` and
    ``concat_dim`` are the block's own dimensions, as in JAX. Returns the
    ranks' new blocks, stacked."""
    n = _ranks(x, axis, mesh, "partition_exchange")
    nd = x.dim() - 1
    if not (0 <= split_dim < nd and 0 <= concat_dim < nd):
        raise ValueError(f"partition_exchange: dims ({split_dim}, {concat_dim}) of a {nd}-d block")
    if x.shape[1 + split_dim] % n:
        raise ValueError(f"partition_exchange: block dim {split_dim} of {x.shape[1 + split_dim]} "
                         f"does not split over {n} ranks")
    tiles = x.unflatten(1 + split_dim, (n, -1))  # (source, ..., destination, chunk, ...)
    tiles = tiles.movedim(1 + split_dim, 0)  # (destination, source, block dims)
    return tiles.movedim(1, 1 + concat_dim).flatten(1 + concat_dim, 2 + concat_dim)


def ring_stream(
    x: torch.Tensor,
    axis: str,
    step_fn: Callable,
    carry_init,
    mesh: Optional[FabricMesh] = None,
) -> Tuple[object, torch.Tensor]:
    """Streaming RPC over the ring: ``n`` hops; at each, every rank folds
    ``step_fn(carry, received) -> (carry, send)`` (on the stacked blocks,
    every rank at once) and ``send`` moves one rank on (``ppermute``
    ``i -> i + 1``: a roll of dim 0). ``received`` starts as ``x``.
    Returns ``(carry, buf)`` as JAX's ``lax.scan`` leaves them."""
    n = _ranks(x, axis, mesh, "ring_stream")
    carry, buf = carry_init, x
    for _ in range(n):
        carry, send = step_fn(carry, buf)
        buf = torch.roll(send, 1, dims=0)
    return carry, buf


def ring_allgather(x: torch.Tensor, axis: str, mesh: Optional[FabricMesh] = None) -> torch.Tensor:
    """All-gather built from :func:`ring_stream` (the tests check it against
    :func:`fanout`): at hop ``k`` rank ``i`` holds the block that started at
    rank ``(i - k) mod n`` and writes it there. Returns every rank's table,
    ``(n, n, ...)``."""
    n = _ranks(x, axis, mesh, "ring_allgather")
    my = torch.arange(n, device=x.device)
    out = x.new_zeros((n,) + tuple(x.shape))

    def step_fn(carry, received):
        acc, k = carry
        return (acc.index_put((my, (my - k) % n), received), k + 1), received

    (out, _), _ = ring_stream(x, axis, step_fn, (out, 0), mesh)
    return out


__all__ = ["MERGERS", "fanout", "merge", "partition_exchange", "ring_allgather", "ring_stream"]
