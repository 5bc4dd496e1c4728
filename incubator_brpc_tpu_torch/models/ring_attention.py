"""Ring attention — exact attention over the 'sp' ring, the counterpart of
``incubator_brpc_tpu/models/ring_attention.py``.

JAX runs ``ring_attention`` inside ``shard_map`` over ``sp`` devices: each
rank keeps its queries, the key/value blocks make one trip around the ring
(``lax.ppermute``), and every hop folds the held block into online-softmax
accumulators (running max ``m``, sum ``l``, weighted sum ``o``). One H100
holds all ``sp`` sequence blocks, so here the ring is a change of which
block each rank folds: at hop ``r`` rank ``i`` folds the block of rank
``(i - r) mod sp`` and no bytes move. Each hop is one launch of the K3
forward kernel for every rank, and the gradient is the K3 backward kernels
(``ops/attention.py``). The ring over several cards (send/recv between
``torch.distributed`` ranks) is a later slice.

Functions take and return the global ``(B, T, H, D)`` tensors, ``T % sp ==
0``; rank ``i`` owns rows ``[i T/sp, (i+1) T/sp)``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from incubator_brpc_tpu_torch.ops.attention import NEG_INF, RingAttentionFunction
from incubator_brpc_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = ["NEG_INF", "full_attention", "make_ring_attention_step", "ring_attention"]


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sp: int = 1,
    causal: bool = True,
    prefetch: bool = False,
) -> torch.Tensor:
    """Exact attention with the key/value blocks ringing over ``sp`` ranks
    of one card; differentiable. ``prefetch`` (JAX: emit each hop's rotation
    before the fold) is accepted and moves nothing on one card, so the
    output is bitwise that of ``prefetch=False``."""
    del prefetch  # the same folds in the same order either way
    return RingAttentionFunction.apply(q, k, v, sp, causal)


def full_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Single-device reference (the spec ``ring_attention`` must match);
    plain PyTorch, the tests' oracle, not on the main path."""
    d = q.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / torch.sqrt(
        torch.tensor(d, dtype=torch.float32, device=q.device)
    )
    t = q.shape[1]
    if causal:
        pos = torch.arange(t, device=q.device)
        s = s + torch.where(pos[None, :] <= pos[:, None], 0.0, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)


def make_ring_attention_step(
    sp: int, causal: bool = True, prefetch: bool = False, device: DeviceLike = None
) -> Tuple[Callable, Callable]:
    """``(step, place)`` like the JAX entry: ``place`` moves a global array
    (numpy or tensor) to the device, ``step(q, k, v)`` returns the global
    output. The device is the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    if sp < 1:
        raise ValueError(f"sp must be >= 1, got {sp}")

    def place(x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(dev).contiguous()

    def step(q, k, v) -> torch.Tensor:
        return ring_attention(q, k, v, sp=sp, causal=causal, prefetch=prefetch)

    return step, place
