"""K4e-a — FabricNet's SGD update over every parameter leaf in one launch,
and its plain version.

:func:`sgd_update_multi` wraps the hand-written CUDA kernel in
``csrc/update.cu``. It replaces, in ``incubator_brpc_tpu/models/fabricnet.py``,
the fused step's update ``p - cfg.lr * g`` over the parameter tree (:405)
and the sliced schedules' gradient accumulation and scaled update
(:381-391). Its modes:

- ``"fused"``: ``p = p - lr * g``;
- ``"accumulate"``: ``acc = acc + g`` (slices 1 .. M-2 of a sliced step);
- ``"last"``: ``p = p - lr * ((acc + g) * (1/M))`` (the last slice), reading
  p, acc and g once, with no separate accumulate pass.

Rounding is JAX's, which is what this module is for. ``cfg.lr`` is a weakly
typed Python float, so JAX rounds it (and ``1/M``) to the parameters' dtype:
in bfloat16 the update is ``p - round(bf16(lr) * g)``, each product and sum
rounded to bf16 where the expression has it (``bf16(0.01)`` is
0.010009765625; a learning rate kept in float32 moves about 1.7 % of the
elements by one bf16 ulp a step). In float32 XLA:CPU contracts ``p - lr *
h`` into one fused multiply-add, after folding ``lr * (1/M)`` into one
float32 constant in the last-slice form: ``fma(-lr, g, p)`` and ``fma(-f32(lr
* (1/M)), acc + g, p)``. The plain version reaches the single rounding of the
FMA through float64 (the product of two float32 values is exact there) with
the sum rounded to odd, so the rounding to float32 that follows cannot round
twice; on the card the kernel calls ``fmaf``.

Given CPU tensors the wrapper runs the plain version; given CUDA tensors it
launches the kernel on the current stream (one launch per 64 leaves) or
raises. Targets are updated in place and must be contiguous (the model
passes views of its parameters, and the accumulators it made); a gradient
that is not contiguous is copied first.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from incubator_brpc_tpu_torch.ops import kernels

MODES = {"fused": 0, "accumulate": 1, "last": 2}
MAX_LEAVES = 64  # csrc/update.cu kMaxLeaves: the leaves one launch takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def update_scalars(dtype: torch.dtype, lr: float, slices: int = 1, mode: str = "fused"
                   ) -> Tuple[float, float]:
    """``(lr, inv)`` as the update computes with them in ``dtype``: each
    rounded to the dtype; in float32's last-slice form ``lr`` is the float32
    product of the two (XLA's folded constant) and ``inv`` is unused (1)."""
    if dtype == torch.float32:
        lr32 = np.float32(lr)
        if mode == "last":
            return float(lr32 * np.float32(1.0 / slices)), 1.0
        return float(lr32), 1.0
    to = lambda v: float(torch.tensor(v, dtype=dtype))  # noqa: E731
    return to(lr), to(1.0 / slices)


def _fma_f32(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (``a`` a float32 value, ``b`` and
    ``c`` float32 tensors): the product is exact in float64, the sum is
    rounded to odd there (``s`` stepped toward the exact value where it is
    inexact and its last bit is even), and float64 keeps 29 bits more than
    float32, so the rounding to float32 is the correct one."""
    prod, c64 = b.double() * a, c.double()
    s = c64 + prod
    bv = s - c64
    err = (c64 - (s - bv)) + (prod - bv)  # s + err == c + prod exactly (TwoSum)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, np.inf), torch.full_like(s, -np.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


# -- the plain version ----------------------------------------------------------------


def sgd_update_plain(mode: str, p: torch.Tensor, g: torch.Tensor, lr: float = 0.0,
                     acc: Optional[torch.Tensor] = None, slices: int = 1) -> torch.Tensor:
    """One leaf of :func:`sgd_update_multi`, in place on ``p`` (the
    accumulator in ``"accumulate"`` mode), in PyTorch's ops; returns ``p``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "accumulate":
        return p.add_(g)
    lr_d, inv_d = update_scalars(p.dtype, lr, slices, mode)
    h = g
    if mode == "last":
        h = acc + g
        if p.dtype != torch.float32:
            h = h * inv_d
    if p.dtype == torch.float32:
        return p.copy_(_fma_f32(-lr_d, h, p))
    return p.sub_(h * lr_d)


# -- the wrapper ---------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}; want "
                         f"{like.dtype} {tuple(like.shape)} on {like.device}")


def sgd_update_multi(mode: str, targets: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                     lr: float = 0.0, acc: Optional[Sequence[torch.Tensor]] = None,
                     slices: int = 1) -> None:
    """K4e-a over the leaves ``targets[i]`` (parameters, or the accumulators
    in ``"accumulate"`` mode), each with ``grads[i]`` and, in ``"last"``
    mode, ``acc[i]`` of ``slices`` slices. All of one dtype (float32 or
    bfloat16) and one device."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if len(grads) != len(targets) or (mode == "last") != (acc is not None) or (
            acc is not None and len(acc) != len(targets)):
        raise ValueError(f"{mode}: {len(targets)} targets, {len(grads)} gradients, "
                         f"{None if acc is None else len(acc)} accumulators")
    if mode == "last" and slices < 2:
        raise ValueError("the last slice's update takes slices >= 2")
    if not targets:
        return
    first = targets[0]
    for i, p in enumerate(targets):
        if not isinstance(p, torch.Tensor) or p.dtype != first.dtype or p.device != first.device:
            raise ValueError(f"targets[{i}]: want {first.dtype} tensors on {first.device}")
        _check(f"grads[{i}]", grads[i], p)
        if acc is not None:
            _check(f"acc[{i}]", acc[i], p)
    if first.device.type == "cpu":
        for i, p in enumerate(targets):
            sgd_update_plain(mode, p, grads[i], lr, None if acc is None else acc[i], slices)
        return
    if first.dtype not in _DTYPES:
        raise TypeError(f"sgd_update_multi takes float32 or bfloat16, not {first.dtype}")
    if not all(t.is_contiguous() for t in list(targets) + list(acc or ())):
        raise ValueError("sgd_update_multi updates in place: targets and accumulators must "
                         "be contiguous")
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    lr_d, inv_d = update_scalars(first.dtype, lr, slices, mode)
    live = [i for i, p in enumerate(targets) if p.numel()]
    lib = kernels.build()
    for k in range(0, len(live), MAX_LEAVES):
        idx = live[k:k + MAX_LEAVES]
        ptrs = lambda ts: (ctypes.c_void_p * len(idx))(*(ts[i].data_ptr() for i in idx))  # noqa: E731
        sizes = (ctypes.c_int64 * len(idx))(*(targets[i].numel() for i in idx))
        with torch.cuda.device(first.device):
            rc = lib.tb_sgd_update_multi(
                ptrs(targets), ptrs(grads), None if acc is None else ptrs(acc), sizes, len(idx),
                MODES[mode], _DTYPES[first.dtype], lr_d, inv_d, kernels._stream(first.device))
        kernels._check_launch(lib, rc, "sgd_update_multi")
        kernels._count("sgd_update_multi")


def launches(leaves: int) -> int:
    """Launches of one :func:`sgd_update_multi` call over ``leaves``
    non-empty leaves."""
    return -(-leaves // MAX_LEAVES)


__all__ = ["MAX_LEAVES", "MODES", "launches", "sgd_update_multi", "sgd_update_plain",
           "update_scalars"]
