"""K4 — FabricNet's elementwise chain (the residual add with the RMS norm
after it, and the tanh GeLU, forward and backward) — and K4e-b/c/d (the
MoE's gate and combine with the last residual add, its gradient, and the
loss with its gradient), and their plain versions.

The wrappers over the hand-written CUDA kernels in ``csrc/elementwise.cu``:

- :func:`add_rms_norm_fwd` (K4a) replaces, in
  ``incubator_brpc_tpu/models/fabricnet.py``, a residual add of ``_stage_fn``
  (:193-209) together with the ``_rms_norm`` (:119) that reads its sum:
  ``s = x + delta`` in x's dtype, then ``n = s * rsqrt(mean(s^2) + 1e-6)``
  over the last dimension. It also writes each row's ``rstd``, the rsqrt
  in float32, for the backward.
- :func:`rms_norm_bwd` (K4b) replaces the gradient JAX takes through
  ``_rms_norm``: ``g = r g_n - (r^3 / d) s sum(g_n s)``, plus the residual
  stream's own gradient ``g_s``, all in float32 and rounded once.
- :func:`gelu_tanh_fwd` (K4c) replaces ``_gelu`` (:123): ``jax.nn.gelu``'s
  tanh form in float32, rounded once to x's dtype.
- :func:`gelu_tanh_bwd` (K4d) replaces its gradient.
- :func:`moe_combine_fwd` (K4e-b) replaces ``_moe``'s ``sigmoid(tokens @
  gate_w)`` and ``ungrouped * g`` (:164, :175) with ``_stage_fn``'s last
  residual add (:208): ``g = sigmoid(logit)`` and ``out[r] = s[r] + yr[r %
  e, r // e] * g[r]``, reading the experts' output ``yr`` in its expert
  layout ``(e, t / e, d)``, so no copy regroups it. The gate's product with
  ``gate_w`` stays ``torch.matmul``.
- :func:`moe_combine_bwd` (K4e-c) replaces its gradient: ``d_yr = dy * g``,
  written in the expert layout for the ``bmm``'s backward, and ``d_logit``,
  the row sum of ``dy * yr`` through the sigmoid's gradient; ``d_s`` is
  ``dy`` itself, with no launch.
- :func:`mse_loss_fwd` (K4e-d) replaces ``_local_loss``'s ``mean((out -
  y)^2)`` (:266-268, :281) and writes, in the same pass, the gradient of
  ``out`` for d(loss) = 1, bitwise what autograd gives through the plain
  expression. The train step starts its backward from that gradient, so the
  loss needs no ``autograd.Function`` (whose backward would have to multiply
  by d(loss) in a launch of its own, or read it on the host).

XLA fuses each of these into the matrix products' neighbours inside one
``jax.jit``; PyTorch runs eagerly, so here each is one pass over its rows,
bound by bytes (a few operations per element read). A wrapper given CPU
tensors runs the plain PyTorch version beside it; given CUDA tensors it
launches the kernel on the current stream or raises. Nothing on the card's
path calls a plain version. :class:`AddRMSNormFunction` and
:class:`GeluFunction` are the ``torch.autograd.Function``s around them, and
:func:`add_rms_norm` and :func:`gelu` what the model calls;
:class:`MoECombineFunction` and :func:`moe_combine` likewise for K4e-b/c.

The kernels take float32 and bfloat16, any width (odd ones too: 16-byte
loads where a row's addresses allow, single elements where they do not) and
any row-major tensor whose last dimension is dense; another layout is
copied first. The plain versions also take float64 (computing in it), for
``torch.autograd.gradcheck``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from incubator_brpc_tpu_torch.ops import kernels

EPS = 1e-6
# PyTorch's tanh GeLU constants, as its kernels form them: sqrt(2) * 2/sqrt(pi)
# * 0.5 rounded once to float32, and 0.044715 in float32
GELU_BETA = float(np.float32(np.sqrt(2.0) * (2.0 / np.sqrt(np.pi)) * 0.5))
GELU_KAPPA = float(np.float32(0.044715))
GELU_KAPPA3 = float(np.float32(3.0) * np.float32(0.044715))

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# |kernel - plain| <= tol * max(1, max |plain|) on the card (chip_smoke.py and
# tests/test_torch_cuda.py hold the kernels to these).
# K4a/K4b: float32 results within 1e-5 (the row sums run in another order, a
# few float32 ulps of the mean or of sum(g_n s), halved by the rsqrt);
# bfloat16 results within 2^-6, two bf16 ulps: the sum's order can move the
# mean of squares across a bf16 rounding, hence rsqrt's bf16 value by one
# ulp, and the output's own rounding adds one more.
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
# K4c: the same formula and tanhf as PyTorch's kernel, so bitwise unless
# nvcc contracts another multiply-add into an FMA than PyTorch's build did:
# float32 within 1e-6, bfloat16 within one bf16 ulp (2^-7), and the count of
# differing elements is reported.
GELU_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}
# K4d: float32 within 1e-5 (FMA contraction and tanhf against the plain
# version's separate ops, near 1 - tanh^2's cancellation); bfloat16 within one
# rounding of the float32 result to bf16 (2^-7).
GELU_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# K4e-b/c: the gate (the same 1 / (1 + expf(-x)) as PyTorch's sigmoid), out
# and d_yr are the plain version's expressions, elementwise, with every
# rounding explicit, and are held bit for bit; d_logit's row sum runs in
# another order: float32 within 1e-5, and bfloat16 within 2^-6, two bf16
# ulps (the sum's order can move its bf16 rounding by one ulp, and the
# sigmoid's gradient rounds once more). The count of differing elements is
# reported.
MOE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
# K4e-d: d_out is elementwise and held bit for bit; the loss sums its
# squares in another order (and PyTorch's mean on the card multiplies by
# 1/n where this divides by n): float32 within 1e-5, bfloat16 within one
# rounding of the float32 mean (2^-7).
MSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


# csrc/elementwise.cu: at most 512 threads a row, and kHold, the pieces of a
# row (16-byte vectors, or single elements where the row's pointers do not
# allow a vector) that a thread of add_rms_norm_fwd keeps in registers, so
# that it reads the row once
MAX_NORM_THREADS = 512
NORM_HOLD = 4


def add_rms_norm_reads_once(d: int, dtype: torch.dtype, head: int = 0) -> bool:
    """Whether ``add_rms_norm_fwd`` keeps a row of width ``d`` in registers
    (reads it once) rather than reading it a second time: a row whose
    pointers share one 16-byte phase, ``head`` elements before the first
    16-byte boundary, is ``head`` single elements, its vectors, and the
    tail's single elements; a row whose pointers disagree (``head = d``) is
    all single elements. It does when these pieces are at most
    ``NORM_HOLD`` x ``MAX_NORM_THREADS`` (the kernel takes the launch's
    row with the most pieces)."""
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    head = min(head, d)
    return d - (d - head) // vec * (vec - 1) <= NORM_HOLD * MAX_NORM_THREADS


def _acc(dtype: torch.dtype) -> torch.dtype:
    """What the plain versions compute in: float32, or float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


# -- plain versions ---------------------------------------------------------------


def add_rms_norm_plain(
    x: torch.Tensor, delta: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(s, n, rstd)``: ``s = x + delta`` rounded to x's dtype (``x`` itself
    without ``delta``), and ``n`` the RMS norm of ``s`` in JAX's order: the
    square in s's dtype, the mean summed and divided in float32 and rounded
    to s's dtype, then the ``+ 1e-6`` and ``rsqrt`` in s's dtype, whose value
    ``rstd`` keeps per row in float32."""
    s = x if delta is None else x + delta
    ms = (s * s).mean(dim=-1, keepdim=True, dtype=_acc(s.dtype)).to(s.dtype)
    r = torch.rsqrt(ms + EPS)
    return s, s * r, r.squeeze(-1).to(_acc(s.dtype))


def rms_norm_bwd_plain(
    s: torch.Tensor, rstd: torch.Tensor, g_n: torch.Tensor, g_s: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The gradient of ``n = s * r`` with ``r = rsqrt(mean(s^2) + eps)``,
    plus ``g_s``: ``r g_n - (r^3 / d) s sum(g_n s)`` with the row sum, and
    everything else, in float32, rounded once to s's dtype."""
    acc = _acc(s.dtype)
    sf, gf = s.to(acc), g_n.to(acc)
    r = rstd.to(acc).unsqueeze(-1)
    dot = (gf * sf).sum(dim=-1, keepdim=True)
    c = r * r * r * (dot / s.shape[-1])
    g = r * gf - c * sf
    if g_s is not None:
        g = g + g_s.to(acc)
    return g.to(s.dtype)


def gelu_plain(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form, its default) in float32, cast back."""
    return F.gelu(x.to(_acc(x.dtype)), approximate="tanh").to(x.dtype)


def gelu_bwd_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``dy * gelu'(x)`` for the tanh form, in float32 and in the order of
    PyTorch's own GeLU backward, rounded once to x's dtype."""
    acc = _acc(x.dtype)
    xf = x.to(acc)
    x_sq = xf * xf
    t = torch.tanh(GELU_BETA * (xf + GELU_KAPPA * (x_sq * xf)))
    left = 0.5 * xf
    left_derivative = 0.5 * (1 + t)
    right_derivative = left * (1 - t * t) * (GELU_BETA * (1 + GELU_KAPPA3 * x_sq))
    return (dy.to(acc) * (left_derivative + right_derivative)).to(x.dtype)


def _routed(yr: torch.Tensor) -> torch.Tensor:
    """The experts' output ``(e, t / e, d)`` as token rows ``(t, d)``: token
    ``r`` is row ``r // e`` of expert ``r % e`` (a copy)."""
    e, per, d = yr.shape
    return yr.transpose(0, 1).reshape(e * per, d)


def moe_combine_plain(s: torch.Tensor, yr: torch.Tensor, logit: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, g)``: ``g = sigmoid(logit)`` and ``out = s + routed * g``, in
    the dtype's ops as the model wrote them before K4e (``routed`` the
    experts' output in token order)."""
    g = torch.sigmoid(logit)
    return s + _routed(yr) * g, g


def moe_combine_bwd_plain(dy: torch.Tensor, yr: torch.Tensor, g: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(d_yr, d_logit)``, the gradients autograd takes through
    :func:`moe_combine_plain`: ``dy * g`` back in the expert layout, and
    ``sigmoid_backward(sum_d(dy * routed), g)``, the products rounded to the
    dtype and summed in float32."""
    e, per, d = yr.shape
    d_routed = dy * g
    d_g = (dy * _routed(yr)).sum(dim=-1, keepdim=True)
    return (d_routed.reshape(per, e, d).transpose(0, 1),
            torch.ops.aten.sigmoid_backward(d_g, g))


def mse_grad_scale(n: int, dtype: torch.dtype) -> float:
    """The gradient reaching each square of a mean over ``n`` elements for
    d(loss) = 1: ``1 / n`` in float32, rounded to the dtype."""
    return float(torch.tensor(np.float32(1.0) / np.float32(n)).to(dtype))


def mse_loss_plain(out: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, d_out)``: ``mean((out - y)^2)`` with the difference and its
    square in the dtype, summed in float32 and rounded to the dtype
    (``jnp.mean``), and its gradient for d(loss) = 1, ``(1/n) * (2 diff)``
    as autograd and ``jax.grad`` round it."""
    diff = out - y
    loss = diff.square().mean(dtype=_acc(out.dtype)).to(out.dtype)
    return loss, (diff * 2.0) * mse_grad_scale(diff.numel(), out.dtype)


# -- wrappers -----------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, like: Optional[torch.Tensor] = None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if not t.is_floating_point() or t.dim() < 1:
        raise TypeError(f"{name}: {t.dtype} {tuple(t.shape)}; want a floating tensor of >= 1 dims")
    if like is not None:
        if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}; want "
                             f"{like.dtype} {tuple(like.shape)} on {like.device}")


def _card(*tensors: Optional[torch.Tensor]):
    """The tensors as the kernels read them: float32 or bfloat16, row-major
    (another layout is copied; an offset into a buffer is kept)."""
    for t in tensors:
        if t is not None and t.dtype not in _DTYPES:
            raise TypeError(f"the K4 kernels take float32 or bfloat16, not {t.dtype}")
    return tuple(None if t is None else t if t.is_contiguous() else t.contiguous()
                 for t in tensors)


def add_rms_norm_fwd(
    x: torch.Tensor, delta: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4a. ``(s, n, rstd)`` as :func:`add_rms_norm_plain` gives them, over
    the last dimension; ``s`` is ``x`` itself without ``delta``. On the card
    a row is read once where :func:`add_rms_norm_reads_once` says so, else
    twice; the results are the same."""
    _check("x", x)
    if delta is not None:
        _check("delta", delta, x)
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, delta)
    x, delta = _card(x, delta)
    d, rows = x.shape[-1], math.prod(x.shape[:-1])
    s = x if delta is None else torch.empty_like(x)
    n = torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if rows == 0:
        return s, n, rstd
    lib = kernels.build()
    with torch.cuda.device(x.device):
        rc = lib.tb_add_rms_norm_fwd(
            x.data_ptr(), kernels._ptr(delta), None if delta is None else s.data_ptr(),
            n.data_ptr(), rstd.data_ptr(), rows, d, _DTYPES[x.dtype], kernels._stream(x.device))
    kernels._check_launch(lib, rc, "add_rms_norm_fwd")
    kernels._count("add_rms_norm_fwd")
    return s, n, rstd


def rms_norm_bwd(
    s: torch.Tensor, rstd: torch.Tensor, g_n: torch.Tensor, g_s: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K4b. The gradient reaching ``s`` of :func:`add_rms_norm_fwd`: the
    norm's, from ``g_n``, plus ``g_s`` when given."""
    _check("s", s)
    _check("g_n", g_n, s)
    if g_s is not None:
        _check("g_s", g_s, s)
    if rstd.shape != s.shape[:-1] or rstd.dtype != _acc(s.dtype) or rstd.device != s.device:
        raise ValueError(f"rstd: {rstd.dtype} {tuple(rstd.shape)}; want {_acc(s.dtype)} "
                         f"{tuple(s.shape[:-1])} on {s.device}")
    if s.device.type == "cpu":
        return rms_norm_bwd_plain(s, rstd, g_n, g_s)
    s, g_n, g_s, rstd = _card(s, g_n, g_s, rstd)
    d, rows = s.shape[-1], math.prod(s.shape[:-1])
    g = torch.empty_like(s)
    if rows == 0:
        return g
    lib = kernels.build()
    with torch.cuda.device(s.device):
        rc = lib.tb_rms_norm_bwd(
            s.data_ptr(), rstd.data_ptr(), g_n.data_ptr(), kernels._ptr(g_s), g.data_ptr(),
            rows, d, _DTYPES[s.dtype], kernels._stream(s.device))
    kernels._check_launch(lib, rc, "rms_norm_bwd")
    kernels._count("rms_norm_bwd")
    return g


def _elementwise(name: str, x: torch.Tensor, *more: torch.Tensor) -> torch.Tensor:
    """Launch K4c or K4d over the elements of x (and dy): one output like x."""
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    lib = kernels.build()
    with torch.cuda.device(out.device):
        rc = getattr(lib, f"tb_{name}")(x.data_ptr(), *(t.data_ptr() for t in more),
                                        out.data_ptr(), out.numel(), _DTYPES[out.dtype],
                                        kernels._stream(out.device))
    kernels._check_launch(lib, rc, name)
    kernels._count(name)
    return out


def gelu_tanh_fwd(x: torch.Tensor) -> torch.Tensor:
    """K4c. :func:`gelu_plain`: the tanh GeLU in float32, one rounding out."""
    _check("x", x)
    if x.device.type == "cpu":
        return gelu_plain(x)
    (x,) = _card(x)
    return _elementwise("gelu_tanh_fwd", x)


def gelu_tanh_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K4d. :func:`gelu_bwd_plain`: ``dy * gelu'(x)`` in float32, one
    rounding out."""
    _check("x", x)
    _check("dy", dy, x)
    if x.device.type == "cpu":
        return gelu_bwd_plain(x, dy)
    x, dy = _card(x, dy)
    return _elementwise("gelu_tanh_bwd", x, dy)


def _moe_shapes(name: str, rows: torch.Tensor, yr: torch.Tensor, gate: torch.Tensor) -> None:
    """``rows`` ``(t, d)``, ``yr`` ``(e, t / e, d)`` and ``gate`` ``(t, 1)``,
    one dtype and device."""
    _check(name, rows)
    _check("yr", yr)
    _check("gate", gate)
    t, d = rows.shape if rows.dim() == 2 else (-1, -1)
    if yr.dim() != 3 or yr.shape[0] * yr.shape[1] != t or yr.shape[2] != d or (
            tuple(gate.shape) != (t, 1)):
        raise ValueError(f"{name} {tuple(rows.shape)}, yr {tuple(yr.shape)}, gate "
                         f"{tuple(gate.shape)}: want (t, d), (e, t / e, d) and (t, 1)")
    for n, x in (("yr", yr), ("gate", gate)):
        if x.dtype != rows.dtype or x.device != rows.device:
            raise ValueError(f"{n}: {x.dtype} on {x.device}; want {rows.dtype} on {rows.device}")


def moe_combine_fwd(s: torch.Tensor, yr: torch.Tensor, logit: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4e-b. ``(out, g)`` as :func:`moe_combine_plain` gives them: ``s``
    ``(t, d)``, the experts' output ``yr`` ``(e, t / e, d)``, the gate's
    logit ``(t, 1)``."""
    _moe_shapes("s", s, yr, logit)
    if s.device.type == "cpu":
        return moe_combine_plain(s, yr, logit)
    s, yr, logit = _card(s, yr, logit)
    out, g = torch.empty_like(s), torch.empty_like(logit)
    (t, d), e = s.shape, yr.shape[0]
    if out.numel() == 0:
        return out, g
    lib = kernels.build()
    with torch.cuda.device(s.device):
        rc = lib.tb_moe_combine_fwd(s.data_ptr(), yr.data_ptr(), logit.data_ptr(), out.data_ptr(),
                                    g.data_ptr(), t, d, e, _DTYPES[s.dtype],
                                    kernels._stream(s.device))
    kernels._check_launch(lib, rc, "moe_combine_fwd")
    kernels._count("moe_combine_fwd")
    return out, g


def moe_combine_bwd(dy: torch.Tensor, yr: torch.Tensor, g: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4e-c. ``(d_yr, d_logit)`` as :func:`moe_combine_bwd_plain` gives
    them, ``d_yr`` contiguous in the expert layout."""
    _moe_shapes("dy", dy, yr, g)
    if dy.device.type == "cpu":
        return moe_combine_bwd_plain(dy, yr, g)
    dy, yr, g = _card(dy, yr, g)
    d_yr, d_logit = torch.empty_like(yr), torch.empty_like(g)
    (t, d), e = dy.shape, yr.shape[0]
    if dy.numel() == 0:
        return d_yr, d_logit
    lib = kernels.build()
    with torch.cuda.device(dy.device):
        rc = lib.tb_moe_combine_bwd(dy.data_ptr(), yr.data_ptr(), g.data_ptr(), d_yr.data_ptr(),
                                    d_logit.data_ptr(), t, d, e, _DTYPES[dy.dtype],
                                    kernels._stream(dy.device))
    kernels._check_launch(lib, rc, "moe_combine_bwd")
    kernels._count("moe_combine_bwd")
    return d_yr, d_logit


def mse_loss_fwd(out: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4e-d. ``(loss, d_out)`` as :func:`mse_loss_plain` gives them: the
    loss a 0-d tensor of out's dtype, ``d_out`` shaped like ``out``. The
    loss adds the blocks' partial sums in block order, so a rerun repeats
    it bit for bit."""
    _check("out", out)
    _check("y", y, out)
    if out.device.type == "cpu":
        return mse_loss_plain(out, y)
    out, y = _card(out, y)
    n = out.numel()
    if n == 0:
        raise ValueError("mse_loss_fwd: the mean of no elements")
    loss = torch.empty((), dtype=out.dtype, device=out.device)
    d_out = torch.empty_like(out)
    lib = kernels.build()
    partial = torch.empty(lib.tb_mse_loss_blocks(n, _DTYPES[out.dtype]), dtype=torch.float32,
                          device=out.device)
    with torch.cuda.device(out.device):
        rc = lib.tb_mse_loss_fwd(out.data_ptr(), y.data_ptr(), d_out.data_ptr(),
                                 partial.data_ptr(), loss.data_ptr(), n,
                                 mse_grad_scale(n, out.dtype), _DTYPES[out.dtype],
                                 kernels._stream(out.device))
    kernels._check_launch(lib, rc, "mse_loss_fwd")
    kernels._count("mse_loss_fwd")
    return loss, d_out


# -- autograd -------------------------------------------------------------------------


class AddRMSNormFunction(torch.autograd.Function):
    """``(s, n)`` of :func:`add_rms_norm_fwd`, or ``n`` alone without
    ``delta``. Saves ``s`` and ``rstd``; the backward folds the gradient that
    reaches ``s`` from the residual stream (``g_s``) into K4b's single
    rounding, and gives the sum to both ``x`` and ``delta``."""

    @staticmethod
    def forward(ctx, x, delta):
        s, n, rstd = add_rms_norm_fwd(x, delta)
        ctx.save_for_backward(s, rstd)
        ctx.set_materialize_grads(False)
        ctx.has_delta = delta is not None
        return (s, n) if ctx.has_delta else n

    @staticmethod
    def backward(ctx, *grads):
        g_s, g_n = grads if ctx.has_delta else (None, grads[0])
        g = g_s if g_n is None else rms_norm_bwd(*ctx.saved_tensors, g_n, g_s)
        return g, g if ctx.has_delta else None


class GeluFunction(torch.autograd.Function):
    """:func:`gelu_tanh_fwd`, with :func:`gelu_tanh_bwd` as its backward.
    Saves x in its own dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return gelu_tanh_fwd(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return gelu_tanh_bwd(x, dy)


class MoECombineFunction(torch.autograd.Function):
    """``out`` of :func:`moe_combine_fwd`, with :func:`moe_combine_bwd` as
    its backward; ``s``'s gradient is ``dy`` itself. Saves ``yr`` and the
    gate ``g``."""

    @staticmethod
    def forward(ctx, s, yr, logit):
        out, g = moe_combine_fwd(s, yr, logit)
        ctx.save_for_backward(yr, g)
        return out

    @staticmethod
    def backward(ctx, dy):
        d_yr, d_logit = moe_combine_bwd(dy, *ctx.saved_tensors)
        return dy, d_yr, d_logit


def add_rms_norm(
    x: torch.Tensor, delta: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s, n)``: the residual sum ``x + delta`` (``x`` without ``delta``)
    and its RMS norm, differentiable."""
    if delta is None:
        return x, AddRMSNormFunction.apply(x, None)
    return AddRMSNormFunction.apply(x, delta)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh GeLU, differentiable."""
    return GeluFunction.apply(x)


def moe_combine(s: torch.Tensor, yr: torch.Tensor, logit: torch.Tensor) -> torch.Tensor:
    """``s + routed(yr) * sigmoid(logit)``, differentiable."""
    return MoECombineFunction.apply(s, yr, logit)


__all__ = [
    "AddRMSNormFunction",
    "GeluFunction",
    "GELU_BWD_TOL",
    "GELU_TOL",
    "MOE_TOL",
    "MSE_TOL",
    "MoECombineFunction",
    "NORM_HOLD",
    "NORM_TOL",
    "add_rms_norm",
    "add_rms_norm_fwd",
    "add_rms_norm_plain",
    "add_rms_norm_reads_once",
    "gelu",
    "gelu_bwd_plain",
    "gelu_plain",
    "gelu_tanh_bwd",
    "gelu_tanh_fwd",
    "moe_combine",
    "moe_combine_bwd",
    "moe_combine_bwd_plain",
    "moe_combine_fwd",
    "moe_combine_plain",
    "mse_grad_scale",
    "mse_loss_fwd",
    "mse_loss_plain",
    "rms_norm_bwd",
    "rms_norm_bwd_plain",
]
