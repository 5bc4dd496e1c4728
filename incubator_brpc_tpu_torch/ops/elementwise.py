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
  ``_rms_norm``, with the residual stream's own gradient ``g_s`` added where
  the train step adds it: ``(g_s + g_n k) + ((sum(s g_n) m) / d) (2 s)``
  with ``k`` the forward's rsqrt, ``j = mean(s^2) + eps`` and ``m = -0.5 k
  / j``, in the order of ``jax.vjp``'s jaxpr.
- :func:`gelu_tanh_fwd` (K4c) replaces ``_gelu`` (:123): ``jax.nn.gelu``'s
  tanh form, ``x (0.5 (1 + tanh(beta (x + kappa x^3))))``.
- :func:`gelu_tanh_bwd` (K4d) replaces its gradient, the chain of
  ``jax.vjp(_gelu)``'s jaxpr.
- :func:`moe_combine_fwd` (K4e-b) replaces ``_moe``'s ``sigmoid(tokens @
  gate_w)`` and ``ungrouped * g`` (:164, :175) with ``_stage_fn``'s last
  residual add (:208): ``g = 1 / (1 + exp(-logit))`` (``jax.nn.sigmoid``
  as XLA expands it) and ``out[r] = s[r] + yr[r % e, r // e] * g[r]``,
  reading the experts' output ``yr`` in its expert layout ``(e, t / e,
  d)``, so no copy regroups it. The gate's product with ``gate_w`` stays
  ``torch.matmul``.
- :func:`moe_combine_bwd` (K4e-c) replaces its gradient: ``d_yr = dy * g``,
  written in the expert layout for the ``bmm``'s backward, and ``d_logit =
  sum_d(yr dy) (g (1 - g))``; ``d_s`` is ``dy`` itself, with no launch.
- :func:`mse_loss_fwd` (K4e-d) replaces ``_local_loss``'s ``mean((out -
  y)^2)`` (:266-268, :281) and writes, in the same pass, the gradient of
  ``out`` for d(loss) = 1, bitwise what autograd gives through the plain
  expression. The train step starts its backward from that gradient, so the
  loss needs no ``autograd.Function`` (whose backward would have to multiply
  by d(loss) in a launch of its own, or read it on the host).
- :func:`ring_mean_add_fwd` (K4f) replaces, with ``heads = 0``,
  ``_stage_fn``'s last MLP residual add and ``x + _ring_context(x)``
  (:138, :205-207) on one rank of the sp ring: ``s = x + delta``, the
  sequence mean ``m = mean_T(s)`` (summed in float32 from ``x + delta``
  before its rounding, as XLA:CPU sums it, times ``1 / T`` as XLA divides
  by a constant, rounded to the dtype as ``jnp.mean`` converts), and ``s +
  m`` broadcast over the sequence; only that sum is written.
  :func:`ring_mean_add_bwd` replaces its gradient, ``g + c`` with ``c``
  the sum of ``g`` over the sequence (in the dtype, as the vjp's
  ``reduce_sum`` runs) times ``1 / T`` in float32, rounded; it reaches
  both ``x`` and ``delta``. Over an sp ring (``sp > 1``, the sequence the
  ranks' blocks of ``T / sp`` rows in rank order) each block takes its own
  mean, rank ``i`` folds the ranks' means around the ring in its own order
  (``((0 + m_i) + m_{i-1}) + ...``, each add rounded to the dtype, as
  ``ring_stream`` forms it) and multiplies by ``1 / sp`` in float32,
  rounded; the gradient is the transposed ring over the blocks' sums. From
  sp = 3 on the ranks' orders differ in the last bit; each rank keeps its
  own.

The reference rounds op by op: in bfloat16 every elementwise op of these
chains (each multiply, add, tanh, exp and divide) rounds its result to
bfloat16, with JAX's weakly typed constants rounded to bfloat16 too
(0.044677734375, 0.796875, the norm's eps 9.98377799987793e-07). The plain
versions state each chain op by op in the operands' dtype, so a bfloat16
tensor rounds where XLA rounds and a float32 one follows the same order;
the kernels round where the plain versions do. Two row sums are the
port's own: the norm's ``sum(s g_n)`` and the combine's ``sum_d(yr dy)``
(and the norm's ``sum(s^2)``, recomputed), which the reference takes in
bfloat16 in XLA:CPU's window order (float32 for ``sum(s^2)``), are summed
in float64 and rounded to float32, then where the reference rounds the
sum (:func:`_row_sum`): exact for rows whose terms span fewer than about
2^34 in magnitude, so the kernels' order and the plain versions' give the
same bits (ROADMAP, "Differences by design", has the distance from JAX).
K4f's sums over the sequence follow the same convention.

XLA fuses each of these into the matrix products' neighbours inside one
``jax.jit``; PyTorch runs eagerly, so here each is one pass over its rows,
bound by bytes (a few operations per element read). A wrapper given CPU
tensors runs the plain PyTorch version beside it; given CUDA tensors it
launches the kernel on the current stream or raises. Nothing on the card's
path calls a plain version. :class:`AddRMSNormFunction` and
:class:`GeluFunction` are the ``torch.autograd.Function``s around them, and
:func:`add_rms_norm` and :func:`gelu` what the model calls;
:class:`MoECombineFunction` and :func:`moe_combine` likewise for K4e-b/c,
:class:`RingMeanAddFunction` and :func:`ring_mean_add` for K4f.

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

from incubator_brpc_tpu_torch.ops import kernels

EPS = 1e-6
# jax.nn.gelu's constants: 0.044715 and sqrt(2 / pi), which JAX rounds to the
# operands' dtype (in bfloat16 0.044677734375 and 0.796875)
GELU_KAPPA = 0.044715
GELU_BETA = math.sqrt(2.0 / math.pi)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# |kernel - plain| <= tol * max(1, max |plain|) on the card (chip_smoke.py and
# tests/test_torch_cuda.py hold K4a to these): float32 results within 1e-5
# (the row sum runs in another order, a few float32 ulps of the mean, halved
# by the rsqrt); bfloat16 results within 2^-6, two bf16 ulps: the sum's order
# can move the mean of squares across a bf16 rounding, hence rsqrt's bf16
# value by one ulp, and the output's own rounding adds one more.
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
# K4b, K4c, K4d and K4e-b/c are held bit for bit against their plain versions
# on the card: the same ops in the same order, each rounded alike, and row
# sums exact in float64. The outputs that pass through a tanhf or expf (the
# GeLU, its gradient, the gate and out) may differ where the card's tanhf or
# expf and the plain version's differ in the last float32 bit: such elements
# are counted and allowed this many ulps of their dtype.
TRANSCENDENTAL_ULPS = 1
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
    """What the plain versions' sums are rounded to, and where the reference
    divides a bfloat16 sum: float32, or float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def _const(value: float, dtype: torch.dtype) -> float:
    """``value`` as JAX rounds a weakly typed Python float to ``dtype``."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def _reciprocal(d: int, dtype: torch.dtype) -> float:
    """``1 / d`` rounded to ``dtype``: XLA divides by a constant ``d`` as a
    multiply by it, and so does ``add_rms_norm_fwd`` for the mean."""
    return float(torch.tensor(1.0, dtype=dtype) / torch.tensor(float(d), dtype=dtype))


def _row_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The sum over ``dim`` (the last dimension), kept: summed in float64 and
    rounded once to :func:`_acc`'s dtype. Exact, so any order gives it, for
    rows whose terms span fewer than about 2^34 (bfloat16) or 2^18
    (float32) in magnitude; beyond, within half a float64 ulp of the row's
    largest partial sum."""
    return x.sum(dim=dim, keepdim=True, dtype=torch.float64).to(_acc(x.dtype))


# -- plain versions ---------------------------------------------------------------


def add_rms_norm_plain(
    x: torch.Tensor, delta: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(s, n, rstd)``: ``s = x + delta`` rounded to x's dtype (``x`` itself
    without ``delta``), and ``n`` the RMS norm of ``s`` in JAX's order: the
    square in s's dtype, the mean summed and divided in float32 and rounded
    to s's dtype, then the ``+ eps`` (1e-6 in s's dtype) and ``rsqrt`` in
    s's dtype, whose value ``rstd`` keeps per row in float32."""
    s = x if delta is None else x + delta
    ms = (s * s).mean(dim=-1, keepdim=True, dtype=_acc(s.dtype)).to(s.dtype)
    r = torch.rsqrt(ms + _const(EPS, s.dtype))
    return s, s * r, r.squeeze(-1).to(_acc(s.dtype))


def rms_norm_bwd_plain(
    s: torch.Tensor, rstd: torch.Tensor, g_n: torch.Tensor, g_s: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The gradient of ``n = s * k`` with ``k = rsqrt(j)``, ``j = mean(s^2) +
    eps``, plus ``g_s``, as jitted ``jax.vjp`` of ``_rms_norm`` inside the
    train step takes it, every op in s's dtype (rounded to bfloat16 for
    bfloat16): ``k`` the forward's ``rstd``; ``j`` recomputed from ``s`` as
    the forward formed it (squares in s's dtype, summed, times ``1 / d`` in
    float32, rounded, ``+ eps``); ``m = -0.5 (k / j)``; ``w = sum(s g_n) m``
    with the products in s's dtype and the row sum by :func:`_row_sum`
    rounded to s's dtype, ``w`` kept in float32 (XLA drops the jaxpr's
    rounding of ``w`` before its conversion to float32; for bfloat16 the
    product is exact); ``w / d`` as XLA forms it, ``w`` times ``1 / d`` in
    float32, rounded, times ``2 s``; then ``(g_s + g_n k) + that``."""
    dt, d = s.dtype, s.shape[-1]
    acc, inv_d = _acc(dt), _reciprocal(d, _acc(dt))
    k = rstd.to(dt).unsqueeze(-1)
    j = (_row_sum(s * s) * inv_d).to(dt) + _const(EPS, dt)
    m = -0.5 * (k / j)
    w = _row_sum(s * g_n).to(dt).to(acc) * m.to(acc)
    g = g_n * k
    if g_s is not None:
        g = g_s + g
    return g + (w * inv_d).to(dt) * (2.0 * s)


def gelu_plain(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form, its default) op by op in x's dtype
    with its constants rounded to it: ``x (0.5 (1 + tanh(beta (x + kappa
    (x (x x))))))``; in bfloat16 each op rounds to bfloat16."""
    kappa, beta = _const(GELU_KAPPA, x.dtype), _const(GELU_BETA, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(beta * (x + kappa * (x * (x * x))))))


def gelu_bwd_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``jax.vjp(_gelu)`` at ``x`` applied to ``dy``, op by op in x's dtype
    in the order of its jaxpr: ``i = tanh(beta (x + kappa x^3))``, ``p =
    (0.5 (x dy)) (1 - i)``, ``s = beta (p + p i)``, then ``(dy (0.5 (1 +
    i)) + s) + (kappa s) (3 x^2)``."""
    kappa, beta = _const(GELU_KAPPA, x.dtype), _const(GELU_BETA, x.dtype)
    i = torch.tanh(beta * (x + kappa * (x * (x * x))))
    p = (0.5 * (x * dy)) * (1.0 - i)
    s = beta * (p + p * i)
    return (dy * (0.5 * (1.0 + i)) + s) + (kappa * s) * (3.0 * (x * x))


def _routed(yr: torch.Tensor) -> torch.Tensor:
    """The experts' output ``(e, t / e, d)`` as token rows ``(t, d)``: token
    ``r`` is row ``r // e`` of expert ``r % e`` (a copy)."""
    e, per, d = yr.shape
    return yr.transpose(0, 1).reshape(e * per, d)


def _logistic(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA expands it, ``1 / (1 + exp(-x))``, op by op
    in x's dtype."""
    return torch.reciprocal(1.0 + torch.exp(-x))


def moe_combine_plain(s: torch.Tensor, yr: torch.Tensor, logit: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, g)``: ``g = 1 / (1 + exp(-logit))`` and ``out = s + routed *
    g`` (``routed`` the experts' output in token order), op by op in the
    dtype as ``_moe`` and ``_stage_fn`` round them."""
    g = _logistic(logit)
    return s + _routed(yr) * g, g


def moe_combine_bwd_plain(dy: torch.Tensor, yr: torch.Tensor, g: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(d_yr, d_logit)`` as ``jax.vjp`` of ``_moe``'s gate and combine
    takes them: ``dy * g`` back in the expert layout, and ``sum_d(routed *
    dy) * (g * (1 - g))``, the products in the dtype, the row sum by
    :func:`_row_sum` rounded to the dtype, every op rounded to it."""
    e, per, d = yr.shape
    d_g = _row_sum(_routed(yr) * dy).to(dy.dtype)
    return ((dy * g).reshape(per, e, d).transpose(0, 1),
            d_g * (g * (1.0 - g)))


def mse_grad_scale(n: int, dtype: torch.dtype) -> float:
    """The gradient reaching each square of a mean over ``n`` elements for
    d(loss) = 1: ``1 / n`` in float32, rounded to the dtype."""
    return float(torch.tensor(np.float32(1.0) / np.float32(n)).to(dtype))


def mse_loss_plain(out: torch.Tensor, y: torch.Tensor, ranks: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, d_out)``: ``mean((out - y)^2)`` with the difference and its
    square in the dtype, summed in float32 and rounded to the dtype
    (``jnp.mean``), and its gradient for d(loss) = 1, ``(1/n) * (2 diff)``
    as autograd and ``jax.grad`` round it. With ``ranks > 1`` the loss is
    one of ``ranks`` equal blocks' whose mean (the ``pmean``) is the step's
    loss, and ``d_out`` is for d(that mean) = 1: ``1 / (n ranks)``."""
    diff = out - y
    loss = diff.square().mean(dtype=_acc(out.dtype)).to(out.dtype)
    return loss, (diff * 2.0) * mse_grad_scale(diff.numel() * ranks, out.dtype)


def _sp_check(t: int, sp: int) -> int:
    """The rows of one rank of the sp ring: ``t / sp``."""
    if not isinstance(sp, int) or sp < 1 or t % sp:
        raise ValueError(f"a sequence of {t} does not split over sp={sp}")
    return t // sp


def _ranks_mean(acc: torch.Tensor, sp: int, dtype: torch.dtype, forward: bool) -> torch.Tensor:
    """The ring of ``_ring_context`` over the ranks' values ``acc`` ``(batch,
    sp, d)`` in ``dtype``, rank by rank. Forward: rank ``i`` folds
    ``((0 + v_i) + v_{i-1}) + ...`` (``ring_stream``'s hops, every add
    rounded to the dtype), then multiplies by ``1 / sp`` in float32, as
    XLA divides by a constant, rounded. Gradient: the ranks' ``v`` are
    first scaled by ``1 / sp`` so, and rank ``i`` takes the transposed ring,
    ``v_i + (v_{i+1} + (... + (v_{i+sp-1} + 0)))``."""
    f32 = _acc(dtype)
    inv = _reciprocal(sp, f32)
    if not forward:
        acc = (acc.to(f32) * inv).to(dtype)
    ranks = range(sp)
    total = torch.zeros_like(acc)
    hops = range(sp) if forward else range(sp - 1, -1, -1)
    for k in hops:
        src = [(i - k) % sp if forward else (i + k) % sp for i in ranks]
        total = total + acc[:, src] if forward else acc[:, src] + total
    return (total.to(f32) * inv).to(dtype) if forward else total


def ring_mean_add_plain(x: torch.Tensor, delta: Optional[torch.Tensor] = None,
                        sp: int = 1) -> torch.Tensor:
    """``s + m`` over ``(batch, T, d)``: ``s = x + delta`` rounded to x's
    dtype (``x`` itself without ``delta``), ``m`` the sum over T by
    :func:`_row_sum` times ``1 / T`` in float32, rounded to the dtype, as
    jitted JAX forms ``jnp.mean(s, axis=1)``; the add rounded. The sum
    reads ``x + delta`` in float32 before its rounding to the dtype:
    XLA:CPU drops the jaxpr's rounding of ``s`` ahead of the mean's
    conversion to float32, as it drops ``w``'s in :func:`rms_norm_bwd_plain`.

    With ``sp > 1`` the sequence is ``sp`` ranks' blocks of ``T / sp`` rows:
    each block's mean so (times ``sp / T``), folded around the ring and
    divided by ``sp`` as ``_ring_context`` does (:func:`_ranks_mean`), and
    added to its own block's rows."""
    s = x if delta is None else x + delta
    acc = _acc(s.dtype)
    wide = s if delta is None else x.to(acc) + delta.to(acc)
    if sp == 1:
        return s + (_row_sum(wide, dim=1) * _reciprocal(s.shape[1], acc)).to(s.dtype)
    b, t, d = s.shape
    tl = _sp_check(t, sp)
    local = (_row_sum(wide.reshape(b, sp, tl, d), dim=2) * _reciprocal(tl, acc)).to(s.dtype)
    m = _ranks_mean(local.reshape(b, sp, d), sp, s.dtype, forward=True)
    return (s.reshape(b, sp, tl, d) + m[:, :, None]).reshape(b, t, d)


def ring_mean_add_bwd_plain(g: torch.Tensor, sp: int = 1) -> torch.Tensor:
    """The gradient of :func:`ring_mean_add_plain`'s ``s``, as jitted
    ``jax.vjp`` of ``x + _ring_context(x)`` forms it: ``g + c``, ``c`` the
    sum of ``g`` over T by :func:`_row_sum` rounded to the dtype (the vjp's
    ``reduce_sum`` runs in it), times ``1 / T`` in float32, rounded. With
    ``sp > 1``: each block's sum so, through the transposed ring
    (:func:`_ranks_mean`), then times ``sp / T`` in float32, rounded, and
    added to the block's rows."""
    acc = _acc(g.dtype)
    if sp == 1:
        c = _row_sum(g, dim=1).to(g.dtype).to(acc) * _reciprocal(g.shape[1], acc)
        return g + c.to(g.dtype)
    b, t, d = g.shape
    tl = _sp_check(t, sp)
    sums = _row_sum(g.reshape(b, sp, tl, d), dim=2).to(g.dtype).reshape(b, sp, d)
    c = (_ranks_mean(sums, sp, g.dtype, forward=False).to(acc) * _reciprocal(tl, acc)).to(g.dtype)
    return (g.reshape(b, sp, tl, d) + c[:, :, None]).reshape(b, t, d)


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
    """K4c. :func:`gelu_plain`: the tanh GeLU op by op in x's dtype."""
    _check("x", x)
    if x.device.type == "cpu":
        return gelu_plain(x)
    (x,) = _card(x)
    return _elementwise("gelu_tanh_fwd", x)


def gelu_tanh_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K4d. :func:`gelu_bwd_plain`: ``jax.vjp(_gelu)``'s chain op by op in
    x's dtype."""
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


def mse_loss_fwd(out: torch.Tensor, y: torch.Tensor, ranks: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4e-d. ``(loss, d_out)`` as :func:`mse_loss_plain` gives them: the
    loss a 0-d tensor of out's dtype, ``d_out`` shaped like ``out`` (for
    the mean of ``ranks`` such losses). The loss adds the blocks' partial
    sums in block order, so a rerun repeats it bit for bit."""
    _check("out", out)
    _check("y", y, out)
    if ranks < 1:
        raise ValueError(f"ranks must be >= 1, got {ranks}")
    if out.device.type == "cpu":
        return mse_loss_plain(out, y, ranks)
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
                                 mse_grad_scale(n * ranks, out.dtype), _DTYPES[out.dtype],
                                 kernels._stream(out.device))
    kernels._check_launch(lib, rc, "mse_loss_fwd")
    kernels._count("mse_loss_fwd")
    return loss, d_out


def _check_ring(name: str, t: torch.Tensor, sp: int = 1) -> None:
    _check(name, t)
    if t.dim() != 3:
        raise ValueError(f"{name}: {tuple(t.shape)}; want (batch, T, d)")
    _sp_check(t.shape[1], sp)


def _ring_launch(name: str, out: torch.Tensor, sp: int, *ptrs) -> torch.Tensor:
    """Launch K4f's forward or backward into ``out``, ``(batch, T, d)``."""
    if out.numel() == 0:
        return out
    lib = kernels.build()
    with torch.cuda.device(out.device):
        rc = getattr(lib, f"tb_{name}")(*ptrs, out.data_ptr(), *out.shape, sp, _DTYPES[out.dtype],
                                        kernels._stream(out.device))
    kernels._check_launch(lib, rc, name)
    kernels._count(name)
    return out


def ring_mean_add_fwd(x: torch.Tensor, delta: Optional[torch.Tensor] = None,
                      sp: int = 1) -> torch.Tensor:
    """K4f. :func:`ring_mean_add_plain`: ``s + mean_T(s)``, ``s = x +
    delta``, over ``(batch, T, d)``, the mean that of the sp ring (each
    rank's block mean folded around it) with ``sp > 1``; only the sum is
    written."""
    _check_ring("x", x, sp)
    if delta is not None:
        _check("delta", delta, x)
    if x.device.type == "cpu":
        return ring_mean_add_plain(x, delta, sp)
    x, delta = _card(x, delta)
    return _ring_launch("ring_mean_add_fwd", torch.empty_like(x), sp, x.data_ptr(),
                        kernels._ptr(delta))


def ring_mean_add_bwd(g: torch.Tensor, sp: int = 1) -> torch.Tensor:
    """K4f's gradient. :func:`ring_mean_add_bwd_plain`: ``g`` plus its
    sequence mean (through the transposed ring with ``sp > 1``), as the
    reference rounds it."""
    _check_ring("g", g, sp)
    if g.device.type == "cpu":
        return ring_mean_add_bwd_plain(g, sp)
    (g,) = _card(g)
    return _ring_launch("ring_mean_add_bwd", torch.empty_like(g), sp, g.data_ptr())


# -- autograd -------------------------------------------------------------------------


class AddRMSNormFunction(torch.autograd.Function):
    """``(s, n)`` of :func:`add_rms_norm_fwd`; without ``delta``, ``s`` is
    ``x``, as an output of its own. Saves ``s`` and ``rstd``; the backward
    hands K4b the gradient that reaches ``s`` from the residual stream
    (``g_s``), which it adds where JAX's backward adds it, and gives the
    result to both ``x`` and ``delta``."""

    @staticmethod
    def forward(ctx, x, delta):
        s, n, rstd = add_rms_norm_fwd(x, delta)
        ctx.save_for_backward(s, rstd)
        ctx.set_materialize_grads(False)
        ctx.has_delta = delta is not None
        return s, n

    @staticmethod
    def backward(ctx, g_s, g_n):
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


class RingMeanAddFunction(torch.autograd.Function):
    """:func:`ring_mean_add_fwd`, with :func:`ring_mean_add_bwd` as its
    backward, whose result reaches both ``x`` and ``delta``. Saves
    nothing."""

    @staticmethod
    def forward(ctx, x, delta, sp):
        ctx.has_delta, ctx.sp = delta is not None, sp
        return ring_mean_add_fwd(x, delta, sp)

    @staticmethod
    def backward(ctx, g):
        g_s = ring_mean_add_bwd(g, ctx.sp)
        return g_s, g_s if ctx.has_delta else None, None


def add_rms_norm(
    x: torch.Tensor, delta: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s, n)``: the residual sum ``x + delta`` (``x`` without ``delta``,
    then a view of it) and its RMS norm, differentiable. The gradient
    reaching ``s`` from the residual stream goes into K4b with the norm's."""
    return AddRMSNormFunction.apply(x, delta)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh GeLU, differentiable: ``_gelu`` and its ``jax.vjp``, which
    the reference rounds op by op (in bfloat16, every op to bfloat16)."""
    return GeluFunction.apply(x)


def ring_mean_add(x: torch.Tensor, delta: Optional[torch.Tensor] = None,
                  sp: int = 1) -> torch.Tensor:
    """``s + mean_T(s)``, ``s = x + delta``, differentiable: with ``heads =
    0``, the last MLP residual add and ``x + _ring_context(x)`` over an sp
    ring of ``sp`` ranks (the sequence their blocks, in rank order), and
    their ``jax.vjp``, rounded as the reference rounds them."""
    return RingMeanAddFunction.apply(x, delta, sp)


def moe_combine(s: torch.Tensor, yr: torch.Tensor, logit: torch.Tensor) -> torch.Tensor:
    """``s + routed(yr) * sigmoid(logit)``, differentiable, with the sigmoid
    as ``1 / (1 + exp(-logit))``: ``_moe``'s gate and combine and their
    ``jax.vjp``, which the reference rounds op by op (in bfloat16, every op
    to bfloat16)."""
    return MoECombineFunction.apply(s, yr, logit)


__all__ = [
    "AddRMSNormFunction",
    "GeluFunction",
    "MSE_TOL",
    "MoECombineFunction",
    "NORM_HOLD",
    "NORM_TOL",
    "RingMeanAddFunction",
    "TRANSCENDENTAL_ULPS",
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
    "ring_mean_add",
    "ring_mean_add_bwd",
    "ring_mean_add_bwd_plain",
    "ring_mean_add_fwd",
    "ring_mean_add_plain",
    "rms_norm_bwd",
    "rms_norm_bwd_plain",
]
