"""K3 — the ring-attention block fold, forward and backward, and their plain
versions.

The wrappers over the hand-written CUDA kernels in ``csrc/attention.cu``,
``csrc/attention_tc.cu``, ``csrc/attention_tf32.cu``,
``csrc/attention_bwd_tc.cu`` and ``csrc/attention_bwd_tf32.cu``:

- :func:`fold` replaces ``incubator_brpc_tpu/models/ring_attention.py``
  ``_block_attn`` (:35) and ``block_merge`` (:81) for one hop of the ring,
  every rank at once, and on the last hop the divide and cast of :131-133.
  The operands' dtype picks the kernel: bfloat16 goes to
  ``attn_fold_fwd_tc`` (``attention_tc.cu``, bf16 products on the tensor
  cores with f32 accumulation, P split as :func:`split_bf16` states),
  float32 to ``attn_fold_fwd_tf32`` (``attention_tf32.cu``, 3xTF32 on the
  tensor cores with f32 accumulation, every operand split as
  :func:`split_tf32` states).
- :func:`backward` (:func:`row_dot`, :func:`dkdv` and :func:`dq` over
  ``attn_bwd_delta``, ``attn_bwd_dkdv_tf32`` or ``attn_bwd_dkdv_tc``, and
  ``attn_bwd_dq_tf32`` or ``attn_bwd_dq_tc``) replaces the gradient JAX's
  autodiff takes through ``ring_attention``. :func:`dkdv` and :func:`dq`
  follow the dtype as :func:`fold` does: bfloat16 goes to
  ``attn_bwd_dkdv_tc`` and ``attn_bwd_dq_tc`` (``attention_bwd_tc.cu``,
  tensor cores, P and dS split), float32 to ``attn_bwd_dkdv_tf32`` and
  ``attn_bwd_dq_tf32`` (``attention_bwd_tf32.cu``, 3xTF32 on the tensor
  cores, every operand split as :func:`split_tf32` states). It
  recomputes the scores from q, k, v, dO and the saved per-row
  log-sum-exp ``lse = m + log(l)``: ``delta = rowsum(dO * O)``,
  ``P = exp(S - lse)``, ``dV += P^T dO``, ``dS = P * (dO V^T - delta)``,
  ``dQ += dS K / sqrt(d)``, ``dK += dS^T Q / sqrt(d)``, summed over the hops
  in order. JAX differentiates through the merges instead, so the two agree
  up to rounding, not bitwise.
- :class:`RingAttentionFunction` is the ``torch.autograd.Function`` around
  both: ``sp`` forward folds, then one backward.

Layouts are JAX's: q, k, v and the output are ``(B, T, H, D)`` in float32 or
bfloat16, computed in float32; the statistics ``m``, ``l`` and ``lse`` are
``(B, H, T)`` float32 and the running sum ``o`` is ``(B, T, H, D)`` float32.
The ring is ``sp`` ranks on one card: rank ``i`` owns rows
``[i T/sp, (i+1) T/sp)`` and at hop ``r`` folds the block of rank
``(i - r) mod sp``. No bytes move between hops. On the card the wrappers
take q, k, v, out, dout, lse and delta in any layout, as JAX does: a
tensor that is not contiguous, or not 16-byte aligned (the kernels' vector
copies), is copied first. The fold's carried state (m, l, o) is the
kernels' own output and must come back as it was made. The kernels take
any ``D % 4 == 0`` up to ``MAX_HEAD_DIM``; the tensor-core kernels read the
columns past D, up to their k-step of 16, as zeros. The wrappers take any
D up to ``MAX_HEAD_DIM``: another D is padded with zero columns to the next
multiple of 4 (:func:`_pad`), the kernels are told the true D for the
score scale ``1/sqrt(D)``, and the results are sliced back.

What bounds the bf16 tensor-core fold on the card is bytes, the f32 one and
the f32 dK/dV and dQ (three tf32 products for each) operations, and the
bf16 tensor-core dK/dV and dQ operations and bytes about alike;
``attn_bwd_delta`` is bound by bytes. It has a vector form (a group of
lanes a row, 16-byte loads) for rows on 16-byte boundaries and a general
form (a warp a row) for any other; :func:`delta_form` picks one from the
shape before the launch, and it takes any D (no ``MAX_HEAD_DIM``).
Each source says how its design meets that. A wrapper given CPU tensors runs the
plain PyTorch version beside it; given CUDA tensors it launches the kernels
on the current stream or raises. Nothing on the card's path calls a plain
version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from incubator_brpc_tpu_torch.ops import kernels

NEG_INF = -1e30
MAX_HEAD_DIM = 1024  # the accumulators of a tile at this D fill half the register file

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
_delta_launches = {}  # (form, lanes a row) -> launches

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sp: int) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
        if x.dim() != 4:
            raise ValueError(f"{name}: {x.dim()}-d; want (B, T, H, D)")
        if x.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {x.dtype}; want float32 or bfloat16")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v lie on different devices")
    if sp < 1 or q.shape[1] % sp:
        raise ValueError(f"sequence {q.shape[1]} does not split over sp={sp}")


def _check_head_dim(d: int) -> int:
    """The zero columns that take ``d`` to the kernels' ``D % 4 == 0``."""
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dimension {d}: the kernels take D <= {MAX_HEAD_DIM} "
                         "(each K3 kernel holds a tile's accumulators over the whole of D)")
    return -d % 4


def _pad(pad: int, *tensors: torch.Tensor):
    """The tensors with ``pad`` zero columns after their last: zeros add
    nothing to a score, and the columns they give the results are sliced
    away. Each as it is when ``pad`` is 0."""
    if not pad:
        return tensors
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in tensors)


def _dense(*tensors: torch.Tensor):
    """The tensors as the kernels read them: contiguous and 16-byte aligned.
    Any other layout is copied; such a tensor passes as it is."""
    return tuple(t if t.is_contiguous() and t.data_ptr() % 16 == 0
                 else t.clone(memory_format=torch.contiguous_format) for t in tensors)


def _check_state(*tensors: torch.Tensor) -> None:
    """The fold's carried (m, l, o): written in place, so never copied."""
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the fold's state (m, l, o) must be contiguous and 16-byte aligned, "
                             "as the previous fold made it")


def _stat(x: torch.Tensor, name: str, shape, device) -> None:
    if x.dtype != torch.float32 or tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(f"{name}: want float32 {tuple(shape)} on {device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")


# -- plain versions -------------------------------------------------------------


def _ranks(x: torch.Tensor, sp: int) -> torch.Tensor:
    """(B, T, H, D) -> float32 (B, sp, T/sp, H, D)."""
    b, t, h, d = x.shape
    return x.float().reshape(b, sp, t // sp, h, d)


def _sources(hop: int, sp: int):
    return [(i - hop) % sp for i in range(sp)]


def _mask(hop: int, sp: int, tl: int, device) -> torch.Tensor:
    """Additive causal mask (sp, tl, tl) of every rank at this hop."""
    ar = torch.arange(tl, device=device)
    q_pos = torch.arange(sp, device=device)[:, None] * tl + ar  # (sp, tl)
    kv_pos = torch.tensor(_sources(hop, sp), device=device)[:, None] * tl + ar
    visible = kv_pos[:, None, :] <= q_pos[:, :, None]
    return torch.where(visible, 0.0, NEG_INF).float()


def _scores(qb, kb, hop, sp, causal):
    """s = q k^T / sqrt(float32(d)) + mask, (B, sp, H, tl, tl)."""
    d = qb.shape[-1]
    s = torch.einsum("bithd,bishd->bihts", qb, kb) / torch.sqrt(
        torch.tensor(d, dtype=torch.float32, device=qb.device)
    )
    if causal:
        s = s + _mask(hop, sp, qb.shape[2], qb.device)[None, :, None]
    return s


def initial_state(q: torch.Tensor) -> State:
    """The accumulators before the first fold: m = -1e30, l = 0, o = 0."""
    b, t, h, d = q.shape
    return (
        torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=q.device),
        torch.zeros((b, h, t), dtype=torch.float32, device=q.device),
        torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device),
    )


def fold_plain(q, k, v, state: Optional[State], *, hop: int, sp: int, causal: bool) -> State:
    """``_block_attn`` + ``block_merge`` of one hop for every rank, as the
    JAX function computes them: the block's exact max, exp and sums over the
    whole block, then the online-softmax merge into (m, l, o)."""
    b, t, h, d = q.shape
    tl = t // sp
    m, l, o = initial_state(q) if state is None else state
    src = _sources(hop, sp)
    qb = _ranks(q, sp)
    kb, vb = _ranks(k, sp)[:, src], _ranks(v, sp)[:, src]
    s = _scores(qb, kb, hop, sp, causal)
    bm = s.amax(dim=-1)  # (B, sp, H, tl)
    p = torch.exp(s - bm[..., None])
    bl = p.sum(dim=-1)
    bo = torch.einsum("bihts,bishd->bithd", p, vb)
    m_r = m.reshape(b, h, sp, tl).permute(0, 2, 1, 3)
    l_r = l.reshape(b, h, sp, tl).permute(0, 2, 1, 3)
    m_new = torch.maximum(m_r, bm)
    alpha = torch.exp(m_r - m_new)
    beta = torch.exp(bm - m_new)
    l_new = l_r * alpha + bl * beta
    o_new = (
        o.reshape(b, sp, tl, h, d) * alpha.transpose(2, 3)[..., None]
        + bo * beta.transpose(2, 3)[..., None]
    )
    return (
        m_new.permute(0, 2, 1, 3).reshape(b, h, t),
        l_new.permute(0, 2, 1, 3).reshape(b, h, t),
        o_new.reshape(b, t, h, d),
    )


def split_bf16(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``attn_fold_fwd_tc`` does with the f32 probabilities P before
    P.V, ``attn_bwd_dkdv_tc`` with P and dS before P^T.dO and dS^T.Q, and
    ``attn_bwd_dq_tc`` with dS before dS.K:
    ``hi = bf16(P)`` and ``lo = bf16(P - hi)``, both rounded to nearest
    even. ``hi + lo`` carries 16 bits of P's 24, and ``hi.V + lo.V`` are two
    bf16 products on the tensor cores accumulated in f32. One bf16 rounding
    alone would miss the f32 tolerance of o, dK, dV and dQ."""
    hi = p.to(torch.bfloat16)
    return hi, (p - hi.float()).to(torch.bfloat16)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32 ``x``, by bit arithmetic: the 13 low
    bits of the significand rounded off to nearest, ties away from zero
    (half an ulp added to the magnitude, then truncated, which carries into
    the exponent and past the largest tf32 to inf as the rounding should);
    subnormals alike; inf and NaN as they are. The result is a float32 that
    tf32 holds exactly."""
    u = x.contiguous().view(torch.int32).to(torch.int64)
    mag = u & 0x7FFFFFFF
    r = torch.where(mag >= 0x7F800000, mag, ((mag + 0x1000) & 0x7FFFE000)) | (u & ~0x7FFFFFFF)
    return r.to(torch.int32).view(torch.float32).view(x.shape)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``attn_fold_fwd_tf32`` does with each float32 operand (Q, K, V and
    P), and ``attn_bwd_dkdv_tf32`` with K, V, Q, dO, P and dS, before its
    products: ``hi = tf32_rna(x)`` and ``lo = tf32_rna(x - hi)``
    (:func:`round_tf32`), both float32 values that tf32 holds exactly.
    ``hi + lo`` carries 22 bits of x's 24, and the three tf32 tensor-core
    products ``a_hi.b_lo + a_lo.b_hi + a_hi.b_hi`` (small terms first, lo.lo
    dropped) accumulated in f32 keep the fold within its f32 tolerance,
    where ``a_hi.b_hi`` alone misses it."""
    hi = round_tf32(x.float())
    return hi, round_tf32(x.float() - hi)


def finalize_plain(state: State, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``o / max(l, 1e-30)`` cast to ``dtype``, and ``lse = m + log(max(l, 1e-30))``."""
    m, l, o = state
    lf = torch.clamp_min(l, 1e-30)
    out = (o / lf.transpose(1, 2)[..., None]).to(dtype)
    return out, m + torch.log(lf)


def row_dot_plain(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in float32, (B, H, T)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _backward_hops(q, k, v, dout, lse, delta, sp, causal):
    """Per hop: (src, P, dS) for every rank, recomputed in float32."""
    b, t, h, d = q.shape
    tl = t // sp
    qb, kb, vb, dob = (_ranks(x, sp) for x in (q, k, v, dout))
    lse_r = lse.reshape(b, h, sp, tl).permute(0, 2, 1, 3)[..., None]
    delta_r = delta.reshape(b, h, sp, tl).permute(0, 2, 1, 3)[..., None]
    for hop in range(sp):
        src = _sources(hop, sp)
        p = torch.exp(_scores(qb, kb[:, src], hop, sp, causal) - lse_r)
        dp = torch.einsum("bithd,bishd->bihts", dob, vb[:, src])
        yield src, qb, kb, dob, p, p * (dp - delta_r)


def _sqrt_d(q: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.tensor(q.shape[-1], dtype=torch.float32, device=q.device))


def dkdv_plain(q, k, v, dout, lse, delta, *, sp: int, causal: bool):
    """``dK = sum dS^T Q / sqrt(d)``, ``dV = sum P^T dO``: dk and dv of a hop
    belong to the block each rank held, summed in hop order."""
    dk = torch.zeros_like(_ranks(k, sp))
    dv = torch.zeros_like(dk)
    for src, qb, _, dob, p, ds in _backward_hops(q, k, v, dout, lse, delta, sp, causal):
        dk[:, src] += torch.einsum("bihts,bithd->bishd", ds, qb) / _sqrt_d(q)
        dv[:, src] += torch.einsum("bihts,bithd->bishd", p, dob)
    return dk.reshape(q.shape).to(q.dtype), dv.reshape(q.shape).to(q.dtype)


def dq_plain(q, k, v, dout, lse, delta, *, sp: int, causal: bool):
    """``dQ = sum dS K / sqrt(d)`` over the hops."""
    dq = torch.zeros_like(_ranks(q, sp))
    for src, _, kb, _, _, ds in _backward_hops(q, k, v, dout, lse, delta, sp, causal):
        dq += torch.einsum("bihts,bishd->bithd", ds, kb[:, src]) / _sqrt_d(q)
    return dq.reshape(q.shape).to(q.dtype)


def backward_plain(q, k, v, out, dout, lse, *, sp: int, causal: bool):
    """The recomputation of :func:`backward` in float32, hop by hop."""
    delta = row_dot_plain(out, dout)
    dk, dv = dkdv_plain(q, k, v, dout, lse, delta, sp=sp, causal=causal)
    return dq_plain(q, k, v, dout, lse, delta, sp=sp, causal=causal), dk, dv


# -- wrappers -------------------------------------------------------------------


def fold(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    state: Optional[State],
    *,
    hop: int,
    sp: int,
    causal: bool,
    finalize: bool,
):
    """K3 forward: fold hop ``hop`` of the ring into ``state`` = (m, l, o)
    (None before hop 0). Returns ``(m, l, o, out, lse)``; ``out`` (in q's
    dtype) and ``lse`` are None unless ``finalize``. On the card the state
    is updated in place (hop 0 allocates it) by ``attn_fold_fwd_tc`` for
    bfloat16 operands and ``attn_fold_fwd_tf32`` for float32; on the CPU it
    is new."""
    _check(q, k, v, sp)
    if not 0 <= hop < sp:
        raise ValueError(f"hop {hop} outside [0, {sp})")
    if q.device.type == "cpu":
        m, l, o = fold_plain(q, k, v, state, hop=hop, sp=sp, causal=causal)
        out, lse = finalize_plain((m, l, o), q.dtype) if finalize else (None, None)
        return m, l, o, out, lse
    b, t, h, d = q.shape
    pad = _check_head_dim(d)
    q, k, v = _dense(*_pad(pad, q, k, v))
    dev = q.device
    if hop == 0:
        m = torch.empty((b, h, t), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
        o = torch.empty((b, t, h, d), dtype=torch.float32, device=dev)
    else:
        if state is None:
            raise ValueError(f"hop {hop} needs the state of hop {hop - 1}")
        m, l, o = state
        _stat(m, "m", (b, h, t), dev)
        _stat(l, "l", (b, h, t), dev)
        _stat(o, "o", (b, t, h, d), dev)
        _check_state(o, m, l)
    (o_k,) = _pad(pad, o)  # o itself, or a padded copy the kernel updates
    out = torch.empty_like(q) if finalize else None
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev) if finalize else None
    lib = kernels.build()
    state_ptrs = (m.data_ptr(), l.data_ptr(), o_k.data_ptr(), kernels._ptr(out), kernels._ptr(lse))
    geometry = (b, t, h, d + pad, d, sp, hop, int(causal), int(finalize), kernels._stream(dev))
    name = "attn_fold_fwd_tc" if q.dtype == torch.bfloat16 else "attn_fold_fwd_tf32"
    with torch.cuda.device(dev):
        rc = getattr(lib, "tb_" + name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), *state_ptrs,
                                        *geometry)
    kernels._check_launch(lib, rc, name)
    kernels._count(name)
    if pad:
        o.copy_(o_k[..., :d])
        out = out[..., :d].contiguous() if finalize else None
    return m, l, o, out, lse


def forward(q, k, v, *, sp: int, causal: bool):
    """All ``sp`` folds of the ring: ``(out, lse, (m, l, o))``."""
    state = None
    for hop in range(sp):
        m, l, o, out, lse = fold(q, k, v, state, hop=hop, sp=sp, causal=causal,
                                 finalize=hop == sp - 1)
        state = (m, l, o)
    return out, lse, state


def _check_backward(q, k, v, dout, lse, sp):
    _check(q, k, v, sp)
    b, t, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout: want {q.dtype} {tuple(q.shape)} on {q.device}")
    _stat(lse, "lse", (b, h, t), q.device)


def delta_form(d: int, dtype: torch.dtype, aligned: bool) -> Tuple[str, int]:
    """The form of ``attn_bwd_delta`` that takes rows of ``d`` elements of
    ``dtype``, and its lanes a row: ``("vector", L)`` where every row starts
    on a 16-byte boundary (``aligned``: both tensors do, and ``d * itemsize
    % 16 == 0``), L the largest power of two <= 32 and <= the row's 16-byte
    vectors; else ``("general", 32)``, a warp a row."""
    row_bytes = d * _ITEMSIZE[dtype]
    if not aligned or row_bytes % 16 or row_bytes == 0:
        return "general", 32
    return "vector", 1 << min(5, (row_bytes // 16).bit_length() - 1)


def delta_form_counts():
    """Launches of ``attn_bwd_delta`` by ``(form, lanes a row)`` since the
    module was loaded."""
    with kernels._launches_lock:
        return dict(_delta_launches)


def _launch_delta(out: torch.Tensor, dout: torch.Tensor, form: Tuple[str, int]) -> torch.Tensor:
    """``attn_bwd_delta`` in ``form`` (as :func:`delta_form` gives it) on
    contiguous CUDA tensors as they lie; the kernel's entry refuses a vector
    form off its alignments or with other lanes than the rule's.
    ``chip_smoke.py`` times the two forms in turns through it."""
    b, t, h, d = out.shape
    delta = torch.empty((b, h, t), dtype=torch.float32, device=out.device)
    lanes = form[1] if form[0] == "vector" else 0
    lib = kernels.build()
    with torch.cuda.device(out.device):
        rc = lib.tb_attn_bwd_delta(out.data_ptr(), dout.data_ptr(), _DTYPES[out.dtype],
                                   delta.data_ptr(), b, t, h, d, lanes,
                                   kernels._stream(out.device))
    kernels._check_launch(lib, rc, "attn_bwd_delta")
    with kernels._launches_lock:
        kernels._launches["attn_bwd_delta"] += 1
        _delta_launches[form] = _delta_launches.get(form, 0) + 1
    return delta


def row_dot(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """K3 backward, ``attn_bwd_delta``: ``rowsum(dO * O)`` -> (B, H, T) f32,
    in the form :func:`delta_form` names, the general form where
    ``B*T*H*D`` reaches 2^31 (the vector form's 32-bit indices)."""
    _check(out, dout, dout, 1)
    if out.device.type == "cpu":
        return row_dot_plain(out, dout)
    b, t, h, d = out.shape
    out, dout = _dense(out, dout)
    aligned = out.data_ptr() % 16 == 0 and dout.data_ptr() % 16 == 0
    form = delta_form(d, out.dtype, aligned) if b * t * h * d < 1 << 31 else ("general", 32)
    return _launch_delta(out, dout, form)


def dkdv(q, k, v, dout, lse, delta, *, sp: int, causal: bool):
    """K3 backward: ``(dk, dv)`` in q's dtype, by ``attn_bwd_dkdv_tc`` for
    bfloat16 operands and ``attn_bwd_dkdv_tf32`` for float32."""
    _check_backward(q, k, v, dout, lse, sp)
    _stat(delta, "delta", lse.shape, q.device)
    if q.device.type == "cpu":
        return dkdv_plain(q, k, v, dout, lse, delta, sp=sp, causal=causal)
    b, t, h, d = q.shape
    pad = _check_head_dim(d)
    q, k, v, dout, lse, delta = _dense(*_pad(pad, q, k, v, dout), lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    name = "attn_bwd_dkdv_tc" if q.dtype == torch.bfloat16 else "attn_bwd_dkdv_tf32"
    lib = kernels.build()
    with torch.cuda.device(q.device):
        rc = getattr(lib, "tb_" + name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, d + pad, d, sp,
            int(causal), kernels._stream(q.device))
    kernels._check_launch(lib, rc, name)
    kernels._count(name)
    if pad:
        return dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


def dq(q, k, v, dout, lse, delta, *, sp: int, causal: bool):
    """K3 backward: ``dq`` in q's dtype, by ``attn_bwd_dq_tc`` for bfloat16
    operands and ``attn_bwd_dq_tf32`` for float32."""
    _check_backward(q, k, v, dout, lse, sp)
    _stat(delta, "delta", lse.shape, q.device)
    if q.device.type == "cpu":
        return dq_plain(q, k, v, dout, lse, delta, sp=sp, causal=causal)
    b, t, h, d = q.shape
    pad = _check_head_dim(d)
    q, k, v, dout, lse, delta = _dense(*_pad(pad, q, k, v, dout), lse, delta)
    out = torch.empty_like(q)
    name = "attn_bwd_dq_tc" if q.dtype == torch.bfloat16 else "attn_bwd_dq_tf32"
    lib = kernels.build()
    with torch.cuda.device(q.device):
        rc = getattr(lib, "tb_" + name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), out.data_ptr(), b, t, h, d + pad, d, sp, int(causal),
            kernels._stream(q.device))
    kernels._check_launch(lib, rc, name)
    kernels._count(name)
    return out[..., :d].contiguous() if pad else out


def backward(q, k, v, out, dout, lse, *, sp: int, causal: bool):
    """K3 backward: ``(dq, dk, dv)`` in q's dtype, from the inputs, the
    output ``out``, its gradient ``dout`` and the forward's ``lse``."""
    delta = row_dot(out, dout)
    dk, dv = dkdv(q, k, v, dout, lse, delta, sp=sp, causal=causal)
    return dq(q, k, v, dout, lse, delta, sp=sp, causal=causal), dk, dv


class RingAttentionFunction(torch.autograd.Function):
    """Exact attention over the ring: K3 forward folds, K3 backward.
    Saves q, k, v, the output and ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, sp: int, causal: bool):
        out, lse, _ = forward(q, k, v, sp=sp, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sp, ctx.causal = sp, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = backward(q, k, v, out, dout.contiguous(), lse, sp=ctx.sp, causal=ctx.causal)
        return dq, dk, dv, None, None


def attention_flops(b: int, t: int, h: int, d: int, *, causal: bool, products: int) -> int:
    """FLOPs (2 per multiply-add) of ``products`` (query, key) x d products
    over every visible pair of full attention, whatever sp: the forward
    fold does 2 (scores, P.V), dK/dV 4 (scores, dO.V^T, dV, dK) and dQ 3
    (scores, dO.V^T, dQ)."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return 2 * b * h * pairs * d * products


__all__ = [
    "NEG_INF",
    "MAX_HEAD_DIM",
    "RingAttentionFunction",
    "attention_flops",
    "backward",
    "backward_plain",
    "dkdv",
    "dkdv_plain",
    "dq",
    "dq_plain",
    "delta_form",
    "delta_form_counts",
    "row_dot",
    "row_dot_plain",
    "finalize_plain",
    "round_tf32",
    "split_bf16",
    "split_tf32",
    "fold",
    "fold_plain",
    "forward",
    "initial_state",
]
