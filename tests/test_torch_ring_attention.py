"""Ring attention of the port against the JAX package, on the CPU: the same
numpy inputs through ``incubator_brpc_tpu.models.ring_attention`` on a
virtual ``sp`` mesh and through the port's plain versions of K3.

Tolerances: the outputs at rtol = atol = 2e-5 in float32, as
``tests/test_ring_attention.py`` holds the ring against full attention (the
sums run in another order); bfloat16 at 0.05, as there; the gradients of
``mean(out^2)`` within 1e-4 absolute (JAX differentiates through the
merges, the port recomputes from the log-sum-exp), and gradients of unit
scale within 1e-4 x max(1, max |g|); bfloat16 gradients within 2^-7 x
max(1, max |g|), one bf16 rounding of the result on either side;
``prefetch`` bitwise.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from incubator_brpc_tpu.models import ring_attention as jax_ra
from incubator_brpc_tpu_torch.models import ring_attention as ra
from incubator_brpc_tpu_torch.ops import attention



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These sizes gain nothing from threads; one keeps the xdist workers'
    cores for the timing-sensitive tests running beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

def _qkv(seed, b=2, t=32, h=4, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))


def _jax_step(sp, causal=True, prefetch=False):
    mesh = Mesh(np.array(jax.devices()[:sp]), axis_names=("sp",))
    return jax_ra.make_ring_attention_step(mesh, causal=causal, prefetch=prefetch)


@pytest.mark.parametrize("sp", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_ring_attention(sp, causal):
    q, k, v = _qkv(sp * 10 + causal)
    jstep, jplace = _jax_step(sp, causal)
    want = np.asarray(jstep(jplace(q), jplace(k), jplace(v)))
    step, place = ra.make_ring_attention_step(sp, causal=causal, device="cpu")
    got = step(place(q), place(k), place(v))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_ragged_block_and_full_attention():
    """T / sp = 12 rows per rank, no multiple of any tile; the port's ring
    against the port's full attention and against JAX's."""
    q, k, v = _qkv(7, b=2, t=48, h=4, d=16)
    jstep, jplace = _jax_step(4)
    want = np.asarray(jstep(jplace(q), jplace(k), jplace(v)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ra.ring_attention(tq, tk, tv, sp=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ra.full_attention(tq, tk, tv).numpy(), want, rtol=2e-5, atol=2e-5)


def test_bfloat16_stays_bfloat16():
    q, k, v = _qkv(2)
    jstep, jplace = _jax_step(4)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jstep(jplace(jq), jplace(jk), jplace(jv)), np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = ra.ring_attention(tq, tk, tv, sp=4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("causal", [True, False])
def test_prefetch_is_bit_identical(causal):
    q, k, v = _qkv(3)
    plain, place = ra.make_ring_attention_step(4, causal=causal, device="cpu")
    pref, _ = ra.make_ring_attention_step(4, causal=causal, prefetch=True, device="cpu")
    a = plain(place(q), place(k), place(v)).numpy()
    b = pref(place(q), place(k), place(v)).numpy()
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("sp", [1, 4])
def test_grads_match_jax(sp):
    q, k, v = _qkv(20 + sp, t=16)
    jstep, jplace = _jax_step(sp)

    def loss(a, b, c):
        return jnp.mean(jnp.square(jstep(a, b, c)))

    want = jax.grad(loss, argnums=(0, 1, 2))(jplace(q), jplace(k), jplace(v))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    ra.ring_attention(tq, tk, tv, sp=sp).square().mean().backward()
    for w, t in zip(want, (tq, tk, tv)):
        g = t.grad.numpy()
        assert np.isfinite(g).all() and np.abs(g).sum() > 0
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4)


def test_fold_with_carried_state_matches_jax_block_merge():
    """One fold of the plain version, from a nonzero incoming (m, l, o),
    against ``_block_attn`` and the merge of ``block_merge`` in JAX, for
    rank 2 of 4 at hop 1 (it holds rank 1's block)."""
    b, t, h, d, sp, hop = 2, 32, 4, 16, 4, 1
    q, k, v = _qkv(30, b=b, t=t, h=h, d=d)
    tl = t // sp
    rng = np.random.default_rng(31)
    m = rng.standard_normal((b, h, t)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (b, h, t)).astype(np.float32)
    o = rng.standard_normal((b, t, h, d)).astype(np.float32)
    tm, tlv, to = attention.fold_plain(
        *map(torch.from_numpy, (q, k, v)),
        tuple(map(torch.from_numpy, (m, l, o))), hop=hop, sp=sp, causal=True,
    )
    i, src = 2, (2 - hop) % sp
    rows, keys = slice(i * tl, (i + 1) * tl), slice(src * tl, (src + 1) * tl)
    q_pos = i * tl + jnp.arange(tl)
    kv_pos = src * tl + jnp.arange(tl)
    mask = jnp.where(kv_pos[None, :] <= q_pos[:, None], 0.0, jax_ra.NEG_INF)
    bm, bl, bo = jax_ra._block_attn(q[:, rows], k[:, keys], v[:, keys], mask)
    m_r, l_r, o_r = m[:, :, rows], l[:, :, rows], o[:, rows]
    m_new = jnp.maximum(m_r, bm)
    alpha, beta = jnp.exp(m_r - m_new), jnp.exp(bm - m_new)
    l_new = l_r * alpha + bl * beta
    o_new = o_r * alpha.transpose(0, 2, 1)[..., None] + bo * beta.transpose(0, 2, 1)[..., None]
    np.testing.assert_allclose(tm[:, :, rows].numpy(), np.asarray(m_new), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tlv[:, :, rows].numpy(), np.asarray(l_new), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(to[:, rows].numpy(), np.asarray(o_new), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("p_as", ["split", "one_bf16_rounding"])
def test_split_p_keeps_the_fold_within_f32_tolerance(p_as):
    """What ``attn_fold_fwd_tc`` does with P, on the CPU: one causal block
    at D = 1024 (T 256; bf16 inputs widened to f32, as the kernel's
    operands are) folded with P replaced by ``split_bf16``'s hi + lo (two
    products, summed in f32), held against JAX's f32 ``_block_attn``
    within 2e-5 * max(1, max |o|), the tolerance of the o state. One bf16
    rounding of P misses it: that is why the kernel splits P."""
    b, t, h, d = 1, 256, 1, 1024
    rng = np.random.default_rng(41)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32))
               .to(torch.bfloat16).float().numpy() for _ in range(3))
    pos = jnp.arange(t)
    mask = jnp.where(pos[None, :] <= pos[:, None], 0.0, jax_ra.NEG_INF)
    _, _, want = jax_ra._block_attn(q, k, v, mask)
    want = np.asarray(want)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    s = torch.einsum("bthd,bshd->bhts", tq, tk) / torch.sqrt(torch.tensor(float(d)))
    s = s + torch.from_numpy(np.array(mask))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pv = lambda x: torch.einsum("bhts,bshd->bthd", x.float(), tv)  # noqa: E731
    if p_as == "split":
        hi, lo = attention.split_bf16(p)
        assert hi.dtype == lo.dtype == torch.bfloat16
        # hi + lo carries P to 16 bits: each rounding keeps 8
        assert bool(((hi.float() + lo.float() - p).abs() <= p * 2.0 ** -16 + 1e-30).all())
        got = pv(hi) + pv(lo)
    else:
        got = pv(p.to(torch.bfloat16))
    err = float(np.abs(got.numpy() - want).max())
    tol = 2e-5 * max(1.0, float(np.abs(want).max()))
    if p_as == "split":
        assert err <= tol
    else:
        assert err > 10 * tol


@functools.lru_cache(maxsize=1)
def _dkdv_block():
    """One causal block at D = 1024 (B 1, T 128, H 1, sp 1; bf16 inputs
    widened to f32, as the kernel's operands are): JAX's dK and dV (the vjp
    of ``ring_attention`` for a unit-scale cotangent dO), and the port's
    recomputed f32 P, dS, Q, K, dO and sqrt(D). Also JAX's dQ."""
    b, t, h, d = 1, 128, 1, 1024
    rng = np.random.default_rng(43)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32))
                   .to(torch.bfloat16).float().numpy() for _ in range(4))
    jstep, jplace = _jax_step(1)
    _, vjp = jax.vjp(jstep, jplace(q), jplace(k), jplace(v))
    want_dq, want_dk, want_dv = (np.asarray(g) for g in vjp(jnp.asarray(do)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse, _ = attention.forward(tq, tk, tv, sp=1, causal=True)
    delta = attention.row_dot_plain(out, tdo)
    (_, qb, kb, dob, p, ds), = attention._backward_hops(tq, tk, tv, tdo, lse, delta, 1, True)
    return ({"dq": want_dq, "dk": want_dk, "dv": want_dv},
            (p, ds, qb, kb, dob, attention._sqrt_d(tq)))


@pytest.mark.parametrize("grad", ["dk", "dv"])
@pytest.mark.parametrize("x_as", ["split", "one_bf16_rounding"])
def test_split_ds_keeps_dkdv_within_f32_tolerance(x_as, grad):
    """What ``attn_bwd_dkdv_tc`` does with P and dS, on the CPU: dV = P^T dO
    and dK = dS^T Q / sqrt(D) in f32 with P (for dV) or dS (for dK)
    replaced by ``split_bf16``'s hi + lo (two products, summed in f32), held
    against JAX's gradient of ``ring_attention`` within 1e-4 x max(1, max
    |g|), the f32 tolerance of the gradients. One bf16 rounding misses it:
    that is why the kernel splits P and dS."""
    want, (p, ds, qb, _, dob, sqd) = _dkdv_block()
    x, operand = (p, dob) if grad == "dv" else (ds, qb)
    prod = lambda y: torch.einsum("bihts,bithd->bishd", y.float(), operand)  # noqa: E731
    if x_as == "split":
        hi, lo = attention.split_bf16(x)
        got = prod(hi) + prod(lo)
    else:
        got = prod(x.to(torch.bfloat16))
    if grad == "dk":
        got = got / sqd
    got = got.reshape(want[grad].shape).numpy()
    err = float(np.abs(got - want[grad]).max())
    tol = 1e-4 * max(1.0, float(np.abs(want[grad]).max()))
    if x_as == "split":
        assert err <= tol
    else:
        assert err > tol


@pytest.mark.parametrize("ds_as", ["split", "one_bf16_rounding"])
def test_split_ds_keeps_dq_within_f32_tolerance(ds_as):
    """What ``attn_bwd_dq_tc`` does with dS, on the CPU: dQ = dS K / sqrt(D)
    in f32 with dS replaced by ``split_bf16``'s hi + lo (two products,
    summed in f32), held against JAX's gradient of ``ring_attention`` on the
    block of ``_dkdv_block`` within 1e-4 x max(1, max |g|), the f32
    tolerance of the gradients. One bf16 rounding misses it: that is why
    the kernel splits dS."""
    want, (_, ds, _, kb, _, sqd) = _dkdv_block()
    prod = lambda y: torch.einsum("bihts,bishd->bithd", y.float(), kb)  # noqa: E731
    if ds_as == "split":
        hi, lo = attention.split_bf16(ds)
        got = prod(hi) + prod(lo)
    else:
        got = prod(ds.to(torch.bfloat16))
    got = (got / sqd).reshape(want["dq"].shape).numpy()
    err = float(np.abs(got - want["dq"]).max())
    tol = 1e-4 * max(1.0, float(np.abs(want["dq"]).max()))
    if ds_as == "split":
        assert err <= tol
    else:
        assert err > tol


def _rna_tf32_reference(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` from its definition, in float64: |x| to the
    nearest multiple of its tf32 ulp (2^(e - 10), and 2^-136 below the
    normal range), ties away from zero; past the largest tf32 to inf; zero,
    inf and NaN as they are."""
    out = np.empty(x.size, np.float64)
    with np.errstate(invalid="ignore"):  # NaN payloads
        wide = x.astype(np.float64).ravel()
    for i, v in enumerate(wide):
        if v == 0 or not math.isfinite(v):
            out[i] = v
            continue
        e = max(math.frexp(abs(v))[1] - 1, -126)
        ulp = 2.0 ** (e - 10)
        r = math.floor(abs(v) / ulp + 0.5) * ulp
        out[i] = math.copysign(math.inf if r >= 2.0 ** 128 else r, v)
    return out.astype(np.float32).reshape(x.shape)


def _tf32_cases(kind: str) -> np.ndarray:
    rng = np.random.default_rng(61)
    bits = lambda b: np.asarray(b, np.uint32).view(np.float32)  # noqa: E731
    if kind == "normal":
        return (rng.standard_normal(4096) * 2.0 ** rng.integers(-120, 120, 4096)).astype(np.float32)
    if kind == "ties":  # exactly halfway between two tf32 values, both signs
        r = rng.integers(0x00800000, 0x7F7FE000, 2048, dtype=np.uint64).astype(np.uint32)
        r = (r & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
        return np.concatenate([bits(r), -bits(r)])
    if kind == "subnormal":
        r = rng.integers(1, 0x00800000, 2048, dtype=np.uint64).astype(np.uint32)
        return np.concatenate([bits(r), -bits(r), bits([0x000FF000, 0x007FF000, 0x007FFFFF])])
    # the edges: zeros, the largest tf32, halfway past it (to inf), FLT_MAX, inf, NaN
    edge = bits([0, 0x80000000, 0x7F7FE000, 0x7F7FEFFF, 0x7F7FF000, 0x7F7FFFFF, 0x7F800000,
                 0xFF800000, 0x7FC00000, 0x7F800001, 0xFFC01234, 0x00800000, 0x00801000])
    return np.concatenate([edge, -edge])


@pytest.mark.parametrize("kind", ["normal", "ties", "subnormal", "edges"])
def test_round_tf32_is_cvt_rna_tf32(kind):
    """:func:`attention.round_tf32` (bit arithmetic) against the rounding's
    definition: nearest, ties away from zero; subnormals rounded on their
    own grid; inf kept, NaN kept NaN, overflow to inf. :func:`split_tf32`'s
    hi and lo are tf32 values and hi + lo holds x to 2^-21 of |x| (to half
    of tf32's subnormal grid, 2^-137, where lo falls below the normal range)."""
    x = _tf32_cases(kind)
    got = attention.round_tf32(torch.from_numpy(x)).numpy()
    want = _rna_tf32_reference(x)
    nan = np.isnan(x)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))
    finite = np.isfinite(x) & np.isfinite(want)
    hi, lo = (t.numpy() for t in attention.split_tf32(torch.from_numpy(x[finite])))
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    xf = x[finite].astype(np.float64)
    err = np.abs(hi.astype(np.float64) + lo - xf)
    assert (err <= np.abs(xf) * 2.0 ** -21 + 2.0 ** -137).all()  # lo subnormal: grid 2^-136


@pytest.mark.parametrize("products", ["3xtf32", "one_tf32_product"])
def test_3xtf32_keeps_the_fold_within_f32_tolerance(products):
    """What ``attn_fold_fwd_tf32`` computes, on the CPU: one causal block at
    D = 1024 (T 256; f32 inputs from a seed), each product S = Q.K^T and
    P.V as ``split_tf32``'s three tf32 products (``a_hi.b_lo + a_lo.b_hi``,
    then ``+ a_hi.b_hi``, summed in f32), held against JAX's f32
    ``_block_attn`` (o) and ``ring_attention`` (the output) within 2e-5 x
    max(1, max |o|), the tolerance of the f32 state. One tf32 product
    (hi.hi) misses it by more than 10x: that is why the kernel splits."""
    b, t, h, d = 1, 256, 1, 1024
    rng = np.random.default_rng(45)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    pos = jnp.arange(t)
    mask = jnp.where(pos[None, :] <= pos[:, None], 0.0, jax_ra.NEG_INF)
    _, _, want = jax_ra._block_attn(q, k, v, mask)
    want = np.asarray(want)
    jstep, jplace = _jax_step(1)
    want_out = np.asarray(jstep(jplace(q), jplace(k), jplace(v)))

    def prod(eq, x, y):
        if products == "3xtf32":
            (xh, xl), (yh, yl) = attention.split_tf32(x), attention.split_tf32(y)
            return (torch.einsum(eq, xh, yl) + torch.einsum(eq, xl, yh)) + torch.einsum(eq, xh, yh)
        return torch.einsum(eq, attention.round_tf32(x), attention.round_tf32(y))

    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    s = prod("bthd,bshd->bhts", tq, tk) / torch.sqrt(torch.tensor(float(d)))
    s = s + torch.from_numpy(np.array(mask))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    got = prod("bhts,bshd->bthd", p, tv)
    out = got / p.sum(-1).transpose(1, 2)[..., None]
    errs = [(float(np.abs(x.numpy() - w).max()), 2e-5 * max(1.0, float(np.abs(w).max())))
            for x, w in ((got, want), (out, want_out))]
    if products == "3xtf32":
        assert all(err <= tol for err, tol in errs)
    else:
        assert errs[0][0] > 10 * errs[0][1]


@pytest.mark.parametrize("products", ["3xtf32", "one_tf32_product"])
def test_3xtf32_keeps_dq_within_f32_tolerance(products):
    """What ``attn_bwd_dq_tf32`` computes, on the CPU: one causal block at
    D = 512 (T 256; f32 inputs from a seed), each of its three products,
    S = Q.K^T, dP = dO.V^T and dQ = dS.K, as ``split_tf32``'s three tf32
    products (``a_hi.b_lo + a_lo.b_hi``, then ``+ a_hi.b_hi``, summed in
    f32), with P = exp(S / sqrt(D) + mask - lse) and dS = P (dP - delta) in
    f32 between them, held against ``dq_plain`` and JAX's gradient of
    ``ring_attention`` within 2e-5 x max(1, max |dq|), the f32 tolerance
    chip_smoke.py holds the kernel to. One tf32 product (hi.hi) misses it by
    more than 10x: that is why the kernel splits."""
    b, t, h, d = 1, 256, 1, 512
    rng = np.random.default_rng(47)
    q, k, v, do = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4))
    jstep, jplace = _jax_step(1)
    _, vjp = jax.vjp(jstep, jplace(q), jplace(k), jplace(v))
    want_jax = np.asarray(vjp(jnp.asarray(do))[0])
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse, _ = attention.forward(tq, tk, tv, sp=1, causal=True)
    delta = attention.row_dot_plain(out, tdo)
    want_plain = attention.dq_plain(tq, tk, tv, tdo, lse, delta, sp=1, causal=True).numpy()

    def prod(eq, x, y):
        if products == "3xtf32":
            (xh, xl), (yh, yl) = attention.split_tf32(x), attention.split_tf32(y)
            return (torch.einsum(eq, xh, yl) + torch.einsum(eq, xl, yh)) + torch.einsum(eq, xh, yh)
        return torch.einsum(eq, attention.round_tf32(x), attention.round_tf32(y))

    sqd = attention._sqrt_d(tq)
    pos = torch.arange(t)
    mask = torch.where(pos[None, :] <= pos[:, None], 0.0, attention.NEG_INF)
    s = prod("bthd,bshd->bhts", tq, tk) / sqd + mask
    p = torch.exp(s - lse[..., None])
    ds = p * (prod("bthd,bshd->bhts", tdo, tv) - delta[..., None])
    got = (prod("bhts,bshd->bthd", ds, tk) / sqd).numpy()
    errs = [(float(np.abs(got - w).max()), 2e-5 * max(1.0, float(np.abs(w).max())))
            for w in (want_plain, want_jax)]
    if products == "3xtf32":
        assert all(err <= tol for err, tol in errs)
    else:
        assert errs[0][0] > 10 * errs[0][1]


def test_bfloat16_grads_off_the_tensor_core_k_step_match_jax():
    """The bf16 path at D = 24 (off the tensor cores' k-step of 16; on the
    card the kernels read the columns past D as zeros) through
    ``RingAttentionFunction`` against JAX's gradient of ``ring_attention``
    on the same bf16 inputs and cotangent, sp 2, causal, T / sp = 24."""
    b, t, h, d, sp = 2, 48, 2, 24, 2
    rng = np.random.default_rng(51)
    q, k, v, w = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4))
    jstep, jplace = _jax_step(sp)
    jq, jk, jv = (jplace(jnp.asarray(x, jnp.bfloat16)) for x in (q, k, v))
    want_out, vjp = jax.vjp(jstep, jq, jk, jv)
    want = vjp(jnp.asarray(w, jnp.bfloat16))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    out = attention.RingAttentionFunction.apply(tq, tk, tv, sp, True)
    out.backward(torch.from_numpy(w).to(torch.bfloat16))
    tol = 2.0 ** -7
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(want_out, np.float32),
                               rtol=0, atol=tol)
    for g, x in zip(want, (tq, tk, tv)):
        g = np.asarray(g, np.float32)
        assert x.grad.dtype == torch.bfloat16
        assert np.abs(g).max() > 0
        err = float(np.abs(x.grad.float().numpy() - g).max())
        assert err <= tol * max(1.0, float(np.abs(g).max()))


def test_wrappers_refuse_what_they_do_not_take():
    q = torch.zeros((1, 10, 2, 8))
    with pytest.raises(ValueError, match="split"):
        attention.fold(q, q, q, None, hop=0, sp=4, causal=True, finalize=True)
    with pytest.raises(TypeError):
        attention.fold(q.double(), q.double(), q.double(), None, hop=0, sp=1, causal=True,
                       finalize=True)
    with pytest.raises(ValueError, match="hop"):
        attention.fold(q, q, q, None, hop=2, sp=2, causal=True, finalize=True)


def test_entry_point_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ra.make_ring_attention_step(2)
    step, place = ra.make_ring_attention_step(2, device="cpu")
    assert place(np.zeros((1, 4, 1, 4), np.float32)).device.type == "cpu"


def test_flop_count():
    assert attention.attention_flops(4, 1024, 2, 1024, causal=False, products=2) == 4 * 4 * 1024 ** 2 * 2048
    assert attention.attention_flops(1, 4, 1, 2, causal=True, products=5) == 2 * 10 * 2 * 5
