"""``attn_bwd_delta`` (``delta = rowsum(dO * O)``, the first kernel of K3's
backward) on the CPU: the form ``ops/attention.py delta_form`` picks for
each shape, numpy statements of both forms' summation orders against
``row_dot_plain`` and a float64 reference, and ``row_dot`` past K3's
``MAX_HEAD_DIM`` against the float64 reference and against the gradient
JAX takes through ``ring_attention``.

Inputs are made from a seed with numpy. Tolerance: ``2e-5 x max(1, max
|want|)``, the f32 tolerance ``chip_smoke.k3_tolerances`` holds delta to on
the card (the same f32 products, summed in another order); the JAX
gradient within 1e-4 absolute, as ``tests/test_torch_ring_attention.py``
holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import chip_smoke
from incubator_brpc_tpu.models import ring_attention as jax_ra
from incubator_brpc_tpu_torch.models import ring_attention as ra
from incubator_brpc_tpu_torch.ops import attention

TOL = 2e-5
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# (d, dtype, aligned) -> the form and its lanes a row: 16-byte rows take the
# vector form with the largest power of two <= 32 and <= the row's vectors
# (8 bf16 or 4 f32 a vector); other rows, and rows off a 16-byte boundary,
# a warp a row
FORMS = {
    (4, "bf16"): ("general", 32), (12, "bf16"): ("general", 32), (16, "bf16"): ("vector", 2),
    (100, "bf16"): ("general", 32), (1000, "bf16"): ("vector", 32),
    (1024, "bf16"): ("vector", 32), (2048, "bf16"): ("vector", 32),
    (4096, "bf16"): ("vector", 32),
    (4, "f32"): ("vector", 1), (12, "f32"): ("vector", 2), (16, "f32"): ("vector", 4),
    (100, "f32"): ("vector", 16), (1000, "f32"): ("vector", 32), (1024, "f32"): ("vector", 32),
    (2048, "f32"): ("vector", 32), (4096, "f32"): ("vector", 32),
}


def test_the_table_covers_chip_smokes_head_dimensions():
    assert sorted({d for d, _ in FORMS}) == sorted(chip_smoke.DELTA_DS)
    lanes = {lanes for form, lanes in FORMS.values() if form == "vector"}
    assert lanes == {1, 2, 4, 16, 32}  # 8 lanes: bf16 D 64-120, f32 D 32-60
    assert attention.delta_form(64, torch.bfloat16, True) == ("vector", 8)
    assert attention.delta_form(32, torch.float32, True) == ("vector", 8)


@pytest.mark.parametrize("d,dtype", sorted(FORMS), ids=[f"{d}-{t}" for d, t in sorted(FORMS)])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "off16"])
def test_delta_form(d, dtype, aligned):
    want = FORMS[(d, dtype)] if aligned else ("general", 32)
    assert attention.delta_form(d, DTYPES[dtype], aligned) == want


def _inputs(seed, d, dtype, rows=(2, 5, 3)):
    """out and dout as torch tensors in ``dtype`` and as the float32 values
    the kernels widen them to, (rows, d)."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal(rows + (d,)).astype(np.float32)).to(DTYPES[dtype])
          for _ in range(2)]
    return ts, [t.float().numpy().reshape(-1, d) for t in ts]


def _fma(a, b, c):
    """f32 a * b + c: the product exact in float64, then rounded to f32
    (double rounding where the sum needs more than 53 bits: rare, within
    the tolerance)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _butterfly(partials):
    """``v += __shfl_xor_sync(v, off)`` for off = L/2 .. 1 across the group's
    L lanes; every lane ends with the same sum (f32 addition commutes)."""
    lanes = partials.shape[1]
    off = lanes // 2
    while off:
        partials = (partials + partials[:, np.arange(lanes) ^ off]).astype(np.float32)
        off //= 2
    assert (partials == partials[:, :1]).all()
    return partials[:, 0]


def vector_order(o, g, per_vec, lanes):
    """The vector form: lane l of the group holds the row's 16-byte vectors
    l, l + L, l + 2L, ... and accumulates them in order, each vector's
    elements in order, one f32 FMA chain; then the butterfly over L lanes.
    (The kernel's turns of 4 vectors a lane keep this order.)"""
    rows, d = o.shape
    nvec = d // per_vec
    partials = np.zeros((rows, lanes), np.float32)
    for lane in range(lanes):
        acc = np.zeros(rows, np.float32)
        for j in range(lane, nvec, lanes):
            for e in range(j * per_vec, (j + 1) * per_vec):
                acc = _fma(o[:, e], g[:, e], acc)
        partials[:, lane] = acc
    return _butterfly(partials)


def general_order(o, g):
    """The general form: lane l of a warp accumulates elements l, l + 32,
    ... in order, then the butterfly over 32 lanes."""
    rows, d = o.shape
    partials = np.zeros((rows, 32), np.float32)
    for lane in range(32):
        acc = np.zeros(rows, np.float32)
        for e in range(lane, d, 32):
            acc = _fma(o[:, e], g[:, e], acc)
        partials[:, lane] = acc
    return _butterfly(partials)


def _close(got, want):
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("d,dtype", sorted(FORMS), ids=[f"{d}-{t}" for d, t in sorted(FORMS)])
def test_both_forms_orders_hold_the_tolerance(d, dtype):
    """Numpy statements of the order each form sums in, against
    ``row_dot_plain`` and float64, where the form applies (the general form
    applies everywhere)."""
    (out, dout), (o, g) = _inputs(d, d, dtype)
    exact = (o.astype(np.float64) * g).sum(-1)
    # row_dot_plain is (B, H, T); the statements run over (B, T, H) rows
    plain = attention.row_dot_plain(out, dout).transpose(1, 2).reshape(-1).numpy()
    _close(plain, exact)
    sums = [general_order(o, g)]
    form, lanes = attention.delta_form(d, DTYPES[dtype], True)
    if form == "vector":
        sums.append(vector_order(o, g, 16 // out.element_size(), lanes))
    for got in sums:
        assert got.dtype == np.float32
        _close(got, exact)
        _close(got, plain.astype(np.float64))


def test_row_dot_takes_d_past_max_head_dim():
    """``row_dot`` no longer asks for D <= MAX_HEAD_DIM: at D = 2048 and
    4096 it matches float64 on the CPU in both dtypes; dK/dV and dQ keep the
    limit on the card."""
    assert attention.MAX_HEAD_DIM == 1024
    for d in (2048, 4096):
        for dtype in DTYPES:
            (out, dout), (o, g) = _inputs(d + 1, d, dtype)
            got = attention.row_dot(out, dout)
            assert got.dtype == torch.float32 and got.shape == (2, 3, 5)
            _close(got.transpose(1, 2).reshape(-1).numpy(), (o.astype(np.float64) * g).sum(-1))


def test_grads_at_d_2048_match_jax():
    """The port's backward (delta, dK/dV, dQ: their plain versions on the
    CPU) at D = 2048 against ``jax.grad`` through ``ring_attention``."""
    rng = np.random.default_rng(2048)
    q, k, v = (rng.standard_normal((1, 8, 1, 2048)).astype(np.float32) for _ in range(3))
    mesh = Mesh(np.array(jax.devices()[:1]), axis_names=("sp",))
    jstep, jplace = jax_ra.make_ring_attention_step(mesh, causal=True)

    def loss(a, b, c):
        return jnp.mean(jnp.square(jstep(a, b, c)))

    want = jax.grad(loss, argnums=(0, 1, 2))(jplace(q), jplace(k), jplace(v))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    ra.ring_attention(tq, tk, tv, sp=1).square().mean().backward()
    for w, t in zip(want, (tq, tk, tv)):
        g = t.grad.numpy()
        assert np.isfinite(g).all() and np.abs(g).sum() > 0
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4)
