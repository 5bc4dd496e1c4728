"""K4f of the port (``incubator_brpc_tpu_torch/ops/elementwise.py``: with
``heads = 0``, the last MLP layer's residual add, the ring mean over the
sequence and its add, ``(x + delta) + _ring_context(x + delta)``, and its
gradient) against the JAX package's ``_ring_context`` inside ``shard_map``
at sp = 1 and ``jax.vjp`` of it, jitted, on the CPU, where the wrappers run
the plain versions.

Inputs are made from a seed with numpy and handed to both, at (batch, T,
d) = (2, 16, 8), (4, 33, 40) and (3, 64, 1000), with and without delta.
Tolerances, each relative to max(1, max |JAX's value|):

- float32 within 1e-6 (the forward) and 1e-5 (the gradient), the
  ``FWD_TOL`` and ``GRAD_TOL`` of ``tests/test_torch_elementwise.py``: the
  sums over T run in another order;
- bfloat16: the forward bit for bit jitted JAX's (every op rounds where
  XLA:CPU rounds; the sum over T reads ``x + delta`` before its rounding,
  as XLA:CPU does, and is exact in float64); the gradient within one bf16
  ulp of its largest value (2^-7), with the differing elements pinned
  (``GRAD_DIFFERING``): the vjp's ``reduce_sum`` over T runs in bfloat16
  in XLA:CPU's order, the port's in float64, rounded to float32 and then
  to bfloat16 (ROADMAP, "Differences by design"). A mean one bf16 ulp off
  moves every element of its column: at (3, 64, 1000), 47,825 of 192,000
  gradient elements differ.

The autograd function's gradient is the plain backward's bit for bit, and
reaches ``x`` and ``delta`` alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from incubator_brpc_tpu.models import fabricnet as jax_fn
from incubator_brpc_tpu.parallel.compat import shard_map_compat
from incubator_brpc_tpu_torch.ops import elementwise as E
from incubator_brpc_tpu_torch.ops import kernels

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL, GRAD_TOL, BF16_ULP = 1e-6, 1e-5, 2.0 ** -7
SHAPES = [(2, 16, 8), (4, 33, 40), (3, 64, 1000)]
SHAPE_IDS = ["2x16x8", "4x33x40", "3x64x1000"]
# bf16 gradient elements that differ from jitted JAX's, by shape (the same
# with delta and without: the gradient does not read the inputs)
GRAD_DIFFERING = {(2, 16, 8): 53, (4, 33, 40): 1318, (3, 64, 1000): 47825}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These sizes gain nothing from threads; one keeps the xdist workers'
    cores for the timing-sensitive tests running beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(shape):
    rng = np.random.default_rng(sum(shape))
    return [(rng.standard_normal(shape) * scale).astype(np.float32) for scale in (2.0, 1.0, 1.0)]


def _jax(x, delta, g):
    """``s + _ring_context(s)``, ``s = x + delta`` (``x`` without delta),
    and its vjp at ``g`` for ``x`` and ``delta``, jitted inside ``shard_map``
    over a one-device sp axis."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))

    def f(x, delta, g):
        def block(x, delta):
            s = x if delta is None else x + delta
            return s + jax_fn._ring_context(s)
        if delta is None:
            out, vjp = jax.vjp(lambda a: block(a, None), x)
            (gx,) = vjp(g)
            return out, gx, gx
        out, vjp = jax.vjp(block, x, delta)
        return (out,) + vjp(g)

    args = (x, g) if delta is None else (x, delta, g)
    fn = (lambda a, b: f(a, None, b)) if delta is None else f
    return jax.jit(shard_map_compat(fn, mesh=mesh, in_specs=(P(),) * len(args),
                                    out_specs=(P(), P(), P())))(*args)


def _f32(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _differing(got, want):
    return int((_f32(got).view(np.int32) != _f32(want).view(np.int32)).sum())


def _close(got, want, tol):
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("with_delta", [True, False], ids=["delta", "nodelta"])
def test_ring_mean_add_matches_jax(dtype, shape, with_delta):
    jdt, tdt = DTYPES[dtype]
    x, delta, g = _inputs(shape)
    if not with_delta:
        delta = None
    j_out, j_gx, j_gd = _jax(*(None if a is None else jnp.asarray(a, jdt) for a in (x, delta, g)))
    tx, td, tg = (None if a is None else torch.from_numpy(a).to(tdt) for a in (x, delta, g))
    before = kernels.launch_counts()
    out = E.ring_mean_add_fwd(tx, td)
    g_s = E.ring_mean_add_bwd(tg)
    assert kernels.launch_counts() == before  # the CPU runs the plain versions
    assert out.dtype == g_s.dtype == tdt and out.shape == g_s.shape == tuple(shape)
    assert torch.equal(out, E.ring_mean_add_plain(tx, td))
    assert torch.equal(g_s, E.ring_mean_add_bwd_plain(tg))
    assert _differing(j_gx, j_gd) == 0  # the sum's gradient reaches both addends
    if dtype == "float32":
        _close(out, j_out, FWD_TOL)
        _close(g_s, j_gx, GRAD_TOL)
        return
    assert _differing(out, j_out) == 0
    _close(g_s, j_gx, BF16_ULP)
    assert _differing(g_s, j_gx) == GRAD_DIFFERING[tuple(shape)]


def _rounded_chain(x, delta):
    """K4f's forward in bfloat16 from its jaxpr, in numpy float32 with each
    rounding stated: s = bf16(x + delta); the sum over T of x + delta in
    float32 (exact here), times 1/T in float32, rounded; bf16(s + m)."""
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()  # noqa: E731
    s = bf(x + delta)
    inv = np.float32(1) / np.float32(x.shape[1])
    m = bf((x + delta).astype(np.float64).sum(axis=1, keepdims=True).astype(np.float32) * inv)
    return bf(s + m)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_bfloat16_plain_version_is_its_chain_rounded_op_by_op(shape):
    """The bf16 plain version equals its chain stated in numpy with each
    rounding of the jaxpr (and XLA's dropped rounding of s ahead of the
    sum), and not the same chain rounded once at the end."""
    x, delta, _ = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in _inputs(shape))
    got = E.ring_mean_add_plain(*(torch.from_numpy(a).to(torch.bfloat16) for a in (x, delta)))
    assert _differing(got, _rounded_chain(x, delta)) == 0
    once = (x + delta) + (x + delta).mean(axis=1, keepdims=True)
    once = torch.from_numpy(once.astype(np.float32)).to(torch.bfloat16)
    assert _differing(got, once) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_delta", [True, False], ids=["delta", "nodelta"])
def test_autograd_gradient_is_the_plain_backward(dtype, with_delta):
    """``ring_mean_add`` through autograd: the forward is the plain
    version's, and the gradient reaching x (and delta) is
    ``ring_mean_add_bwd_plain``'s, bit for bit."""
    tdt = DTYPES[dtype][1]
    x, delta, g = (torch.from_numpy(a).to(tdt) for a in _inputs((4, 33, 40)))
    x.requires_grad_()
    if with_delta:
        delta.requires_grad_()
    else:
        delta = None
    out = E.ring_mean_add(x, delta)
    assert torch.equal(out, E.ring_mean_add_plain(x.detach(), None if delta is None
                                                  else delta.detach()))
    grads = torch.autograd.grad(out, [x] + ([delta] if with_delta else []), g)
    want = E.ring_mean_add_bwd_plain(g)
    assert all(gr.dtype == tdt and torch.equal(gr, want) for gr in grads)


def test_gradcheck_float64():
    rng = np.random.default_rng(7)
    x, delta = (torch.from_numpy(rng.standard_normal((2, 5, 3))).requires_grad_()
                for _ in range(2))
    assert torch.autograd.gradcheck(E.ring_mean_add, (x, delta))
    assert torch.autograd.gradcheck(lambda a: E.ring_mean_add(a), (x,))


def test_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match="batch, T, d"):
        E.ring_mean_add_fwd(x[0])
    with pytest.raises(ValueError, match="delta"):
        E.ring_mean_add_fwd(x, torch.zeros((2, 4, 7)))
    with pytest.raises(TypeError):
        E.ring_mean_add_bwd(torch.zeros((2, 4, 8), dtype=torch.int32))


# -- K4f over the sp ring (sp > 1) ------------------------------------------------
#
# ``_ring_context`` inside ``shard_map`` over sp of the 8 virtual CPU devices,
# the sequence sharded over sp, against the plain versions with ``sp``; the
# same tolerances as above. Rank i's block mean is folded around the ring in
# rank i's own order and multiplied by 1/sp in float32 (XLA's division by a
# constant), so from sp = 3 on the ranks' means may differ in the last bit:
# with sums that are exact in any order (integer inputs) the port is bit for
# bit JAX's in both dtypes, forward and gradient, and one fold order for
# every rank is not.

SP_SHAPES = [(2, 24, 8), (3, 36, 40), (2, 96, 1000)]
SP_SHAPE_IDS = ["2x24x8", "3x36x40", "2x96x1000"]
# bf16 gradient elements that differ from jitted JAX's, by (sp, shape): the
# blocks' reduce_sum runs in bfloat16 in XLA:CPU's order, as at sp = 1
SP_GRAD_DIFFERING = {
    (2, (2, 24, 8)): 59, (2, (3, 36, 40)): 993, (2, (2, 96, 1000)): 38704,
    (3, (2, 24, 8)): 89, (3, (3, 36, 40)): 1006, (3, (2, 96, 1000)): 43069,
    (4, (2, 24, 8)): 82, (4, (3, 36, 40)): 955, (4, (2, 96, 1000)): 39902,
}


def _jax_sp(x, delta, g, sp):
    """``s + _ring_context(s)``, ``s = x + delta``, and its vjp at ``g``,
    jitted inside ``shard_map`` over ``sp`` devices, the sequence sharded."""
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))

    def f(x, delta, g):
        def block(x, delta):
            s = x + delta
            return s + jax_fn._ring_context(s)
        out, vjp = jax.vjp(block, x, delta)
        return (out,) + vjp(g)

    spec = P(None, "sp", None)
    return jax.jit(shard_map_compat(f, mesh=mesh, in_specs=(spec,) * 3,
                                    out_specs=(spec,) * 3))(x, delta, g)


def _sp_inputs(shape, integers=False):
    rng = np.random.default_rng(sum(shape) + 3)
    if integers:
        return [rng.integers(-8, 9, shape).astype(np.float32) for _ in range(3)]
    return [(rng.standard_normal(shape) * scale).astype(np.float32) for scale in (2.0, 1.0, 1.0)]


@pytest.fixture(scope="module")
def jax_sp_results():
    """JAX's forward and gradients, by (dtype, sp, shape, integers)."""
    out = {}
    for dtype, (jdt, _) in DTYPES.items():
        for sp in (2, 3, 4):
            for shape in SP_SHAPES:
                for integers in (False, True):
                    args = [jnp.asarray(a, jdt) for a in _sp_inputs(shape, integers)]
                    out[dtype, sp, shape, integers] = _jax_sp(*args, sp)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sp", [2, 3, 4])
@pytest.mark.parametrize("shape", SP_SHAPES, ids=SP_SHAPE_IDS)
def test_ring_mean_add_over_sp_matches_jax(jax_sp_results, dtype, sp, shape):
    tdt = DTYPES[dtype][1]
    j_out, j_gx, j_gd = jax_sp_results[dtype, sp, shape, False]
    tx, td, tg = (torch.from_numpy(a).to(tdt) for a in _sp_inputs(shape))
    out = E.ring_mean_add_fwd(tx, td, sp)
    g_s = E.ring_mean_add_bwd(tg, sp)
    assert torch.equal(out, E.ring_mean_add_plain(tx, td, sp))
    assert torch.equal(g_s, E.ring_mean_add_bwd_plain(tg, sp))
    assert _differing(j_gx, j_gd) == 0
    if dtype == "float32":
        _close(out, j_out, FWD_TOL)
        _close(g_s, j_gx, GRAD_TOL)
        return
    assert _differing(out, j_out) == 0
    _close(g_s, j_gx, BF16_ULP)
    assert _differing(g_s, j_gx) == SP_GRAD_DIFFERING[sp, tuple(shape)]


def _one_order(x, delta, sp):
    """The forward with every rank folding the means in rank order 0, 1, ...:
    not JAX's ring (a test that cannot tell it apart holds nothing)."""
    s = x + delta
    b, t, d = s.shape
    local = (s.float().reshape(b, sp, t // sp, d).sum(dim=2) * (np.float32(1) / np.float32(t // sp))
             ).to(s.dtype)
    acc = torch.zeros_like(local[:, 0])
    for j in range(sp):
        acc = acc + local[:, j]
    m = (acc.float() * (np.float32(1) / np.float32(sp))).to(s.dtype)
    return s + m[:, None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sp", [2, 3, 4])
@pytest.mark.parametrize("shape", SP_SHAPES[:2], ids=SP_SHAPE_IDS[:2])
def test_ring_mean_add_over_sp_bit_for_bit_where_sums_are_exact(jax_sp_results, dtype, sp, shape):
    tdt = DTYPES[dtype][1]
    j_out, j_gx, _ = jax_sp_results[dtype, sp, shape, True]
    tx, td, tg = (torch.from_numpy(a).to(tdt) for a in _sp_inputs(shape, integers=True))
    out = E.ring_mean_add_plain(tx, td, sp)
    assert _differing(out, j_out) == 0
    assert _differing(E.ring_mean_add_bwd_plain(tg, sp), j_gx) == 0
    if sp >= 3 and shape == SP_SHAPES[1]:  # 2 x 24 x 8 has too few columns to show it
        assert _differing(_one_order(tx, td, sp), j_out) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sp_one_is_the_one_rank_form(dtype):
    """``sp=1`` is the function of the tests above, bit for bit (no ring, no
    ``0 +``)."""
    tdt = DTYPES[dtype][1]
    x, delta, g = (torch.from_numpy(a).to(tdt) for a in _inputs((4, 33, 40)))
    assert torch.equal(E.ring_mean_add_plain(x, delta, 1), E.ring_mean_add_plain(x, delta))
    assert torch.equal(E.ring_mean_add_bwd_plain(g, 1), E.ring_mean_add_bwd_plain(g))


@pytest.mark.parametrize("sp", [2, 3])
def test_autograd_over_sp_is_the_plain_backward(sp):
    x, delta, g = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs((3, 36, 40)))
    x.requires_grad_()
    delta.requires_grad_()
    out = E.ring_mean_add(x, delta, sp)
    assert torch.equal(out, E.ring_mean_add_plain(x.detach(), delta.detach(), sp))
    gx, gd = torch.autograd.grad(out, [x, delta], g)
    want = E.ring_mean_add_bwd_plain(g, sp)
    assert torch.equal(gx, want) and torch.equal(gd, want)
    x64, d64 = (torch.from_numpy(np.random.default_rng(9).standard_normal((2, 6, 3)))
                .requires_grad_() for _ in range(2))
    assert torch.autograd.gradcheck(lambda a, b: E.ring_mean_add(a, b, sp), (x64, d64))


def test_wrappers_refuse_a_sequence_sp_does_not_split():
    x = torch.zeros((2, 6, 8))
    with pytest.raises(ValueError, match="sp=4"):
        E.ring_mean_add_fwd(x, None, 4)
    with pytest.raises(ValueError, match="sp=0"):
        E.ring_mean_add_bwd(x, 0)
