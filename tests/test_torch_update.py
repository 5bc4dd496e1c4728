"""K4e of the port against the JAX package on the CPU, where the wrappers
run their plain versions: the SGD update (``ops/update.py``,
``sgd_update_multi``), the MoE's gate and combine and the loss
(``ops/elementwise.py``), and FabricNet's sliced schedules
(``models/fabricnet.py``, ``"serialized"`` and ``"overlapped"``).

Inputs are made from a seed with numpy and handed to both packages.
Tolerances:

- the update, bitwise JAX's jitted ``p - lr * g`` and the sliced form of
  ``make_train_step`` (fabricnet.py:381-391), in float32 and bfloat16 (0
  differing elements); the expression the port used before
  (``p.sub_(lr * g)``, the learning rate in float32, two roundings in
  float32) misses it;
- the loss's gradient bitwise ``jax.grad``'s, the bfloat16 loss bitwise;
  the float32 loss within 1e-6 relative (XLA:CPU and PyTorch add the
  squares in another order);
- the MoE combine and its gradient ``torch.equal`` to the model's
  expression before K4e (with the gate as the reference computes it, ``1 /
  (1 + exp(-x))`` op by op and JAX's derivative ``g (1 - g)``) and to
  autograd through it; ``gradcheck`` in float64; the gate, ``out`` and
  ``d_yr`` bit for bit JAX's ``_moe`` with ``_stage_fn``'s residual add (in
  bfloat16; float32 within 1e-6, XLA:CPU contracting ``s + yr g`` into an
  FMA and using its own exp), ``d_logit`` too but for the row sum, which
  JAX takes in bf16 and the port exactly: the differing elements pinned;
- the sliced schedules against JAX's on the one-device mesh as
  ``tests/test_torch_fabricnet.py`` holds the fused step: float32 within
  1e-5 relative to each parameter's largest value after 1 and 3 steps,
  bfloat16 within 0.05; against the port's fused step within the
  reference's own 2e-4 / 2e-5 (``tests/test_fabricnet.py``); serialized
  and overlapped byte for byte.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_brpc_tpu.models import fabricnet as jax_fn
from incubator_brpc_tpu.parallel.mesh import make_fabric_mesh as jax_mesh
from incubator_brpc_tpu_torch.models import fabricnet as fn
from incubator_brpc_tpu_torch.ops import elementwise as E
from incubator_brpc_tpu_torch.ops import kernels
from incubator_brpc_tpu_torch.ops import update as U
from incubator_brpc_tpu_torch.parallel import mesh as pmesh

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LR = 1e-2
N = 1 << 14
# p = 1 and lr * g = -(2^-24 + 2^-60) exactly: p - lr * g lies just above the
# float32 midpoint 1 + 2^-24, so one rounding gives 1 + 2^-23; a float64 sum
# rounded to nearest drops the 2^-60 and then rounds the tie to 1
CRAFTED_LR = 4097 / 4096
CRAFTED = (1.0, -16773121 * 2.0 ** -48)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These sizes gain nothing from threads; one keeps the xdist workers'
    cores for the timing-sensitive tests running beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _arrays(seed, count, n=N):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    return [p] + [(rng.standard_normal(n) * 0.3).astype(np.float32) for _ in range(count)]


def _torch(arrays, dtype):
    """Copies, never views: JAX on the CPU may share a numpy input's buffer
    and run a jitted call after it returns, so the port's in-place updates
    must not write into the arrays handed to JAX (ROADMAP C5)."""
    return [torch.tensor(a).to(DTYPES[dtype][1]) for a in arrays]


def _jax_result(fn, arrays, dtype):
    """``fn`` jitted on the arrays in ``dtype``, read back to numpy (f32)
    before the caller touches anything in place."""
    return _bits(jax.jit(fn)(*(jnp.asarray(a, DTYPES[dtype][0]) for a in arrays)))


def _bits(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _differing(got, want):
    return int((_bits(got) != _bits(want)).sum())


def _jax_sliced(p, *gs):
    """The sliced schedules' accumulation and scaled update
    (fabricnet.py:381-391) for one leaf, jitted as the step is."""
    inv = 1.0 / len(gs)
    acc = gs[0]
    for g in gs[1:]:
        acc = acc + g
    return p - LR * (acc * jnp.asarray(inv, acc.dtype)).astype(p.dtype)


# -- the repair: the update is JAX's ----------------------------------------------


# (g, JAX's p - lr * g, the old p.sub_(lr * g)) at p = 1, lr = 0.01: an element
# where the two differ (ROADMAP C4)
EXAMPLE = {"bfloat16": (2.140625, 0.9765625, 0.98046875),
           "float32": (1.7393678426742554, 0.9826063513755798, 0.9826062917709351)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_is_jax_update_and_the_old_expression_is_not(dtype):
    p, g = _arrays(1, 1)
    p[0], g[0] = 1.0, EXAMPLE[dtype][0]
    want = _jax_result(lambda p, g: p - LR * g, (p, g), dtype)
    tp, tg = _torch([p, g], dtype)
    old = tp.clone().sub_(LR * tg)  # the update before the repair
    before = kernels.launch_counts()
    U.sgd_update_multi("fused", [tp], [tg], LR)
    assert kernels.launch_counts() == before  # the CPU runs the plain version
    assert _differing(tp, want) == 0
    assert _differing(old, want) > 0
    assert (float(want[0]), float(old[0])) == EXAMPLE[dtype][1:]


@pytest.mark.parametrize("slices", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sliced_update_is_jax_sliced_update(dtype, slices):
    p, *gs = _arrays(2 + slices, slices)
    want = _jax_result(_jax_sliced, [p, *gs], dtype)
    tp, *tg = _torch([p, *gs], dtype)
    old = tp.clone()
    acc = tg[0].clone()
    for g in tg[1:-1]:
        U.sgd_update_multi("accumulate", [acc], [g])
    U.sgd_update_multi("last", [tp], [tg[-1]], LR, acc=[acc], slices=slices)
    assert _differing(tp, want) == 0
    old.sub_(LR * (sum(tg[1:], tg[0]) * (1.0 / slices)))
    assert _differing(old, want) > 0


@pytest.mark.parametrize("inputs", ["views, as before the repair", "copies"])
def test_references_are_not_computed_from_buffers_the_port_updates(inputs):
    """ROADMAP C5: ``jnp.asarray`` of a 64-byte aligned float32 array shares
    its buffer on the CPU, and a jitted call returns before it has run. The
    update tests handed JAX the buffer that ``torch.from_numpy`` gave the
    port to update in place, so when JAX's queue was busy the reference was
    computed from the updated parameters: all 16,384 elements differed.
    Here a large product keeps the queue busy: the views give that wrong
    reference; ``_torch``'s copies and ``_jax_result`` give the right one."""
    p, g = _arrays(9, 1)
    buf = np.zeros(N + 16, np.float32)
    aligned = buf[(-buf.ctypes.data % 64) // 4:][:N]
    aligned[:] = p
    assert jnp.asarray(aligned).unsafe_buffer_pointer() == aligned.ctypes.data  # shared
    fused = lambda p, g: p - LR * g  # noqa: E731
    honest = _jax_result(fused, (p.copy(), g), "float32")
    big = jnp.ones((1024, 1024), jnp.float32)
    busy = jax.jit(lambda x: (x @ x @ x @ x).sum())
    busy(big).block_until_ready()  # compiled before the queue is timed
    busy(big)  # the queue is busy for a while
    if inputs == "copies":
        want = _jax_result(fused, (aligned, g), "float32")
        tp, tg = _torch([aligned, g], "float32")
    else:
        want = jax.jit(fused)(*(jnp.asarray(a) for a in (aligned, g)))
        tp, tg = torch.from_numpy(aligned), torch.from_numpy(g)
    U.sgd_update_multi("fused", [tp], [tg], LR)
    assert _differing(tp, honest) == 0
    if inputs == "copies":
        assert _differing(want, honest) == 0 and not np.shares_memory(tp.numpy(), aligned)
    else:
        assert _differing(want, honest) == N


def test_float32_update_rounds_once_where_float64_would_round_twice():
    p, g = (torch.tensor([v], dtype=torch.float32) for v in CRAFTED)
    want = jax.jit(lambda p, g: p - CRAFTED_LR * g)(jnp.float32(CRAFTED[0]), jnp.float32(CRAFTED[1]))
    assert float(want) == 1 + 2.0 ** -23
    assert float((p.double() - CRAFTED_LR * g.double()).float()) == 1.0
    U.sgd_update_multi("fused", [p], [g], CRAFTED_LR)
    assert float(p) == float(want)


# -- K4e-a's plain modes -------------------------------------------------------------


def _rounded_once(exact: Fraction) -> float:
    """``exact`` rounded to the nearest float32, ties to even."""
    c = np.float32(float(exact))
    best = None
    for v in (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))):
        key = (abs(Fraction(float(v)) - exact), int(np.float32(v).view(np.int32)) & 1)
        best = (key, v) if best is None or key < best[0] else best
    return float(best[1])


@pytest.mark.parametrize("mode", ["fused", "accumulate", "last"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_modes_equal_the_ops_they_replace(dtype, mode):
    """bfloat16: the chain of tensor ops, each rounding to bf16. float32:
    ``acc + g``, and the update rounded once from the exact value (Fraction
    arithmetic), the crafted element included."""
    p, g, acc = _torch(_arrays(7, 2, 256), dtype)
    if dtype == "float32":
        p[0], g[0] = CRAFTED
    lr = CRAFTED_LR if dtype == "float32" else LR
    got = p.clone()
    U.sgd_update_plain(mode, got, g, lr, acc if mode == "last" else None, 3)
    lr_d, inv_d = U.update_scalars(p.dtype, lr, 3, mode)
    if mode == "accumulate":
        want = p + g
    elif dtype == "bfloat16":
        h = (acc + g) * inv_d if mode == "last" else g
        want = p - h * lr_d
    else:
        h = (acc + g).tolist() if mode == "last" else g.tolist()
        want = torch.tensor([_rounded_once(Fraction(pv) - Fraction(lr_d) * Fraction(hv))
                             for pv, hv in zip(p.tolist(), h)])
    assert torch.equal(got, want)
    if dtype == "float32" and mode == "fused":
        assert float(got[0]) == 1 + 2.0 ** -23


def test_update_wrapper_refuses_what_it_does_not_take():
    p, g = torch.zeros(4), torch.zeros(4)
    with pytest.raises(ValueError, match="unknown mode"):
        U.sgd_update_multi("adam", [p], [g], LR)
    with pytest.raises(ValueError, match="grads"):
        U.sgd_update_multi("fused", [p], [torch.zeros(5)], LR)
    with pytest.raises(ValueError, match="grads"):
        U.sgd_update_multi("fused", [p], [g.to(torch.bfloat16)], LR)
    with pytest.raises(ValueError, match="accumulators"):
        U.sgd_update_multi("last", [p], [g], LR, slices=2)
    with pytest.raises(ValueError, match="slices >= 2"):
        U.sgd_update_multi("last", [p], [g], LR, acc=[g], slices=1)
    assert U.launches(16) == 1 and U.launches(65) == 2


# -- K4e-b/c: the MoE's gate and combine ---------------------------------------------


def _moe_inputs(dtype, t=12, e=2, d=33, seed=5):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((t, d), (e, t // e, d), (t, 1), (t, d))]
    return [torch.from_numpy(a).to(dtype) for a in arrays]


class _Logistic(torch.autograd.Function):
    """``jax.nn.sigmoid`` as the reference computes it: ``1 / (1 + exp(-x))``
    op by op in x's dtype, and JAX's derivative ``d (g (1 - g))``."""

    @staticmethod
    def forward(ctx, x):
        g = torch.reciprocal(1.0 + torch.exp(-x))
        ctx.save_for_backward(g)
        return g

    @staticmethod
    def backward(ctx, d):
        (g,) = ctx.saved_tensors
        return d * (g * (1.0 - g))


class _Broadcast(torch.autograd.Function):
    """``g`` (t, 1) broadcast over the d columns of ``like``; its backward
    sums the columns as the port does (exactly, in float64, rounded to
    float32 and then to the dtype) where autograd's broadcast would sum in
    float32 in its own order."""

    @staticmethod
    def forward(ctx, g, like):
        return g.expand_as(like)

    @staticmethod
    def backward(ctx, grad):
        return grad.sum(-1, keepdim=True, dtype=torch.float64).to(
            torch.promote_types(grad.dtype, torch.float32)).to(grad.dtype), None


def _old_moe_tail(s, yr, logit):
    """The model's expression before K4e: ``_moe``'s gate and
    ``routed_out * g``, then ``_stage_fn``'s ``s + ...``, with the gate
    stated as the reference computes it (:class:`_Logistic`) and its
    broadcast summed back as the port sums it (:class:`_Broadcast`)."""
    e, per, d = yr.shape
    routed_out = yr.transpose(0, 1).reshape(e * per, d)
    return s + routed_out * _Broadcast.apply(_Logistic.apply(logit), routed_out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("t,e,d", [(12, 2, 33), (9, 3, 8), (4, 1, 1000)])
def test_moe_combine_equals_the_old_expression_and_its_gradient(dtype, t, e, d):
    s, yr, logit, dy = _moe_inputs(dtype, t, e, d)
    out, g = E.moe_combine_fwd(s, yr, logit)
    assert torch.equal(out, _old_moe_tail(s, yr, logit)) and torch.equal(g, _Logistic.apply(logit))
    leaves = [x.clone().requires_grad_() for x in (s, yr, logit)]
    want = torch.autograd.grad(_old_moe_tail(*leaves), leaves, dy)
    leaves = [x.clone().requires_grad_() for x in (s, yr, logit)]
    got = torch.autograd.grad(E.moe_combine(*leaves), leaves, dy)
    for name, a, b in zip(("d_s", "d_yr", "d_logit"), got, want):
        assert a.shape == b.shape and torch.equal(a, b), name


# (t = d tokens, e experts, d_expert): the tokens are the identity, so
# d(gate_w) of ``_moe`` is d_logit itself; and the bf16 d_logit elements
# that differ from JAX's (its row sum in bf16), pinned
MOE_JAX_SHAPES = [(32, 2, 16), (96, 3, 8)]
MOE_DLOGIT_DIFFERING = {(32, 2, 16): 21, (96, 3, 8): 68}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,e,fe", MOE_JAX_SHAPES, ids=["32x2", "96x3"])
def test_moe_combine_is_jaxs_moe_and_stage_add(dtype, t, e, fe):
    """K4e-b/c against ``_moe`` itself (ep = 1, inside ``shard_map``) and
    ``_stage_fn``'s ``x + _moe(...)``: the port is handed JAX's gate logit
    and experts' output and gives ``out`` (bf16 bit for bit) and the gate
    (bit for bit ``jax.nn.sigmoid``); ``d_logit`` is ``_moe``'s gradient of
    ``gate_w`` (the tokens are the identity), bit for bit but for the rows
    whose sum JAX rounds otherwise (bf16: pinned, and within one bf16 ulp
    of max(1, max |JAX's|)); ``d_yr`` bit for bit ``jax.vjp`` of the
    combine stated with ``jax.nn.sigmoid``. f32 within the forward's 1e-6
    and the gradients' 1e-5."""
    from jax.sharding import Mesh, PartitionSpec as P

    from incubator_brpc_tpu.parallel.compat import shard_map_compat

    d = t
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(t + e)
    w1, w2 = (jnp.asarray(rng.standard_normal(sh) / np.sqrt(sh[1]), jdt)
              for sh in ((e, d, fe), (e, fe, d)))
    gate_w = jnp.asarray(rng.standard_normal((d, 1)) * 2, jdt)
    x = jnp.eye(t, dtype=jdt).reshape(1, t, d)
    s, dy = (jnp.asarray(rng.standard_normal((1, t, d)), jdt) for _ in range(2))
    mesh = Mesh(np.array(jax.devices()[:1]), ("ep",))

    def stage(s, w1, w2, gate_w, x, dy):
        out, vjp = jax.vjp(lambda gw: s + jax_fn._moe(w1, w2, gw, x), gate_w)
        return out, vjp(dy)[0]

    j_out, j_dgate = jax.jit(shard_map_compat(stage, mesh=mesh, in_specs=(P(),) * 6,
                                              out_specs=(P(), P())))(s, w1, w2, gate_w, x, dy)
    tokens = x.reshape(t, d)
    logit = jax.jit(lambda a, b: a @ b)(tokens, gate_w)
    yr = jax.jit(lambda xr, w1, w2: jnp.einsum(
        "etf,efd->etd", jax_fn._gelu(jnp.einsum("etd,edf->etf", xr, w1)), w2))(
        tokens.reshape(t // e, e, d).swapaxes(0, 1), w1, w2)
    T = lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdt)  # noqa: E731
    out, g = E.moe_combine_fwd(T(s).reshape(t, d), T(yr), T(logit))
    d_yr, d_logit = E.moe_combine_bwd(T(dy).reshape(t, d), T(yr), g)
    want_g = jax.jit(jax.nn.sigmoid)(logit)
    want_dyr = jax.jit(lambda s, yr, lg, dy: jax.vjp(
        lambda yr: s + yr.swapaxes(0, 1).reshape(t, d) * jax.nn.sigmoid(lg), yr)[1](dy)[0])(
        s.reshape(t, d), yr, logit, dy.reshape(t, d))
    if dtype == "float32":  # FWD_TOL and GRAD_TOL of tests/test_torch_elementwise.py
        for got, want, tol in ((g, want_g, 1e-6), (out, j_out.reshape(t, d), 1e-6),
                               (d_yr, want_dyr, 1e-5), (d_logit, j_dgate, 1e-5)):
            np.testing.assert_allclose(_bits(got), _bits(want), rtol=0,
                                       atol=tol * max(1.0, float(np.abs(_bits(want)).max())))
        return
    assert _differing(g, want_g) == 0
    assert _differing(d_yr, want_dyr) == 0
    assert _differing(out, j_out.reshape(t, d)) == 0
    assert _differing(d_logit, j_dgate) == MOE_DLOGIT_DIFFERING[(t, e, fe)]
    # within one bf16 ulp of max(1, max |JAX's|), as the norm's gradient
    np.testing.assert_allclose(_bits(d_logit), _bits(j_dgate), rtol=0,
                               atol=2.0 ** -7 * max(1.0, float(np.abs(_bits(j_dgate)).max())))


def test_moe_combine_gradcheck_float64():
    s, yr, logit, _ = _moe_inputs(torch.float64, 6, 2, 5)
    assert torch.autograd.gradcheck(
        E.moe_combine, [x.requires_grad_() for x in (s, yr, logit)])


def test_moe_combine_refuses_mismatched_shapes():
    s, yr, logit, _ = _moe_inputs(torch.float32)
    with pytest.raises(ValueError, match="want"):
        E.moe_combine_fwd(s, yr[:, :-1], logit)
    with pytest.raises(ValueError, match="want"):
        E.moe_combine_fwd(s, yr, logit[:-1])
    with pytest.raises(ValueError, match="gate"):
        E.moe_combine_fwd(s, yr, logit.to(torch.bfloat16))


# -- K4e-d: the loss -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 16, 64), (3, 5, 33)], ids=["4x16x64", "3x5x33"])
def test_loss_and_gradient_are_jax_and_autograds(dtype, shape):
    rng = np.random.default_rng(sum(shape))
    o, y = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jy = jnp.asarray(y, DTYPES[dtype][0])
    jl, jg = jax.jit(jax.value_and_grad(lambda o: jnp.mean(jnp.square(o - jy))))(
        jnp.asarray(o, DTYPES[dtype][0]))
    to, ty = _torch([o, y], dtype)
    loss, d_out = E.mse_loss_fwd(to, ty)
    assert loss.dtype == to.dtype and loss.shape == () and d_out.shape == to.shape
    assert _differing(d_out, jg) == 0
    if dtype == "bfloat16":
        assert _differing(loss, jl) == 0
    else:
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    # autograd through the model's expression before K4e gives the same d_out
    og = to.clone().requires_grad_()
    old = (og - ty).square().mean(dtype=torch.float32).to(to.dtype)
    assert torch.equal(loss, old.detach())
    assert torch.equal(d_out, torch.autograd.grad(old, og)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fault", ["zeros", "doubled", "one_ulp"])
def test_chip_smoke_holds_d_out_bit_for_bit(dtype, fault):
    """The card's check of K4e-d's d_out (values below 1e-5, as at the
    bench shape) refuses a gradient that is all zeros, twice too large or one
    element one ulp off, and passes the plain version's own."""
    import chip_smoke

    rng = np.random.default_rng(7)
    to, ty = _torch([(rng.standard_normal((4, 64, 128)) * 1e-2).astype(np.float32)
                     for _ in range(2)], dtype)
    want = E.mse_loss_plain(to, ty)[1]
    assert float(want.float().abs().max()) < 1e-5  # as small as at the bench shape
    errs = {}
    assert chip_smoke.hold(torch, "mse_loss_fwd", "d_out", want.clone(), want, None, errs) \
        == "d_out bitwise"
    bad = {"zeros": torch.zeros_like(want), "doubled": want * 2, "one_ulp": want.clone()}[fault]
    if fault == "one_ulp":  # one element's magnitude one ulp up, through its bits
        bad.view(-1).view(torch.int32 if dtype == "float32" else torch.int16)[5] += 1
    with pytest.raises(AssertionError, match="held bit for bit"):
        chip_smoke.hold(torch, "mse_loss_fwd", "d_out", bad, want, None, errs)
    # the tolerance scaled by max(1, max |want|) alone would have passed it
    chip_smoke.err_within(torch, "d_out", bad, want, E.MSE_TOL[want.dtype], {})


# -- the sliced schedules ------------------------------------------------------------

SIZES = dict(d_model=16, d_ff=32, d_expert=16, experts_per_rank=2, seq=8)


def _both(dtype, slices, heads):
    jdt, tdt = DTYPES[dtype]
    kw = dict(SIZES, batch=4 * slices if slices == 2 else 6, microbatches=slices, heads=heads)
    jcfg = jax_fn.FabricNetConfig(dtype=jdt, **kw)
    cfg = fn.FabricNetConfig(dtype=tdt, **kw)
    jmesh = jax_mesh(1)
    jax_fn.validate_config(jcfg, jmesh)
    jparams = jax_fn.init_params(jcfg, jmesh)
    jx, jy = jax_fn.make_batch(jcfg, jmesh)
    mesh = pmesh.make_fabric_mesh(1, device="cpu")
    params = fn.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, cfg, "cpu")
    x, y = (torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in (jx, jy))
    return (jcfg, jmesh, jparams, jx, jy), (cfg, mesh, params, x, y)


@pytest.mark.parametrize("heads", [2, 0], ids=["heads2", "heads0"])
@pytest.mark.parametrize("slices", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sliced_schedules_match_jax(dtype, slices, heads):
    (jcfg, jmesh, jparams, jx, jy), (cfg, mesh, params, x, y) = _both(dtype, slices, heads)
    jstep = jax_fn.make_train_step(jcfg, jmesh, schedule="serialized")
    step = fn.make_train_step(cfg, mesh, schedule="serialized")
    tol = 1e-5 if dtype == "float32" else 0.05
    for n in range(1, 4):
        jparams, jloss = jstep(jparams, jx, jy)
        params, loss = step(params, x, y)
        assert loss.dtype == torch.float32 and np.asarray(jloss).dtype == np.float32
        if n in (1, 3):
            np.testing.assert_allclose(float(loss), float(jloss), rtol=tol)
            for k in jparams:
                want = _bits(jparams[k])
                atol = tol * np.abs(want).max() if dtype == "float32" else tol
                rtol = 0 if dtype == "float32" else tol
                np.testing.assert_allclose(_bits(params[k]), want, rtol=rtol, atol=atol,
                                           err_msg=f"{k} after {n} steps")


@pytest.mark.parametrize("heads", [2, 0], ids=["heads2", "heads0"])
@pytest.mark.parametrize("slices", [2, 3])
def test_sliced_schedules_are_byte_identical_and_match_fused(slices, heads):
    _, (cfg, mesh, params, x, y) = _both("float32", slices, heads)
    results = {}
    for schedule in ("fused", "serialized", "overlapped"):
        p = {k: v.clone() for k, v in params.items()}
        step = fn.make_train_step(cfg, mesh, schedule=schedule)
        losses = [step(p, x, y)[1] for _ in range(3)]
        results[schedule] = (torch.stack(losses), p)
    (ls, ps), (lo, po) = results["serialized"], results["overlapped"]
    assert ls.dtype == torch.float32 and ls.numpy().tobytes() == lo.numpy().tobytes()
    for k in ps:
        assert ps[k].numpy().tobytes() == po[k].numpy().tobytes(), k
    # one step from the same parameters: the reference's fused-vs-sliced bounds
    pf, po = ({k: v.clone() for k, v in params.items()} for _ in range(2))
    lf = fn.make_train_step(cfg, mesh)(pf, x, y)[1]
    lo = fn.make_train_step(cfg, mesh, schedule="overlapped")(po, x, y)[1]
    assert abs(float(lf) - float(lo)) < 1e-6
    for k in pf:
        np.testing.assert_allclose(po[k].numpy(), pf[k].numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=f"param {k}")
