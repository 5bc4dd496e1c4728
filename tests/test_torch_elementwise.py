"""K4 of the port (``incubator_brpc_tpu_torch/ops/elementwise.py``: the
residual add with the RMS norm after it, the tanh GeLU, and their
backwards) against the JAX package's ``_rms_norm`` and ``_gelu`` and
``jax.vjp`` of them, on the CPU, where the wrappers run the plain versions.

Inputs are made from a seed with numpy and handed to both. Widths are
narrow and odd (d = 32, 33 and 1000, which is not a multiple of 8), over 1
to 5 rows, and for K4a also the widths on either side of the rows its
kernel keeps in registers (``chip_smoke.K4A_CAP``, up to 16,392), 3 rows. Tolerances, each relative to max(1, max |JAX's value|):

- float32 forward within 1e-6: XLA's and PyTorch's rsqrt and tanh and the
  row sum's order differ by a few float32 ulps;
- float32 gradients within 1e-5, as ``tests/test_torch_fabricnet.py``
  holds the train step: the same chains, with XLA's tanh and row sums
  against PyTorch's;
- bfloat16 GeLU and its gradient bit for bit jitted JAX's (both round
  every op to bf16, with JAX's bf16 constants), over every bf16 value in
  [-16, 16] too, the tails included;
- the bfloat16 norm's gradient in the train step's form within one bf16
  ulp of its largest value, the differing elements pinned: every op rounds
  as JAX's, but the row sum ``sum(s g_n)``, which JAX takes in bf16 and the
  port exactly (ROADMAP, "Differences by design"); the residual add and
  norm themselves, and the gradient in the other forms, at the loose 0.05
  of ``test_torch_fabricnet.py`` (the norm's forward rounds its squares,
  where XLA:CPU keeps them in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from incubator_brpc_tpu.models import fabricnet as jax_fn
from incubator_brpc_tpu_torch.ops import elementwise as E
from incubator_brpc_tpu_torch.ops import kernels

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"float32": 1e-6, "bfloat16": 0.05}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 0.05}
# (leading shape, d): 1 to 5 rows, d = 32, 33 and 1000
SHAPES = [((1,), 32), ((3,), 33), ((5,), 1000), ((2, 2), 33)]
SHAPE_IDS = ["1x32", "3x33", "5x1000", "2x2x33"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These sizes gain nothing from threads; one keeps the xdist workers'
    cores for the timing-sensitive tests running beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed, lead, d, count):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(lead + (d,)) * (2.0 if i == 0 else 1.0)).astype(np.float32)
            for i in range(count)]


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _bits(t):
    """A tensor or JAX array as bf16 or f32 bits, for bitwise comparison."""
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t, np.float32))
    return t.detach().float().numpy().view(np.int32)


def _differing(got, want):
    return int((_bits(got) != _bits(want)).sum())


def _pair(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead,d", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("with_delta", [True, False], ids=["delta", "nodelta"])
def test_add_rms_norm_matches_jax(dtype, lead, d, with_delta):
    (jx, jd), (tx, td) = _pair(_inputs(d + len(lead), lead, d, 2), dtype)
    if not with_delta:
        jd, td = None, None
    js = jx if jd is None else jx + jd
    jn = jax_fn._rms_norm(js)
    before = kernels.launch_counts()
    s, n, rstd = E.add_rms_norm_fwd(tx, td)
    assert kernels.launch_counts() == before  # the CPU runs the plain version
    assert s.dtype == n.dtype == DTYPES[dtype][1] and rstd.dtype == torch.float32
    assert rstd.shape == tx.shape[:-1]
    assert torch.equal(s.float(), torch.from_numpy(np.array(js, np.float32)))
    _close(n, jn, FWD_TOL[dtype])
    # rstd is the rsqrt the norm multiplied by, in the working dtype
    r = jax.lax.rsqrt(jnp.mean(jnp.square(js), axis=-1) + 1e-6)
    _close(rstd, r, FWD_TOL[dtype])
    s2, n2 = E.add_rms_norm(tx, td)
    assert torch.equal(s2, s) and torch.equal(n2, n)


# (dtype, d, rows one element off 16-byte alignment): the widest rows that
# add_rms_norm_fwd keeps in registers and the next widths, which it reads
# twice; rows whose pointers share a 16-byte phase (vectors) or not (single
# elements), as tests/test_torch_cuda.py holds the kernel at them
K4A_CAP = chip_smoke.K4A_CAP


@pytest.mark.parametrize("dtype,d,offset", K4A_CAP,
                         ids=[f"{t}-{d}-{'off' if o else 'aligned'}" for t, d, o in K4A_CAP])
@pytest.mark.parametrize("with_delta", [True, False], ids=["delta", "nodelta"])
def test_add_rms_norm_on_both_sides_of_the_register_cap_matches_jax(dtype, d, offset,
                                                                     with_delta):
    """The widths where K4a's register path (the row read once) and its
    two-pass path split: ``add_rms_norm_reads_once`` puts the first width of
    each pair in registers and the second not, for rows whose pointers agree
    (16-byte vectors) and, one element off alignment, disagree (single
    elements); the plain version the kernel is held to on the card matches
    JAX's residual add and ``_rms_norm`` at each, from inputs one element
    into their buffers where ``offset``."""
    once = K4A_CAP.index((dtype, d, offset)) % 2 == 0
    assert E.add_rms_norm_reads_once(d, DTYPES[dtype][1], head=d if offset else 0) is once
    (jx, jd), (tx, td) = _pair(_inputs(d, (3,), d, 2), dtype)
    if offset:
        tx, td = (torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape).copy_(t)
                  for t in (tx, td))
    if not with_delta:
        jd, td = None, None
    js = jx if jd is None else jx + jd
    s, n, rstd = E.add_rms_norm_fwd(tx, td)
    assert torch.equal(s.float(), torch.from_numpy(np.array(js, np.float32)))
    _close(n, jax_fn._rms_norm(js), FWD_TOL[dtype])
    _close(rstd, jax.lax.rsqrt(jnp.mean(jnp.square(js), axis=-1) + 1e-6), FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead,d", SHAPES, ids=SHAPE_IDS)
def test_gelu_matches_jax(dtype, lead, d):
    (jx,), (tx,) = _pair(_inputs(7 * d, lead, d, 1), dtype)
    y = E.gelu_tanh_fwd(tx)
    assert y.dtype == tx.dtype
    want = jax.jit(jax_fn._gelu)(jx)
    if dtype == "bfloat16":  # op by op in bf16 on both sides
        assert _differing(y, want) == 0
    _close(y, want, FWD_TOL[dtype])
    assert torch.equal(E.gelu(tx), y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead,d", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("with_delta", [True, False], ids=["delta", "nodelta"])
def test_add_rms_norm_gradient_matches_jax_vjp(dtype, lead, d, with_delta):
    (jx, jd, jgs, jgn), (tx, td, tgs, tgn) = _pair(_inputs(3 * d + len(lead), lead, d, 4), dtype)
    tx.requires_grad_()
    if with_delta:
        td.requires_grad_()
        (_, _), vjp = jax.vjp(lambda a, b: (a + b, jax_fn._rms_norm(a + b)), jx, jd)
        want_x, want_d = vjp((jgs, jgn))
        s, n = E.add_rms_norm(tx, td)
        gx, gd = torch.autograd.grad((s, n), (tx, td), (tgs, tgn))
        assert torch.equal(gx, gd)  # the sum's gradient reaches both addends
        _close(gd, want_d, GRAD_TOL[dtype])
    else:
        _, vjp = jax.vjp(jax_fn._rms_norm, jx)
        (want_x,) = vjp(jgn)
        s, n = E.add_rms_norm(tx)
        assert torch.equal(s, tx)
        (gx,) = torch.autograd.grad(n, tx, tgn)
    assert gx.dtype == tx.dtype
    _close(gx, want_x, GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead,d", SHAPES, ids=SHAPE_IDS)
def test_gelu_gradient_matches_jax_vjp(dtype, lead, d):
    (jx, jdy), (tx, tdy) = _pair(_inputs(5 * d, lead, d, 2), dtype)
    want = jax.jit(lambda x, dy: jax.vjp(jax_fn._gelu, x)[1](dy)[0])(jx, jdy)
    tx.requires_grad_()
    (got,) = torch.autograd.grad(E.gelu(tx), tx, tdy)
    assert got.dtype == tx.dtype
    if dtype == "bfloat16":
        assert _differing(got, want) == 0
    _close(got, want, GRAD_TOL[dtype])
    _close(E.gelu_tanh_bwd(tx.detach(), tdy), want, GRAD_TOL[dtype])


def _every_bf16(lo, hi):
    """Every bf16 value in [lo, hi] that is zero or at least 2^-120 in
    magnitude (XLA:CPU flushes subnormal results to zero, the port's plain
    versions and kernels do not), as float32."""
    v = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    x = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16).float().numpy()
    return x[np.isfinite(x) & (x >= lo) & (x <= hi) & ((x == 0) | (np.abs(x) >= 2.0 ** -120))]


def test_bf16_gelu_and_its_gradient_are_jax_bitwise_at_every_value_and_the_tails():
    """Every bf16 value in [-16, 16] (GeLU's tails past |x| = 4 included,
    where tanh saturates and the gradient cancels) but the smallest, the
    gradient against a seeded dy: bit for bit jitted ``_gelu`` and its
    ``jax.vjp``."""
    x = _every_bf16(-16.0, 16.0)
    assert (np.abs(x) > 4).sum() == 512  # (4, 16] of each sign: 127 + 128 + 1
    dy = np.random.default_rng(16).standard_normal(x.shape).astype(np.float32)
    (jx, jdy), (tx, tdy) = _pair([x, dy], "bfloat16")
    assert _differing(E.gelu_tanh_fwd(tx), jax.jit(jax_fn._gelu)(jx)) == 0
    want = jax.jit(lambda x, dy: jax.vjp(jax_fn._gelu, x)[1](dy)[0])(jx, jdy)
    assert _differing(E.gelu_tanh_bwd(tx, tdy), want) == 0


# (rows, d) of the train step's form of the norm's gradient, and the bf16
# elements that differ from JAX's there (the row sum's rounding), pinned
NORM_GRAD_SHAPES = [(64, 2048), (16, 33), (8, 1000)]
NORM_GRAD_DIFFERING = {(64, 2048): 6839, (16, 33): 71, (8, 1000): 1157}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", NORM_GRAD_SHAPES, ids=["64x2048", "16x33", "8x1000"])
def test_norm_gradient_in_the_train_steps_form_is_jax_within_the_pinned_bound(dtype, rows, d):
    """``jax.vjp`` of ``x + _rms_norm(x) @ w``, the residual layer of
    ``_stage_fn``, against K4b with ``g_s`` the layer's output gradient and
    ``g_n`` JAX's ``g_s @ w^T``: bf16 within one bf16 ulp of the largest
    value (2^-7 x max(1, max |JAX's|)), with the differing elements pinned
    (JAX sums ``s g_n`` in bf16 in XLA:CPU's window order, the port exactly,
    and rounds the sum once; the residual stream's gradient goes in first,
    as the train step adds it); f32 within 1e-5."""
    rng = np.random.default_rng(rows + d)
    x, g_s = rng.standard_normal((rows, d)).astype(np.float32) * 2, \
        rng.standard_normal((rows, d)).astype(np.float32)
    w = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    (jx, jgs, jw), (tx, tgs, _) = _pair([x, g_s, w], dtype)
    want = jax.jit(lambda x, g, w: jax.vjp(lambda a: a + jax_fn._rms_norm(a) @ w, x)[1](g)[0])(
        jx, jgs, jw)
    g_n = torch.from_numpy(np.array(jax.jit(lambda g, w: g @ w.T)(jgs, jw), np.float32)).to(
        DTYPES[dtype][1])
    s, _, rstd = E.add_rms_norm_fwd(tx)
    got = E.rms_norm_bwd(s, rstd, g_n, tgs)
    if dtype == "float32":
        _close(got, want, GRAD_TOL[dtype])
        return
    _close(got, want, 2.0 ** -7)
    assert _differing(got, want) == NORM_GRAD_DIFFERING[(rows, d)]


@pytest.mark.parametrize("d", [1, 33])
def test_autograd_functions_pass_gradcheck_in_float64(d):
    rng = np.random.default_rng(d)
    x, delta = (torch.from_numpy(rng.standard_normal((3, d))).requires_grad_() for _ in range(2))
    assert torch.autograd.gradcheck(lambda a, b: E.AddRMSNormFunction.apply(a, b), (x, delta))
    assert torch.autograd.gradcheck(lambda a: E.AddRMSNormFunction.apply(a, None), (x,))
    assert torch.autograd.gradcheck(E.GeluFunction.apply, (x,))


def _unfused(x, delta):
    """The residual add and the norm as separate PyTorch ops, autograd
    through each: the port's forward before K4."""
    s = x + delta
    ms = (s * s).mean(dim=-1, keepdim=True, dtype=torch.float32).to(s.dtype)
    return s, s * torch.rsqrt(ms + 1e-6)


@pytest.mark.parametrize("lead,d", SHAPES, ids=SHAPE_IDS)
def test_fused_gradient_equals_the_unfused_composition(lead, d):
    """float32, within 1e-6 of max(1, max |g|): the same function, one
    formula against autograd's op-by-op chain, a few float32 ulps apart."""
    x, delta, g_s, g_n = (torch.from_numpy(a) for a in _inputs(11 * d, lead, d, 4))
    x.requires_grad_()
    delta.requires_grad_()
    s, n = E.add_rms_norm(x, delta)
    want_s, want_n = _unfused(x, delta)
    assert torch.equal(s, want_s) and torch.equal(n, want_n)
    got = torch.autograd.grad((s, n), (x, delta), (g_s, g_n))
    want = torch.autograd.grad((want_s, want_n), (x, delta), (g_s, g_n))
    for a, b in zip(got, want):
        _close(a, b.numpy(), 1e-6)
    # only one output used: its gradient alone (the other comes as None)
    s, n = E.add_rms_norm(x, delta)
    (g,) = torch.autograd.grad(n.sum(), x)
    (w,) = torch.autograd.grad(_unfused(x, delta)[1].sum(), x)
    _close(g, w.numpy(), 1e-6)
    s, n = E.add_rms_norm(x, delta)
    (g,) = torch.autograd.grad(s.sum(), delta)
    assert torch.equal(g, torch.ones_like(g))


def _rounded(x):
    """float32 values rounded to bf16 and back: one op's result in bf16."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("fn", ["gelu", "gelu_bwd", "rms_norm_bwd"])
def test_plain_versions_round_every_op_in_bfloat16(fn):
    """The bf16 plain versions equal their chains computed in float32 with
    each op's result rounded to bf16 (numpy), and differ from the same
    chain rounded once at the end, as the port computed them before."""
    x, dy, g_s = _inputs(3, (4,), 40, 3)
    b = [_rounded(a) for a in (x, dy, g_s)]
    k, beta = _rounded(np.float32(E.GELU_KAPPA)), _rounded(np.float32(E.GELU_BETA))
    for r in (_rounded, lambda v: np.asarray(v, np.float32)):  # op by op, then not
        x, dy, g_s = b
        if fn == "rms_norm_bwd":
            s, _, rstd = E.add_rms_norm_plain(torch.from_numpy(x).to(torch.bfloat16))
            kk = rstd.numpy()[:, None]
            sb = s.float().numpy()
            inv_d = np.float32(1) / np.float32(40)
            j = r(r(np.float32((r(sb * sb)).astype(np.float64).sum(-1, keepdims=True)) * inv_d)
                  + _rounded(np.float32(1e-6)))
            m = r(np.float32(-0.5) * r(kk / j))
            w = r(np.float32(r(sb * dy).astype(np.float64).sum(-1, keepdims=True))) * m
            want = r(r(g_s + r(dy * kk)) + r(r(w * inv_d) * r(2 * sb)))
            got = E.rms_norm_bwd_plain(s, rstd, torch.from_numpy(dy).to(torch.bfloat16),
                                       torch.from_numpy(g_s).to(torch.bfloat16))
        else:
            i = r(np.tanh(r(beta * r(x + r(k * r(x * r(x * x)))))))
            if fn == "gelu":
                want = r(x * r(0.5 * r(1 + i)))
                got = E.gelu_plain(torch.from_numpy(x).to(torch.bfloat16))
            else:
                p = r(r(0.5 * r(x * dy)) * r(1 - i))
                sv = r(beta * r(p + r(p * i)))
                want = r(r(r(dy * r(0.5 * r(1 + i))) + sv) + r(r(k * sv) * r(3 * r(x * x))))
                got = E.gelu_bwd_plain(*(torch.from_numpy(a).to(torch.bfloat16) for a in (x, dy)))
        same = np.array_equal(got.float().numpy(), _rounded(want))
        assert same if r is _rounded else not same


def test_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="delta"):
        E.add_rms_norm_fwd(x, torch.zeros((2, 9)))
    with pytest.raises(ValueError, match="delta"):
        E.add_rms_norm_fwd(x, torch.zeros((2, 8), dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="floating"):
        E.gelu_tanh_fwd(torch.zeros((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="rstd"):
        E.rms_norm_bwd(x, torch.zeros(3), x)
    with pytest.raises(ValueError, match="dy"):
        E.gelu_tanh_bwd(x, torch.zeros((8, 2)))


@pytest.mark.parametrize("schedule,kw", [
    ("fused", {}), ("fused", {"heads": 0}), ("fused", {"heads": 0, "layers_per_stage": 0}),
    ("fused", {"layers_per_stage": 2, "microbatches": 1}), ("serialized", {}),
    ("overlapped", {"heads": 0}), ("serialized", {"batch": 6, "microbatches": 3}),
    ("overlapped", {"layers_per_stage": 2, "microbatches": 1})],
    ids=["heads2", "heads0", "heads0-layers0", "layers2-m1", "serialized", "overlapped-heads0",
         "serialized-m3", "overlapped-layers2-m1"])
def test_train_step_calls_k4_as_chip_smoke_counts(monkeypatch, schedule, kw):
    """A FabricNet train step on the CPU calls each K4, K4f and K4e wrapper
    as often as ``chip_smoke.k4_launches_per_step`` and
    ``k4e_launches_per_step`` say the card launches it: the first norm's
    backward is never called (its input is the batch), nor, with heads = 0
    and no MLP layer, K4f's; the fused step updates once and takes the loss
    once, a sliced one accumulates M - 2 times, updates once and takes each
    slice's loss."""
    from incubator_brpc_tpu_torch.models import fabricnet as fn
    from incubator_brpc_tpu_torch.ops import update
    from incubator_brpc_tpu_torch.parallel import mesh as pmesh

    calls = dict.fromkeys(chip_smoke.K4 + chip_smoke.K4F + chip_smoke.K4E, 0)
    for name in calls:
        owners = [m for m in (E, update, fn) if hasattr(m, name)]
        real = getattr(owners[0], name)

        def counted(*args, _name=name, _fn=real, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        for m in owners:
            monkeypatch.setattr(m, name, counted)
    cfg = fn.FabricNetConfig(d_model=16, d_ff=32, d_expert=16, **{"batch": 4, "seq": 8, **kw})
    mesh = pmesh.make_fabric_mesh(1, device="cpu")
    params = fn.init_params(cfg, mesh, seed=3)
    fn.make_train_step(cfg, mesh, schedule=schedule)(params, *fn.make_batch(cfg, mesh, seed=4))
    assert calls == {**chip_smoke.k4_launches_per_step(cfg),
                     **chip_smoke.k4e_launches_per_step(cfg, schedule)}
