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
  holds the train step: JAX differentiates op by op, the port's backward is
  one formula;
- bfloat16 at the loose 0.05 of ``test_torch_fabricnet.py``: JAX rounds
  the gradient to bf16 op by op, the port once.
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
    _close(y, jax_fn._gelu(jx), FWD_TOL[dtype])
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
        assert s is tx
        (gx,) = torch.autograd.grad(n, tx, tgn)
    assert gx.dtype == tx.dtype
    _close(gx, want_x, GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead,d", SHAPES, ids=SHAPE_IDS)
def test_gelu_gradient_matches_jax_vjp(dtype, lead, d):
    (jx, jdy), (tx, tdy) = _pair(_inputs(5 * d, lead, d, 2), dtype)
    _, vjp = jax.vjp(jax_fn._gelu, jx)
    (want,) = vjp(jdy)
    tx.requires_grad_()
    (got,) = torch.autograd.grad(E.gelu(tx), tx, tdy)
    assert got.dtype == tx.dtype
    _close(got, want, GRAD_TOL[dtype])
    _close(E.gelu_tanh_bwd(tx.detach(), tdy), want, GRAD_TOL[dtype])


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


def test_plain_backwards_round_once():
    """bfloat16: the norm's backward with g_s and the GeLU's backward are
    their float32 results rounded once."""
    x, delta, g_s, g_n = (torch.from_numpy(a) for a in _inputs(3, (4,), 40, 4))
    b = [t.to(torch.bfloat16) for t in (x, delta, g_s, g_n)]
    s, _, rstd = E.add_rms_norm_plain(b[0], b[1])
    want = E.rms_norm_bwd_plain(s.float(), rstd, b[3].float(), b[2].float())
    assert torch.equal(E.rms_norm_bwd_plain(s, rstd, b[3], b[2]), want.to(torch.bfloat16))
    want = E.gelu_bwd_plain(b[0].float(), b[3].float())
    assert torch.equal(E.gelu_bwd_plain(b[0], b[3]), want.to(torch.bfloat16))


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
    """A FabricNet train step on the CPU calls each K4 and K4e wrapper as
    often as ``chip_smoke.k4_launches_per_step`` and
    ``k4e_launches_per_step`` say the card launches it: the first norm's
    backward is never called (its input is the batch); the fused step
    updates once and takes the loss once, a sliced one accumulates M - 2
    times, updates once and takes each slice's loss."""
    from incubator_brpc_tpu_torch.models import fabricnet as fn
    from incubator_brpc_tpu_torch.ops import update
    from incubator_brpc_tpu_torch.parallel import mesh as pmesh

    calls = dict.fromkeys(chip_smoke.K4 + chip_smoke.K4E, 0)
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
