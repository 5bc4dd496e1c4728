"""FabricNet of the port against the JAX package on the one-device mesh, on
the CPU: the JAX ``init_params`` and ``make_batch`` arrays are carried across
with ``params_from_numpy`` and both packages run the same steps, at the
sizes of ``tests/test_fabricnet.py:_setup`` (d_model 16, d_ff 32, d_expert
16, 2 experts, batch 8, seq 8, microbatches 2).

Tolerances: float32 forward within 1e-5 absolute (outputs are O(1-10));
the loss and every updated parameter after 1 and 3 fused steps within
1e-5 relative to the parameter's largest value (sums run in another order
in the matmuls and in ring attention's gradient); bfloat16 at 0.05, and
within one bf16 ulp of each result's largest value with the differing
outputs pinned.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_brpc_tpu.models import fabricnet as jax_fn
from incubator_brpc_tpu.parallel.mesh import make_fabric_mesh as jax_mesh
from incubator_brpc_tpu_torch.models import fabricnet as fn
from incubator_brpc_tpu_torch.ops import update
from incubator_brpc_tpu_torch.parallel import mesh as pmesh

SIZES = dict(d_model=16, d_ff=32, d_expert=16, experts_per_rank=2, batch=8, seq=8,
             microbatches=2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These sizes gain nothing from threads; one keeps the xdist workers'
    cores for the timing-sensitive tests running beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

def _both(dtype="float32", **kw):
    jdt, tdt = DTYPES[dtype]
    cfg_kw = {**SIZES, **kw}
    jcfg = jax_fn.FabricNetConfig(dtype=jdt, **cfg_kw)
    cfg = fn.FabricNetConfig(dtype=tdt, **cfg_kw)
    jmesh = jax_mesh(1)
    jax_fn.validate_config(jcfg, jmesh)
    jparams = jax_fn.init_params(jcfg, jmesh)
    jx, jy = jax_fn.make_batch(jcfg, jmesh)
    mesh = pmesh.make_fabric_mesh(1, device="cpu")
    params = fn.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, cfg, "cpu")

    def tensor(a):
        return torch.from_numpy(np.array(a, np.float32)).to(tdt)

    return (jcfg, jmesh, jparams, jx, jy), (cfg, mesh, params, tensor(jx), tensor(jy))


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def test_params_carried_across():
    (jcfg, _, jparams, _, _), (cfg, _, params, _, _) = _both()
    assert list(params) == list(jparams)
    for k in jparams:
        assert params[k].dtype == torch.float32
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(jparams[k]))


@pytest.mark.parametrize("kw", [{}, {"heads": 0}, {"layers_per_stage": 2}],
                         ids=["heads2", "heads0", "layers2"])
def test_forward_matches_jax(kw):
    (jcfg, jmesh, jparams, jx, _), (cfg, mesh, params, x, _) = _both(**kw)
    want = np.asarray(jax_fn.make_forward_step(jcfg, jmesh)(jparams, jx))
    got = fn.make_forward_step(cfg, mesh)(params, x)
    assert got.shape == (cfg.batch, cfg.seq, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"heads": 0}, {"layers_per_stage": 2}],
                         ids=["heads2", "heads0", "layers2"])
def test_train_steps_match_jax(kw):
    (jcfg, jmesh, jparams, jx, jy), (cfg, mesh, params, x, y) = _both(**kw)
    jstep = jax_fn.make_train_step(jcfg, jmesh)
    step = fn.make_train_step(cfg, mesh)
    for n in range(1, 4):
        jparams, jloss = jstep(jparams, jx, jy)
        params, loss = step(params, x, y)
        if n in (1, 3):
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
            for k in jparams:
                want = np.asarray(jparams[k])
                np.testing.assert_allclose(
                    params[k].numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max(),
                    err_msg=f"{k} after {n} steps",
                )


def _whole_parameter_step(cfg):
    """The train step written the old way: each whole parameter an autograd
    leaf, indexed by the forward (a ``select_backward`` of full size for
    each use), its gradients summed at full size; the same plain update."""

    def step(params, x, y):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        w = {k: v[0] for k, v in leaves.items() if k != "head"}  # indexed per layer as used
        w["head"] = leaves["head"]
        with torch.enable_grad():
            loss, out, d_out = fn._local_loss(cfg, w, x, y)
            grads = torch.autograd.grad(out, list(leaves.values()), d_out)
        for p, g in zip(params.values(), grads):
            update.sgd_update_plain("fused", p, g, cfg.lr)
        return params, loss

    return step


def _small(dtype, **kw):
    cfg = fn.FabricNetConfig(dtype=DTYPES[dtype][1], **{**SIZES, **kw})
    mesh = pmesh.make_fabric_mesh(1, device="cpu")
    return cfg, mesh, fn.init_params(cfg, mesh, seed=4), *fn.make_batch(cfg, mesh, seed=6)


@pytest.mark.parametrize("kw", [{}, {"heads": 0}, {"layers_per_stage": 2}],
                         ids=["heads2", "heads0", "layers2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_on_slices_equals_the_whole_parameter_step(dtype, kw):
    """Each element's gradient in the old step was its slice's gradient plus
    exact zeros, so the step on slices gives equal parameters (torch.equal:
    -0.0 == +0.0 is the only difference adding +0.0 can make)."""
    cfg, mesh, params, x, y = _small(dtype, **kw)
    ref = {k: p.clone() for k, p in params.items()}
    step, old = fn.make_train_step(cfg, mesh), _whole_parameter_step(cfg)
    for n in range(1, 4):
        params, loss = step(params, x, y)
        ref, ref_loss = old(ref, x, y)
        if n in (1, 3):
            assert torch.equal(loss, ref_loss)
            for k in ref:
                assert torch.equal(params[k], ref[k]), f"{k} after {n} steps"


def test_train_step_forms_no_whole_parameter_gradient():
    """A profiled step runs no ``select_backward`` (the old step's zero fill
    and copy of a whole parameter for each indexed use)."""
    from torch.profiler import ProfilerActivity, profile

    cfg, mesh, params, x, y = _small("float32", layers_per_stage=2)

    def ops(step):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(params, x, y)
        return {e.key for e in prof.key_averages()}

    assert "aten::select_backward" in ops(_whole_parameter_step(cfg))  # what the test looks for
    assert "aten::select_backward" not in ops(fn.make_train_step(cfg, mesh))


def test_train_step_updates_in_place_and_loss_falls():
    _, (cfg, mesh, params, x, y) = _both()
    step = fn.make_train_step(cfg, mesh)
    first = params["head"]
    losses = []
    for _ in range(6):
        out, loss = step(params, x, y)
        assert out is params and out["head"] is first
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_bfloat16_loosely():
    (jcfg, jmesh, jparams, jx, jy), (cfg, mesh, params, x, y) = _both("bfloat16")
    want = _f32(jax_fn.make_forward_step(jcfg, jmesh)(jparams, jx))
    got = fn.make_forward_step(cfg, mesh)(params, x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), want, rtol=0.05, atol=0.05)
    jparams, jloss = jax_fn.make_train_step(jcfg, jmesh)(jparams, jx, jy)
    params, loss = fn.make_train_step(cfg, mesh)(params, x, y)
    assert loss.dtype == torch.bfloat16 and params["w_in"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0.05)
    for k in jparams:
        np.testing.assert_allclose(_f32(params[k]), _f32(jparams[k]), rtol=0.05, atol=0.05)


# outputs of the bf16 forward that differ from JAX's, at most (measured with
# the elementwise chain rounded op by op; 655 and more with it rounded once)
BF16_FORWARD_DIFFERING = {2: 252, 0: 412}


@pytest.mark.parametrize("heads", [2, 0], ids=["heads2", "heads0"])
def test_bfloat16_within_one_bf16_ulp(heads):
    """bf16 with the elementwise chain rounded op by op as JAX rounds it:
    the forward within one bf16 ulp of its largest value (2^-7 x max(1, max
    |JAX's|); measured 0.039 of 5.8 with heads 2) and at most
    ``BF16_FORWARD_DIFFERING`` of its 1,024 outputs differing, the loss
    within one bf16 ulp (measured equal), and every parameter after one
    train step within 2^-7 x max(1, max |JAX's|) (measured 0.00098 of
    0.51). What is left is the matrix products' and the row sums' order,
    which ``test_bfloat16_loosely`` allows 0.05 for."""
    (jcfg, jmesh, jparams, jx, jy), (cfg, mesh, params, x, y) = _both("bfloat16", heads=heads)
    tol = 2.0 ** -7
    want = _f32(jax_fn.make_forward_step(jcfg, jmesh)(jparams, jx))
    got = _f32(fn.make_forward_step(cfg, mesh)(params, x))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))
    assert int((got != want).sum()) <= BF16_FORWARD_DIFFERING[heads]
    jparams, jloss = jax_fn.make_train_step(jcfg, jmesh)(jparams, jx, jy)
    params, loss = fn.make_train_step(cfg, mesh)(params, x, y)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=tol)
    for k in jparams:
        want = _f32(jparams[k])
        np.testing.assert_allclose(_f32(params[k]), want, rtol=0,
                                   atol=tol * max(1.0, float(np.abs(want).max())), err_msg=k)


def test_init_params_and_batch_shapes():
    cfg = fn.FabricNetConfig(**SIZES)
    mesh = pmesh.make_fabric_mesh(1, device="cpu")
    params = fn.init_params(cfg, mesh, seed=3)
    want = {k: np.asarray(v).shape
            for k, v in jax_fn.init_params(jax_fn.FabricNetConfig(**SIZES), jax_mesh(1)).items()}
    assert {k: tuple(v.shape) for k, v in params.items()} == want
    g = torch.Generator().manual_seed(5)
    x, y = fn.make_batch(cfg, mesh, generator=g)
    assert x.shape == y.shape == (8, 8, 16) and not torch.equal(x, y)
    assert torch.equal(fn.init_params(cfg, mesh, seed=3)["head"], params["head"])


def test_validate_config_refuses_an_axis_above_one():
    cfg = fn.FabricNetConfig(**SIZES)
    mesh = pmesh.FabricMesh(shape={**dict.fromkeys(pmesh.FABRIC_AXES, 1), "sp": 2},
                            device=torch.device("cpu"))
    with pytest.raises(ValueError, match="slice 4"):
        fn.validate_config(cfg, mesh)
    with pytest.raises(ValueError, match="slice 4"):
        pmesh.make_fabric_mesh(2, device="cpu")
    assert pmesh.default_axis_sizes(8) == {"dp": 2, "pp": 2, "tp": 2, "sp": 1, "ep": 1}


def test_schedules():
    """An unknown schedule raises; the sliced schedules run on one card's
    mesh, updating in place and returning a float32 loss (their numbers
    are held in ``tests/test_torch_update.py``); a mesh with an axis above
    1 still raises "slice 4"."""
    cfg = fn.FabricNetConfig(**SIZES)
    mesh = pmesh.make_fabric_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="unknown schedule"):
        fn.make_train_step(cfg, mesh, schedule="pipelined")
    wide = pmesh.FabricMesh(shape={**dict.fromkeys(pmesh.FABRIC_AXES, 1), "dp": 2},
                            device=torch.device("cpu"))
    for schedule in ("serialized", "overlapped"):
        params = fn.init_params(cfg, mesh, seed=3)
        head = params["head"].clone()
        out, loss = fn.make_train_step(cfg, mesh, schedule=schedule)(
            params, *fn.make_batch(cfg, mesh, seed=4))
        assert out is params and not torch.equal(params["head"], head)
        assert loss.dtype == torch.float32 and loss.shape == () and torch.isfinite(loss)
        with pytest.raises(ValueError, match="slice 4"):
            fn.make_train_step(cfg, wide, schedule=schedule)


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = fn.FabricNetConfig(**SIZES)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn.make_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn.make_forward_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_fabric_mesh(1)
    assert fn.make_train_step(cfg, device="cpu") is not None


def test_flop_count_of_the_bench_width():
    cfg = fn.FabricNetConfig(d_model=2048, d_ff=8192, d_expert=2048, experts_per_rank=2,
                             layers_per_stage=4, batch=4, seq=1024, microbatches=1)
    f = fn.forward_flops(cfg)
    assert f["attention"] == 4 * 4 * 1024 ** 2 * 2048
    assert 1.36e12 < sum(f.values()) < 1.38e12
    assert 4.0e12 < fn.train_step_flops(cfg) < 4.2e12
