"""The port's fabric mesh and collectives (``incubator_brpc_tpu_torch/parallel``)
against the JAX package's on the CPU: ``tests/test_parallel.py``'s cases on
both packages with the same numpy inputs, JAX on the 8 virtual CPU devices of
``tests/conftest.py`` under ``shard_map(check_vma=False)``, the port with
every rank's block stacked on dim 0 of one tensor.

Forward and gradient (``jax.vjp`` of the ``shard_map``'d function against
PyTorch's autograd): bit for bit on integer-valued inputs, where every sum is
exact in any order. On normal random inputs the data movements (gather,
exchange, ring) are bit for bit both ways; the sums over 8 ranks are within
1e-6 of the largest value (XLA's all-reduce order is not the port's rank
order), and so are the gradients of outputs that every rank holds alike:
JAX hands each of the 8 ranks 1/8 of the cotangent and sums the 8 shares
back, which rounds where 3/8, 5/8 and 7/8 of it do not fit, while autograd
passes it whole. ``pmax``/``pmin`` have no gradient in JAX.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from incubator_brpc_tpu.parallel import collective as jc
from incubator_brpc_tpu.parallel import mesh as jmesh
from incubator_brpc_tpu_torch import parallel as tpar

SUM_TOL = 1e-6
MESHES = [{"dp": 2, "tp": 2, "sp": 2}, {"dp": 2, "pp": 2, "tp": 2}, {"pp": 2, "sp": 2, "ep": 2}]


def _smap(mesh, fn, in_spec, out_spec):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(in_spec,), out_specs=out_spec,
                                 check_vma=False))


@pytest.fixture(scope="module")
def flat():
    """All 8 ranks on dp, both packages."""
    axes = {"dp": 8, "pp": 1, "tp": 1, "sp": 1, "ep": 1}
    return jmesh.make_fabric_mesh(8, axis_sizes=axes), tpar.make_fabric_mesh(8, axes, "cpu")


def _inputs(shape, integers, seed=0):
    rng = np.random.default_rng(seed + sum(shape))
    if integers:
        return rng.integers(-9, 10, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _bits(a):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _same(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _close(got, want, tol=SUM_TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _vjp(f, x, ct):
    out, vjp = jax.vjp(f, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(ct))[0])


def _grad(f, x, ct):
    t = torch.from_numpy(x.copy()).requires_grad_()
    out = f(t)
    (g,) = torch.autograd.grad(out, t, torch.from_numpy(ct.copy()))
    return out.detach(), g


def test_default_axis_sizes():
    for n in list(range(1, 65)) + [96, 128, 384]:
        assert tpar.default_axis_sizes(n) == jmesh.default_axis_sizes(n), n
    s8 = tpar.default_axis_sizes(8)
    assert s8["dp"] == 2 and s8["tp"] == 2 and s8["pp"] == 2
    assert all(v == 2 for v in tpar.default_axis_sizes(32).values())


@pytest.mark.parametrize("axes", [None] + MESHES, ids=["default", "dp2tp2sp2", "dp2pp2tp2",
                                                        "pp2sp2ep2"])
def test_make_fabric_mesh(axes):
    """The port's mesh has the JAX mesh's axes and sizes, and rank r sits
    where the JAX mesh puts device r."""
    jm = jmesh.make_fabric_mesh(8, axis_sizes=axes)
    tm = tpar.make_fabric_mesh(8, axis_sizes=axes, device="cpu")
    assert jm.axis_names == tpar.FABRIC_AXES
    assert tm.shape == dict(jm.shape) and tm.size == 8
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(8):
        where = dict(zip(jm.axis_names, (int(i) for i in np.argwhere(ids == r)[0])))
        assert tm.coords(r) == where
    assert tm.device == torch.device("cpu")


def test_make_fabric_mesh_refuses():
    with pytest.raises(ValueError, match="do not factor"):
        tpar.make_fabric_mesh(8, axis_sizes={"dp": 3}, device="cpu")
    with pytest.raises(ValueError, match="unknown mesh axes"):
        tpar.make_fabric_mesh(2, axis_sizes={"xp": 2}, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        tpar.make_fabric_mesh(2, axis_sizes={"sp": 2}, device="cpu").coords(2)


@pytest.mark.parametrize("merger", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("integers", [True, False], ids=["integers", "normal"])
def test_merge(flat, merger, integers):
    jm, tm = flat
    x = _inputs((8, 5), integers)
    f = _smap(jm, partial(jc.merge, axis="dp", merger=merger), P("dp"), P())
    want = np.asarray(f(jnp.asarray(x)))  # (1, 5): every rank's reply
    got = tpar.merge(torch.from_numpy(x), "dp", merger, tm)
    assert got.shape == (5,)
    if integers or merger in ("max", "min"):
        _same(got, want[0])
    else:
        _close(got, want[0])
    if merger in ("sum", "mean"):  # JAX differentiates neither pmax nor pmin
        ct = _inputs((1, 5), integers, seed=1)
        _, jg = _vjp(f, x, ct)
        _, tg = _grad(lambda t: tpar.merge(t, "dp", merger, tm), x, ct[0])
        (_same if integers else _close)(tg, jg)


def test_merge_psum_of_arange(flat):
    """``tests/test_parallel.py::test_merge_psum``."""
    _, tm = flat
    out = tpar.merge(torch.arange(8, dtype=torch.float32), "dp", "sum", tm)
    assert float(out) == 28.0


@pytest.mark.parametrize("axes", MESHES, ids=["dp2tp2sp2", "dp2pp2tp2", "pp2sp2ep2"])
def test_merge_over_one_axis_of_a_mesh(axes):
    """A psum over one named axis of a three-axis mesh: every rank holds a
    row; the sum over the first axis of the three varies over the other two."""
    names = [a for a in tpar.FABRIC_AXES if axes.get(a, 1) > 1]
    jm = jmesh.make_fabric_mesh(8, axis_sizes=axes)
    tm = tpar.make_fabric_mesh(8, axis_sizes=axes, device="cpu")
    x = _inputs((8, 6), False, seed=5)
    ax, rest = names[0], tuple(names[1:])
    f = _smap(jm, lambda v: jc.merge(v, ax, "sum"), P(tuple(names)), P(rest))
    ct = _inputs((4, 6), False, seed=6)
    want, jg = _vjp(f, x, ct)

    def port(t):
        return tpar.merge(t.reshape(2, 2, 2, 6), ax, "sum", tm).reshape(4, 6)

    got, tg = _grad(port, x, ct)
    _same(got, want)  # two ranks: one add, the same either way
    _same(tg, jg)


@pytest.mark.parametrize("integers", [True, False], ids=["integers", "normal"])
def test_fanout_allgather(flat, integers):
    jm, tm = flat
    x = _inputs((8, 3), integers)
    # every rank ends with the full (8, 3) table -> replicated out_spec
    f = _smap(jm, lambda v: jc.fanout(v[0], "dp"), P("dp", None), P(None, None))
    ct = _inputs((8, 3), integers, seed=2)
    want, jg = _vjp(f, x, ct)
    got, tg = _grad(lambda t: tpar.fanout(t, "dp", tm), x, ct)
    _same(got, want)
    (_same if integers else _close)(tg, jg)


def test_partition_exchange_is_transpose(flat):
    """``tests/test_parallel.py::test_partition_exchange_is_transpose``."""
    _, tm = flat
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    out = tpar.partition_exchange(x.reshape(8, 1, 8), "dp", split_dim=1, concat_dim=1, mesh=tm)
    assert torch.equal(out.reshape(8, 8), x.T)


@pytest.mark.parametrize("split_dim,concat_dim", [(0, 0), (1, 1), (0, 1), (1, 0)])
def test_partition_exchange(flat, split_dim, concat_dim):
    """The tiled all_to_all on a (8, 16) block a rank, forward and gradient,
    bit for bit (a permutation)."""
    jm, tm = flat
    x = _inputs((64, 16), False, seed=3)
    f = _smap(jm, partial(jc.partition_exchange, axis="dp", split_dim=split_dim,
                          concat_dim=concat_dim), P("dp", None), P("dp", None))
    want = np.asarray(f(jnp.asarray(x)))
    ct = _inputs(want.shape, False, seed=4)
    want, jg = _vjp(f, x, ct)

    def port(t):
        out = tpar.partition_exchange(t.reshape(8, 8, 16), "dp", split_dim, concat_dim, tm)
        return out.reshape(-1, out.shape[-1])

    got, tg = _grad(port, x, ct)
    _same(got, want)
    _same(tg, jg)


@pytest.mark.parametrize("integers", [True, False], ids=["integers", "normal"])
def test_ring_allgather_matches_native(flat, integers):
    """``tests/test_parallel.py::test_ring_allgather_matches_native``: every
    rank's table is the gather; the gradient through rank 0's table is
    JAX's through its replicated output."""
    jm, tm = flat
    x = _inputs((8, 2), integers)
    f = _smap(jm, lambda v: jc.ring_allgather(v.reshape(2), "dp"), P("dp", None), P(None, None))
    ct = _inputs((8, 2), integers, seed=7)
    want, jg = _vjp(f, x, ct)
    tables = tpar.ring_allgather(torch.from_numpy(x), "dp", tm)
    assert tables.shape == (8, 8, 2)
    for r in range(8):
        _same(tables[r], want)
    _same(tpar.fanout(torch.from_numpy(x), "dp", tm), want)
    got, tg = _grad(lambda t: tpar.ring_allgather(t, "dp", tm)[0], x, ct)
    _same(got, want)
    (_same if integers else _close)(tg, jg)


@pytest.mark.parametrize("integers", [True, False], ids=["integers", "normal"])
def test_ring_stream_fold(flat, integers):
    """``ring_stream`` folding ``acc + received`` (``_ring_context``'s ring):
    each rank's carry in its own order, and the transposed ring's gradient,
    bit for bit."""
    jm, tm = flat

    def fold(acc, received):
        return acc + received, received

    x = _inputs((8, 4), integers, seed=8)
    f = _smap(jm, lambda v: jc.ring_stream(v, "dp", fold, jnp.zeros_like(v))[0],
              P("dp", None), P("dp", None))
    ct = _inputs((8, 4), integers, seed=9)
    want, jg = _vjp(f, x, ct)
    got, tg = _grad(lambda t: tpar.ring_stream(t, "dp", fold, torch.zeros_like(t), tm)[0], x, ct)
    _same(got, want)
    _same(tg, jg)


def test_collectives_check_the_axis():
    tm = tpar.make_fabric_mesh(8, axis_sizes={"dp": 2, "tp": 2, "sp": 2}, device="cpu")
    with pytest.raises(ValueError, match="mesh's tp is 2"):
        tpar.merge(torch.zeros(4, 3), "tp", mesh=tm)
    with pytest.raises(ValueError, match="unknown axis"):
        tpar.fanout(torch.zeros(2, 3), "xp", tm)
    with pytest.raises(ValueError, match="unknown merger"):
        tpar.merge(torch.zeros(2, 3), "tp", "prod")
    with pytest.raises(ValueError, match="does not split"):
        tpar.partition_exchange(torch.zeros(2, 3), "tp")
