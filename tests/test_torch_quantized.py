"""K2 of the port (``ops/quantize.py`` through ``parallel/quantized.py``)
against the JAX package and the numpy twin, on the CPU: the same numpy
rows through ``incubator_brpc_tpu.parallel.quantized._jq_quantize`` /
``_jq_dequantize`` (XLA:CPU) and through the port's plain versions.

Tolerances: none below the party mean. Quantize, dequantize and the mean
are bitwise equal to the numpy twin everywhere, and to the JAX twins on
random rows; the party mean equals JAX's bitwise at 2 parties, and within
1e-5 at 3 (XLA may add the parties in another order).

One exception, in the reference: on XLA:CPU ``jnp.exp2`` of an integer is
not a power of two for most exponents outside [-12, 12], and XLA:CPU
flushes subnormals to zero, so ``_jq_*`` differs from the numpy twin on
blocks with such exponents or subnormal values (``chip_smoke.py``'s edge
blocks are built to reach them). There the port follows the numpy twin,
which is what the checkpoint restore path computes; the comparison with
JAX covers every other block (``_xla_cpu_exact``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from incubator_brpc_tpu.parallel import quantized as JQ
from incubator_brpc_tpu_torch.ops import quantize
from incubator_brpc_tpu_torch.parallel import quantized as Q
from incubator_brpc_tpu_torch.parallel.mc_collective import _pmean_dm
from incubator_brpc_tpu_torch.rpc.device_method import DeviceMethod

WIDTH = 256  # 64 floats = 2 default blocks
TINY = np.finfo(np.float32).tiny


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These sizes gain nothing from threads; one keeps the xdist workers'
    cores for the timing-sensitive tests running beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rows(n, nfloats, seed=5, scale=3.0):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal(nfloats) * scale * (i + 1)).astype(np.float32)
        for i in range(n)
    ]


def _port_quantize(rows, mode, block):
    q, e = Q._tq_quantize(torch.from_numpy(np.stack(rows)), mode, block)
    return q.numpy(), e.numpy()


def _jax_quantize(rows, mode, block):
    q, e = JQ._jq_quantize(jnp.asarray(np.stack(rows)), mode, block)
    return np.asarray(q), np.asarray(e)


def _xla_cpu_exact(rows, mode, block):
    """[rows, nblocks] bool: the blocks on which XLA:CPU computes the JAX
    twins exactly — its exp2 is 2^e bit for bit at the block's exponent,
    and neither a value nor amax / qmax is subnormal."""
    x = np.abs(np.stack(rows)).reshape(len(rows), -1, block)
    e = np.stack([JQ.np_quantize(r, mode, block)[1] for r in rows]).astype(np.float32)
    exp2_ok = np.asarray(jnp.exp2(jnp.asarray(e))).view(np.uint32) == np.exp2(e).view(np.uint32)
    y = x.max(axis=-1) / np.float32(JQ.qmax_for(mode))
    no_sub = ~((x > 0) & (x < TINY)).any(axis=-1) & ~((y > 0) & (y < TINY))
    return exp2_ok & no_sub


def _edge_rows(mode, block, parties=3):
    return list(chip_smoke.quant_rows(parties, 16 * block, block, mode, seed=block))


# -- the kernels against the JAX twins and the numpy twin -----------------------


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("scale", [3.0, 1e-3, 500.0])
def test_quantize_matches_jax_and_numpy_on_random_rows(mode, block, scale):
    rows = _rows(3, 1024, seed=block, scale=scale)
    q, e = _port_quantize(rows, mode, block)
    jq, je = _jax_quantize(rows, mode, block)
    assert q.dtype == jq.dtype and e.dtype == je.dtype == np.int8
    assert q.tobytes() == jq.tobytes() and e.tobytes() == je.tobytes()
    for r, row in enumerate(rows):
        nq, ne = Q.np_quantize(row, mode, block)
        assert q[r].tobytes() == nq.tobytes() and e[r].tobytes() == ne.tobytes()


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("block", [16, 32])
def test_quantize_on_edge_rows(mode, block):
    """The edge blocks of chip_smoke.py phase 9 (zero, amax/qmax = 2^5,
    .5 ties, subnormal, tiny, up to FLT_MAX, mixed signs): bitwise the
    numpy twin's on every block, and JAX's where XLA:CPU is exact."""
    rows = _edge_rows(mode, block)
    q, e = _port_quantize(rows, mode, block)
    for r, row in enumerate(rows):
        nq, ne = Q.np_quantize(row, mode, block)
        assert q[r].tobytes() == nq.tobytes() and e[r].tobytes() == ne.tobytes()
    assert set(e[0, :8].tolist()) >= {0, 5, 3, -126}  # the edges are reached
    exact = _xla_cpu_exact(rows, mode, block)
    assert exact.sum() >= exact.size // 2
    jq, je = _jax_quantize(rows, mode, block)
    per = block // 2 if mode == "int4" else block
    for r in range(len(rows)):
        for b in np.nonzero(exact[r])[0]:
            assert je[r, b] == e[r, b]
            assert q[r, b * per:(b + 1) * per].tobytes() == jq[r, b * per:(b + 1) * per].tobytes()


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("edges", [False, True], ids=["random", "edge"])
def test_dequantize_matches_jax_and_numpy(mode, block, edges):
    rows = _edge_rows(mode, block) if edges else _rows(3, 512, seed=block + 1)
    q, e = _port_quantize(rows, mode, block)
    got = Q._tq_dequantize(torch.from_numpy(q), torch.from_numpy(e), mode, block).numpy()
    with np.errstate(over="ignore"):  # the FLT_MAX edge block dequantizes to inf
        for r in range(len(rows)):
            assert got[r].tobytes() == Q.np_dequantize(q[r], e[r], mode, block).tobytes()
    want = np.asarray(JQ._jq_dequantize(jnp.asarray(q), jnp.asarray(e), mode, block))
    mask = np.repeat(_xla_cpu_exact(rows, mode, block), block, axis=1)
    assert mask.any()
    assert got[mask].tobytes() == want[mask].tobytes()


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("parties", [2, 3, 8])
def test_dequantize_mean_matches_jax_and_numpy(mode, parties):
    """K2b's plain version: every row the party-ordered mean, bitwise the
    numpy twin's sum; JAX's jnp.sum(axis=0) / P bitwise at 2 parties (one
    addition has one order), within 1e-5 beyond."""
    rows = _rows(parties, 1024, seed=parties)
    q, e = _port_quantize(rows, mode, 32)
    got = quantize.dequant_mean_rows(torch.from_numpy(q), torch.from_numpy(e), mode, 32).numpy()
    deq = [Q.np_dequantize(q[r], e[r], mode, 32) for r in range(parties)]
    want = np.sum(np.stack(deq), axis=0, dtype=np.float32) / np.float32(parties)
    assert got.shape == (parties, 1024)
    for r in range(parties):
        assert got[r].tobytes() == want.tobytes()
    jv = JQ._jq_dequantize(jnp.asarray(q), jnp.asarray(e), mode, 32)
    jm = np.asarray(jnp.sum(jv, axis=0) / jnp.float32(parties))
    if parties == 2:
        assert got[0].tobytes() == jm.tobytes()
    else:
        np.testing.assert_allclose(got[0], jm, rtol=0, atol=1e-5)


def test_quantize_takes_a_strided_chunk_and_wrappers_check_arguments():
    x = torch.from_numpy(np.stack(_rows(3, 256, seed=4)))
    q, e = quantize.quantize_rows(x[:, 64:128], "int8", 32)
    qw, ew = quantize.quantize_rows(x[:, 64:128].contiguous(), "int8", 32)
    assert torch.equal(q, qw) and torch.equal(e, ew)
    with pytest.raises(ValueError, match="odd"):
        quantize.quantize_rows(x, "int4", 1)
    with pytest.raises(ValueError, match="blocks"):
        quantize.quantize_rows(x, "int8", 100)
    with pytest.raises(ValueError, match="mode"):
        quantize.quantize_rows(x, "int2", 32)
    with pytest.raises(TypeError):
        quantize.quantize_rows(x.double(), "int8", 32)
    with pytest.raises(TypeError):
        quantize.dequant_mean_rows(q.view(torch.uint8), e, "int8", 32)
    with pytest.raises(ValueError):
        quantize.dequant_mean_rows(q, e[:, :1], "int8", 32)


def test_exact_helpers():
    """2^e from its bits for every int8 exponent (torch.exp2 is not exact
    for all of them); the block exponent agrees with np.frexp's, zero and
    subnormals included."""
    e = np.arange(-128, 128).astype(np.int8)
    got = quantize.exp2_exact(torch.from_numpy(e)).numpy().astype(np.float64)
    assert np.array_equal(got, 2.0 ** e.astype(np.float64))
    rng = np.random.default_rng(1)
    y = np.concatenate([
        np.abs(rng.standard_normal(20000)) * 2.0 ** rng.integers(-149, 127, 20000),
        2.0 ** np.arange(-149, 128), [0.0, np.finfo(np.float32).max],
    ]).astype(np.float32)
    y = y[np.isfinite(y)]
    m, ex = np.frexp(y)
    want = np.clip(ex - (m == np.float32(0.5)), -126, 127)
    assert np.array_equal(quantize.block_exponents_from(torch.from_numpy(y)).numpy(), want)


# -- the port's counterparts of tests/test_quantized.py TestQuantizerMath ------


class TestQuantizerMath:
    """The torch twins: the arithmetic contract the session plane rides."""

    @pytest.mark.parametrize("mode", ["int8", "int4"])
    @pytest.mark.parametrize("width,block", [(128, 32), (512, 32), (512, 64), (4096, 32), (256, 8)])
    def test_round_trip_error_inside_bound(self, mode, width, block):
        (x,) = _rows(1, width // 4)
        q, e = Q._tq_quantize(torch.from_numpy(x)[None], mode, block)
        v = Q._tq_dequantize(q, e, mode, block)[0].numpy()
        bound = Q.pmean_error_bound([x], 1, mode, block)
        assert float(np.abs(v - x).max()) <= bound

    @pytest.mark.parametrize("mode", ["int8", "int4"])
    def test_round_trip_is_idempotent(self, mode):
        (x,) = _rows(1, WIDTH // 4, seed=9, scale=40.0)
        t = torch.from_numpy(x)[None]
        v1 = Q._tq_dequantize(*Q._tq_quantize(t, mode, 32), mode, 32)
        v2 = Q._tq_dequantize(*Q._tq_quantize(v1, mode, 32), mode, 32)
        assert v1.numpy().tobytes() == v2.numpy().tobytes()

    @pytest.mark.parametrize("mode", ["int8", "int4"])
    def test_zero_and_uniform_blocks(self, mode):
        for x in (np.zeros(64, np.float32), np.full(64, 7.5, np.float32)):
            t = torch.from_numpy(x)[None]
            v = Q._tq_dequantize(*Q._tq_quantize(t, mode, 32), mode, 32)[0].numpy()
            if not x.any():
                assert v.tobytes() == x.tobytes()
            assert float(np.abs(v - x).max()) <= Q.pmean_error_bound([x], 1, mode)

    @pytest.mark.parametrize("mode", ["int8", "int4"])
    @pytest.mark.parametrize("chunks", [2, 4])
    def test_chunk_split_identity(self, mode, chunks):
        """Quantizing each block-aligned chunk (a strided view of the
        rows) gives the bytes of the slice of the full-width result — the
        chunk-safety the overlap scheduler relies on."""
        x = torch.from_numpy(np.stack(_rows(3, 128, seed=3)))
        full = Q._tq_dequantize(*Q._tq_quantize(x, mode, 32), mode, 32)
        cw = 128 // chunks
        parts = [
            Q._tq_dequantize(*Q._tq_quantize(x[:, j * cw:(j + 1) * cw], mode, 32), mode, 32)
            for j in range(chunks)
        ]
        assert torch.cat(parts, dim=1).numpy().tobytes() == full.numpy().tobytes()

    def test_wire_bytes_and_support(self):
        assert Q.wire_bytes(512, "none") == 512
        assert Q.wire_bytes(512, "int8") == 128 + 4  # values + exponents
        assert Q.wire_bytes(512, "int4") == 64 + 4
        for width in (512, 4096, 1 << 20):
            for mode in ("int8", "int4"):
                assert Q.wire_bytes(width, mode) == JQ.wire_bytes(width, mode)
        assert round(Q.wire_bytes(1 << 20, "int8") / (1 << 20), 4) == 0.2578
        assert round(Q.wire_bytes(1 << 20, "int4") / (1 << 20), 4) == 0.1328
        assert not Q.supports(100, "int8")   # 25 floats: no whole block
        assert not Q.supports(514, "int8")   # not float32-aligned
        assert not Q.supports(512, "int4", block=31)  # odd int4 block
        with pytest.raises(ValueError):
            Q.wire_bytes(100, "int8")

    @pytest.mark.parametrize("mode", ["int8", "int4"])
    def test_quantized_pmean_model_error_bound(self, mode):
        rows = _rows(3, 64, seed=12)
        exact = np.mean(np.stack(rows), axis=0, dtype=np.float32)
        for steps in (1, 4):
            got = Q.np_quantized_pmean(rows, steps, mode)
            assert got.tobytes() == JQ.np_quantized_pmean(rows, steps, mode).tobytes()
            assert float(np.abs(got - exact).max()) <= Q.pmean_error_bound(rows, steps, mode)


# -- the port's counterparts of tests/test_quantized.py TestVariantRegistry ----


class TestVariantRegistry:
    def test_fingerprint_stability_and_distinctness(self):
        a = DeviceMethod(Q._make_quantized_pmean_kernel("int8", 32), width=WIDTH)
        b = DeviceMethod(Q._make_quantized_pmean_kernel("int8", 32), width=WIDTH)
        assert a.fingerprint() == b.fingerprint()
        c = DeviceMethod(Q._make_quantized_pmean_kernel("int4", 32), width=WIDTH)
        d = DeviceMethod(Q._make_quantized_pmean_kernel("int8", 16), width=WIDTH)
        e = DeviceMethod(Q._make_quantized_pmean_kernel("int8", 32), width=2 * WIDTH)
        assert len({x.fingerprint() for x in (a, c, d, e)}) == 4

    def test_quantized_resolution(self):
        dm = _pmean_dm(WIDTH)
        assert dm.quantized("none") is dm
        assert dm.quantized("") is dm
        v8 = dm.quantized("int8")
        assert v8 is not None and v8.quant_mode == "int8"
        assert v8.chunkable and v8.chunk_align == 4 * Q.DEFAULT_BLOCK
        assert v8.wire_bytes() == Q.wire_bytes(WIDTH, "int8")
        assert v8.quantized("int8") is v8  # a variant resolves itself
        assert _pmean_dm(68).quantized("int8") is None  # 17 floats: no whole block

    def test_variant_cache_is_shared(self):
        assert Q.quantized_pmean_dm(WIDTH, "int8") is Q.quantized_pmean_dm(WIDTH, "int8")
        assert Q.quantized_pmean_dm(100, "int8") is None
