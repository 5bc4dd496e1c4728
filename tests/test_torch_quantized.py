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


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("parties", [2, 3, 8])
@pytest.mark.parametrize("steps", [1, 3])
def test_dequantize_mean_one_row_form_is_the_models_row(mode, parties, steps):
    """K2b's one-row form (``out_rows=1``, what a rank of a session across
    processes keeps): the gathered parties' mean in one row, bitwise the
    row ``np_quantized_pmean`` gives every party, step after step from that
    one row as the session runs it."""
    rows = _rows(parties, 1024, seed=10 + parties)
    cur = [torch.from_numpy(r)[None] for r in rows]  # each party's [1, nfloats]
    for _ in range(steps):
        parts = [quantize.quantize_rows(c, mode, 32) for c in cur]
        gq = torch.cat([q for q, _ in parts])
        ge = torch.cat([e for _, e in parts])
        one = quantize.dequant_mean_rows(gq, ge, mode, 32, out_rows=1)
        assert one.shape == (1, 1024)
        full = quantize.dequant_mean_rows(gq, ge, mode, 32)
        assert all(full[r].numpy().tobytes() == one[0].numpy().tobytes() for r in range(parties))
        cur = [one] * parties
    assert one[0].numpy().tobytes() == Q.np_quantized_pmean(rows, steps, mode).tobytes()
    with pytest.raises(ValueError, match="out_rows"):
        quantize.dequant_mean_rows(gq, ge, mode, 32, mean=False, out_rows=1)
    with pytest.raises(ValueError, match="out_rows"):
        quantize.dequant_mean_rows(gq, ge, mode, 32, out_rows=0)


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


# -- the arithmetic of the vector forms (csrc/quantize.cu) ----------------------


def _pow2(e):
    """2^e as float32 from its bits, for int e in [-149, 127] (the kernels'
    exp2_exact)."""
    e = np.asarray(e, dtype=np.int64)
    normal = ((np.clip(e, -126, 127) + 127) << 23).astype(np.uint32).view(np.float32)
    sub = (np.uint32(1) << np.clip(e + 149, 0, 22).astype(np.uint32)).view(np.float32)
    return np.where(e >= -126, normal, sub)


def _identity_values(kind):
    rng = np.random.default_rng(13)
    if kind == "exponents":  # every biased exponent, normal and subnormal, random mantissas
        biased = np.repeat(np.arange(256, dtype=np.uint32), 64)
        bits = (biased << 23) | rng.integers(0, 1 << 23, biased.size, dtype=np.uint32)
        bits |= rng.integers(0, 2, biased.size, dtype=np.uint32) << 31
        return bits.view(np.float32)
    if kind == "subnormal_quotients":  # x / 2^e below 2^-126 for the larger e, ties in the last bit
        x = (rng.uniform(1, 2, 4096) * 2.0 ** rng.integers(-149, 20, 4096)).astype(np.float32)
        odd = ((np.arange(1, 4097, dtype=np.uint32) | 1) << 1).view(np.float32)  # tiny odd subnormals
        return np.concatenate([x, -x, odd, np.float32(2.0 ** -126) * np.arange(1, 9, dtype=np.float32)])
    if kind == "specials":
        return np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, np.finfo(np.float32).max,
                         np.finfo(np.float32).tiny, 2.0 ** -149], dtype=np.float32)
    # the rows of chip_smoke.quant_edge_blocks
    return np.concatenate([chip_smoke.quant_edge_blocks(b, m, seed=b).reshape(-1)
                           for m in ("int8", "int4") for b in (16, 32, 64)])


@pytest.mark.parametrize("kind", ["exponents", "subnormal_quotients", "specials", "edge_rows"])
def test_division_by_2e_is_multiplication_by_2_minus_e(kind):
    """The vector kernels scale by x * 2^-e where the numpy twin divides
    by 2^e: bitwise the same for every e in [-126, 127] (2^-127, for e =
    127, is subnormal), with gradual underflow, for +-0, +-inf and NaN."""
    x = _identity_values(kind)
    assert kind != "exponents" or len(np.unique((x.view(np.uint32) >> 23) & 0xFF)) == 256
    with np.errstate(all="ignore"):
        for e in range(-126, 128):
            div = x / _pow2(e)
            mul = x * _pow2(-e)
            assert div.view(np.uint32).tobytes() == mul.view(np.uint32).tobytes(), e
    assert _pow2(-127).view(np.uint32) == 1 << 22  # the subnormal 2^-127


def _block_exponents_from_bits(y):
    """The kernels' block_exponent over f32 y >= 0."""
    bits = y.view(np.uint32)
    biased = ((bits >> 23) & 0xFF).astype(np.int64)
    mant = bits & 0x7FFFFF
    e = np.minimum(biased - 127 + (mant != 0), 127)
    return np.where(biased == 0, np.where(mant == 0, 0, -126), e)


def _k2a_vector(rows, mode, block):
    """K2a's vector form, stated in numpy: a group of block / 4 lanes owns a
    block, each lane a float4; the lane's max of |x| from 0 (fmax drops a
    NaN), the group's max, e from the bits of amax / qmax, x scaled by
    2^-e, four values packed into one little-endian word (int8: 32 bits;
    int4: 16 bits of nibbles q + 8, the first element lowest)."""
    qmax = np.float32(Q.qmax_for(mode))
    x = np.asarray(rows, dtype=np.float32)
    r, n = x.shape
    f4 = x.reshape(r, n // 4, 4)
    lane = np.fmax(np.fmax(np.fmax(np.abs(f4[..., 0]), np.abs(f4[..., 1])),
                           np.fmax(np.abs(f4[..., 2]), np.abs(f4[..., 3]))), np.float32(0))
    amax = lane.reshape(r, n // block, block // 4).max(axis=-1)
    e = _block_exponents_from_bits(amax / qmax)
    inv = np.repeat(_pow2(-e), block // 4, axis=1)[..., None]
    with np.errstate(over="ignore", invalid="ignore"):
        qv = np.clip(np.rint(f4 * inv), -qmax, qmax).astype(np.int64)
    if mode == "int4":
        nib = (qv + 8) & 0xF
        words = (nib[..., 0] | nib[..., 1] << 4 | nib[..., 2] << 8 | nib[..., 3] << 12).astype("<u2")
    else:
        b = qv & 0xFF
        words = (b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24).astype("<u4")
    return words.view(np.uint8).reshape(r, -1), e.astype(np.int8)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("block", [16, 32, 64])
@pytest.mark.parametrize("edges", [False, True], ids=["random", "edge"])
def test_k2a_vector_form_statement_matches_the_numpy_twin(mode, block, edges):
    rows = np.stack(_edge_rows(mode, block) if edges else _rows(3, 1024, seed=block + 2))
    q, e = _k2a_vector(rows, mode, block)
    with np.errstate(over="ignore"):
        for r, row in enumerate(rows):
            nq, ne = Q.np_quantize(row, mode, block)
            assert q[r].tobytes() == nq.view(np.uint8).tobytes()
            assert e[r].tobytes() == ne.tobytes()


def _k2b_vector(q, e, mode, block, mean):
    """K2b's vector form, stated in numpy: a thread's 4 elements from one
    little-endian word of q a party (int8: 32 bits; int4: 16 bits of
    nibbles), scaled by 2^e of their block, the party sum in order from
    -0.0 (the identity of IEEE addition), one division by P."""
    words = np.ascontiguousarray(q).view("<u2" if mode == "int4" else "<u4").astype(np.int64)
    shift = np.arange(4) * (4 if mode == "int4" else 8)
    vals = (words[..., None] >> shift) & (0xF if mode == "int4" else 0xFF)
    vals = vals - 8 if mode == "int4" else np.where(vals > 127, vals - 256, vals)
    p = q.shape[0]
    v = vals.reshape(p, -1).astype(np.float32) * np.repeat(_pow2(e.astype(np.int64)), block, axis=1)
    if not mean:
        return v
    acc = np.full(v.shape[1], -0.0, dtype=np.float32)
    for row in v:
        acc = acc + row
    return np.broadcast_to(acc / np.float32(p), v.shape)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("block", [8, 16, 32])
@pytest.mark.parametrize("parties", [1, 3, 8])
def test_k2b_vector_form_statement_matches_the_numpy_twin(mode, block, parties):
    rows = list(chip_smoke.quant_rows(parties, 16 * block, block, mode, seed=block + parties))
    twins = [Q.np_quantize(r, mode, block) for r in rows]
    q = np.stack([t[0] for t in twins])
    e = np.stack([t[1] for t in twins])
    with np.errstate(over="ignore"):
        deq = [Q.np_dequantize(tq, te, mode, block) for tq, te in twins]
        want = np.sum(np.stack(deq), axis=0, dtype=np.float32) / np.float32(parties)
        got = _k2b_vector(q, e, mode, block, mean=True)
        own = _k2b_vector(q, e, mode, block, mean=False)
    for r in range(parties):
        assert got[r].tobytes() == want.tobytes()
        assert own[r].tobytes() == deq[r].tobytes()


def test_forms_are_chosen_by_shape():
    """ops/quantize.py picks each kernel's form from the shape alone, as
    chip_smoke.k2_expected_forms states it; the session's chunks (views of
    the state cut at chunk_align = 4 * block bytes) take the vector forms."""
    for mode in ("int8", "int4"):
        for parties, width, block, layout in chip_smoke.K2_CASES:
            if width > 4096:
                continue
            rows = chip_smoke.quant_rows(parties, width // 4, block, mode, seed=1, edges=False)
            x = chip_smoke.k2_layout(torch, rows, torch.device("cpu"), layout)
            q, _ = quantize.quantize_rows(x, mode, block)
            if layout == "offset":
                q = torch.empty(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)
            want = chip_smoke.k2_expected_forms(block, mode, layout)
            assert [quantize.quantize_form(x, block)] == want["quantize_rows"]
            assert [quantize.dequant_form(q, mode, block)] == want["dequant_mean_rows"]
    state = torch.zeros((8, 4096), dtype=torch.uint8)
    cw = 4096 // 4
    for j in range(4):
        chunk = state[:, j * cw:(j + 1) * cw].view(torch.float32)
        assert quantize.quantize_form(chunk, 32) == "vector"
    assert quantize.quantize_form(torch.zeros((70000, 32)), 32) == "general"  # rows past grid.y
