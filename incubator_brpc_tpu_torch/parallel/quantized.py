"""Quantized collectives — block-wise int8/int4 pmean on the collective
session plane, the counterpart of ``incubator_brpc_tpu/parallel/quantized.py``
(EQuARX, PAPERS.md 2506.17615): ~4x fewer bytes on the wire.

A quantized pmean splits each party's f32 row into blocks of ``block``
floats, keeps one power-of-two scale per block (an int8 exponent), ships
the int8 (or packed int4) values and the exponents across the party axis,
and dequantizes and averages on arrival. The design decisions and the error
bound are the JAX module's: power-of-two scales make quantize and
dequantize exact arithmetic and the round trip idempotent (what lets a
quantized checkpoint ring resume byte-identically), rounding is half to
even, never stochastic, and a chunk boundary must fall on a block boundary
(``DeviceMethod.chunk_align = 4 * block``).

The constants, ``qmax_for``, ``supports``, ``wire_bytes`` and the numpy
twin (``np_*``, ``pmean_error_bound``) are the JAX module's, verbatim: the
checkpoint restore path (``parallel/mc_dispatch.py``) dequantizes on the
host with them, and the tests hold the kernels against them. The device
side is ``_tq_quantize`` / ``_tq_dequantize``, the counterparts of
``_jq_quantize`` / ``_jq_dequantize``, over K2 (``ops/quantize.py``,
``csrc/quantize.cu``), and the pmean kernel that runs them:

    quantize the rows this process holds (K2a) -> axis.all_gather
        -> dequantize-mean (K2b) into as many rows as it holds

which is bitwise the numpy twin's arithmetic, the party sum included (it
is taken in party order). It runs unchanged on both forms of the party
axis (``parallel/mesh.py``): in the single-controller form it quantizes
and writes every party's row, across processes each rank quantizes its
own row, the int8 (or packed int4) values and the exponents cross the
session group in those dtypes, and K2b writes the rank's one row.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from incubator_brpc_tpu_torch.ops import quantize
from incubator_brpc_tpu_torch.rpc.device_method import DeviceMethod

QUANT_MODES = ("none", "int8", "int4")
DEFAULT_BLOCK = 32  # float32 values per scale block
_QMAX = {"int8": 127, "int4": 7}

# exponent clamp: int8 storage and exp2() exactness both hold inside
# the normal-float32 exponent range; a block whose amax sits outside it
# quantizes to zeros (subnormal data) or saturates (near-f32-max data)
_E_MIN, _E_MAX = -126, 127


def qmax_for(mode: str) -> int:
    return _QMAX[mode]


def supports(width: int, mode: str, block: int = DEFAULT_BLOCK) -> bool:
    """Whether a width-``width``-byte row quantizes in ``mode``: float32
    rows only, whole blocks only (a trailing partial block would need its
    own scale arithmetic and break chunk alignment), and int4 packs two
    values per byte so blocks must hold an even count."""
    if mode not in _QMAX or block <= 0:
        return False
    if width % 4 != 0:
        return False
    nfloats = width // 4
    if nfloats % block != 0:
        return False
    if mode == "int4" and block % 2 != 0:
        return False
    return True


def wire_bytes(width: int, mode: str, block: int = DEFAULT_BLOCK) -> int:
    """Bytes one party ships per step for a width-byte row: the quantized
    values plus one int8 exponent per block (the exact path ships
    ``width``).  Derived from the storage dtypes, not hand math."""
    if mode == "none":
        return int(width)
    if not supports(width, mode, block):
        raise ValueError(f"width {width} does not quantize as {mode}/{block}")
    nfloats = width // 4
    nblocks = nfloats // block
    vals = nfloats * np.dtype(np.int8).itemsize
    if mode == "int4":
        vals //= 2  # two 4-bit values packed per byte
    return vals + nblocks * np.dtype(np.int8).itemsize


# -- the numpy twin ------------------------------------------------------------
#
# Host-side mirror of the device arithmetic below, used by checkpoint
# restore/reshard (parallel/mc_dispatch._restore_state dequantizes ring
# shards on the host) and by tests as the oracle.  Every operation is
# exact (comparisons, frexp, power-of-two scaling), so the two twins
# agree BITWISE — the property the restore path depends on.


def np_block_exponents(xf: np.ndarray, mode: str, block: int) -> np.ndarray:
    """Per-block power-of-two scale exponents: the smallest e with
    ``amax / 2^e <= qmax``.  frexp gives amax/qmax = m * 2^ex with
    m in [0.5, 1); ceil(log2) is ex except exactly at m == 0.5."""
    qmax = _QMAX[mode]
    xb = np.abs(xf.reshape(-1, block)).max(axis=1) / np.float32(qmax)
    m, ex = np.frexp(xb.astype(np.float32))
    e = ex - (m == np.float32(0.5))
    return np.clip(e, _E_MIN, _E_MAX).astype(np.int8)


def np_quantize(
    xf: np.ndarray, mode: str, block: int = DEFAULT_BLOCK
) -> Tuple[np.ndarray, np.ndarray]:
    """float32[nfloats] -> (wire values, int8 exponents).  int8 mode
    returns int8[nfloats]; int4 packs value pairs into uint8[nfloats/2]
    (low nibble first, offset-8 so [-7, 7] maps to [1, 15])."""
    xf = np.asarray(xf, dtype=np.float32).reshape(-1)
    qmax = _QMAX[mode]
    e = np_block_exponents(xf, mode, block)
    scale = np.exp2(e.astype(np.float32))
    q = np.clip(
        np.round(xf.reshape(-1, block) / scale[:, None]), -qmax, qmax
    ).astype(np.int8)
    q = q.reshape(-1)
    if mode == "int4":
        u = (q.astype(np.int16) + 8).astype(np.uint8)
        q = (u[0::2] | (u[1::2] << 4)).astype(np.uint8)
    return q, e


def np_dequantize(
    q: np.ndarray, e: np.ndarray, mode: str, block: int = DEFAULT_BLOCK
) -> np.ndarray:
    """Inverse of :func:`np_quantize` — exact (power-of-two scaling)."""
    if mode == "int4":
        u = np.asarray(q, dtype=np.uint8)
        lo = (u & 0xF).astype(np.int16) - 8
        hi = (u >> 4).astype(np.int16) - 8
        q = np.stack([lo, hi], axis=1).reshape(-1).astype(np.int8)
    q = np.asarray(q, dtype=np.int8)
    scale = np.exp2(np.asarray(e, dtype=np.int8).astype(np.float32))
    return (
        q.reshape(-1, block).astype(np.float32) * scale[:, None]
    ).reshape(-1)


def np_quantized_pmean(
    rows: List[np.ndarray], steps: int, mode: str, block: int = DEFAULT_BLOCK
) -> np.ndarray:
    """Host model of the K-step quantized pmean chain: each step every
    party quantizes its row, the dequantized contributions average, and
    every party continues from the mean.  Float summation order may
    differ from XLA's by an ulp — compare with a tolerance, not bytes
    (the byte-exactness claims live in the round-trip, not the sum)."""
    cur = [np.asarray(r, dtype=np.float32).reshape(-1) for r in rows]
    for _ in range(int(steps)):
        deq = [np_dequantize(*np_quantize(r, mode, block), mode, block)
               for r in cur]
        m = (np.sum(np.stack(deq), axis=0, dtype=np.float32)
             / np.float32(len(cur)))
        cur = [m.copy() for _ in cur]
    return cur[0]


def pmean_error_bound(
    rows: List[np.ndarray], steps: int, mode: str, block: int = DEFAULT_BLOCK
) -> float:
    """The documented worst-case |quantized - exact| for a K-step pmean
    chain of these operands: per step each party contributes ≤ scale/2 ≤
    amax_block/qmax of error to the mean, so one step is bounded by the
    max over parties of the per-block amax / qmax, and K steps compound
    ≤ K times that (magnitudes only shrink under pmean)."""
    qmax = _QMAX[mode]
    worst = 0.0
    for r in rows:
        xb = np.abs(np.asarray(r, dtype=np.float32).reshape(-1, block))
        worst = max(worst, float(xb.max()))
    return steps * worst / qmax


# -- the torch kernels ---------------------------------------------------------


def _tq_quantize(xf: torch.Tensor, mode: str, block: int):
    """torch twin of np_quantize over a [rows, nfloats] float32 tensor:
    returns (wire values [rows, ...], exponents int8 [rows, nblocks]).
    K2a on the card; its plain version on the CPU."""
    return quantize.quantize_rows(xf, mode, block)


def _tq_dequantize(q: torch.Tensor, e: torch.Tensor, mode: str, block: int):
    """torch twin of np_dequantize over [rows, ...] wire tensors: K2b
    with ``mean=False``."""
    return quantize.dequant_mean_rows(q, e, mode, block, mean=False)


def _make_quantized_pmean_kernel(mode: str, block: int):
    """Mint the quantized pmean kernel for one (mode, block): quantize
    every party's row, all_gather the QUANTIZED representation over the
    party axis (the gathered tensors are the int8/int4 values + int8
    exponents, never the float32 rows), dequantize every party's
    contribution and average in party order. The defaults (mode, block)
    enter the DeviceMethod fingerprint, so two parametrizations can never
    silently alias."""

    def kernel(data, n, axis, _mode=mode, _block=block):
        f = data.view(torch.float32)  # [P_local, width / 4]; a chunk stays a view
        q, e = _tq_quantize(f, _mode, _block)
        # the wire crossing: per party, len(q[0]) + len(e[0]) bytes
        # instead of the width-byte float row
        gq = axis.all_gather(q)
        ge = axis.all_gather(e)
        m = quantize.dequant_mean_rows(gq, ge, _mode, _block, out_rows=f.shape[0])
        return m.view(torch.uint8), n

    return kernel


_variant_cache: Dict[tuple, "object"] = {}
_variant_lock = threading.Lock()


def quantized_pmean_dm(
    width: int, mode: str, block: int = DEFAULT_BLOCK
):
    """The quantized pmean DeviceMethod for one (width, mode, block) —
    cached so every resolution in this process hands back the same
    object (and therefore the same fingerprint)."""
    if not supports(width, mode, block):
        return None
    key = (int(width), mode, int(block))
    with _variant_lock:
        dm = _variant_cache.get(key)
        if dm is None:
            dm = DeviceMethod(
                _make_quantized_pmean_kernel(mode, block),
                width=width,
                chunkable=True,
            )
            dm.quant_mode = mode
            dm.quant_block = int(block)
            dm.chunk_align = 4 * int(block)
            dm.collective_bytes = wire_bytes(width, mode, block)
            _variant_cache[key] = dm
        return dm


def attach_pmean_variants(dm, width: int, block: int = DEFAULT_BLOCK):
    """Hang the int8/int4 pmean variants off an exact pmean DeviceMethod
    (parallel/mc_collective mints one per width): the session plane's
    ``quantize=`` knob resolves through ``DeviceMethod.quantized``, and a
    width that doesn't block-align simply gets no variant — the knob
    then rejects cleanly before any step."""
    for mode in ("int8", "int4"):
        if supports(width, mode, block):
            var = quantized_pmean_dm(width, mode, block)
            if var is not None:
                dm.quant_variants[mode] = var
    return dm
