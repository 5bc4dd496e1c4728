"""K2 — block quantize and dequantize-mean, the kernels of the quantized
collective sessions, and their plain versions.

Two wrappers over the hand-written CUDA kernels in ``csrc/quantize.cu``:

- :func:`quantize_rows` (K2a) replaces
  ``incubator_brpc_tpu/parallel/quantized.py:197 _jq_quantize``: f32 rows
  ``[P, nfloats]`` -> wire values (int8 ``[P, nfloats]``, or int4 packed in
  uint8 ``[P, nfloats / 2]``) and one int8 power-of-two exponent per block
  of ``block`` floats ``[P, nfloats / block]``. The session plane runs it
  on every party's row each step (``_make_quantized_pmean_kernel``) and on
  each checkpointed state (``mc_dispatch._make_ck_quant``).
- :func:`dequant_mean_rows` (K2b) replaces ``quantized.py:220
  _jq_dequantize`` and the party mean after it (``:256-258``): the gathered
  values of P parties -> f32 ``[P, nfloats]`` whose every row is the mean,
  summed in party order. With ``mean=False`` it is the dequantize alone
  (row p holds party p's values), which is ``_jq_dequantize``.

The arithmetic is bitwise the numpy twin's (``parallel/quantized.py``
``np_quantize``, ``np_dequantize``, ``np_quantized_pmean``): power-of-two
scales built from exponent bits, IEEE divisions, round half to even, the
party sum in order. The plain versions below do the same in PyTorch; two
hazards of PyTorch shape them. ``torch.exp2`` is not exact for every
exponent, so 2^e comes from its bits. A CUDA tensor divided by a Python
number is multiplied by its reciprocal (one rounding more), so every
division here divides by a tensor.

Both kernels are bound by bytes: quantize reads 4 bytes and writes 1 (int4:
1/2) per float; dequantize-mean reads P (int4: P/2) bytes and writes 4 P
per float, the whole state. ``csrc/quantize.cu`` says what the design does
about it. Each kernel has a vector form (16-byte loads and stores, every
block loaded once) and a general form for the shapes off its alignments;
:func:`quantize_form` and :func:`dequant_form` pick one from the shape
before the launch. A wrapper given CPU tensors runs the plain version;
given CUDA tensors it launches the kernel on the current stream or raises.
Each launch adds one to its count in ``kernels.launch_counts()``, whichever
form ran, and one to the form's count in :func:`form_counts`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from incubator_brpc_tpu_torch.ops import kernels

QMAX = {"int8": 127, "int4": 7}
E_MIN, E_MAX = -126, 127
MAX_GRID = (1 << 31) - 1
K2 = ("quantize_rows", "dequant_mean_rows")
FORMS = ("vector", "general")
# the blocks K2a's vector form takes: block / 4 lanes, a power of two up to a warp
VECTOR_BLOCKS = (4, 8, 16, 32, 64, 128)

_form_launches = {(name, form): 0 for name in K2 for form in FORMS}


# -- exact helpers (shared by the plain versions) ------------------------------


def exp2_exact(e: torch.Tensor) -> torch.Tensor:
    """2^e as f32, exactly, for int8 exponents (subnormal below -126)."""
    e = e.to(torch.int32)
    normal = ((e.clamp(min=E_MIN) + 127) << 23).view(torch.float32)
    sub = (torch.ones_like(e) << (e + 149).clamp(0, 22)).view(torch.float32)
    return torch.where(e >= E_MIN, normal, sub)


def block_exponents_from(y: torch.Tensor) -> torch.Tensor:
    """clip(ceil(log2 y), -126, 127), and 0 where y == 0, from the bits of
    f32 ``y >= 0`` (np.frexp's exponent, minus 1 at mantissa 0.5)."""
    bits = y.contiguous().view(torch.int32)
    biased = (bits >> 23) & 0xFF
    mant = bits & 0x7FFFFF
    e = biased - 127 + (mant != 0).to(torch.int32)
    sub = torch.where(mant == 0, 0, E_MIN)  # zero, or a subnormal y
    return torch.where(biased == 0, sub, e).clamp(E_MIN, E_MAX)


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b rounded once (IEEE), also on CUDA where a Python divisor
    would be a multiplication by its reciprocal."""
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, float(b))
    return a / b


# -- plain versions ------------------------------------------------------------


def quantize_rows_plain(x: torch.Tensor, mode: str, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    qmax = QMAX[mode]
    rows = x.shape[0]
    xb = x.reshape(rows, -1, block)
    e = block_exponents_from(_div(xb.abs().amax(dim=-1), qmax))
    scale = exp2_exact(e)
    q = torch.round(_div(xb, scale[..., None])).clamp(-qmax, qmax)
    q = q.to(torch.int8).reshape(rows, -1)
    if mode == "int4":
        u = (q.to(torch.int16) + 8).to(torch.uint8)
        q = u[:, 0::2] | (u[:, 1::2] << 4)
    return q, e.to(torch.int8)


def dequantize_rows_plain(q: torch.Tensor, e: torch.Tensor, mode: str, block: int) -> torch.Tensor:
    rows = q.shape[0]
    if mode == "int4":
        lo = (q & 0xF).to(torch.int16) - 8
        hi = (q >> 4).to(torch.int16) - 8
        q = torch.stack([lo, hi], dim=-1).reshape(rows, -1)
    v = q.reshape(rows, -1, block).to(torch.float32) * exp2_exact(e)[..., None]
    return v.reshape(rows, -1)


def dequant_mean_rows_plain(q, e, mode: str, block: int, *, mean: bool = True) -> torch.Tensor:
    v = dequantize_rows_plain(q, e, mode, block)
    if not mean:
        return v
    acc = v[0].clone()
    for p in range(1, v.shape[0]):  # party order, as the kernel and np.sum(axis=0)
        acc += v[p]
    return _div(acc, v.shape[0]).expand_as(v).contiguous()


# -- wrappers ------------------------------------------------------------------


def form_counts():
    """Launches of each kernel's each form, ``{(name, form): n}``, since the
    module was loaded."""
    with kernels._launches_lock:
        return dict(_form_launches)


def quantize_form(x: torch.Tensor, block: int) -> str:
    """The K2a form that takes ``x`` [rows, nfloats]: ``"vector"`` where a
    block is a power-of-two group of 1-32 float4s (``VECTOR_BLOCKS``) and
    every row starts on a 16-byte boundary, with at most ``MAX_ROWS`` rows;
    else ``"general"``, one warp a block."""
    rows = x.shape[0]
    if (block in VECTOR_BLOCKS and x.data_ptr() % 16 == 0 and rows <= kernels.MAX_ROWS
            and (rows <= 1 or x.stride(0) % 4 == 0)):
        return "vector"
    return "general"


def dequant_form(q: torch.Tensor, mode: str, block: int) -> str:
    """The K2b form that takes ``q``: ``"vector"`` where a thread's 4
    elements lie in one block and ``q`` starts on a boundary of their word
    (4 bytes int8, 2 bytes int4); else ``"general"``, one thread an element."""
    word = 2 if mode == "int4" else 4
    return "vector" if block % 4 == 0 and q.data_ptr() % word == 0 else "general"


def _launch(name: str, form: str, dev: torch.device, fn, *args) -> None:
    """``fn(*args, stream)`` on ``dev``'s current stream, its error raised,
    its launch counted. The device is made current only where it is not."""
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    if rc != 0:
        kernels._check_launch(kernels._lib, rc, name)
    with kernels._launches_lock:
        kernels._launches[name] += 1
        _form_launches[(name, form)] += 1


def _check_mode(mode: str, block: int, nfloats: int) -> None:
    if mode not in QMAX:
        raise ValueError(f"mode {mode!r}; want one of {sorted(QMAX)}")
    if block <= 0 or nfloats % block != 0:
        raise ValueError(f"{nfloats} floats do not split into blocks of {block}")
    if mode == "int4" and block % 2 != 0:
        raise ValueError(f"int4 packs value pairs: block {block} is odd")


def quantize_rows(x: torch.Tensor, mode: str, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2a. f32 ``[P, nfloats]`` (rows may be strided; each row contiguous)
    -> (int8 ``[P, nfloats]`` or packed int4 uint8 ``[P, nfloats / 2]``,
    int8 exponents ``[P, nfloats / block]``)."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError("quantize_rows takes a 2-d float32 tensor")
    rows, nfloats = x.shape
    _check_mode(mode, block, nfloats)
    if x.device.type == "cpu":
        return quantize_rows_plain(x, mode, block)
    if nfloats > 1 and x.stride(1) != 1:
        raise ValueError("quantize_rows: each row must be contiguous (stride 1 along it)")
    if rows > 1 and x.stride(0) < nfloats:
        raise ValueError(f"quantize_rows: row stride {x.stride(0)} < {nfloats} floats")
    nblocks = nfloats // block
    form = quantize_form(x, block)
    if form == "general" and rows * nblocks > MAX_GRID * 8:
        raise ValueError(f"quantize_rows: {rows} x {nblocks} blocks exceed the kernel's grid")
    int4 = mode == "int4"
    q = torch.empty((rows, nfloats // 2 if int4 else nfloats),
                    dtype=torch.uint8 if int4 else torch.int8, device=x.device)
    e = torch.empty((rows, nblocks), dtype=torch.int8, device=x.device)
    if rows == 0 or nfloats == 0:
        return q, e
    lib = kernels._lib or kernels.build()
    _launch("quantize_rows", form, x.device, lib.tb_quantize_rows, x.data_ptr(), x.stride(0),
            rows, nfloats, block, int(int4), int(form == "vector"), q.data_ptr(), e.data_ptr())
    return q, e


def dequant_mean_rows(q: torch.Tensor, e: torch.Tensor, mode: str, block: int,
                      *, mean: bool = True) -> torch.Tensor:
    """K2b. The wire values and exponents of P parties -> f32 ``[P,
    nfloats]``: every row the party-ordered mean (``mean=True``), or row p
    party p's dequantized values (``mean=False``)."""
    for t, name in ((q, "q"), (e, "e")):
        if not isinstance(t, torch.Tensor) or t.dim() != 2:
            raise TypeError(f"dequant_mean_rows: {name} must be a 2-d tensor")
    int4 = mode == "int4"
    want = torch.uint8 if int4 else torch.int8
    if q.dtype != want or e.dtype != torch.int8:
        raise TypeError(f"dequant_mean_rows: q {q.dtype}, e {e.dtype}; want {want}, int8")
    parties = q.shape[0]
    nfloats = q.shape[1] * (2 if int4 else 1)
    _check_mode(mode, block, nfloats)
    if tuple(e.shape) != (parties, nfloats // block):
        raise ValueError(f"dequant_mean_rows: e {tuple(e.shape)} for q {tuple(q.shape)}")
    if e.device != q.device:
        raise ValueError(f"dequant_mean_rows: q on {q.device}, e on {e.device}")
    if q.device.type == "cpu":
        return dequant_mean_rows_plain(q, e, mode, block, mean=mean)
    kernels._cuda_args(q, e)
    if (nfloats + 255) // 256 > MAX_GRID:
        raise ValueError(f"dequant_mean_rows: {nfloats} floats exceed the kernel's grid")
    out = torch.empty((parties, nfloats), dtype=torch.float32, device=q.device)
    if parties == 0 or nfloats == 0:
        return out
    form = dequant_form(q, mode, block)
    lib = kernels._lib or kernels.build()
    _launch("dequant_mean_rows", form, q.device, lib.tb_dequant_mean_rows, q.data_ptr(),
            e.data_ptr(), parties, nfloats, block, int(int4), int(mean), int(form == "vector"),
            out.data_ptr())
    return out
