"""K1 — the kernels of the device echo path, and their plain versions.

Three wrappers over the hand-written CUDA kernels in ``csrc/framing.cu``:

- :func:`frame_rows` (K1a) replaces ``incubator_brpc_tpu/ops/framing.py``
  ``checksum_u32`` + ``frame`` as ``transport/device.py`` batches them under
  ``jax.vmap``: payload rows ``[B, W]`` -> framed rows ``[B, 8 + W]``.
- :func:`verify_rows` (K1b) replaces ``ops/framing.py`` ``parse``'s ``ok``:
  framed rows -> ``ok [B]`` (magic, length and checksum all hold).
- :func:`echo_step_rows` (K1c) replaces ``models/tensor_echo.py``
  ``TensorEchoService.step`` with the default table ``{0: echo}``: the fused
  parse / verify / dispatch / respond of a batch of request rows.

Each is bound by bytes (a streaming copy or read plus a mod-2^32 sum); the
source says how the design keeps every SM busy. Words are ``torch.uint32``
(``int32`` is taken as a bit view). A wrapper given CPU tensors runs the
plain PyTorch version beside it; given CUDA tensors it launches the kernel
on the current stream or raises. Nothing on the card's path calls a plain
version: the tests use them, ``chip_smoke.py`` holds each kernel against
its plain version on the card, and CPU execution runs them.

The kernels are built at first use: ``nvcc`` compiles each source of
``csrc/`` (``framing.cu`` here; ``attention.cu``, ``attention_tc.cu``,
``attention_tf32.cu``, ``attention_bwd_tc.cu`` and ``attention_bwd_tf32.cu``
for K3, whose wrappers are in ``ops/attention.py``, the last four sharing
``tc_mma.cuh``;
``quantize.cu`` for K2, whose wrappers are in ``ops/quantize.py``;
``elementwise.cu`` for K4, K4e-b/c/d and K4f, whose wrappers are in
``ops/elementwise.py``; and ``update.cu`` for K4e-a,
the SGD update, whose wrapper is in ``ops/update.py``; the last two share
``elementwise.cuh``) for ``sm_90a``, one process
per source, all started together, and links them into one shared library with a plain C
interface under ``incubator_brpc_tpu_torch/_build/``, loaded with
``ctypes``. Each wrapper adds one to its launch count
(:func:`launch_counts`) where it launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

HEADER_WORDS = 8
MAGIC = 0x54505243  # "TPRC"
FLAG_RESPONSE = 1
ENOMETHOD = 1002
EREQUEST = 1003

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG_DIR / "csrc" / f for f in (
    "framing.cu", "attention.cu", "attention_tc.cu", "attention_tf32.cu", "attention_bwd_tc.cu",
    "attention_bwd_tf32.cu", "quantize.cu", "elementwise.cu", "update.cu"))
# included by the tensor-core sources, and by elementwise.cu and update.cu
HEADERS = (_PKG_DIR / "csrc" / "tc_mma.cuh", _PKG_DIR / "csrc" / "elementwise.cuh")
BUILD_DIR = _PKG_DIR / "_build"
# no --use_fast_math, -ftz=true or -prec-div=false: K2 is bitwise (quantize.cu)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)
MAX_ROWS = 65535  # the kernels put rows on grid.y

KERNELS = (
    "frame_rows",
    "verify_rows",
    "echo_step_rows",
    "attn_fold_fwd_tf32",
    "attn_fold_fwd_tc",
    "attn_bwd_delta",
    "attn_bwd_dkdv_tf32",
    "attn_bwd_dkdv_tc",
    "attn_bwd_dq_tc",
    "attn_bwd_dq_tf32",
    "quantize_rows",
    "dequant_mean_rows",
    "add_rms_norm_fwd",
    "rms_norm_bwd",
    "gelu_tanh_fwd",
    "gelu_tanh_bwd",
    "sgd_update_multi",
    "moe_combine_fwd",
    "moe_combine_bwd",
    "mse_loss_fwd",
    "ring_mean_add_fwd",
    "ring_mean_add_bwd",
)

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_launches_lock = threading.Lock()


# -- launch counts ------------------------------------------------------------


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    with _launches_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launches_lock:
        for k in _launches:
            _launches[k] = 0


def _count(name: str) -> None:
    with _launches_lock:
        _launches[name] += 1


# -- build --------------------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # finds the toolkit

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES + HEADERS:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtbkernels-{digest.hexdigest()[:16]}.so"


def build_log() -> str:
    """What nvcc and ptxas said in the last build (registers, spills)."""
    log = BUILD_DIR / "build.log"
    return log.read_text() if log.exists() else ""


def _run_all(cmds) -> str:
    """Run the commands side by side; their output, or raise on a failure."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            (BUILD_DIR / "build.log").write_text(log)
            raise RuntimeError(f"nvcc failed ({p.returncode}): {c[-1]}\n{o[-4000:]}")
    return log


def _compile(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    log = _run_all(
        [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for o, src in zip(objs, SOURCES)]
    )
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    log += _run_all([[_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]])
    (BUILD_DIR / "build.log").write_text(log)
    for o in objs:
        o.unlink()
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing


def build() -> ctypes.CDLL:
    """Compile (once per source digest) and load the kernels' library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            so = _library_path()
            if not so.exists():
                _compile(so)
            lib = ctypes.CDLL(str(so))
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.tb_error_string.argtypes = [ctypes.c_int]
            lib.tb_error_string.restype = ctypes.c_char_p
            lib.tb_frame_rows.argtypes = [
                p, p, p, i64, i64, p, p, p, p, ctypes.c_uint32, p
            ]
            lib.tb_verify_rows.argtypes = [p, p, p, i64, i64, p]
            lib.tb_echo_step_rows.argtypes = [p, p, p, i64, i64, p]
            c_int = ctypes.c_int
            # K3's geometry: B, T, H, D (padded to D % 4 == 0), Dscale (the true D), sp
            lib.tb_attn_fold_fwd_tc.argtypes = lib.tb_attn_fold_fwd_tf32.argtypes = [
                p, p, p, p, p, p, p, p, i64, i64, i64, i64, i64, i64, i64, c_int, c_int, p
            ]
            # ..., lanes a row (0: the general form; ops/attention.py delta_form), stream
            lib.tb_attn_bwd_delta.argtypes = [p, p, c_int, p, i64, i64, i64, i64, c_int, p]
            lib.tb_attn_bwd_dkdv_tc.argtypes = lib.tb_attn_bwd_dkdv_tf32.argtypes = [
                p, p, p, p, p, p, p, p, i64, i64, i64, i64, i64, i64, c_int, p
            ]
            lib.tb_attn_bwd_dq_tc.argtypes = lib.tb_attn_bwd_dq_tf32.argtypes = [
                p, p, p, p, p, p, p, i64, i64, i64, i64, i64, i64, c_int, p
            ]
            # K2: ..., int4, (mean,) vector (the form ops/quantize.py chose), ...
            lib.tb_quantize_rows.argtypes = [p, i64, i64, i64, c_int, c_int, c_int, p, p, p]
            lib.tb_dequant_mean_rows.argtypes = [p, p, i64, i64, c_int, c_int, c_int, c_int, p, p]
            lib.tb_add_rms_norm_fwd.argtypes = [p, p, p, p, p, i64, i64, c_int, p]
            lib.tb_rms_norm_bwd.argtypes = [p, p, p, p, p, i64, i64, c_int, p]
            lib.tb_gelu_tanh_fwd.argtypes = [p, p, i64, c_int, p]
            lib.tb_gelu_tanh_bwd.argtypes = [p, p, p, i64, c_int, p]
            lib.tb_moe_combine_fwd.argtypes = [p, p, p, p, p, i64, i64, i64, c_int, p]
            lib.tb_moe_combine_bwd.argtypes = [p, p, p, p, p, i64, i64, i64, c_int, p]
            lib.tb_mse_loss_blocks.argtypes = [i64, c_int]
            lib.tb_mse_loss_blocks.restype = i64
            lib.tb_mse_loss_fwd.argtypes = [p, p, p, p, p, i64, ctypes.c_float, c_int, p]
            lib.tb_mse_loss_sum.argtypes = [p, i64, p, i64, c_int, p]
            lib.tb_ring_mean_add_fwd.argtypes = [p, p, p, i64, i64, i64, i64, c_int, p]
            lib.tb_ring_mean_add_bwd.argtypes = [p, p, i64, i64, i64, i64, c_int, p]
            # the leaves' pointers and sizes as host arrays, read before the launch
            lib.tb_sgd_update_multi.argtypes = [
                p, p, p, p, c_int, c_int, c_int, ctypes.c_float, ctypes.c_float, p
            ]
            for fn in (lib.tb_frame_rows, lib.tb_verify_rows, lib.tb_echo_step_rows,
                       lib.tb_attn_fold_fwd_tf32, lib.tb_attn_fold_fwd_tc, lib.tb_attn_bwd_delta,
                       lib.tb_attn_bwd_dkdv_tf32, lib.tb_attn_bwd_dkdv_tc,
                       lib.tb_attn_bwd_dq_tc, lib.tb_attn_bwd_dq_tf32, lib.tb_quantize_rows,
                       lib.tb_dequant_mean_rows, lib.tb_add_rms_norm_fwd, lib.tb_rms_norm_bwd,
                       lib.tb_gelu_tanh_fwd, lib.tb_gelu_tanh_bwd, lib.tb_moe_combine_fwd,
                       lib.tb_moe_combine_bwd, lib.tb_mse_loss_fwd, lib.tb_mse_loss_sum,
                       lib.tb_ring_mean_add_fwd, lib.tb_ring_mean_add_bwd,
                       lib.tb_sgd_update_multi):
                fn.restype = c_int
            _lib = lib
    return _lib


def _check_launch(lib: ctypes.CDLL, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name}: CUDA error {rc} ({lib.tb_error_string(rc).decode()})"
        )


# -- argument checks ----------------------------------------------------------


def _words(x: torch.Tensor, name: str, ndim: int) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"{name}: dtype {x.dtype}; want uint32 (or int32 as a bit view)")
    if x.dim() != ndim:
        raise ValueError(f"{name}: {x.dim()}-d; want {ndim}-d")
    return x


def _meta(x: Optional[torch.Tensor], name: str, rows: int, like: torch.Tensor):
    if x is None:
        return None
    _words(x, name, 1)
    if x.shape[0] != rows:
        raise ValueError(f"{name}: {x.shape[0]} entries for {rows} rows")
    if x.device != like.device:
        raise ValueError(f"{name} on {x.device}, rows on {like.device}")
    return x


def _cuda_args(*tensors: Optional[torch.Tensor]) -> None:
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# -- plain versions (int64 arithmetic; uint32 is a storage type) ---------------


def u64(x: torch.Tensor) -> torch.Tensor:
    """uint32 (or int32) bits -> int64 holding the unsigned value."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def bits32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 holding the same value mod 2^32 (exact, no overflow)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def checksum_rows_plain(payload: torch.Tensor) -> torch.Tensor:
    """(sum of each row mod 2^32) xor W, as int64 ``[B]``."""
    return (u64(payload).sum(dim=1) & 0xFFFFFFFF) ^ payload.shape[1]


def frame_rows_plain(payload, cid_lo, mid, *, cid_hi=None, err=None, flags=0):
    rows, words = payload.shape
    dev = payload.device
    zeros = torch.zeros(rows, dtype=torch.int64, device=dev)
    header = torch.stack(
        [
            torch.full((rows,), MAGIC, dtype=torch.int64, device=dev),
            torch.full((rows,), words & 0xFFFFFFFF, dtype=torch.int64, device=dev),
            torch.full((rows,), flags & 0xFFFFFFFF, dtype=torch.int64, device=dev),
            u64(cid_lo),
            zeros if cid_hi is None else u64(cid_hi),
            u64(mid),
            checksum_rows_plain(payload),
            zeros if err is None else u64(err),
        ],
        dim=1,
    )
    return torch.cat([bits32(header), payload.view(torch.int32)], dim=1).view(
        torch.uint32
    )


def verify_rows_plain(framed: torch.Tensor) -> torch.Tensor:
    words = framed.shape[1] - HEADER_WORDS
    h = u64(framed[:, :HEADER_WORDS])
    return (
        (h[:, 0] == MAGIC)
        & (h[:, 1] == (words & 0xFFFFFFFF))
        & (h[:, 6] == checksum_rows_plain(framed[:, HEADER_WORDS:]))
    )


def echo_step_rows_plain(framed: torch.Tensor) -> torch.Tensor:
    ok = verify_rows_plain(framed)
    known = u64(framed[:, 5]) == 0
    good = ok & known
    payload = torch.where(good[:, None], framed[:, HEADER_WORDS:].view(torch.int32), 0)
    err = torch.where(ok, torch.where(known, 0, ENOMETHOD), EREQUEST)
    return frame_rows_plain(
        payload.view(torch.uint32),
        framed[:, 3],
        framed[:, 5],
        cid_hi=framed[:, 4],
        err=bits32(err.to(torch.int64)),
        flags=FLAG_RESPONSE,
    )


# -- wrappers -----------------------------------------------------------------


def frame_rows(
    payload: torch.Tensor,
    cid_lo: torch.Tensor,
    mid: torch.Tensor,
    *,
    cid_hi: Optional[torch.Tensor] = None,
    err: Optional[torch.Tensor] = None,
    flags: int = 0,
) -> torch.Tensor:
    """K1a. payload ``[B, W]`` -> framed ``[B, 8 + W]`` uint32; per-row
    ``cid_lo``/``mid`` (and optional ``cid_hi``/``err``, zeros when None)
    are ``[B]``; ``flags`` is one value for every row."""
    _words(payload, "payload", 2)
    rows, words = payload.shape
    cid_lo = _meta(cid_lo, "cid_lo", rows, payload)
    mid = _meta(mid, "mid", rows, payload)
    cid_hi = _meta(cid_hi, "cid_hi", rows, payload)
    err = _meta(err, "err", rows, payload)
    if payload.device.type == "cpu":
        return frame_rows_plain(payload, cid_lo, mid, cid_hi=cid_hi, err=err, flags=flags)
    _cuda_args(payload, cid_lo, mid, cid_hi, err)
    if rows > MAX_ROWS or words + HEADER_WORDS > 0xFFFFFFFF:
        raise ValueError(f"frame_rows: [{rows}, {words}] exceeds the kernel's range")
    out = torch.empty((rows, words + HEADER_WORDS), dtype=torch.uint32, device=payload.device)
    if rows == 0:
        return out
    sums = torch.empty(rows, dtype=torch.int32, device=payload.device)
    lib = build()
    with torch.cuda.device(payload.device):
        rc = lib.tb_frame_rows(
            _ptr(payload), _ptr(out), _ptr(sums), rows, words,
            _ptr(cid_lo), _ptr(cid_hi), _ptr(mid), _ptr(err),
            flags & 0xFFFFFFFF, _stream(payload.device),
        )
    _check_launch(lib, rc, "frame_rows")
    _count("frame_rows")
    return out


def verify_rows(framed: torch.Tensor) -> torch.Tensor:
    """K1b. framed ``[B, 8 + W]`` -> ``ok [B]`` bool."""
    _words(framed, "framed", 2)
    if framed.shape[1] < HEADER_WORDS:
        raise ValueError("framed rows are shorter than the header")
    if framed.device.type == "cpu":
        return verify_rows_plain(framed)
    _cuda_args(framed)
    rows, width = framed.shape
    if rows > MAX_ROWS or width > 0xFFFFFFFF:
        raise ValueError(f"verify_rows: [{rows}, {width}] exceeds the kernel's range")
    ok = torch.empty(rows, dtype=torch.bool, device=framed.device)
    if rows == 0:
        return ok
    sums = torch.empty(rows, dtype=torch.int32, device=framed.device)
    lib = build()
    with torch.cuda.device(framed.device):
        rc = lib.tb_verify_rows(
            _ptr(framed), _ptr(ok), _ptr(sums), rows, width - HEADER_WORDS,
            _stream(framed.device),
        )
    _check_launch(lib, rc, "verify_rows")
    _count("verify_rows")
    return ok


def echo_step_rows(framed: torch.Tensor) -> torch.Tensor:
    """K1c. request rows ``[B, 8 + W]`` -> response rows, same shape."""
    _words(framed, "framed", 2)
    if framed.shape[1] < HEADER_WORDS:
        raise ValueError("framed rows are shorter than the header")
    if framed.device.type == "cpu":
        return echo_step_rows_plain(framed)
    _cuda_args(framed)
    rows, width = framed.shape
    if rows > MAX_ROWS or width > 0xFFFFFFFF:
        raise ValueError(f"echo_step_rows: [{rows}, {width}] exceeds the kernel's range")
    out = torch.empty((rows, width), dtype=torch.uint32, device=framed.device)
    if rows == 0:
        return out
    sums = torch.empty(rows, dtype=torch.int32, device=framed.device)
    lib = build()
    with torch.cuda.device(framed.device):
        rc = lib.tb_echo_step_rows(
            _ptr(framed), _ptr(out), _ptr(sums), rows, width - HEADER_WORDS,
            _stream(framed.device),
        )
    _check_launch(lib, rc, "echo_step_rows")
    _count("echo_step_rows")
    return out

