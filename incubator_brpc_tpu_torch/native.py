"""ctypes bindings for the port's native host runtime (``csrc/host``).

The host runtime is C++: blocks, refcounts, vectored fd IO, regions, the
versioned-id resource pool, the containers, and tbnet (the epoll reactors,
the tbus_std cut, the method dispatcher and the native client). Its
sources under ``csrc/host/`` are the port's own copies of the JAX
package's ``src/tbutil`` and ``src/tbnet``; Python holds opaque handles.

The library is built at first use with ``g++`` (the JAX package's
``src/Makefile`` flags) into ``incubator_brpc_tpu_torch/_build/
libtbtorch_host-<digest>.so``, the digest taken over the sources and the
flags, under a file lock and through a temporary file moved into place, so
concurrent processes build it once. First use is this module's import, as
in the JAX package: the host plane picks its IOBuf class, socket registry
and method map when it is imported. ``NATIVE_AVAILABLE`` says whether it
loaded; when it did not (no compiler), ``BUILD_ERROR`` holds the
compiler's log, the package still imports, and ``iobuf.py``,
``utils/crc32c.py`` and ``protocol/tbus_std.py`` run their plain Python
versions. To rebuild after editing ``csrc/host``, start a new process:
the digest changes and the next import builds the new library.
``TBTORCH_HOST_LIB`` loads another build of the same sources instead.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

_PKG_DIR = Path(__file__).resolve().parent
HOST_DIR = _PKG_DIR / "csrc" / "host"
SOURCES = (HOST_DIR / "tbutil" / "tbutil.cc", HOST_DIR / "tbnet" / "tbnet.cc")
HEADERS = (HOST_DIR / "tbutil" / "tbutil.h", HOST_DIR / "tbnet" / "tbnet.h")
BUILD_DIR = _PKG_DIR / "_build"
CXX = os.environ.get("CXX") or "g++"
# src/Makefile's CXXFLAGS, LDFLAGS and LIBS
CXXFLAGS = ("-O2", "-g", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")
LDFLAGS = ("-shared", "-pthread")
LIBS = ("-lz",)
# TBTORCH_HOST_LIB points the loader at another build of the same sources
# (the sanitizer harness, tools/fabriclint/san.py, sets it to its ASan or
# TSan build). An override is loaded as given and never built: a missing
# path leaves the library unloaded, with BUILD_ERROR saying so.
_LIB_OVERRIDE = os.environ.get("TBTORCH_HOST_LIB") or None

_lib = None
_lib_lock = threading.Lock()
# what the build in this process did: compiler, seconds, library path
BUILD_INFO: Dict[str, object] = {}
BUILD_ERROR: Optional[str] = None


class _Ref(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("length", ctypes.c_size_t)]


class TbusHdr(ctypes.Structure):
    """Mirror of tb_tbus_hdr (csrc/host/tbutil/tbutil.h)."""

    _fields_ = [
        ("body_len", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("cid_lo", ctypes.c_uint32),
        ("cid_hi", ctypes.c_uint32),
        ("meta_len", ctypes.c_uint32),
        ("crc", ctypes.c_uint32),
        ("error_code", ctypes.c_uint32),
    ]


class TelemetryRecord(ctypes.Structure):
    """Mirror of tb_telemetry_record (csrc/host/tbnet/tbnet.h): one completion
    record per natively-dispatched request, drained in batches."""

    _fields_ = [
        ("method_idx", ctypes.c_uint32),
        ("error_code", ctypes.c_uint32),
        ("start_ns", ctypes.c_uint64),
        ("latency_ns", ctypes.c_uint64),
        ("correlation_id", ctypes.c_uint64),
        ("request_size", ctypes.c_uint32),
        ("response_size", ctypes.c_uint32),
        ("sampled", ctypes.c_uint32),
        ("reactor_id", ctypes.c_uint32),
        # wire-propagated trace context (0 = the request carried none):
        # the drain parents the server span into the caller's trace
        ("trace_id", ctypes.c_uint64),
        ("span_id", ctypes.c_uint64),
    ]


RELEASE_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p)

# tbnet callbacks (csrc/host/tbnet/tbnet.h): the per-frame Python route and the
# protocol-sniff connection handoff
FRAME_FN = ctypes.CFUNCTYPE(
    None,
    ctypes.c_void_p,  # ctx
    ctypes.c_uint64,  # conn token
    ctypes.c_uint32,  # cid_lo
    ctypes.c_uint32,  # cid_hi
    ctypes.c_uint32,  # flags
    ctypes.c_uint32,  # error_code
    ctypes.c_void_p,  # meta ptr
    ctypes.c_size_t,  # meta len
    ctypes.c_void_p,  # body tb_iobuf* (ownership transfers)
)
HANDOFF_FN = ctypes.CFUNCTYPE(
    None,
    ctypes.c_void_p,  # ctx
    ctypes.c_int,  # fd (ownership transfers)
    ctypes.c_void_p,  # buffered bytes
    ctypes.c_size_t,  # buffered len
)
CLOSED_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_uint64)
# credential verifier (tb_server_set_auth): int (*)(void* ud,
# const char* auth_data, size_t auth_len, const char* peer_ip, int port)
# — auth_data is a raw pointer (may contain NULs), hence c_void_p + len
AUTH_FN = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.c_void_p,  # ud
    ctypes.c_void_p,  # auth data ptr
    ctypes.c_size_t,  # auth data len
    ctypes.c_char_p,  # peer ip (NUL-terminated textual)
    ctypes.c_int,  # peer port
)


# The declared C ABI: name -> (restype, argtypes), one entry per
# extern "C" function in csrc/host/tbutil/tbutil.h and csrc/host/tbnet/tbnet.h
# (the JAX package's table, entry for entry: the sources are its copies).
b = ctypes.c_void_p  # shorthand: any opaque native handle
SIGNATURES = {
    "tb_set_block_size": (None, [ctypes.c_size_t]),
    "tb_block_size": (ctypes.c_size_t, []),
    "tb_block_pool_stats": (
        None,
        [ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t)],
    ),
    "tb_iobuf_read_burst": (ctypes.c_size_t, []),
    "tb_iobuf_create": (b, []),
    "tb_iobuf_handle_pool_stats": (
        None,
        [ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t)],
    ),
    "tb_iobuf_destroy": (None, [b]),
    "tb_iobuf_clear": (None, [b]),
    "tb_iobuf_size": (ctypes.c_size_t, [b]),
    "tb_iobuf_block_count": (ctypes.c_size_t, [b]),
    "tb_iobuf_append": (None, [b, ctypes.c_char_p, ctypes.c_size_t]),
    "tb_iobuf_append_external": (
        None,
        [b, ctypes.c_void_p, ctypes.c_size_t, RELEASE_FN, ctypes.c_void_p],
    ),
    "tb_iobuf_append_iobuf": (None, [b, b]),
    "tb_iobuf_cutn": (ctypes.c_size_t, [b, b, ctypes.c_size_t]),
    "tb_iobuf_popn": (ctypes.c_size_t, [b, ctypes.c_size_t]),
    "tb_iobuf_copy_to": (
        ctypes.c_size_t,
        [b, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t],
    ),
    "tb_iobuf_refs": (ctypes.c_int, [b, ctypes.POINTER(_Ref), ctypes.c_int]),
    "tb_iobuf_block_shared_count": (ctypes.c_int, [b, ctypes.c_size_t]),
    "tb_iobuf_cut_into_fd": (
        ctypes.c_long,
        [b, ctypes.c_int, ctypes.c_size_t],
    ),
    "tb_iobuf_append_from_fd": (
        ctypes.c_long,
        [b, ctypes.c_int, ctypes.c_size_t],
    ),
    "tb_iobuf_append_from_fd_bulk": (
        ctypes.c_long,
        [b, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t],
    ),
    "tb_region_register": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t],
    ),
    "tb_iobuf_append_from_region": (
        ctypes.c_int,
        [b, ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t],
    ),
    "tb_region_free_blocks": (ctypes.c_size_t, [ctypes.c_int]),
    "tb_crc32": (
        ctypes.c_uint32,
        [ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t],
    ),
    "tb_crc32c": (
        ctypes.c_uint32,
        [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t],
    ),
    "tb_iobuf_crc32c": (
        ctypes.c_uint32,
        [b, ctypes.c_uint32, ctypes.c_size_t, ctypes.c_size_t],
    ),
    "tb_tbus_peek": (ctypes.c_int, [b, ctypes.POINTER(TbusHdr)]),
    "tb_tbus_cut": (
        ctypes.c_int,
        [b, ctypes.POINTER(TbusHdr), ctypes.c_void_p, b],
    ),
    "tb_tbus_pack": (
        None,
        [
            b,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.c_int,
        ],
    ),
    "tb_fast_rand": (ctypes.c_uint64, []),
    "tb_fast_rand_less_than": (ctypes.c_uint64, [ctypes.c_uint64]),
    "tb_monotonic_ns": (ctypes.c_uint64, []),
    "tb_respool_create": (b, [ctypes.c_size_t]),
    "tb_respool_destroy": (None, [b]),
    "tb_respool_get": (b, [b, ctypes.POINTER(ctypes.c_uint64)]),
    "tb_respool_address": (b, [b, ctypes.c_uint64]),
    "tb_respool_return": (ctypes.c_int, [b, ctypes.c_uint64]),
    "tb_respool_live": (ctypes.c_size_t, [b]),
    "tb_objpool_create": (b, [ctypes.c_size_t]),
    "tb_objpool_destroy": (None, [b]),
    "tb_objpool_get": (b, [b]),
    "tb_objpool_return": (None, [b, ctypes.c_void_p]),
    "tb_objpool_live": (ctypes.c_size_t, [b]),
    "tb_objpool_free_count": (ctypes.c_size_t, [b]),
    "tb_flatmap_create": (b, [ctypes.c_size_t]),
    "tb_flatmap_destroy": (None, [b]),
    "tb_flatmap_insert": (
        ctypes.c_int,
        [b, ctypes.c_uint64, ctypes.c_uint64],
    ),
    "tb_flatmap_get": (
        ctypes.c_int,
        [b, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)],
    ),
    "tb_flatmap_erase": (ctypes.c_int, [b, ctypes.c_uint64]),
    "tb_flatmap_size": (ctypes.c_size_t, [b]),
    "tb_flatmap_capacity": (ctypes.c_size_t, [b]),
    "tb_cimap_create": (b, [ctypes.c_size_t]),
    "tb_cimap_destroy": (None, [b]),
    "tb_cimap_set": (
        ctypes.c_int,
        [b, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
         ctypes.c_size_t],
    ),
    "tb_cimap_get": (
        ctypes.c_long,
        [b, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
         ctypes.c_size_t],
    ),
    "tb_cimap_erase": (ctypes.c_int, [b, ctypes.c_char_p, ctypes.c_size_t]),
    "tb_cimap_size": (ctypes.c_size_t, [b]),
    "tb_cimap_key_at": (
        ctypes.c_long,
        [b, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t],
    ),
    "tb_mru_create": (b, [ctypes.c_size_t]),
    "tb_mru_destroy": (None, [b]),
    "tb_mru_put": (ctypes.c_int, [b, ctypes.c_uint64, ctypes.c_uint64]),
    "tb_mru_get": (
        ctypes.c_int,
        [b, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)],
    ),
    "tb_mru_size": (ctypes.c_size_t, [b]),
    # ---- tbnet (csrc/host/tbnet): native network plane ----
    "tb_server_create": (b, [ctypes.c_int]),
    "tb_server_num_reactors": (ctypes.c_int, [b]),
    # work-stealing dispatch pool (per-reactor Chase–Lev deques; worker
    # threads steal) + the per-method long-running deferral flag
    "tb_server_set_dispatch_pool": (ctypes.c_int, [b, ctypes.c_int]),
    "tb_server_set_native_long_running": (
        ctypes.c_int,
        [b, ctypes.c_char_p, ctypes.c_int],
    ),
    "tb_server_set_frame_cb": (None, [b, FRAME_FN, ctypes.c_void_p]),
    "tb_server_set_handoff_cb": (None, [b, HANDOFF_FN, ctypes.c_void_p]),
    "tb_server_set_closed_cb": (None, [b, CLOSED_FN, ctypes.c_void_p]),
    "tb_server_set_max_body": (None, [b, ctypes.c_size_t]),
    # production-shaped traffic knobs: response-compression floor,
    # decompress-bomb ceiling, and the auth seam (verifier callback or
    # constant-time token table; rejects answered ERPCAUTH natively)
    "tb_server_set_compress_min_bytes": (None, [b, ctypes.c_size_t]),
    "tb_server_set_max_decompress": (None, [b, ctypes.c_size_t]),
    "tb_server_set_auth": (ctypes.c_int, [b, AUTH_FN, ctypes.c_void_p]),
    "tb_server_set_auth_tokens": (
        ctypes.c_int,
        [b, ctypes.c_char_p, ctypes.c_size_t],
    ),
    "tb_server_auth_rejects": (ctypes.c_uint64, [b]),
    "tb_server_compress_stats": (
        None,
        [b] + [ctypes.POINTER(ctypes.c_uint64)] * 4,
    ),
    "tb_server_get_native_max_concurrency": (
        ctypes.c_long,
        [b, ctypes.c_char_p],
    ),
    "tb_server_set_native_max_concurrency": (
        ctypes.c_int,
        [b, ctypes.c_char_p, ctypes.c_uint32],
    ),
    "tb_server_register_native": (
        ctypes.c_int,
        [b, ctypes.c_char_p, ctypes.c_int, ctypes.c_uint32],
    ),
    # user C callback methods: int (*)(void* ud, const char* req,
    # size_t len, char** resp, size_t* resp_len) — the fn pointer is
    # passed as a raw void* (dlsym'd from a user .so, or a ctypes
    # CFUNCTYPE cast down)
    # fabriclint: allow(ffi-callback) fn arrives as a dlsym'd void* from a user .so by design; its layout contract is transport/native_plane.NATIVE_METHOD_FN, checked against the tb_native_fn typedef globally
    "tb_server_register_native_fn": (
        ctypes.c_int,
        [b, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_uint32],
    ),
    # completion-record telemetry ring (per-method latency / rpcz /
    # limiter feedback for natively-dispatched requests)
    "tb_server_set_telemetry": (
        None,
        [b, ctypes.c_uint32, ctypes.c_uint32],
    ),
    "tb_server_drain_telemetry": (
        ctypes.c_long,
        [b, ctypes.POINTER(TelemetryRecord), ctypes.c_size_t],
    ),
    # one reactor's ring only (the per-ring batched drain's shape)
    "tb_server_drain_telemetry_ring": (
        ctypes.c_long,
        [b, ctypes.c_int, ctypes.POINTER(TelemetryRecord), ctypes.c_size_t],
    ),
    "tb_server_telemetry_dropped": (ctypes.c_uint64, [b]),
    # per-reactor live_conns / native_reqs / ring drops
    "tb_server_reactor_stats": (
        ctypes.c_int,
        [b, ctypes.c_int] + [ctypes.POINTER(ctypes.c_uint64)] * 3,
    ),
    "tb_server_listen": (ctypes.c_int, [b, ctypes.c_char_p, ctypes.c_int]),
    "tb_server_port": (ctypes.c_int, [b]),
    "tb_server_stop": (None, [b]),
    "tb_server_destroy": (None, [b]),
    "tb_server_stats": (
        None,
        [b] + [ctypes.POINTER(ctypes.c_uint64)] * 5,
    ),
    "tb_server_deadline_sheds": (ctypes.c_uint64, [b]),
    # lame-duck: stop accepting while live connections drain
    "tb_server_pause_accept": (None, [b]),
    # idle reap for native ports (returns connections culled)
    "tb_server_close_idle": (ctypes.c_long, [b, ctypes.c_uint64]),
    "tb_conn_respond": (
        ctypes.c_int,
        [
            ctypes.c_uint64,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.c_uint32,
        ],
    ),
    "tb_conn_write": (ctypes.c_int, [ctypes.c_uint64, b]),
    "tb_conn_peer": (
        ctypes.c_int,
        [ctypes.c_uint64, ctypes.c_char_p, ctypes.c_size_t],
    ),
    "tb_conn_close": (ctypes.c_int, [ctypes.c_uint64]),
    # cache a Python-route auth verdict on the C++ conn (fast-path reuse)
    "tb_conn_set_authenticated": (ctypes.c_int, [ctypes.c_uint64]),
    "tb_channel_connect": (
        b,
        [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
         ctypes.POINTER(ctypes.c_int)],
    ),
    # wire protocol: 0 = tbus_std (default), 1 = baidu_std (PRPC);
    # must be set before the first send
    "tb_channel_set_protocol": (ctypes.c_int, [b, ctypes.c_int]),
    # channel-default request compress_type (RpcMeta field 3; caller
    # compresses payloads) and the first-request credential (field 7)
    "tb_channel_set_compress": (ctypes.c_int, [b, ctypes.c_int]),
    "tb_channel_set_auth": (
        ctypes.c_int,
        [b, ctypes.c_void_p, ctypes.c_size_t],
    ),
    # counter-scheduled client fault injection (fail/close/delay every
    # Nth call; the native analog of the Socket.write seam)
    "tb_channel_set_fault": (
        ctypes.c_int,
        [b] + [ctypes.c_uint32] * 5,
    ),
    # ambient trace context for the pipelined pump: every Nth frame
    # carries the Dapper fields (counter-scheduled, exact-rate like the
    # fault seam), span_id incremented per traced frame
    "tb_channel_set_trace": (
        ctypes.c_int,
        [b] + [ctypes.c_uint64] * 4 + [ctypes.c_int, ctypes.c_uint32],
    ),
    "tb_channel_call": (
        ctypes.c_long,
        [
            b,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_uint32,
            b,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int,
        ],
    ),
    "tb_channel_send": (
        ctypes.c_uint64,
        [
            b,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_int),
        ],
    ),
    "tb_channel_recv": (
        ctypes.c_long,
        [
            b,
            ctypes.POINTER(ctypes.c_uint64),
            b,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int,
        ],
    ),
    "tb_channel_error": (ctypes.c_int, [b]),
    # client reactor shard pinned at connect + wrong-shard cid counter
    "tb_channel_reactor": (ctypes.c_int, [b]),
    "tb_channel_cid_misroutes": (ctypes.c_uint64, [b]),
    "tb_channel_destroy": (None, [b]),
    "tb_channel_pump": (
        ctypes.c_long,
        [
            b,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ],
    ),
    # ---- codec table (protocol/compress.py prefers these over its
    # pure-Python twins so both planes run the identical codec) ----
    "tb_codec_compress": (
        ctypes.c_long,
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t, b],
    ),
    "tb_codec_decompress": (
        ctypes.c_long,
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t, b],
    ),
    # ---- RpcMeta scanner (differential-testing surface): the server cut
    # path's proto2 scanner over one meta blob (baidu_std, ROADMAP A11) ----
    "tb_scan_prpc_meta": (
        ctypes.c_long,
        [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
            # trace out-params (RpcRequestMeta 3/4/5/6 + field-9 sampled)
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32),
        ],
    ),
    # ---- work-stealing deque (Chase–Lev; the dispatch pool's queue) ----
    "tb_wsq_create": (b, [ctypes.c_size_t]),
    "tb_wsq_destroy": (None, [b]),
    "tb_wsq_push": (ctypes.c_int, [b, ctypes.c_uint64]),
    "tb_wsq_pop": (ctypes.c_int, [b, ctypes.POINTER(ctypes.c_uint64)]),
    "tb_wsq_steal": (ctypes.c_int, [b, ctypes.POINTER(ctypes.c_uint64)]),
    "tb_wsq_size": (ctypes.c_long, [b]),
}
del b


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def library_path() -> Path:
    """Where the library of these sources and flags lives."""
    digest = hashlib.sha256()
    for src in SOURCES + HEADERS:
        digest.update(src.read_bytes())
    digest.update(" ".join(CXXFLAGS + LDFLAGS + LIBS).encode())
    return BUILD_DIR / f"libtbtorch_host-{digest.hexdigest()[:16]}.so"


def compile_library(out: Path) -> Dict[str, object]:
    """Run g++ over ``csrc/host`` into ``out`` (through a temporary file
    moved into place). Returns the compiler's version line, the seconds
    the build took and its log; raises RuntimeError with the log when the
    compiler fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXXFLAGS, *LDFLAGS, "-o", str(tmp), *map(str, SOURCES), *LIBS]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"{' '.join(cmd)}\n{e}") from e
    seconds = time.perf_counter() - t0
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    (out.parent / "host_build.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{log[-6000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return {"compiler": compiler_version(), "seconds": seconds, "path": str(out), "log": log}


def compiler_version() -> str:
    try:
        return subprocess.run(
            [CXX, "--version"], capture_output=True, text=True, timeout=30
        ).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{CXX}: not found"


def zlib_header_found() -> bool:
    """Whether the compiler finds ``zlib.h`` (tbnet's gzip and zlib codecs
    and tbutil's crc32 need it)."""
    if shutil.which(CXX) is None:
        return False
    proc = subprocess.run(
        [CXX, "-E", "-x", "c++", "-"], input="#include <zlib.h>\n",
        capture_output=True, text=True, timeout=60,
    )
    return proc.returncode == 0


def _build() -> Path:
    """The library of these sources, compiled once across processes."""
    global BUILD_INFO
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "host_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building it
        if not so.exists():
            info = compile_library(so)
            info.pop("log")
            BUILD_INFO = info
    return so


def load():
    """Load (building on first use) and return the declared CDLL, or None
    with ``BUILD_ERROR`` saying why."""
    global _lib, BUILD_ERROR
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None and BUILD_ERROR is None:
            try:
                path = Path(_LIB_OVERRIDE) if _LIB_OVERRIDE else _build()
                _lib = _declare(ctypes.CDLL(str(path)))
                BUILD_INFO.setdefault("path", str(path))
            except (OSError, RuntimeError, AttributeError) as e:
                BUILD_ERROR = str(e)
        return _lib


def require():
    """The loaded library, or RuntimeError with the compiler's log."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"the port's host runtime did not build or load:\n{BUILD_ERROR}")
    return lib


LIB = load()
NATIVE_AVAILABLE = LIB is not None


def monotonic_ns() -> int:
    if LIB is not None:
        return LIB.tb_monotonic_ns()
    return time.monotonic_ns()


def fast_rand() -> int:
    if LIB is not None:
        return LIB.tb_fast_rand()
    import random

    return random.getrandbits(64)


def crc32(data: bytes, seed: int = 0) -> int:
    """CRC-32 (zlib's polynomial), zlib-style chaining through ``seed``."""
    if LIB is not None:
        return LIB.tb_crc32(seed, bytes(data), len(data))
    import zlib

    return zlib.crc32(data, seed) & 0xFFFFFFFF


def crc32c(data, seed: int = 0) -> int:
    """CRC32C (Castagnoli; SSE4.2 when the CPU has it). zlib-style
    chaining: pass the previous return value as ``seed``. Without the
    library, the table loop of ``utils/crc32c.py``."""
    if LIB is not None:
        return LIB.tb_crc32c(seed, bytes(data), len(data))
    from incubator_brpc_tpu_torch.utils.crc32c import crc32c_plain

    return crc32c_plain(data, seed)


class ResourcePool:
    """Versioned-id slab (csrc/host/tbutil ResourcePool; reference
    resource_pool.h:24-83). Ids stay stale-detectable forever."""

    def __init__(self, item_size: int = 8):
        if LIB is None:
            require()
        self._p = LIB.tb_respool_create(item_size)

    def get(self) -> int:
        out = ctypes.c_uint64()
        LIB.tb_respool_get(self._p, ctypes.byref(out))
        return out.value

    def address(self, rid: int):
        return LIB.tb_respool_address(self._p, rid)

    def return_(self, rid: int) -> bool:
        return LIB.tb_respool_return(self._p, rid) == 0

    @property
    def live(self) -> int:
        return LIB.tb_respool_live(self._p)

    def __del__(self):
        p, self._p = getattr(self, "_p", None), None
        if p and LIB is not None:
            LIB.tb_respool_destroy(p)


class ObjectPool:
    """Pointer-addressed fixed-size object slab (csrc/host/tbutil ObjectPool;
    reference object_pool.h). Memory never returns to the OS."""

    def __init__(self, item_size: int = 8):
        if LIB is None:
            require()
        self._p = LIB.tb_objpool_create(item_size)

    def get(self) -> int:
        return LIB.tb_objpool_get(self._p) or 0

    def return_(self, item: int) -> None:
        LIB.tb_objpool_return(self._p, item)

    @property
    def live(self) -> int:
        return LIB.tb_objpool_live(self._p)

    @property
    def free_count(self) -> int:
        return LIB.tb_objpool_free_count(self._p)

    def __del__(self):
        p, self._p = getattr(self, "_p", None), None
        if p and LIB is not None:
            LIB.tb_objpool_destroy(p)


class FlatMap:
    """Native open-addressing u64→u64 map (csrc/host/tbutil FlatMap; reference
    containers/flat_map.h) — the hot-path id table for native transports."""

    def __init__(self, initial_capacity: int = 16):
        if LIB is None:
            require()
        self._m = LIB.tb_flatmap_create(initial_capacity)
        if not self._m:
            raise MemoryError("tb_flatmap_create failed")

    def __setitem__(self, key: int, value: int) -> None:
        if LIB.tb_flatmap_insert(self._m, key, value) < 0:
            raise MemoryError("flatmap grow failed")

    def get(self, key: int, default=None):
        out = ctypes.c_uint64()
        if LIB.tb_flatmap_get(self._m, key, ctypes.byref(out)):
            return out.value
        return default

    def __getitem__(self, key: int) -> int:
        v = self.get(key)
        if v is None:
            raise KeyError(key)
        return v

    def __contains__(self, key: int) -> bool:
        return LIB.tb_flatmap_get(self._m, key, None) == 1

    def __delitem__(self, key: int) -> None:
        if not LIB.tb_flatmap_erase(self._m, key):
            raise KeyError(key)

    def __len__(self) -> int:
        return LIB.tb_flatmap_size(self._m)

    @property
    def capacity(self) -> int:
        return LIB.tb_flatmap_capacity(self._m)

    def __del__(self):
        m, self._m = getattr(self, "_m", None), None
        if m and LIB is not None:
            LIB.tb_flatmap_destroy(m)


class CaseIgnoredMap:
    """Native case-ignored string map (csrc/host/tbutil tb_cimap; reference
    CaseIgnoredFlatMap, containers/case_ignored_flat_map.h — the HTTP
    header table type). Keys compare case-insensitively; stored keys keep
    their original spelling."""

    def __init__(self, initial_capacity: int = 16):
        if LIB is None:
            require()
        self._m = LIB.tb_cimap_create(initial_capacity)
        if not self._m:
            raise MemoryError("tb_cimap_create failed")

    @staticmethod
    def _b(s) -> bytes:
        return s.encode("latin-1") if isinstance(s, str) else bytes(s)

    def __setitem__(self, key, value) -> None:
        k, v = self._b(key), self._b(value)
        if LIB.tb_cimap_set(self._m, k, len(k), v, len(v)) < 0:
            raise MemoryError("cimap set failed")

    def get(self, key, default=None):
        k = self._b(key)
        n = LIB.tb_cimap_get(self._m, k, len(k), None, 0)
        while True:
            if n < 0:
                return default
            if n == 0:
                return ""
            buf = ctypes.create_string_buffer(n)
            m = LIB.tb_cimap_get(self._m, k, len(k), buf, n)
            if m == n:
                return buf.raw.decode("latin-1")
            n = m  # value replaced between the probe and the copy: retry

    def __getitem__(self, key):
        v = self.get(key)
        if v is None:
            raise KeyError(key)
        return v

    def __contains__(self, key) -> bool:
        k = self._b(key)
        return LIB.tb_cimap_get(self._m, k, len(k), None, 0) >= 0

    def __delitem__(self, key) -> None:
        k = self._b(key)
        if not LIB.tb_cimap_erase(self._m, k, len(k)):
            raise KeyError(key)

    def __len__(self) -> int:
        return LIB.tb_cimap_size(self._m)

    def keys(self):
        out = []
        i = 0
        buf = ctypes.create_string_buffer(256)
        while True:
            n = LIB.tb_cimap_key_at(self._m, i, buf, 256)
            if n < 0:
                return out
            if n <= 256:
                out.append(buf.raw[:n].decode("latin-1"))
            else:  # key longer than the scratch: refetch until stable
                while True:
                    big = ctypes.create_string_buffer(n)
                    m = LIB.tb_cimap_key_at(self._m, i, big, n)
                    if m < 0:
                        break  # entry vanished mid-iteration
                    if m <= n:
                        out.append(big.raw[:m].decode("latin-1"))
                        break
                    n = m
            i += 1

    def __del__(self):
        m, self._m = getattr(self, "_m", None), None
        if m and LIB is not None:
            LIB.tb_cimap_destroy(m)


class MRUCache:
    """Native bounded u64→u64 MRU cache (csrc/host/tbutil tb_mru; reference
    MRUCache, containers/mru_cache.h): get/put freshen the entry, inserts
    past capacity evict the least-recently-used one."""

    def __init__(self, capacity: int):
        if LIB is None:
            require()
        self._m = LIB.tb_mru_create(capacity)
        if not self._m:
            raise MemoryError("tb_mru_create failed")

    def put(self, key: int, value: int) -> bool:
        """True when the key already existed (value replaced)."""
        return LIB.tb_mru_put(self._m, key, value) == 1

    def get(self, key: int, default=None):
        out = ctypes.c_uint64()
        if LIB.tb_mru_get(self._m, key, ctypes.byref(out)):
            return out.value
        return default

    def __contains__(self, key: int) -> bool:
        return LIB.tb_mru_get(self._m, key, None) == 1

    def __len__(self) -> int:
        return LIB.tb_mru_size(self._m)

    def __del__(self):
        m, self._m = getattr(self, "_m", None), None
        if m and LIB is not None:
            LIB.tb_mru_destroy(m)
