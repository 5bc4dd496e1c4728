"""Native network plane — the Python face of the port's ``csrc/host/tbnet``.

tbnet is the native epoll reactor + tbus_std and baidu_std messenger +
method dispatcher, and this module is the seam between it and the port's
Python RPC layer:

- ``NativeServerPlane`` replaces the Python Acceptor/EventDispatcher for a
  Server (``ServerOptions(native_plane=True)``): tbus_std AND baidu_std
  (PRPC) frames are cut, verified and, for natively registered methods
  (``native_echo``, ``native_nop``, and user C functions through
  ``native_method_lib``), ANSWERED on a reactor thread without the
  interpreter, in the protocol they arrived in (baidu_std's compressed
  bodies through the C++ codec table); every other frame surfaces here as
  one callback (flag 0x100 marks a PRPC meta) and runs through the same
  ``Server.process_request`` as the Python plane over a ``NativeConnSock``
  facade, answered in its own protocol (so a
  ``DeviceEndpoint.server_handler()`` serves the card behind the C++
  reactor). Connections that open with another protocol (HTTP) are handed
  off wholesale to a real Python ``Socket`` (one port, the reference's
  protocol scan, input_messenger.cpp:60-129).
- Reactors: ``num_reactors`` epoll loops, each with its own listener
  (SO_REUSEPORT), telemetry ring and cut/pack buffers; connections shard
  round-robin at accept. ``native_dispatch_workers`` adds a work-stealing
  pool (per-reactor Chase-Lev deques) that long-running native methods
  (``native_long_running``) defer to.
- ``NativeClientChannel`` is the client fast path: pack/write/read/match
  in C++ with the GIL released; concurrent callers share one connection and
  elect a completion-pump reader; ``pump`` runs a pipelined load in C++.
- The telemetry ring: every natively dispatched request appends a
  completion record to a lock-free ring in C++; the drain here (a
  background thread, and a forced drain at stop) feeds per-method
  ``LatencyRecorder``s and, where an adaptive limiter listens, the
  server's limiters (``Server._on_native_completion``).
- Limits: each native method carries its per-method limit into the C++
  table (``tb_server_register_native``); an adaptive limit, the method's
  own or the server-wide one distributed per method, is pushed there as
  it moves (``set_native_max_concurrency``), and the C++ dispatch answers
  ELIMIT past it. A constant server-wide limit keeps every method on the
  Python route, where it runs.
- Auth: a token-table authenticator (``TokenAuthenticator.native_tokens``)
  is loaded into the C++ plane's constant-time table
  (``tb_server_set_auth_tokens``); any other authenticator verifies
  through a callback, once a connection. baidu_std's authentication_data
  is checked in C and a wrong one answered ERPCAUTH there; the verdict is
  cached on the connection, and a connection still unproven (a tbus_std
  credential rides the JSON meta the cutter does not read) goes to the
  Python route's ``server_check``, which pushes its verdict down.
- ``install_native_client_fault`` arms the native client's counter
  schedule (every Nth call fails, closes or waits, in C++) on every
  ``NativeClientChannel`` made while the ``fault_injection`` flag is on.

- Telemetry: every natively dispatched request leaves a 64-byte record in
  a per-reactor ring; the drain (a background thread, every scrape of
  ``/brpc_metrics`` and ``/vars``, and ``stop``) folds the records into
  per-method latency summaries, the limiters' feedback and the rpcz server
  spans of the records whose sample bit is set (every
  ``native_telemetry_sample_every``-th one, or the wire's sampled bit),
  parented into the caller's trace.

The port's copy of the JAX package's ``transport/native_plane.py``. A handle of this package's library (an
IOBuf, a connection token) never crosses to another package's runtime:
only bytes on the wire do.
"""

from __future__ import annotations

import ctypes
import errno as _errno
import logging
import os
import socket as _pysocket
import struct
import threading
import time
import weakref
from typing import Dict, Optional

from incubator_brpc_tpu_torch import native
from incubator_brpc_tpu_torch.builtin import prometheus
from incubator_brpc_tpu_torch.builtin import rpcz as rpcz_mod
from incubator_brpc_tpu_torch.bvar import Adder, IntRecorder, LatencyRecorder, PassiveStatus
from incubator_brpc_tpu_torch.native import AUTH_FN, CLOSED_FN, FRAME_FN, HANDOFF_FN, LIB
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint
from incubator_brpc_tpu_torch.utils.flags import get_flag
from incubator_brpc_tpu_torch.utils.status import ErrorCode

logger = logging.getLogger(__name__)

NET_AVAILABLE = native.NATIVE_AVAILABLE

KIND_ECHO = 1
KIND_NOP = 2

# internal callback-only flags from tbnet.cc: the frame arrived on a
# baidu_std (PRPC) connection; the connection's credential was verified
_FLAG_WIRE_PRPC = 0x100
_FLAG_CONN_AUTHED = 0x200

# tb_channel_set_protocol values (tbnet.h)
_CH_PROTO = {"tbus_std": 0, "baidu_std": 1}

# tb_telemetry_record ABI size (static_assert in csrc/host/tbnet/tbnet.cc)
_TELEMETRY_RECORD_BYTES = 64

# sampled-word bit layout (tbnet.cc kTeleSampleBit/kTeleCodecShift/
# kTeleWireForced): bit 0 = rpcz sample election, bits 1-2 = request
# codec id, bit 3 = the sampled bit arrived ON THE WIRE (head-based
# coherent sampling — the edge's decision, which already forced bit 0)
_TEL_SAMPLE_BIT = 1
_TEL_CODEC_SHIFT = 1
_TEL_WIRE_FORCED = 8

# wire CompressType <-> codec names the native plane implements (the
# baidu_std table restricted to what the C++ codec table speaks)
_NATIVE_COMPRESS_WIRE = {"snappy": 1, "gzip": 2, "zlib1": 3}
_NATIVE_COMPRESS_NAMES = {v: k for k, v in _NATIVE_COMPRESS_WIRE.items()}

# client fast-path instrumentation: per-call round trip (the Python
# boundary included), transport errors, and the pump's ns/request
native_client_calls = Adder(name="native_client_calls")
native_client_errors = Adder(name="native_client_errors")
native_client_call_us = LatencyRecorder(name="native_client_call_us")
native_pump_ns = IntRecorder(name="native_pump_ns")
# the same pipelined pump over the baidu_std (PRPC) wire
prpc_pump_ns = IntRecorder(name="prpc_pump_ns")

# process-wide compress/auth telemetry summed across every live native
# plane (a stopping plane folds its final counts into the retired
# tallies first, so neither gauge ever moves backwards)
_planes_tally_lock = threading.Lock()
_live_planes: "weakref.WeakSet" = weakref.WeakSet()
_retired_compress_saved = 0
_retired_auth_rejects = 0


def _sum_compress_saved() -> int:
    total = _retired_compress_saved
    for plane in list(_live_planes):
        st = plane.compress_stats()
        total += max(0, st["in_raw"] - st["in_wire"])
        total += max(0, st["out_raw"] - st["out_wire"])
    return total


def _sum_auth_rejects() -> int:
    total = _retired_auth_rejects
    for plane in list(_live_planes):
        total += plane.stats().get("auth_rejects", 0)
    return total


# bytes kept OFF the wire by native codecs: (decompressed request bytes -
# their wire bytes) + (raw response bytes - their wire bytes)
native_compress_bytes_saved = PassiveStatus(_sum_compress_saved, name="native_compress_bytes_saved")
# requests rejected ERPCAUTH by the native auth seam
native_auth_rejects = PassiveStatus(_sum_auth_rejects, name="native_auth_rejects")


def _native_kind(handler) -> Optional[int]:
    return getattr(handler, "_native_kind", None)


# The layout of tb_native_fn (csrc/host/tbnet/tbnet.h), which a user
# library's method must have: int (*)(void* ud, const char* req, size_t
# len, char** resp, size_t* n). The symbol crosses the FFI as a raw
# void*, so this mirror is what fabriclint holds the typedef against.
NATIVE_METHOD_FN = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.c_void_p,
    ctypes.c_char_p,
    ctypes.c_size_t,
    ctypes.POINTER(ctypes.c_char_p),
    ctypes.POINTER(ctypes.c_size_t),
)


def native_method_lib(lib_path: str, symbol: str, fallback) -> "object":
    """Tag ``fallback`` (the ordinary Python handler, used when the native
    plane is off) with a shared-library implementation of the same method:
    ``symbol`` in ``lib_path`` must be a ``tb_native_fn``
    (csrc/host/tbnet/tbnet.h). On the native plane, requests to this method
    are answered entirely on the C++ reactor thread. The two
    implementations must agree: the Python fallback is the method's
    portable semantics, the .so its native fast path."""
    try:
        fallback._native_lib = (lib_path, symbol)
        return fallback
    except AttributeError:  # bound methods can't carry attributes: wrap

        def handler(cntl, request, _fb=fallback):
            return _fb(cntl, request)

        handler._native_lib = (lib_path, symbol)
        return handler


def native_echo(cntl, request: bytes) -> bytes:
    """Echo handler the native plane runs without the interpreter; works
    identically as a plain Python handler when the plane is off."""
    cntl.response_attachment = cntl.request_attachment
    return request


native_echo._native_kind = KIND_ECHO


def native_nop(cntl, request: bytes) -> bytes:
    """No-op handler (empty response); native kind 2."""
    return b""


native_nop._native_kind = KIND_NOP


def native_long_running(handler):
    """Mark a native .so method (``native_method_lib``) long-running: with
    a dispatch pool (``ServerOptions.native_dispatch_workers``) its
    requests always defer to the work-stealing pool instead of running
    inline on the reactor thread. No-op without a pool, and for plain
    Python handlers (the Python route has its own worker pool)."""
    try:
        handler._native_long_running = True
        return handler
    except AttributeError:  # bound methods can't carry attributes: wrap

        def wrapped(cntl, request, _fb=handler):
            return _fb(cntl, request)

        wrapped._native_long_running = True
        return wrapped


def _resolve_num_reactors(nloops) -> int:
    """None = auto from the process affinity mask, capped so a 96-core
    host doesn't mint 96 loop threads for one port."""
    if nloops:
        return max(1, int(nloops))
    try:
        ncpu = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        ncpu = os.cpu_count() or 1
    return max(1, min(16, ncpu))


class NativeConnSock:
    """Socket facade over a tbnet connection token: enough surface for the
    Python request path (process_request, streams): write, context,
    remote, failure hooks. The real fd lives in C++."""

    def __init__(self, token: int, server):
        self.token = token
        self.context: Dict = {"server": server}
        self.on_failed = []
        self.on_revived = []
        self.error_code = 0
        self.error_text = ""
        self.state = 0  # transport/sock.CONNECTED
        self._state_lock = threading.Lock()  # set_failed vs _mark_closed race
        self.preferred_protocol = None
        ip = ctypes.create_string_buffer(64)
        port = LIB.tb_conn_peer(token, ip, 64)
        self.remote = EndPoint(ip=ip.value.decode(), port=port) if port >= 0 else None

    def write(self, data, on_error=None, timeout=None) -> int:
        from incubator_brpc_tpu_torch.iobuf import IOBuf

        if isinstance(data, (bytes, bytearray, memoryview)):
            buf = IOBuf()
            buf.append(bytes(data))
        else:
            buf = data
        if LIB.tb_conn_write(self.token, buf._h) != 0:
            if on_error is not None:
                try:
                    on_error(ErrorCode.EFAILEDSOCKET, "native conn gone")
                except Exception:
                    logger.exception("write on_error callback failed")
            return ErrorCode.EFAILEDSOCKET
        return 0

    def set_failed(self, code: int = ErrorCode.EFAILEDSOCKET, reason: str = "") -> bool:
        # fail IMMEDIATELY, like Socket.set_failed: writes after this
        # report failure and stream failure callbacks fire without waiting
        # for the C++ loop to observe the hang-up
        with self._state_lock:
            if self.state != 0:
                return False
            self.state = 1  # FAILED
            self.error_code = code
            self.error_text = reason
        # fabriclint: allow(ffi-unchecked) -1 means the token is already stale: the C++ connection died under us, the state set_failed is putting it in
        LIB.tb_conn_close(self.token)
        for cb in list(self.on_failed):
            try:
                cb(self)
            except Exception:
                logger.exception("on_failed callback raised")
        return True

    def mark_native_authenticated(self) -> None:
        """The Python route verified this connection's credential
        (rpc/auth.server_check): cache the verdict on the C++ conn so its
        later frames ride the native fast path without re-fighting auth."""
        # fabriclint: allow(ffi-unchecked) -1 means the token went stale (the connection died); there is no verdict to cache on a dead connection
        LIB.tb_conn_set_authenticated(self.token)

    def _mark_closed(self) -> None:
        """tbnet says the connection died: run failure hooks (streams)."""
        with self._state_lock:
            if self.state != 0:
                return
            self.state = 1  # FAILED
            if not self.error_code:
                self.error_code = ErrorCode.EEOF
                self.error_text = "native conn closed"
        for cb in list(self.on_failed):
            try:
                cb(self)
            except Exception:
                logger.exception("on_failed callback raised")

    def __repr__(self) -> str:
        return f"<NativeConnSock token={self.token:#x} remote={self.remote}>"


def _drain_pump(plane_ref, stop_event) -> None:
    """Background telemetry drain. Module-level with a weakref on purpose:
    the thread must not pin an abandoned plane against GC; it exits when
    the plane is collected or stop() sets the event."""
    while True:
        interval = max(0.005, float(get_flag("native_telemetry_drain_ms")) / 1e3)
        if stop_event.wait(interval):
            return
        plane = plane_ref()
        if plane is None:
            return
        try:
            plane.drain_telemetry()
        except Exception:
            logger.exception("native telemetry drain failed")
        del plane  # release between ticks: don't pin across the wait


class NativeServerPlane:
    def __init__(self, server, nloops: Optional[int] = None, dispatch_workers: int = 0):
        native.require()
        self._server = server
        # serializes native reads of the server handle against destroy
        self._stats_lock = threading.Lock()
        self.num_reactors = _resolve_num_reactors(nloops)
        self._srv = LIB.tb_server_create(self.num_reactors)
        LIB.tb_server_set_max_body(self._srv, int(get_flag("max_body_size")) + 64 * 1024)
        # shared with the Python route so the planes answer byte-identically
        LIB.tb_server_set_compress_min_bytes(self._srv, int(get_flag("native_compress_min_bytes")))
        LIB.tb_server_set_max_decompress(self._srv, int(get_flag("max_decompress_bytes")))
        self._dispatch_workers = max(0, int(dispatch_workers))
        if self._dispatch_workers:
            if LIB.tb_server_set_dispatch_pool(self._srv, self._dispatch_workers) != 0:
                logger.warning("dispatch pool rejected (listen already?)")
        # the telemetry ring must be armed before listen
        self._telemetry = bool(get_flag("native_telemetry"))
        if self._telemetry:
            LIB.tb_server_set_telemetry(
                self._srv,
                int(get_flag("native_telemetry_ring_size")),
                int(get_flag("native_telemetry_sample_every")),
            )
        self._tel_lock = threading.Lock()  # serializes drains (one consumer)
        self._tel_recorders: Dict[int, LatencyRecorder] = {}  # method idx ->
        self._tel_drained = 0
        self._tel_drained_per = [0] * self.num_reactors
        self._tel_batch = (native.TelemetryRecord * 4096)()
        self._drain_stop = threading.Event()
        self._drain_thread: Optional[threading.Thread] = None
        # the callbacks must outlive the C++ server: a collected one is a
        # segfault on a reactor thread
        self._frame_cb = FRAME_FN(self._on_frame)
        self._handoff_cb = HANDOFF_FN(self._on_handoff)
        self._closed_cb = CLOSED_FN(self._on_closed)
        LIB.tb_server_set_frame_cb(self._srv, self._frame_cb, None)
        LIB.tb_server_set_handoff_cb(self._srv, self._handoff_cb, None)
        LIB.tb_server_set_closed_cb(self._srv, self._closed_cb, None)
        self._socks: Dict[int, NativeConnSock] = {}
        self._socks_lock = threading.Lock()
        self._stats_snap = None  # (monotonic, stats dict) for the gauges
        self._handoff_socks: set = set()  # live handed-off Python Sockets
        self._user_libs: list = []  # dlopened user-method libraries
        self._native_names: list = []  # fulls registered for C++ dispatch
        # natively registered methods with no limit of their own: the
        # server-wide ADAPTIVE limit is distributed to them per method
        # (the C++ plane has no server-level gate)
        self._auto_targets: list = []
        self._m_stats: list = []
        self._stopped = False
        self.port = 0

    # -- registration ------------------------------------------------------

    def register_methods(self) -> None:
        """Register native-kind handlers (echo/nop) and user .so methods
        for pure-C++ dispatch, each with its per-method limit; everything
        else stays on the per-frame Python route. Gates the Python route
        enforces per request must not be skippable by a fast path: a
        CONSTANT server-wide limit has no native enforcement, so a server
        with one keeps ALL methods on the Python route. A server-wide
        "auto" limit IS enforceable natively, as a per-method ceiling pushed
        every time the adaptive limit moves
        (Server._on_server_limit_change). The Authenticator is enforceable
        natively too (``_configure_auth``), and a native reject answers
        ERPCAUTH byte-identically to the Python route."""
        from incubator_brpc_tpu_torch.rpc.concurrency_limiter import AutoConcurrencyLimiter

        # gate on the RESOLVED limiter, not the raw spec: "12" is a
        # constant limit too
        lim = self._server._server_limiter
        if lim is not None and not isinstance(lim, AutoConcurrencyLimiter):
            return
        auth = self._server.options.auth
        if auth is not None and not self._configure_auth(auth):
            # an auth seam the native plane cannot arrange must fail
            # CLOSED: no native registrations, every frame runs the Python
            # route's server_check
            return
        for full, prop in self._server.methods().items():
            kind = _native_kind(prop.handler)
            limit = prop.status.max_concurrency
            if kind is not None:
                if LIB.tb_server_register_native(self._srv, full.encode(), kind, limit) != 0:
                    # duplicate / key collision: the method stays on the
                    # Python route and must NOT claim a telemetry index
                    # (_native_names positions mirror the C++ table)
                    logger.warning(
                        "native registration of %s rejected; it stays on the Python route", full
                    )
                    continue
                self._native_names.append(full)
                if prop.status.limiter is None:
                    self._auto_targets.append(full)
                continue
            lib_spec = getattr(prop.handler, "_native_lib", None)
            if lib_spec is None:
                continue
            path, symbol = lib_spec
            try:
                dll = ctypes.CDLL(path)
                fn = ctypes.cast(getattr(dll, symbol), ctypes.c_void_p)
            except (OSError, AttributeError) as e:
                logger.warning(
                    "native method lib %s:%s unavailable (%s); %s stays on the Python route",
                    path, symbol, e, full,
                )
                continue
            if LIB.tb_server_register_native_fn(self._srv, full.encode(), fn, None, limit) != 0:
                logger.warning(
                    "native registration of %s rejected (duplicate or method-key "
                    "collision); it stays on the Python route", full,
                )
                continue
            self._user_libs.append(dll)  # keepalive
            self._native_names.append(full)
            if prop.status.limiter is None:
                self._auto_targets.append(full)
            if getattr(prop.handler, "_native_long_running", False):
                if LIB.tb_server_set_native_long_running(self._srv, full.encode(), 1) != 0:
                    logger.warning("long-running flag rejected for %s", full)

    def _configure_auth(self, auth) -> bool:
        """Arrange native auth verification for ``auth`` (pre-listen).
        Token-table authenticators (a ``native_tokens()`` hook returning
        the accepted credential strings) verify entirely in C —
        constant-time, no interpreter even on first frames. Anything else
        verifies through a ctypes trampoline: ONE GIL crossing per
        connection (the verdict caches on the conn), zero on the steady
        state. False = the plane could not arrange it."""
        tokens_hook = getattr(auth, "native_tokens", None)
        tokens = tokens_hook() if callable(tokens_hook) else None
        if tokens:
            blob = b"".join(
                struct.pack("<I", len(t)) + t
                for t in (x.encode() if isinstance(x, str) else bytes(x) for x in tokens)
            )
            return LIB.tb_server_set_auth_tokens(self._srv, blob, len(blob)) == 0

        def _verify(_ud, data_ptr, data_len, ip, port, _auth=auth):
            try:
                cred = (
                    ctypes.string_at(data_ptr, data_len) if data_ptr and data_len else b""
                ).decode(errors="replace")
                remote = EndPoint(ip=(ip or b"").decode(), port=int(port))
                return 0 if _auth.verify_credential(cred, remote) else 1
            except Exception:
                logger.exception("native auth verifier raised; rejecting")
                return 1

        # the CFUNCTYPE must outlive the C++ server
        self._auth_cb = AUTH_FN(_verify)
        return LIB.tb_server_set_auth(self._srv, self._auth_cb, None) == 0

    def native_method_names(self) -> list:
        """Methods dispatched on the C++ plane (registration order)."""
        return list(self._native_names)

    def set_native_max_concurrency(self, full_name: str, n: int) -> bool:
        """Runtime retune of a natively registered method's admission
        limit (False if the method is not native). Guarded against the
        stopped plane: a limiter update racing tb_server_destroy (a
        straggler completion after Server.stop) must not touch freed
        state."""
        with self._stats_lock:
            if self._srv is None:
                return False
            return LIB.tb_server_set_native_max_concurrency(self._srv, full_name.encode(), int(n)) == 0

    def auto_limit_targets(self) -> list:
        """Natively registered methods that follow the server-wide
        adaptive limit (no per-method limiter of their own)."""
        return list(self._auto_targets)

    def set_auto_limit_target(self, full_name: str, follow: bool) -> None:
        """Flip whether a native method follows the server-wide adaptive
        limit: a per-method limit set at runtime must STOP the server-wide
        pushes from clobbering it (and resume when cleared to unlimited)."""
        if full_name not in self._native_names:
            return
        if follow and full_name not in self._auto_targets:
            self._auto_targets.append(full_name)
        elif not follow and full_name in self._auto_targets:
            self._auto_targets.remove(full_name)

    def native_max_concurrency(self, full_name: str) -> int:
        """Current native-plane limit; -1 = not natively registered (or
        the plane already stopped)."""
        with self._stats_lock:
            if self._srv is None:
                return -1
            return int(LIB.tb_server_get_native_max_concurrency(self._srv, full_name.encode()))

    def listen(self, ip: str, port: int) -> int:
        rc = LIB.tb_server_listen(self._srv, ip.encode(), port)
        if rc < 0:
            raise OSError(-rc, "tb_server_listen failed")
        self.port = rc
        # the C++ plane's counters as port-scoped bvars, hidden at stop
        self._m_stats = [
            PassiveStatus(
                (lambda _k=k: self._stats_snapshot()[_k]),
                name=f"native_plane_{self.port}_{k}",
            )
            for k in ("accepted", "native_reqs", "cb_frames", "handoffs", "live_conns",
                      "deadline_sheds", "auth_rejects")
        ]
        # the process-wide native_compress_bytes_saved / native_auth_rejects
        # gauges sum across live planes
        _live_planes.add(self)
        for i in range(self.num_reactors):
            self._m_stats.extend(
                PassiveStatus(
                    (lambda _i=i, _k=k: self._reactor_snapshot(_i)[_k]),
                    name=f"native_reactor_{self.port}_{i}_{k}",
                )
                for k in ("conns", "reqs", "dropped")
            )
        if self._telemetry:
            self._m_stats.append(
                PassiveStatus(self.telemetry_dropped, name=f"native_plane_{self.port}_telemetry_dropped")
            )
            self._m_stats.append(
                PassiveStatus(lambda: self._tel_drained, name=f"native_plane_{self.port}_telemetry_drained")
            )
            # scrapes force a drain so /brpc_metrics and /vars see
            # completions recorded microseconds — not a drain interval —
            # ago. The hook and the pump hold only a WEAK reference: a
            # started-then-abandoned plane stays collectable, so the
            # __del__ -> stop() backstop can fire
            wr = weakref.ref(self)

            def _scrape_drain(_wr=wr):
                plane = _wr()
                if plane is not None:
                    plane.drain_telemetry()

            self._scrape_hook = _scrape_drain
            prometheus.register_scrape_hook(_scrape_drain)
            self._drain_thread = threading.Thread(
                target=_drain_pump,
                args=(wr, self._drain_stop),
                name=f"tbtorch-native-telemetry-{self.port}",
                daemon=True,
            )
            self._drain_thread.start()
        return rc

    # -- telemetry drain ---------------------------------------------------

    def telemetry_dropped(self) -> int:
        """Ring-overflow drop count, summed across every reactor's ring."""
        with self._stats_lock:
            if self._srv is None:
                return getattr(self, "_final_tel_dropped", 0)
            return int(LIB.tb_server_telemetry_dropped(self._srv))

    def reactor_stats(self, reactor: int) -> Dict[str, int]:
        """One reactor's live connections, natively dispatched request
        count, and telemetry-ring drops (zeros after stop or for an
        out-of-range index)."""
        with self._stats_lock:
            if self._srv is None:
                final = getattr(self, "_final_reactor_stats", None)
                if final is not None and 0 <= reactor < len(final):
                    return final[reactor]
                return {"conns": 0, "reqs": 0, "dropped": 0}
            vals = [ctypes.c_uint64() for _ in range(3)]
            rc = LIB.tb_server_reactor_stats(
                self._srv, int(reactor), *[ctypes.byref(v) for v in vals]
            )
            if rc != 0:
                return {"conns": 0, "reqs": 0, "dropped": 0}
            return {"conns": vals[0].value, "reqs": vals[1].value, "dropped": vals[2].value}

    # fabriclint: hotpath
    def drain_telemetry(self) -> int:
        """Pull every completed record off each reactor's C++ ring into the
        per-method latency summaries, one reactor's batch per numpy pass.
        Returns the record count. Serialized: the background pump and the
        stop-time flush never interleave batches."""
        if not self._telemetry:
            return 0
        total = 0
        # fabriclint: allow(hotpath-lock) one acquisition a drain call, not a record: the rings have one consumer, and the pump and the stop-time flush both drain
        with self._tel_lock:
            # batch cap: a drain races live producers and must not spin
            # forever against a sustained flood (~1M records per call)
            budget = 256
            # fabriclint: allow(hotpath-loop) iterates reactors (num_reactors, at most 16), never records; each ring's batches share the budget below
            for reactor in range(self.num_reactors):
                # fabriclint: allow(hotpath-loop) at most 256 batches a call (the shared budget); the per-record work is numpy in _consume_records
                while budget > 0:
                    budget -= 1
                    # fabriclint: allow(hotpath-lock) guards the native handle against tb_server_destroy; one acquisition a batch of up to 4096 records
                    with self._stats_lock:
                        if self._srv is None:
                            budget = 0
                            break
                        n = int(
                            LIB.tb_server_drain_telemetry_ring(
                                self._srv, reactor, self._tel_batch, len(self._tel_batch)
                            )
                        )
                    if n <= 0:
                        break
                    self._consume_records(self._tel_batch, n)
                    total += n
                    self._tel_drained_per[reactor] += n
                    # loop until an EMPTY return, not a short batch: the
                    # C++ drain discards clock-invalid records
                if budget <= 0:
                    break
            self._tel_drained += total
        return total

    _REC_DTYPE = None  # numpy structured dtype mirror of TelemetryRecord

    @classmethod
    def _rec_dtype(cls):
        if cls._REC_DTYPE is None:
            import numpy as np

            cls._REC_DTYPE = np.dtype(
                [
                    ("method_idx", "<u4"),
                    ("error_code", "<u4"),
                    ("start_ns", "<u8"),
                    ("latency_ns", "<u8"),
                    ("correlation_id", "<u8"),
                    ("request_size", "<u4"),
                    ("response_size", "<u4"),
                    ("sampled", "<u4"),
                    ("reactor_id", "<u4"),
                    ("trace_id", "<u8"),
                    ("span_id", "<u8"),
                ]
            )
            assert cls._REC_DTYPE.itemsize == _TELEMETRY_RECORD_BYTES, (
                "telemetry drain dtype drifted from the 64-byte record ABI"
            )
        return cls._REC_DTYPE

    # fabriclint: hotpath
    def _consume_records(self, batch, n: int) -> None:
        """Vectorized fan-out of one batch: per-method latency summaries
        (exact count/sum/max, a strided subsample for the percentiles),
        natively shed requests into ``deadline_shed_count``, where an
        adaptive limiter listens, one time-ordered feed of decimated
        completions into the server's limiters, and with rpcz on, a server
        span for every record whose sample bit is set."""
        import numpy as np

        from incubator_brpc_tpu_torch.rpc.concurrency_limiter import AutoConcurrencyLimiter

        arr = np.frombuffer(batch, dtype=self._rec_dtype(), count=n)
        names = self._native_names
        server = self._server
        server_auto = isinstance(server._server_limiter, AutoConcurrencyLimiter)
        interval = int(get_flag("auto_cl_sampling_interval_us"))
        methods = server.methods()
        feed = []  # (done_us, full, error_code, latency_us) across methods
        method_ids = arr["method_idx"]
        errors = arr["error_code"]
        lat_us = arr["latency_ns"] * 1e-3
        ok = errors == 0
        nshed = int((errors == ErrorCode.EDEADLINE).sum())
        if nshed:
            from incubator_brpc_tpu_torch.rpc.server import deadline_shed_count

            deadline_shed_count << nshed
        # fabriclint: allow(hotpath-loop) iterates the batch's distinct method indices, bounded by the native method table, never records
        for idx in np.unique(method_ids):
            if idx >= len(names):
                continue  # table drift (never expected): drop, don't crash
            full = names[idx]
            mask = method_ids == idx
            succ = mask & ok
            nsucc = int(succ.sum())
            if nsucc:
                recorder = self._tel_recorders.get(int(idx))
                if recorder is None:
                    recorder = LatencyRecorder()
                    base = "native_method_" + full.replace(".", "_") + "_latency_us"
                    # two planes in one process may serve one method name:
                    # fall back to a port-scoped name
                    if not recorder.expose(base):
                        recorder.expose(
                            f"native_method_{self.port}_" + full.replace(".", "_") + "_latency_us"
                        )
                    self._tel_recorders[int(idx)] = recorder
                vals = lat_us[succ]
                recorder.record_batch(
                    nsucc, float(vals.sum()), float(vals.max()), vals[:: -(-nsucc // 64)][:64].tolist()
                )
            # limiter feedback — only where an adaptive limiter listens,
            # decimated to its sampling interval so a 100 k-record drain
            # feeds the handful of samples the limiter would keep anyway.
            # ELIMIT refusals and deadline sheds are excluded, as on the
            # Python route: shed work never ran the method
            prop = methods.get(full)
            method_auto = prop is not None and isinstance(prop.status.limiter, AutoConcurrencyLimiter)
            if not (server_auto or method_auto):
                continue
            fb = mask & (errors != ErrorCode.ELIMIT) & (errors != ErrorCode.EDEADLINE)
            if not fb.any():
                continue
            done_us = (arr["start_ns"][fb] + arr["latency_ns"][fb]) // 1000
            fb_err = errors[fb]
            fb_lat = lat_us[fb]
            order = np.argsort(done_us, kind="stable")
            ts = done_us[order]
            picks = []
            i = 0
            step = max(1, interval)
            # fabriclint: allow(hotpath-loop) one searchsorted jump a limiter sample, at most 1024: O(picks log n), not O(records)
            while i < len(ts) and len(picks) < 1024:
                picks.append(order[i])
                i = int(np.searchsorted(ts, ts[i] + step, side="left"))
            # errors beyond the decimation still matter (all-fail
            # halving): force-feed a bounded number of them
            err_pos = np.flatnonzero(fb_err != 0)[:256]
            # fabriclint: allow(hotpath-loop) bounded by the decimated picks (1024) and the forced errors (256), not by the batch's size
            for j in {int(q) for q in picks} | {int(q) for q in err_pos}:
                feed.append((int(done_us[j]), full, int(fb_err[j]), float(fb_lat[j])))
        # ONE globally time-ordered feed across every method: on_responded
        # keeps only forward-moving timestamps, so per-method sequences fed
        # back to back would let the first method's newest sample mask
        # every other method's older ones from the SHARED server limiter
        feed.sort()
        # fabriclint: allow(hotpath-loop) the feed is the decimated limiter samples (at most 1280 a method), bounded above
        for done, full, err, lat in feed:
            server._on_native_completion(full, err, lat, now_us=done)
        if rpcz_mod.rpcz_enabled():
            self._submit_sampled_spans(arr, names)

    def _submit_sampled_spans(self, arr, names) -> None:
        """One rpcz server span for each record of the batch whose sample
        bit is set (bit 0: the local 1/N election or the wire's sampled
        bit), parented into the caller's trace the record carries."""
        import numpy as np

        sampled_idx = np.flatnonzero(arr["sampled"] & _TEL_SAMPLE_BIT)
        if not len(sampled_idx):
            return
        # wall/monotonic anchor: record timestamps are CLOCK_MONOTONIC ns,
        # spans carry wall-clock start_real_us
        wall_anchor_us = time.time() * 1e6
        mono_anchor_ns = native.monotonic_ns()
        # fabriclint: allow(hotpath-loop) iterates the records whose sample bit is set (1 in N, or forced by the wire), well below the batch's size
        for i in sampled_idx:
            rec = arr[int(i)]
            idx = int(rec["method_idx"])
            if idx >= len(names):
                continue
            sampled_word = int(rec["sampled"])
            forced = bool(sampled_word & _TEL_WIRE_FORCED)
            # the 1/N flag elects; the shared token bucket still bounds
            # spans/second (rpcz_samples_per_second) like every other
            # producer. Wire-FORCED records (the edge's head-based
            # decision) ride through a dry bucket, and the scan CONTINUES
            # past refused locally-elected records so a forced one later in
            # the batch still lands
            if not rpcz_mod._limiter.grab() and not forced:
                continue
            service, _, method = names[idx].partition(".")
            codec = (sampled_word >> _TEL_CODEC_SHIFT) & 3
            # the caller's span id becomes this span's parent; fresh ids
            # only when the wire carried none
            wire_trace = int(rec["trace_id"])
            rpcz_mod.span_store.submit(
                rpcz_mod.Span(
                    trace_id=wire_trace or rpcz_mod._new_id(),
                    span_id=rpcz_mod._new_id(),
                    parent_span_id=int(rec["span_id"]),
                    span_type=rpcz_mod.SPAN_TYPE_SERVER,
                    service=service,
                    method=method,
                    error_code=int(rec["error_code"]),
                    start_real_us=int(wall_anchor_us - (mono_anchor_ns - int(rec["start_ns"])) / 1e3),
                    latency_us=float(rec["latency_ns"]) / 1e3,
                    request_size=int(rec["request_size"]),
                    response_size=int(rec["response_size"]),
                    annotations=(
                        [(0.0, "compress=" + _NATIVE_COMPRESS_NAMES.get(codec, str(codec)))]
                        if codec
                        else []
                    ),
                )
            )

    def method_latency(self, full_name: str) -> Optional[LatencyRecorder]:
        """The drained latency summary of a natively dispatched method
        (None before its first drained completion)."""
        try:
            idx = self._native_names.index(full_name)
        except ValueError:
            return None
        return self._tel_recorders.get(idx)

    def _reactor_snapshot(self, reactor: int) -> Dict[str, int]:
        """reactor_stats memoized for ~50 ms: one scrape renders 3 gauges
        per reactor off ONE native read."""
        now = time.monotonic()
        cache = getattr(self, "_reactor_snaps", None)
        if cache is None:
            cache = self._reactor_snaps = {}
        snap = cache.get(reactor)
        if snap is None or now - snap[0] > 0.05:
            snap = (now, self.reactor_stats(reactor))
            cache[reactor] = snap
        return snap[1]

    def _stats_snapshot(self) -> Dict[str, int]:
        """stats() memoized for ~50 ms (one native read feeds every gauge)."""
        now = time.monotonic()
        snap = self._stats_snap
        if snap is None or now - snap[0] > 0.05:
            snap = (now, self.stats())
            self._stats_snap = snap
        return snap[1]

    # -- callbacks from loop threads --------------------------------------

    def _sock_for(self, token: int) -> NativeConnSock:
        with self._socks_lock:
            s = self._socks.get(token)
            if s is None:
                s = NativeConnSock(token, self._server)
                self._socks[token] = s
            return s

    # fabriclint: hotpath
    def _on_frame(self, _ctx, token, cid_lo, cid_hi, flags, error_code,
                  meta_ptr, meta_len, body_h) -> None:
        from incubator_brpc_tpu_torch.iobuf import IOBuf
        from incubator_brpc_tpu_torch.protocol.tbus_std import Meta, ParsedFrame

        try:
            body = IOBuf(_handle=body_h)  # take ownership
            meta_bytes = ctypes.string_at(meta_ptr, meta_len) if meta_len else b""
            is_prpc = bool(flags & _FLAG_WIRE_PRPC)
            if is_prpc:
                # a baidu_std frame off the C++ cut loop: the meta is
                # RpcMeta proto bytes, and the response leaves in PRPC
                # (_send_response keys off frame.wire_protocol)
                from incubator_brpc_tpu_torch.protocol.baidu_std import RpcMeta, rpc_meta_to_meta

                meta = rpc_meta_to_meta(RpcMeta.decode(meta_bytes))
            else:
                meta = Meta.from_bytes(meta_bytes)
            blen = len(body)
            att = meta.attachment_size
            if att > blen:
                # consumed and unrecoverable: kill the connection
                # fabriclint: allow(ffi-unchecked) the connection is being killed for a fatal parse; a stale token means it is already dead, and both outcomes are the goal
                LIB.tb_conn_close(token)
                return
            frame = ParsedFrame(
                meta=meta,
                payload=body.to_bytes(blen - att),
                attachment=body.to_bytes(att, pos=blen - att) if att else b"",
                correlation_id=cid_lo | (cid_hi << 32),
                flags=flags & ~(_FLAG_WIRE_PRPC | _FLAG_CONN_AUTHED),
                error_code=error_code,
            )
            # deadline-shed baseline for the worker-pool queue ahead
            frame.arrival_ts = time.monotonic()
            if is_prpc:
                frame.wire_protocol = "baidu_std"
            sock = self._sock_for(token)
            if flags & _FLAG_CONN_AUTHED:
                # the C++ plane already verified this connection's
                # credential: server_check honors the cached verdict
                sock.context["authenticated"] = True
            self._dispatch(sock, frame)
        except Exception:
            logger.exception("native frame dispatch failed")

    # fabriclint: hotpath
    def _dispatch(self, sock: NativeConnSock, frame) -> None:
        """Mirror of InputMessenger._process_one for pre-cut frames."""
        from incubator_brpc_tpu_torch import protocol as proto_pkg

        proto = proto_pkg.protocol_registry.get(frame.wire_protocol)
        if frame.is_stream and proto.process_stream is not None:
            proto.process_stream(sock, frame)  # in wire order, inline
            return
        if frame.is_response:
            if proto.process_response is not None:
                proto.process_response(sock, frame)
            return
        if self._server.options.usercode_inline:
            self._server.process_request(sock, frame)
        else:
            from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool

            global_worker_pool().spawn(self._server.process_request, sock, frame)

    def _on_handoff(self, _ctx, fd, buffered_ptr, buffered_len) -> None:
        """A connection speaking neither tbus_std nor baidu_std: wrap the fd
        in a real Python Socket so the Python protocol scan runs exactly as
        with the Python acceptor."""
        try:
            data = ctypes.string_at(buffered_ptr, buffered_len) if buffered_len else b""
            conn = _pysocket.socket(fileno=fd)
            try:
                peer = conn.getpeername()
            except OSError:
                peer = None
            from incubator_brpc_tpu_torch.transport.sock import Socket

            sock = Socket.from_accepted(
                conn,
                peer,
                messenger=self._server._messenger,
                context={"server": self._server},
                inline_read=self._server.options.usercode_inline,
                preread=data,
            )
            with self._socks_lock:
                self._handoff_socks.add(sock)
            # a dead handed-off connection must not pin its Socket
            sock.on_failed.append(self._forget_handoff)
        except Exception:
            logger.exception("native handoff failed")

    def _forget_handoff(self, sock) -> None:
        with self._socks_lock:
            self._handoff_socks.discard(sock)

    def _on_closed(self, _ctx, token) -> None:
        with self._socks_lock:
            sock = self._socks.pop(token, None)
        if sock is not None:
            try:
                sock._mark_closed()
            except Exception:
                logger.exception("conn-closed hook raised")

    # -- lifecycle ---------------------------------------------------------

    def stop(self) -> None:
        """The JAX package's stop order: the drain thread first (no Python
        lock is held while the reactors, which take the GIL in callbacks,
        are joined), then tb_server_stop joins the loops, the finals are
        read, the telemetry tail is flushed, and only then is the server
        destroyed."""
        if self._stopped:
            return
        self._stopped = True
        self._drain_stop.set()
        if self._drain_thread is not None:
            self._drain_thread.join(timeout=5.0)
            self._drain_thread = None
        hook = getattr(self, "_scrape_hook", None)
        if hook is not None:
            prometheus.unregister_scrape_hook(hook)
            self._scrape_hook = None
        for v in self._m_stats:
            v.hide()  # free the port-scoped names for the next plane
        # stop joins the loop threads, so no callback can be in flight when
        # destroy frees the epoll/event fds and the method table
        LIB.tb_server_stop(self._srv)
        self._final_stats = self.stats()
        self._final_compress = self.compress_stats()
        self._final_reactor_stats = [self.reactor_stats(i) for i in range(self.num_reactors)]
        # fold the finals into the retired tallies so the process-wide
        # gauges keep this plane's contribution without double-counting
        global _retired_compress_saved, _retired_auth_rejects
        with _planes_tally_lock:
            if self in _live_planes:
                _live_planes.discard(self)
                fc = self._final_compress
                _retired_compress_saved += max(0, fc["in_raw"] - fc["in_wire"]) + max(
                    0, fc["out_raw"] - fc["out_wire"]
                )
                _retired_auth_rejects += self._final_stats.get("auth_rejects", 0)
        try:
            self.drain_telemetry()
            self._final_tel_dropped = self.telemetry_dropped()
        except Exception:
            logger.exception("final telemetry drain failed")
        for recorder in self._tel_recorders.values():
            recorder.hide()
        with self._socks_lock:
            handoffs = list(self._handoff_socks)
            self._handoff_socks.clear()
        for sock in handoffs:
            try:
                sock.set_failed(ErrorCode.ECLOSE, "server stopped")
            except Exception:
                logger.exception("handoff teardown raised")
        with self._socks_lock:
            socks, self._socks = list(self._socks.values()), {}
        for s in socks:
            s._mark_closed()
        with self._stats_lock:
            srv, self._srv = self._srv, None
        LIB.tb_server_destroy(srv)

    def stats(self) -> Dict[str, int]:
        with self._stats_lock:
            if self._srv is not None:
                vals = [ctypes.c_uint64() for _ in range(5)]
                LIB.tb_server_stats(self._srv, *[ctypes.byref(v) for v in vals])
                keys = ("accepted", "native_reqs", "cb_frames", "handoffs", "live_conns")
                out = dict(zip(keys, (v.value for v in vals)))
                out["deadline_sheds"] = int(LIB.tb_server_deadline_sheds(self._srv))
                out["auth_rejects"] = int(LIB.tb_server_auth_rejects(self._srv))
                return out
        return getattr(
            self,
            "_final_stats",
            dict.fromkeys(
                ("accepted", "native_reqs", "cb_frames", "handoffs", "live_conns",
                 "deadline_sheds", "auth_rejects"),
                0,
            ),
        )

    def compress_stats(self) -> Dict[str, int]:
        """Native codec byte counters: request wire/raw bytes in, response
        raw/wire bytes out."""
        keys = ("in_wire", "in_raw", "out_raw", "out_wire")
        with self._stats_lock:
            if self._srv is None:
                return getattr(self, "_final_compress", dict.fromkeys(keys, 0))
            vals = [ctypes.c_uint64() for _ in range(4)]
            LIB.tb_server_compress_stats(self._srv, *[ctypes.byref(v) for v in vals])
            return dict(zip(keys, (v.value for v in vals)))

    def close_idle(self, idle_s: float) -> int:
        """Cull native connections with no read activity for ``idle_s``
        (the C++ side shutdown()s, the owning loop reaps). Returns the
        count culled."""
        with self._stats_lock:
            if self._srv is None:
                return 0
            return int(LIB.tb_server_close_idle(self._srv, int(max(0.0, idle_s) * 1000)))

    def pause_accept(self) -> None:
        """Lame-duck: close the listener while live connections keep being
        served."""
        with self._stats_lock:
            if self._srv is not None:
                LIB.tb_server_pause_accept(self._srv)

    def connection_count(self) -> int:
        with self._socks_lock:
            live_handoffs = sum(1 for s in self._handoff_socks if s.state == 0)
        return self.stats()["live_conns"] + live_handoffs

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


# process-global fault schedule for native CLIENT channels: armed on
# every NativeClientChannel created afterwards while the
# ``fault_injection`` master flag is on. Redials inherit it — an injected
# close heals into a re-armed channel, as with the Python seam's
# process-wide injector.
_native_client_fault = None


def install_native_client_fault(
    fail_every: int = 0,
    close_every: int = 0,
    delay_every: int = 0,
    delay_ms: int = 0,
    error_code: int = 0,
) -> None:
    """Install (or clear, with all zeros) the process-global native-client
    fault schedule (see tb_channel_set_fault). Deterministic counter
    scheduling like rpc/fault_injector.py; acts only behind the
    ``fault_injection`` master flag."""
    global _native_client_fault
    spec = tuple(
        max(0, int(v)) for v in (fail_every, close_every, delay_every, delay_ms, error_code)
    )
    _native_client_fault = spec if any(spec[:3]) else None


class NativeClientChannel:
    """Client fast path over one shared native connection.

    ``protocol`` selects the wire format the C++ channel emits:
    "tbus_std" (default) or "baidu_std" — the latter sends wire-exact PRPC
    frames (header + proto2 RpcMeta), byte for byte those of
    ``protocol/baidu_std.py``, with a credential (``set_auth``), a request
    codec (``set_request_compress``) and the pump's trace context
    (``set_trace``)."""

    _META_CACHE_MAX = 1024

    def __init__(
        self,
        ip: str,
        port: int,
        connect_timeout_ms: int = 5000,
        protocol: str = "tbus_std",
    ):
        native.require()
        if protocol not in _CH_PROTO:
            raise ValueError(f"unsupported native protocol {protocol!r}")
        err = ctypes.c_int(0)
        self._meta_cache: Dict[tuple, bytes] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._inflight = 0  # calls inside C; destroy only when drained
        self._ch = LIB.tb_channel_connect(ip.encode(), port, connect_timeout_ms, ctypes.byref(err))
        if not self._ch:
            raise OSError(err.value, f"connect {ip}:{port} failed")
        self.protocol = protocol
        if protocol != "tbus_std" and LIB.tb_channel_set_protocol(self._ch, _CH_PROTO[protocol]) != 0:
            # the C++ side refused the protocol id: the channel would
            # silently speak tbus_std — fail construction instead
            LIB.tb_channel_destroy(self._ch)
            self._ch = None
            raise ValueError(f"native channel rejected protocol {protocol!r}")
        # reusable per-thread response-meta buffer: a fresh 64 KiB buffer
        # per call costs more than the whole native round trip
        self._tls = threading.local()
        spec = _native_client_fault
        if spec is not None and get_flag("fault_injection"):
            self.set_fault(*spec)

    def healthy(self) -> bool:
        return not self._closed and LIB.tb_channel_error(self._ch) == 0

    @property
    def reactor(self) -> int:
        """Client reactor shard this channel pinned at connect: the top 8
        bits of every correlation id it mints (-1 once closed)."""
        with self._lock:
            if self._ch is None:
                return -1
            return int(LIB.tb_channel_reactor(self._ch))

    def cid_misroutes(self) -> int:
        """Responses seen with a WRONG shard tag in their correlation id
        (each answered EREQUEST to its caller instead of crashing)."""
        with self._lock:
            if self._ch is None:
                return 0
            return int(LIB.tb_channel_cid_misroutes(self._ch))

    def set_request_compress(self, name: str) -> None:
        """Channel-default request compress_type (baidu_std only): stamps
        RpcMeta field 3 on every request this channel emits. The CALLER
        compresses payloads with the matching protocol/compress.py codec —
        the same algorithm the server's C++ table runs, so the planes stay
        byte-identical. "" clears."""
        wire = _NATIVE_COMPRESS_WIRE.get(name, 0)
        if name and wire == 0:
            raise ValueError(f"codec {name!r} is not native-plane capable")
        if LIB.tb_channel_set_compress(self._ch, wire) != 0:
            raise RuntimeError("tb_channel_set_compress rejected the codec")

    def set_auth(self, credential) -> None:
        """Arm the connection's credential (RpcMeta field 7,
        authentication_data): stamped on requests until the first
        successful response proves the connection — the reference's
        first-request auth fight. A redialed channel re-arms with a fresh
        credential."""
        data = credential.encode() if isinstance(credential, str) else bytes(credential)
        # fabriclint: allow(ffi-unchecked) csrc/host's tb_channel_set_auth always accepts, and copies the credential before it returns
        LIB.tb_channel_set_auth(self._ch, data, len(data))

    def set_trace(
        self,
        trace_id: int,
        span_id: int = 0,
        parent_span_id: int = 0,
        log_id: int = 0,
        sampled: int = 1,
        every: int = 1,
    ) -> None:
        """Arm ambient trace context for the pipelined ``pump``
        (tb_channel_set_trace): every ``every``'th pump frame carries the
        Dapper fields in its RpcRequestMeta, with a distinct per-frame span
        id (``span_id + sequence``). baidu_std channels only; ``every=0``
        disarms."""
        m64 = (1 << 64) - 1
        rc = LIB.tb_channel_set_trace(
            self._ch,
            int(log_id) & m64,
            int(trace_id) & m64,
            int(span_id) & m64,
            int(parent_span_id) & m64,
            1 if sampled else 0,
            max(0, int(every)),
        )
        if rc != 0:
            raise ValueError("traced pumps ride the PRPC wire: use protocol='baidu_std'")

    def set_fault(
        self,
        fail_every: int = 0,
        close_every: int = 0,
        delay_every: int = 0,
        delay_ms: int = 0,
        error_code: int = 0,
    ) -> None:
        """Arm the C++ channel's counter-scheduled fault seam
        (tb_channel_set_fault) — the native analog of the Python
        Socket.write injector: every Nth call fails/closes/delays,
        deterministically. 0 disables a schedule."""
        rc = LIB.tb_channel_set_fault(
            self._ch,
            *(max(0, int(v)) for v in (fail_every, close_every, delay_every, delay_ms, error_code)),
        )
        if rc != 0:
            raise RuntimeError("tb_channel_set_fault rejected the schedule")

    def _meta_bytes(
        self,
        service: str,
        method: str,
        att_len: int,
        log_id: int = 0,
        trace_id: int = 0,
        span_id: int = 0,
        parent_span_id: int = 0,
        sampled: int = 0,
        timeout_ms: int = 0,
    ) -> bytes:
        from incubator_brpc_tpu_torch.protocol.tbus_std import Meta

        traced = bool(log_id or trace_id or span_id or parent_span_id or sampled)
        if self.protocol == "baidu_std":
            # the RpcRequestMeta submessage only: correlation_id and
            # attachment_size live OUTSIDE it, spliced in by the C++
            # channel, so the cache key never depends on the attachment;
            # traced calls build uncached (their ids change per call)
            from incubator_brpc_tpu_torch.protocol.baidu_std import encode_request_submeta

            if traced:
                return encode_request_submeta(
                    service, method, log_id, trace_id, span_id, parent_span_id,
                    timeout_ms=timeout_ms, sampled=sampled,
                )
            key = (service, method, timeout_ms)
            m = self._meta_cache.get(key)
            if m is None:
                m = encode_request_submeta(service, method, timeout_ms=timeout_ms)
                if len(self._meta_cache) >= self._META_CACHE_MAX:
                    self._meta_cache.clear()  # one-shot keys flooded it
                self._meta_cache[key] = m
            return m
        if traced or att_len:
            return Meta(
                service=service,
                method=method,
                timeout_ms=timeout_ms,
                log_id=log_id,
                trace_id=trace_id,
                span_id=span_id,
                parent_span_id=parent_span_id,
                sampled=sampled,
            ).to_bytes(attachment_size=att_len)
        # the propagated deadline joins the cache KEY: clients reuse one
        # configured timeout per channel, so the steady state is one hit
        key = (service, method, timeout_ms)
        m = self._meta_cache.get(key)
        if m is None:
            m = Meta(service=service, method=method, timeout_ms=timeout_ms).to_bytes()
            if len(self._meta_cache) >= self._META_CACHE_MAX:
                # one-shot keys flooded it: clear rather than freeze
                self._meta_cache.clear()
            self._meta_cache[key] = m
        return m

    def decode_resp_meta(self, resp_meta: bytes):
        """Response meta bytes -> Meta: JSON on tbus_std, RpcMeta proto
        bytes on baidu_std (the raw bytes tb_channel_call copied out)."""
        from incubator_brpc_tpu_torch.protocol.tbus_std import Meta

        if not resp_meta:
            return Meta()
        if self.protocol == "baidu_std":
            from incubator_brpc_tpu_torch.protocol.baidu_std import RpcMeta, rpc_meta_to_meta

            return rpc_meta_to_meta(RpcMeta.decode(resp_meta))
        return Meta.from_bytes(resp_meta)

    def _leave(self) -> None:
        """One call out of C: the last one out of a closed channel
        destroys it."""
        with self._lock:
            self._inflight -= 1
            destroy = self._closed and self._inflight == 0 and self._ch
            if destroy:
                ch, self._ch = self._ch, None
        if destroy:
            LIB.tb_channel_destroy(ch)

    def call(
        self,
        service: str,
        method: str,
        payload: bytes,
        attachment: bytes = b"",
        timeout_ms: int = 500,
        log_id: int = 0,
        trace_id: int = 0,
        span_id: int = 0,
        parent_span_id: int = 0,
        sampled: int = 0,
        compress: str = "",
    ):
        """One native round trip. Returns (rc, err_code, resp_meta_bytes,
        body: IOBuf): rc < 0 is a transport errno, err_code the server's
        RPC error. Nonzero log_id/trace ids travel in the request meta as
        the Python packers send them. ``compress`` (baidu_std only) names
        the codec the CALLER already compressed ``payload`` with: it rides
        the wire's compress_type, and the response body comes back as wire
        bytes (the caller decompresses per the response meta)."""
        from incubator_brpc_tpu_torch.iobuf import IOBuf
        from incubator_brpc_tpu_torch.protocol.tbus_std import FLAG_BODY_CRC

        with self._lock:
            if self._closed:
                return -_errno.EPIPE, 0, b"", IOBuf()
            self._inflight += 1
        try:
            wire_timeout = max(1, int(timeout_ms)) if timeout_ms and timeout_ms > 0 else 0
            meta = self._meta_bytes(
                service, method, len(attachment), log_id, trace_id, span_id,
                parent_span_id, sampled, timeout_ms=wire_timeout,
            )
            if self.protocol == "baidu_std":
                # flags carry the per-call compress_type in PRPC mode (the
                # tbus flag space means nothing there)
                flags = _NATIVE_COMPRESS_WIRE.get(compress, 0)
            else:
                flags = FLAG_BODY_CRC if get_flag("tbus_body_crc") else 0
            body = IOBuf()
            tls = self._tls
            try:
                meta_out, meta_len, err_code = tls.meta_out, tls.meta_len, tls.err_code
            except AttributeError:
                meta_out = tls.meta_out = ctypes.create_string_buffer(64 * 1024)
                meta_len = tls.meta_len = ctypes.c_uint32(0)
                err_code = tls.err_code = ctypes.c_uint32(0)
            t0 = time.perf_counter()
            rc = LIB.tb_channel_call(
                self._ch,
                meta,
                len(meta),
                payload,
                len(payload),
                attachment,
                len(attachment),
                flags,
                body._h,
                meta_out,
                64 * 1024,
                ctypes.byref(meta_len),
                ctypes.byref(err_code),
                wire_timeout,
            )
            native_client_calls << 1
            if rc < 0:
                native_client_errors << 1
            else:
                native_client_call_us << (time.perf_counter() - t0) * 1e6
            resp_meta = ctypes.string_at(meta_out, meta_len.value) if meta_len.value else b""
            return rc, err_code.value, resp_meta, body
        finally:
            self._leave()

    def pump(
        self,
        service: str,
        method: str,
        payload: bytes,
        n: int,
        inflight: int = 64,
        timeout_ms: int = 60000,
    ) -> float:
        """Pipelined native load run: n requests with ``inflight``
        outstanding, entirely in C++. Returns ns/request. Requires exclusive
        use of this channel."""
        with self._lock:
            if self._closed:
                raise OSError(_errno.EPIPE, "channel closed")
            self._inflight += 1
        try:
            meta = self._meta_bytes(service, method, 0)
            rc = LIB.tb_channel_pump(
                self._ch, meta, len(meta), payload, len(payload), n, inflight, timeout_ms
            )
            if rc < 0:
                native_client_errors << 1
                raise OSError(-rc, "native pump failed")
            (prpc_pump_ns if self.protocol == "baidu_std" else native_pump_ns) << int(rc)
            return float(rc)
        finally:
            self._leave()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._inflight > 0 or not self._ch:
                return  # last call out destroys
            ch, self._ch = self._ch, None
        LIB.tb_channel_destroy(ch)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
