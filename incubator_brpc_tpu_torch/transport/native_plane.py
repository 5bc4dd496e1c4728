"""Native network plane — the Python face of the port's ``csrc/host/tbnet``.

tbnet is the native epoll reactor + tbus_std messenger + method dispatcher,
and this module is the seam between it and the port's Python RPC layer:

- ``NativeServerPlane`` replaces the Python Acceptor/EventDispatcher for a
  Server (``ServerOptions(native_plane=True)``): tbus_std frames are cut,
  verified and, for natively registered methods (``native_echo``,
  ``native_nop``, and user C functions through ``native_method_lib``),
  ANSWERED on a reactor thread without the interpreter; every other frame
  surfaces here as one callback and runs through the same
  ``Server.process_request`` as the Python plane over a ``NativeConnSock``
  facade (so a ``DeviceEndpoint.server_handler()`` serves the card behind
  the C++ reactor). Connections that open with another protocol are handed
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
  ``LatencyRecorder``s.

The port's copy of the JAX package's ``transport/native_plane.py``. Not
here yet, each refusing where it is asked for: the native plane's auth and
per-method limits with the adaptive limiter's feedback (ROADMAP A7; the
``auth`` and ``max_concurrency`` options refuse in ``ServerOptions``) and
its client fault seam (``install_native_client_fault``, A7); baidu_std on
the native plane (A11: ``NativeClientChannel(protocol="baidu_std")``
refuses, and a baidu_std frame reaching the Python route closes its
connection); the rpcz spans the telemetry ring samples (A12). A handle of
this package's library (an IOBuf, a connection token) never crosses to
another package's runtime: only bytes on the wire do.
"""

from __future__ import annotations

import ctypes
import errno as _errno
import logging
import os
import socket as _pysocket
import threading
import time
import weakref
from typing import Dict, Optional

from incubator_brpc_tpu_torch import native
from incubator_brpc_tpu_torch.bvar import Adder, IntRecorder, LatencyRecorder, PassiveStatus
from incubator_brpc_tpu_torch.native import CLOSED_FN, FRAME_FN, HANDOFF_FN, LIB
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

# tb_telemetry_record ABI size (static_assert in csrc/host/tbnet/tbnet.cc)
_TELEMETRY_RECORD_BYTES = 64

# client fast-path instrumentation: per-call round trip (the Python
# boundary included), transport errors, and the pump's ns/request
native_client_calls = Adder(name="native_client_calls")
native_client_errors = Adder(name="native_client_errors")
native_client_call_us = LatencyRecorder(name="native_client_call_us")
native_pump_ns = IntRecorder(name="native_pump_ns")


def _native_kind(handler) -> Optional[int]:
    return getattr(handler, "_native_kind", None)


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
        LIB.tb_conn_close(self.token)  # -1: the token is already stale
        for cb in list(self.on_failed):
            try:
                cb(self)
            except Exception:
                logger.exception("on_failed callback raised")
        return True

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
        self._m_stats: list = []
        self._stopped = False
        self.port = 0

    # -- registration ------------------------------------------------------

    def register_methods(self) -> None:
        """Register native-kind handlers (echo/nop) and user .so methods
        for pure-C++ dispatch; everything else stays on the per-frame
        Python route. (The port's methods run with unlimited concurrency:
        limits wait for ROADMAP A7.)"""
        for full, prop in self._server.methods().items():
            kind = _native_kind(prop.handler)
            if kind is not None:
                if LIB.tb_server_register_native(self._srv, full.encode(), kind, 0) != 0:
                    # duplicate / key collision: the method stays on the
                    # Python route and must NOT claim a telemetry index
                    # (_native_names positions mirror the C++ table)
                    logger.warning(
                        "native registration of %s rejected; it stays on the Python route", full
                    )
                    continue
                self._native_names.append(full)
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
            if LIB.tb_server_register_native_fn(self._srv, full.encode(), fn, None, 0) != 0:
                logger.warning(
                    "native registration of %s rejected (duplicate or method-key "
                    "collision); it stays on the Python route", full,
                )
                continue
            self._user_libs.append(dll)  # keepalive
            self._native_names.append(full)
            if getattr(prop.handler, "_native_long_running", False):
                if LIB.tb_server_set_native_long_running(self._srv, full.encode(), 1) != 0:
                    logger.warning("long-running flag rejected for %s", full)

    def native_method_names(self) -> list:
        """Methods dispatched on the C++ plane (registration order)."""
        return list(self._native_names)

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
                      "deadline_sheds")
        ]
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
            # a weak reference: a started-then-abandoned plane stays
            # collectable, so the __del__ -> stop() backstop can fire
            self._drain_thread = threading.Thread(
                target=_drain_pump,
                args=(weakref.ref(self), self._drain_stop),
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

    def drain_telemetry(self) -> int:
        """Pull every completed record off each reactor's C++ ring into the
        per-method latency summaries, one reactor's batch per numpy pass.
        Returns the record count. Serialized: the background pump and the
        stop-time flush never interleave batches."""
        if not self._telemetry:
            return 0
        total = 0
        with self._tel_lock:
            # batch cap: a drain races live producers and must not spin
            # forever against a sustained flood (~1M records per call)
            budget = 256
            for reactor in range(self.num_reactors):
                while budget > 0:
                    budget -= 1
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

    def _consume_records(self, batch, n: int) -> None:
        """Vectorized fan-out of one batch: per-method latency summaries
        (exact count/sum/max, a strided subsample for the percentiles),
        and natively shed requests into ``deadline_shed_count``."""
        import numpy as np

        arr = np.frombuffer(batch, dtype=self._rec_dtype(), count=n)
        names = self._native_names
        method_ids = arr["method_idx"]
        errors = arr["error_code"]
        lat_us = arr["latency_ns"] * 1e-3
        ok = errors == 0
        nshed = int((errors == ErrorCode.EDEADLINE).sum())
        if nshed:
            from incubator_brpc_tpu_torch.rpc.server import deadline_shed_count

            deadline_shed_count << nshed
        for idx in np.unique(method_ids):
            if idx >= len(names):
                continue  # table drift (never expected): drop, don't crash
            succ = (method_ids == idx) & ok
            nsucc = int(succ.sum())
            if not nsucc:
                continue
            recorder = self._tel_recorders.get(int(idx))
            if recorder is None:
                full = names[idx]
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

    def _on_frame(self, _ctx, token, cid_lo, cid_hi, flags, error_code,
                  meta_ptr, meta_len, body_h) -> None:
        from incubator_brpc_tpu_torch.iobuf import IOBuf
        from incubator_brpc_tpu_torch.protocol.tbus_std import Meta, ParsedFrame

        try:
            body = IOBuf(_handle=body_h)  # take ownership
            if flags & _FLAG_WIRE_PRPC:
                # baidu_std on the native plane's Python route waits for
                # ROADMAP A11: refuse the connection, answer nothing wrong
                logger.warning("baidu_std frame on a native plane: not in the port yet (ROADMAP A11)")
                LIB.tb_conn_close(token)
                return
            meta = Meta.from_bytes(ctypes.string_at(meta_ptr, meta_len) if meta_len else b"")
            blen = len(body)
            att = meta.attachment_size
            if att > blen:
                # consumed and unrecoverable: kill the connection
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
            self._dispatch(self._sock_for(token), frame)
        except Exception:
            logger.exception("native frame dispatch failed")

    def _dispatch(self, sock: NativeConnSock, frame) -> None:
        """Mirror of InputMessenger._process_one for pre-cut frames."""
        from incubator_brpc_tpu_torch import protocol as proto_pkg

        proto = proto_pkg.TBUS_STD
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
        for v in self._m_stats:
            v.hide()  # free the port-scoped names for the next plane
        # stop joins the loop threads, so no callback can be in flight when
        # destroy frees the epoll/event fds and the method table
        LIB.tb_server_stop(self._srv)
        self._final_stats = self.stats()
        self._final_reactor_stats = [self.reactor_stats(i) for i in range(self.num_reactors)]
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
                return out
        return getattr(
            self,
            "_final_stats",
            dict.fromkeys(
                ("accepted", "native_reqs", "cb_frames", "handoffs", "live_conns",
                 "deadline_sheds"),
                0,
            ),
        )

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


def install_native_client_fault(
    fail_every: int = 0,
    close_every: int = 0,
    delay_every: int = 0,
    delay_ms: int = 0,
    error_code: int = 0,
) -> None:
    """The process-global native-client fault schedule waits for the fault
    injector (ROADMAP A7)."""
    from incubator_brpc_tpu_torch.rpc.controller import refuse_unported

    refuse_unported(
        "install_native_client_fault", "fail_every",
        (fail_every, close_every, delay_every, delay_ms, error_code), "A7",
    )


class NativeClientChannel:
    """Client fast path over one shared native connection, speaking
    tbus_std (``protocol="baidu_std"`` waits for ROADMAP A11)."""

    _META_CACHE_MAX = 1024

    def __init__(
        self,
        ip: str,
        port: int,
        connect_timeout_ms: int = 5000,
        protocol: str = "tbus_std",
    ):
        native.require()
        if protocol == "baidu_std":
            from incubator_brpc_tpu_torch.rpc.controller import refuse_unported

            refuse_unported("NativeClientChannel", "protocol", protocol, "A11")
        if protocol != "tbus_std":
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
        # reusable per-thread response-meta buffer: a fresh 64 KiB buffer
        # per call costs more than the whole native round trip
        self._tls = threading.local()

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
        """Response meta bytes (JSON on tbus_std) -> Meta."""
        from incubator_brpc_tpu_torch.protocol.tbus_std import Meta

        return Meta.from_bytes(resp_meta) if resp_meta else Meta()

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
    ):
        """One native round trip. Returns (rc, err_code, resp_meta_bytes,
        body: IOBuf): rc < 0 is a transport errno, err_code the server's
        RPC error. Nonzero log_id/trace ids travel in the request meta as
        the Python packers send them."""
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
            native_pump_ns << int(rc)
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
