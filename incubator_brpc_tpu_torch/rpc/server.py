"""Server — service registry + lifecycle (reference src/brpc/server.{h,cpp}:
StartInternal server.cpp:690, method map server.cpp:1209, MethodStatus
details/method_status.h:90-97).

Request flow (mirrors SURVEY.md §3.2):
  Acceptor IN event → Socket reader fiber → InputMessenger cut
    → tbus_std.process_request (bound below)
      ├ look up the server via sock.context (the reference reaches it
      │ through the Socket's user object)
      ├ shed a request whose propagated deadline expired (EDEADLINE)
      ├ ELOGOFF when stopping; find the method, ENOSERVICE/ENOMETHOD on miss
      ├ decompress, build the server Controller
      └ run the handler; done → _send_response (compress, pack,
        Socket.write, MethodStatus latency bvars)

A handler is ``handler(cntl, request: bytes) -> Optional[bytes]``:
  - return bytes: the response payload (sync style);
  - return None after calling ``cntl.set_async()``: the handler owns the
    response and must call ``cntl.send_response(payload)`` later — the
    reference's done-closure style (baidu_rpc_protocol.cpp:490-503).
Errors: ``cntl.set_failed(code, text)`` → an error frame, payload dropped.

The port's copy of the JAX package's ``rpc/server.py`` on the Python
acceptor, trimmed: the method map is a plain dict keyed by full name
(where the JAX package uses its native FlatMap), methods run with
unlimited concurrency, and the native plane, TLS, the concurrency
limiters, auth, the fault injector, rpcz, request dumps, streams, the
HTTP gateway, lame-duck draining, session and thread-local data, and the
collective services are later slices. The device-link handshake
(``_tpu_transport.handshake``, ``transport/device_link.py``) is registered
at ``start``; ``stop`` closes every link the server accepted.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional, Union

import torch

from incubator_brpc_tpu_torch import protocol as proto_pkg
from incubator_brpc_tpu_torch.bvar import Adder, LatencyRecorder
from incubator_brpc_tpu_torch.protocol import compress as compress_mod
from incubator_brpc_tpu_torch.protocol.tbus_std import (
    FLAG_RESPONSE,
    Meta,
    ParsedFrame,
    pack_frame_iobuf,
)
from incubator_brpc_tpu_torch.rpc.controller import Controller, refuse_unported
from incubator_brpc_tpu_torch.rpc.deadline import pop_deadline, push_deadline
from incubator_brpc_tpu_torch.runtime.timer_thread import global_timer_thread
from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool
from incubator_brpc_tpu_torch.transport.acceptor import Acceptor
from incubator_brpc_tpu_torch.transport.messenger import InputMessenger
from incubator_brpc_tpu_torch.utils.device import DeviceLike, resolve_device
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint, str2endpoint
from incubator_brpc_tpu_torch.utils.flags import get_flag
from incubator_brpc_tpu_torch.utils.status import ErrorCode, berror

logger = logging.getLogger(__name__)

# Requests shed because their PROPAGATED deadline (meta timeout_ms) expired
# before the method could be dispatched — expired-at-arrival and
# expired-mid-queue both count here.
deadline_shed_count = Adder(name="deadline_shed_count")


class MethodStatus:
    """Per-method in-flight count + latency stats
    (details/method_status.h:28,90-97), with unlimited concurrency."""

    def __init__(self, full_name: str):
        self.full_name = full_name
        self._nprocessing = 0
        self._lock = threading.Lock()
        self.latency = LatencyRecorder(name=f"method_{full_name}_latency")
        self.nerror = Adder(name=f"method_{full_name}_error")

    def on_requested(self) -> None:
        with self._lock:
            self._nprocessing += 1

    def on_responded(self, error_code: int, latency_us: float) -> None:
        with self._lock:
            self._nprocessing -= 1
        if error_code == 0:
            self.latency << latency_us
        else:
            self.nerror << 1


class MethodProperty:
    __slots__ = ("handler", "status")

    def __init__(self, handler: Callable, status: MethodStatus):
        self.handler = handler
        self.status = status


class ServerOptions:
    """Reference ServerOptions (server.h:55-239) with the reference's
    parameters in the reference's order, so a positional call binds as it
    binds there. The port serves ``usercode_inline`` and ``device_index``;
    ``has_builtin_services`` is accepted either way and is inert until
    ROADMAP A12 brings the builtin services. Every other parameter keeps
    its place and its default, and a value that asks for something the
    port does not serve yet raises ``NotImplementedError`` naming the
    ROADMAP item that brings it.

    ``device`` (keyword-only, after the reference's parameters) is the
    device the server's links and device methods use: ``None`` means the
    card (``cuda``, ``device_index`` picking among several), ``"cpu"`` runs
    them on the CPU when the caller asks for it."""

    def __init__(
        self,
        max_concurrency: Union[int, str] = 0,
        method_max_concurrency: Union[int, str] = 0,
        idle_timeout_s: float = -1,
        has_builtin_services: bool = True,
        auth=None,
        usercode_inline: bool = False,
        device_index: Optional[int] = None,
        nshead_service=None,
        thrift_service=None,
        mongo_service_adaptor=None,
        rtmp_service=None,
        ssl_context=None,
        native_plane: bool = False,
        native_loops: Optional[int] = None,
        num_reactors: Optional[int] = None,
        native_dispatch_workers: int = 0,
        session_local_data_factory=None,
        reserved_session_local_data: int = 0,
        thread_local_data_factory=None,
        reserved_thread_local_data: int = 0,
        enable_collective_service: Optional[bool] = None,
        collective_max_concurrency: int = 1,
        fault_injector=None,
        *,
        device: DeviceLike = None,
    ):
        unported = (
            ("max_concurrency", max_concurrency, 0, "A7"),
            ("method_max_concurrency", method_max_concurrency, 0, "A7"),
            ("auth", auth, None, "A7"),
            ("nshead_service", nshead_service, None, "A11"),
            ("thrift_service", thrift_service, None, "A11"),
            ("mongo_service_adaptor", mongo_service_adaptor, None, "A11"),
            ("rtmp_service", rtmp_service, None, "A11"),
            ("ssl_context", ssl_context, None, "A10"),
            ("native_plane", native_plane, False, "A6"),
            ("native_loops", native_loops, None, "A6"),
            ("num_reactors", num_reactors, None, "A6"),
            ("native_dispatch_workers", native_dispatch_workers, 0, "A6"),
            ("session_local_data_factory", session_local_data_factory, None, "A7"),
            ("reserved_session_local_data", reserved_session_local_data, 0, "A7"),
            ("thread_local_data_factory", thread_local_data_factory, None, "A7"),
            ("reserved_thread_local_data", reserved_thread_local_data, 0, "A7"),
            ("collective_max_concurrency", collective_max_concurrency, 1, "A4"),
            ("fault_injector", fault_injector, None, "A7"),
        )
        for name, value, default, item in unported:
            if value != default:
                refuse_unported("ServerOptions", name, value, item)
        if idle_timeout_s is not None and idle_timeout_s > 0:
            refuse_unported("ServerOptions", "idle_timeout_s", idle_timeout_s, "A7")
        if enable_collective_service:
            refuse_unported(
                "ServerOptions", "enable_collective_service", enable_collective_service, "A4"
            )
        # inert until ROADMAP A12 (the port has no builtin services yet)
        self.has_builtin_services = has_builtin_services
        # Run request processing (cut + handler) inline on the reactor
        # thread instead of a pool fiber — removes two thread handoffs per
        # request. ONLY for services whose handlers never block: a blocking
        # handler stalls every connection hashed to the same dispatcher.
        self.usercode_inline = usercode_inline
        # device this server binds for transport='tpu' links (None = pick a
        # neighbor of the client's device; the reference's use_rdma slot)
        self.device_index = device_index
        self.device = device


class Server:
    def __init__(self, options: Optional[ServerOptions] = None):
        self.options = options or ServerOptions()
        self._methods: Dict[str, MethodProperty] = {}
        self._acceptor: Optional[Acceptor] = None
        self._messenger = InputMessenger()
        self._stopping = False
        self._started = False
        self._lock = threading.Lock()
        self._nprocessing = 0  # server-level in-flight count
        self._quiescent = threading.Condition(self._lock)
        self.nrequest = Adder(name=None)
        self.nerror = Adder(name=None)
        self.listen_endpoint: Optional[EndPoint] = None
        # full name -> DeviceMethod: what the link handshake advertises
        self._device_methods: Dict[str, object] = {}
        # server halves of the transport='tpu' links this server accepted
        self._device_socks: list = []

    def device(self) -> torch.device:
        """The device this server's links and device methods use:
        ``options.device`` (the card unless ``"cpu"``), with
        ``options.device_index`` picking the card among several."""
        dev = resolve_device(self.options.device)
        if dev.type == "cuda" and self.options.device_index is not None:
            dev = torch.device("cuda", int(self.options.device_index))
        return dev

    # -- registration --------------------------------------------------------

    def add_service(self, name: str, handlers: Dict[str, Callable]) -> None:
        """Register ``name.method → handler`` rows (Server::AddService builds
        the same flat _method_map, server.cpp:1209)."""
        if self._started:
            raise RuntimeError("add_service after start")
        for method in handlers:
            if f"{name}.{method}" in self._methods:
                raise ValueError(f"method {name}.{method} already registered")
        for method, handler in handlers.items():
            full = f"{name}.{method}"
            self._methods[full] = MethodProperty(handler, MethodStatus(full))
            dm = getattr(handler, "_device_method", None)
            if dm is not None:
                # device-kernel methods publish to the registry the session
                # plane resolves, and to this server's table, which the link
                # handshake advertises as fingerprints
                from incubator_brpc_tpu_torch.rpc.device_method import (
                    register_device_method,
                )

                register_device_method(name, method, dm)
                self._device_methods[full] = dm

    def method_status(self, service: str, method: str) -> Optional[MethodStatus]:
        prop = self._methods.get(f"{service}.{method}")
        return prop.status if prop else None

    # -- lifecycle -----------------------------------------------------------

    def start(self, listen: Union[int, str, EndPoint] = 0) -> bool:
        """StartInternal (server.cpp:690): build the acceptor and listen.
        ``listen`` may be a port (0 = ephemeral, on 127.0.0.1), "ip:port",
        or an EndPoint."""
        if self._started:
            return False
        # the transport='tpu' bootstrap: every server answers the device
        # handshake on its host port (the reference's Socket accepts the
        # RDMA magic on any connection when rdma is compiled in)
        from incubator_brpc_tpu_torch.transport.device_link import (
            HANDSHAKE_METHOD,
            HANDSHAKE_SERVICE,
            make_handshake_handler,
        )

        hs = f"{HANDSHAKE_SERVICE}.{HANDSHAKE_METHOD}"
        if hs not in self._methods:
            self._methods[hs] = MethodProperty(make_handshake_handler(self), MethodStatus(hs))
        if isinstance(listen, int):
            ep = EndPoint(ip="127.0.0.1", port=listen)
        elif isinstance(listen, str):
            ep = str2endpoint(listen)
        else:
            ep = listen
        self._acceptor = Acceptor(
            ep,
            messenger=self._messenger,
            conn_context={"server": self},
            inline_read=self.options.usercode_inline,
        )
        self.listen_endpoint = self._acceptor.endpoint
        self._stopping = False
        self._started = True
        logger.info("server started on %s", self.listen_endpoint)
        return True

    def stop(self) -> None:
        """Stop accepting + fail connections; in-flight handlers finish
        (Server::Stop then Join, server.cpp)."""
        if not self._started:
            return
        self._stopping = True
        if self._acceptor is not None:
            self._acceptor.stop()
        for ds in list(self._device_socks):
            try:
                ds.set_failed(ErrorCode.ECLOSE, "server stopped")
            except Exception:
                logger.exception("device link teardown raised")
        self._device_socks.clear()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait until every in-flight request finished."""
        with self._quiescent:
            return self._quiescent.wait_for(
                lambda: self._nprocessing == 0, timeout=timeout
            )

    @property
    def port(self) -> int:
        return self.listen_endpoint.port if self.listen_endpoint else 0

    def connection_count(self) -> int:
        """Host connections this server holds open."""
        return self._acceptor.connection_count() if self._acceptor else 0

    # -- request path --------------------------------------------------------

    def process_request(self, sock, frame: ParsedFrame) -> None:
        """The tbus_std process_request body (baidu_rpc_protocol.cpp:307)."""
        self.nrequest << 1
        meta = frame.meta
        # timeout_ms=0: a server-side controller has no deadline unless the
        # request PROPAGATED one (set below)
        cntl = Controller(timeout_ms=0)
        cntl.request_meta = meta
        cntl.remote_side = sock.remote
        cntl.log_id = meta.log_id
        cntl.call_id = frame.correlation_id
        cntl.compress_type = meta.compress
        cntl.request_attachment = frame.attachment
        cntl._server = self
        cntl._service = meta.service
        cntl._method = meta.method
        cntl._mark_start()

        # deadline propagation (reference RpcRequestMeta.timeout_ms +
        # server-side ProcessRpcRequest shed): the request carries its
        # remaining budget; measured against when the frame ARRIVED (the
        # messenger stamps arrival_ts at cut), work that expired on the
        # wire or in this server's dispatch queue is answered EDEADLINE
        # without invoking the method.
        budget_ms = meta.timeout_ms
        if budget_ms and budget_ms > 0:
            now = time.monotonic()
            arrival = frame.arrival_ts if frame.arrival_ts is not None else now
            if (now - arrival) * 1000.0 >= budget_ms:
                deadline_shed_count << 1
                cntl.set_failed(ErrorCode.EDEADLINE, berror(ErrorCode.EDEADLINE))
                self.nerror << 1
                self._send_response(sock, cntl, b"")
                return
            # the server-side controller's deadline IS the propagated one:
            # deadline_left_ms() hands the residue to downstream work
            cntl.timeout_ms = budget_ms
            cntl._deadline = arrival + budget_ms / 1000.0

        if self._stopping:
            # a stopping server refuses NEW work with the retriable ELOGOFF;
            # in-flight handlers (admitted before) finish
            cntl.set_failed(ErrorCode.ELOGOFF, berror(ErrorCode.ELOGOFF))
            self._send_response(sock, cntl, b"")
            return
        prop = self._methods.get(f"{meta.service}.{meta.method}")
        if prop is None:
            code = (
                ErrorCode.ENOMETHOD
                if any(k.startswith(meta.service + ".") for k in self._methods)
                else ErrorCode.ENOSERVICE
            )
            cntl.set_failed(code, f"unknown {meta.service}.{meta.method}")
            self._send_response(sock, cntl, b"")
            return
        status = prop.status
        self._admit(status)

        try:
            payload = frame.payload
            if meta.compress:
                payload = compress_mod.decompress(meta.compress, payload)
        except Exception as e:
            cntl.set_failed(ErrorCode.EREQUEST, f"decompress failed: {e}")
            self._finish(sock, cntl, b"", status)
            return
        cntl._request_payload = payload

        # wire the async-response closure before running user code. The
        # closure finishes AT MOST ONCE: the async-reap timer below and a
        # late (or duplicate) send_response from the handler must not both
        # release the admission slot.
        cntl._async = False
        cntl.set_async = lambda: setattr(cntl, "_async", True)
        finish_lock = threading.Lock()
        cntl._finish_done = False

        def _claim_finish() -> bool:
            """True exactly once: the caller that wins owns the finish."""
            with finish_lock:
                if cntl._finish_done:
                    return False
                cntl._finish_done = True
                return True

        def _finish_once(response: bytes = b"") -> None:
            if _claim_finish():
                self._finish(sock, cntl, response, status)

        cntl.send_response = _finish_once

        def _reap_unanswered(timeout: float) -> None:
            if not _claim_finish():
                return  # answered in time: nothing to do
            cntl.set_failed(
                ErrorCode.ERPCTIMEDOUT,
                f"async handler sent no response within {timeout:g}s",
            )
            self._finish(sock, cntl, b"", status)

        # downstream Channels on this thread inherit the request's
        # remaining budget (rpc/deadline.py) — the decrement-across-hops
        # half of deadline propagation
        prev_deadline = push_deadline(cntl._deadline or None)
        try:
            response = prop.handler(cntl, payload)
        except Exception as e:
            logger.exception("handler %s.%s raised", meta.service, meta.method)
            cntl.set_failed(ErrorCode.EINTERNAL, f"handler raised: {e!r}")
            response = b""
        finally:
            pop_deadline(prev_deadline)
        if cntl._async and not cntl.failed():
            # handler owns the response now — but bound how long it can
            # hold the admission slot
            self._watch_async_response(cntl, _reap_unanswered)
            return
        _finish_once(response or b"")

    def _watch_async_response(self, cntl: Controller, reap) -> None:
        """Arm the async-response reap: after ``async_response_timeout_s``
        an unanswered async RPC is failed with ERPCTIMEDOUT through
        ``reap`` (which claims the once-only finish first)."""
        timeout = float(get_flag("async_response_timeout_s"))
        if timeout <= 0 or cntl._finish_done:
            return  # reap disabled, or a fast async handler already answered

        # the reap does a socket write: too heavy for the shared
        # TimerThread, so the timer only spawns, and only for RPCs still
        # unanswered
        def _maybe_spawn_reap() -> None:
            if not cntl._finish_done:
                global_worker_pool().spawn(lambda: reap(timeout))

        cntl._reap_timer_id = global_timer_thread().schedule(
            _maybe_spawn_reap, delay=timeout
        )

    def _finish(self, sock, cntl: Controller, response: bytes, status: MethodStatus) -> None:
        # a finished RPC must not stay pinned by its armed reap timer
        tid = getattr(cntl, "_reap_timer_id", None)
        if tid is not None:
            cntl._reap_timer_id = None
            global_timer_thread().unschedule(tid)
        self._send_response(sock, cntl, response)
        cntl._mark_end()
        self._release(status, cntl)
        if cntl.failed():
            self.nerror << 1

    def _admit(self, status: MethodStatus) -> None:
        """Count the request in flight (caller MUST pair with _release)."""
        with self._lock:
            self._nprocessing += 1
        status.on_requested()

    def _release(self, status: MethodStatus, cntl: Controller) -> None:
        status.on_responded(cntl.error_code, cntl.latency_us)
        with self._lock:
            self._nprocessing -= 1
            if self._nprocessing == 0:
                self._quiescent.notify_all()

    def _send_response(self, sock, cntl: Controller, response: bytes) -> None:
        """SendRpcResponse (baidu_rpc_protocol.cpp:136): serialize+compress,
        append attachment, write. The response meta carries only what the
        client reads back (error text / compress / attachment size); a
        plain success with a bare payload travels with NO meta at all."""
        failed = cntl.failed()
        payload = b"" if failed else response
        meta = None
        if failed and cntl.error_text:
            meta = Meta(error_text=cntl.error_text)
        if payload and cntl.compress_type:
            # response-compression floor: tiny payloads skip the codec and
            # travel uncompressed (the reference's response_compress_type
            # discipline)
            if len(payload) >= int(get_flag("native_compress_min_bytes")):
                if meta is None:
                    meta = Meta()
                meta.compress = cntl.compress_type
                payload = compress_mod.compress(cntl.compress_type, payload)
        attachment = b"" if failed else cntl.response_attachment
        if attachment and meta is None:
            meta = Meta()
        data = pack_frame_iobuf(
            meta,
            payload,
            cntl.call_id,
            flags=FLAG_RESPONSE,
            error_code=cntl.error_code,
            attachment=attachment,
        )
        rc = sock.write(data)
        if rc != 0:
            logger.warning("response write to %s failed: %s", sock.remote, berror(rc))


def process_request(sock, frame: ParsedFrame) -> None:
    """Global tbus_std Protocol.process_request hook: route to the server
    that accepted this connection (the reference reaches the Server through
    the Socket's user field)."""
    server: Optional[Server] = sock.context.get("server")
    if server is None:
        logger.warning("request frame on %r with no owning server", sock)
        return
    server.process_request(sock, frame)


proto_pkg.TBUS_STD.process_request = process_request
