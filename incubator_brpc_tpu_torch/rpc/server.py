"""Server — service registry + lifecycle + admission (reference
src/brpc/server.{h,cpp}: StartInternal server.cpp:690, method map
server.cpp:1209, MethodStatus admission details/method_status.h:90-97).

Request flow (mirrors SURVEY.md §3.2):
  Acceptor IN event → Socket reader fiber → InputMessenger cut
    → tbus_std.process_request (bound below)
      ├ look up the server via sock.context (the reference reaches it
      │ through the Socket's user object)
      ├ shed a request whose propagated deadline expired (EDEADLINE)
      ├ the fault injector's dispatch seam (error / delay / close)
      ├ ELOGOFF when stopping or in lame duck; ERPCAUTH on a bad credential
      ├ find the method, ENOSERVICE/ENOMETHOD on miss
      ├ admission: the server-wide then the per-method limiter (ELIMIT)
      ├ decompress, sample into rpc_dump, build the server Controller
      └ run the handler; done → _send_response (compress, pack,
        Socket.write, MethodStatus latency bvars and limiter feedback)

A handler is ``handler(cntl, request: bytes) -> Optional[bytes]``:
  - return bytes: the response payload (sync style);
  - return None after calling ``cntl.set_async()``: the handler owns the
    response and must call ``cntl.send_response(payload)`` later — the
    reference's done-closure style (baidu_rpc_protocol.cpp:490-503).
Errors: ``cntl.set_failed(code, text)`` → an error frame, payload dropped.

The port's copy of the JAX package's ``rpc/server.py`` over tbus_std. It
serves the policies of ROADMAP A7: ``max_concurrency`` and
``method_max_concurrency`` (an int, or ``"auto"`` for the gradient limiter
of ``rpc/concurrency_limiter.py``; ``reset_max_concurrency`` and
``set_method_max_concurrency`` retune them live), ``auth``
(``rpc/auth.py``), ``fault_injector`` (``rpc/fault_injector.py``),
``idle_timeout_s`` (the idle reaper), the session and thread-local data
factories (``rpc/data_pool.py``), request dumps (``rpc/dump.py``), and the
lame duck (``enter_lame_duck``; SIGTERM with ``graceful_quit_on_sigterm``).
Each request is answered in the protocol it arrived in: tbus_std or
baidu_std (``_send_response`` looks the packer up in the protocol
registry), and HTTP through ``builtin/pages.handle``: the ``/health`` and
``/quitquitquit`` pages, handlers added with ``add_http_handler``
(``progressive=True`` streams a chunked upload into the handler), restful
mappings (``add_service(restful_mappings=)``) and the
``/<service>/<method>`` gateway (``invoke_for_http``: the same method map,
admission gates and session data as the binary route, JSON transcoded
through a json2pb schema where the handler carries one). Both the binary
route and the gateway open an rpcz server span (``builtin/rpcz.py``; the
binary route annotates it "processing"), the handler runs inside it (a
nested client call parents to it), and every started server with builtin
services registers with ``builtin/portal.py`` for the portal's pages. TLS
(ROADMAP A10) and the other protocols (A11) are later items. The method map (``_MethodMap``) is keyed on the
native FlatMap of the port's host runtime. A server listens on the Python
acceptor, or with ``ServerOptions(native_plane=True)`` on the C++ reactors
of ``transport/native_plane.py`` (``num_reactors``, alias
``native_loops``; ``native_dispatch_workers``): tbus_std and baidu_std
frames to natively registered methods (``native_echo``, ``native_nop``,
``native_method_lib``) are answered in C++ under their per-method limit
(an adaptive limit is pushed into the C++ table as it moves, and the
telemetry drain's completions feed the limiters back) and behind its auth
seam (a token table, or one verdict a connection from the authenticator),
every other frame through ``process_request`` as on the Python plane, and
a connection speaking HTTP is handed to a Python socket. A constant
server-wide limit keeps every method on the Python route, where it runs. Where the host
runtime did not build, or the C++ listener cannot take the address,
``start`` logs why and listens on the Python acceptor. The collective
services (``_tpu_transport.collective`` and
``_tpu_transport.collective_dispatch``, ``parallel/mc_collective.py`` and
``parallel/mc_dispatch.py``) are registered at ``start`` where
``enable_collective_service`` asks for them, or by default where this
process joined a job (``utils/distributed.current_job()``); each admits at
most ``collective_max_concurrency`` session runs at once (ELIMIT past it;
0 = unlimited; ``mc_dispatch.RunLimit``: accepts and aborts are never
refused, where the JAX package's method limit refuses them too), so they
carry no per-method limiter here. A handler accepts a streaming RPC with
``rpc.stream.stream_accept(cntl)``; the accepted stream's id rides the
response meta, and a handler that fails after accepting kills the stream.
The device-link handshake (``_tpu_transport.handshake``,
``transport/device_link.py``; with ``controller="multi"``,
``transport/mc_link.py``) is registered at ``start``; ``stop`` closes
every link the server accepted.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
import weakref
from typing import Callable, Dict, Optional, Union

import torch

from incubator_brpc_tpu_torch import protocol as proto_pkg
from incubator_brpc_tpu_torch.builtin import portal
from incubator_brpc_tpu_torch.builtin.rpcz import clear_parent_span, end_server_span, start_server_span
from incubator_brpc_tpu_torch.bvar import Adder, LatencyRecorder, PassiveStatus
from incubator_brpc_tpu_torch.protocol import compress as compress_mod
from incubator_brpc_tpu_torch.protocol.tbus_std import Meta, ParsedFrame
from incubator_brpc_tpu_torch.rpc import stream as stream_mod
from incubator_brpc_tpu_torch.rpc.auth import server_check
from incubator_brpc_tpu_torch.rpc.concurrency_limiter import (
    AutoConcurrencyLimiter,
    create_concurrency_limiter,
)
from incubator_brpc_tpu_torch.rpc.controller import Controller, refuse_unported
from incubator_brpc_tpu_torch.rpc.data_pool import SimpleDataPool
from incubator_brpc_tpu_torch.rpc.deadline import pop_deadline, push_deadline

# imported at module scope so the rpc_dump* flags exist before the first
# request arrives
from incubator_brpc_tpu_torch.rpc.dump import maybe_dump_request
from incubator_brpc_tpu_torch.rpc.fault_injector import ACTION_CLOSE, ACTION_ERROR
from incubator_brpc_tpu_torch.runtime.timer_thread import global_timer_thread
from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool
from incubator_brpc_tpu_torch.transport.acceptor import Acceptor
from incubator_brpc_tpu_torch.transport.messenger import InputMessenger
from incubator_brpc_tpu_torch.utils.device import DeviceLike, resolve_device
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint, str2endpoint
from incubator_brpc_tpu_torch.utils.flags import define_flag, get_flag
from incubator_brpc_tpu_torch.utils.status import ErrorCode, berror

logger = logging.getLogger(__name__)

define_flag(
    "lame_duck_grace_s",
    10.0,
    "default grace window for Server.enter_lame_duck / SIGTERM graceful "
    "quit: in-flight RPCs and open collective sessions get this long to "
    "drain before the hard stop",
    lambda v: v > 0,
)
define_flag(
    "graceful_quit_on_sigterm",
    False,
    "SIGTERM triggers a lame-duck drain (stop accepting, drain in-flight "
    "work for lame_duck_grace_s, then stop) instead of the default abrupt "
    "death — the reference's graceful_quit_on_sigterm gflag (server.cpp)",
    lambda v: True,
)

# Requests shed because their PROPAGATED deadline (meta timeout_ms) expired
# before the method could be dispatched — expired-at-arrival and
# expired-mid-queue both count here.
deadline_shed_count = Adder(name="deadline_shed_count")

# every started Server, for the SIGTERM graceful-quit fan-out (weak: a
# leaked reference here must never pin a stopped server)
_started_servers: "weakref.WeakSet" = weakref.WeakSet()
_sigterm_state = {"installed": False, "prev": None}


def _on_sigterm(signum, frame) -> None:
    """SIGTERM with graceful_quit_on_sigterm: lame-duck every running
    server, then (once all drains finish) hand the signal to whatever was
    installed before us so the process still dies."""
    servers = [s for s in list(_started_servers) if s.running]
    logger.info("SIGTERM: lame-duck draining %d server(s)", len(servers))

    def _drain_all() -> None:
        threads = [s.enter_lame_duck() for s in servers]
        for t in threads:
            if t is not None:
                t.join()
        prev = _sigterm_state.get("prev")
        try:
            signal.signal(signal.SIGTERM, prev if callable(prev) else signal.SIG_DFL)
        except (ValueError, TypeError):
            pass
        os.kill(os.getpid(), signal.SIGTERM)  # now dies the default death

    threading.Thread(target=_drain_all, name="tbtorch-sigterm-lame-duck", daemon=True).start()


def _maybe_install_sigterm() -> None:
    if _sigterm_state["installed"] or not get_flag("graceful_quit_on_sigterm"):
        return
    try:
        _sigterm_state["prev"] = signal.signal(signal.SIGTERM, _on_sigterm)
        _sigterm_state["installed"] = True
    except ValueError:
        # signal() only works on the main thread; a server started from a
        # worker keeps the flag's promise best-effort
        logger.warning(
            "graceful_quit_on_sigterm: cannot install the SIGTERM handler off the main thread"
        )


class MethodStatus:
    """Per-method concurrency gate + latency stats
    (details/method_status.h:28,90-97: _nprocessing fetch_add vs the
    ConcurrencyLimiter; latency bvars fed in OnResponded).

    ``max_concurrency`` accepts an int (0 = unlimited) or ``"auto"`` —
    the adaptive gradient limiter (policy/auto_concurrency_limiter.cpp)
    fed from this method's own completion samples. ``on_limit_change``
    is forwarded to an auto limiter so the server can push adaptive
    limits into the native plane."""

    def __init__(
        self,
        full_name: str,
        max_concurrency: Union[int, str] = 0,
        on_limit_change=None,
    ):
        self.full_name = full_name
        self._on_limit_change = on_limit_change
        self._limiter = create_concurrency_limiter(max_concurrency, on_limit_change=on_limit_change)
        self._nprocessing = 0
        self._lock = threading.Lock()
        self.latency = LatencyRecorder(name=f"method_{full_name}_latency")
        self.nerror = Adder(name=f"method_{full_name}_error")

    @property
    def processing(self) -> int:
        return self._nprocessing

    @property
    def max_concurrency(self) -> int:
        """Current limit (adaptive limiters move it); 0 = unlimited."""
        return self._limiter.max_concurrency() if self._limiter else 0

    @max_concurrency.setter
    def max_concurrency(self, value: Union[int, str]) -> None:
        self._limiter = create_concurrency_limiter(value, on_limit_change=self._on_limit_change)

    @property
    def limiter(self):
        return self._limiter

    def on_requested(self) -> bool:
        with self._lock:
            self._nprocessing += 1
            current = self._nprocessing
        if self._limiter is not None and not self._limiter.on_requested(current):
            with self._lock:
                self._nprocessing -= 1
            return False
        return True

    def on_responded(self, error_code: int, latency_us: float) -> None:
        with self._lock:
            self._nprocessing -= 1
        if self._limiter is not None:
            self._limiter.on_responded(error_code, latency_us)
        if error_code == 0:
            self.latency << latency_us
        else:
            self.nerror << 1


class MethodProperty:
    __slots__ = ("handler", "status", "full_name")

    def __init__(self, handler: Callable, status: MethodStatus, full_name: str):
        self.handler = handler
        self.status = status
        self.full_name = full_name


class _MethodMap:
    """Method table on the native open-addressing FlatMap (csrc/host/tbutil
    tb_flatmap; reference server.cpp:1209 builds _method_map on
    butil::FlatMap for the same hot lookup). Keys are a 64-bit double-CRC
    of the full name (crc32c | crc32<<32: two polynomials, so a clash needs
    both to collide); values index a list of the MethodProperty objects,
    each verified by name on a hit. A str-keyed dict remains for
    registration, iteration, and the double-collision overflow (and is the
    whole map where the host runtime did not build)."""

    def __init__(self) -> None:
        from incubator_brpc_tpu_torch import native

        self._by_name: Dict[str, MethodProperty] = {}
        self._props: list = []
        self._fm = native.FlatMap(64) if native.NATIVE_AVAILABLE else None
        self._crc32 = native.crc32
        self._crc32c = native.crc32c

    def _key(self, name: str) -> int:
        b = name.encode()
        return self._crc32c(b) | (self._crc32(b) << 32)

    def insert(self, full: str, prop: MethodProperty) -> None:
        self._by_name[full] = prop
        if self._fm is not None:
            key = self._key(full)
            if key not in self._fm:  # double-collision -> dict overflow
                self._fm[key] = len(self._props)
                self._props.append(prop)

    def get(self, full: str) -> Optional[MethodProperty]:
        if self._fm is not None:
            idx = self._fm.get(self._key(full))
            if idx is not None:
                prop = self._props[idx]
                if prop.full_name == full:
                    return prop
        return self._by_name.get(full)

    def __contains__(self, full: str) -> bool:
        return self.get(full) is not None

    def __iter__(self):
        return iter(self._by_name)

    def items(self):
        return self._by_name.items()

    def as_dict(self) -> Dict[str, MethodProperty]:
        return dict(self._by_name)


# worker-thread context while user code runs: powers the argless
# ``thread_local_data()`` (the reference's brpc::thread_local_data() reads
# an equivalent per-thread slot set by the server loop)
_usercode_tls = threading.local()


def thread_local_data():
    """Pooled per-thread data of the server whose handler is running on
    this thread (reference brpc::thread_local_data(), server.h:55-239).
    None outside a handler or when the server has no
    thread_local_data_factory."""
    server = getattr(_usercode_tls, "server", None)
    return server.thread_local_data() if server is not None else None


class ServerOptions:
    """Reference ServerOptions (server.h:55-239) with the reference's
    parameters in the reference's order, so a positional call binds as it
    binds there. The port serves the admission limits (``max_concurrency``,
    ``method_max_concurrency``: an int, 0 = unlimited, or ``"auto"``),
    ``idle_timeout_s``, ``auth``, ``usercode_inline``, ``device_index``, the
    native plane's ``native_plane``, ``num_reactors`` (``native_loops`` is
    its alias, a live property) and ``native_dispatch_workers``, the
    session and thread-local data factories with their reservations, the
    collective services' options and ``fault_injector``;
    ``has_builtin_services`` switches the builtin pages of the HTTP portal
    (``builtin/pages.py``: the JAX package's whole table). Every other
    parameter keeps
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
            ("nshead_service", nshead_service, None, "A11"),
            ("thrift_service", thrift_service, None, "A11"),
            ("mongo_service_adaptor", mongo_service_adaptor, None, "A11"),
            ("rtmp_service", rtmp_service, None, "A11"),
            ("ssl_context", ssl_context, None, "A10"),
        )
        for name, value, default, item in unported:
            if value != default:
                refuse_unported("ServerOptions", name, value, item)
        # int (0 = unlimited) or "auto" — the adaptive gradient limiter
        # (reference AdaptiveMaxConcurrency, server.h + policy/
        # auto_concurrency_limiter.cpp) applied server-wide / per-method
        self.max_concurrency = max_concurrency
        self.method_max_concurrency = method_max_concurrency
        # rpc/fault_injector.FaultInjector: scripted brownouts at the
        # frame-dispatch seam (error/delay/close before the handler runs);
        # acts only while the ``fault_injection`` master flag is on
        self.fault_injector = fault_injector
        # close connections with no wire activity for this long (<= 0 off),
        # on both planes
        self.idle_timeout_s = idle_timeout_s
        # the HTTP portal's builtin pages (builtin/pages.py)
        self.has_builtin_services = has_builtin_services
        self.auth = auth  # Authenticator (rpc/auth.py)
        # Run request processing (cut + handler) inline on the reactor
        # thread instead of a pool fiber — removes two thread handoffs per
        # request. ONLY for services whose handlers never block: a blocking
        # handler stalls every connection hashed to the same dispatcher.
        self.usercode_inline = usercode_inline
        # serve this port from the native C++ reactors (csrc/host/tbnet):
        # tbus_std frames cut, checked and, for natively registered
        # methods, answered without the interpreter; the rest through
        # process_request (transport/native_plane.py)
        self.native_plane = native_plane
        # reactor count of the native plane (None = one a core, at most
        # 16); ``native_loops`` is the legacy spelling of the same knob
        self.num_reactors = num_reactors if num_reactors is not None else native_loops
        # work-stealing dispatch pool threads for native methods marked
        # long-running (0 = every native method runs on its reactor)
        self.native_dispatch_workers = native_dispatch_workers
        # device this server binds for transport='tpu' links (None = pick a
        # neighbor of the client's device; the reference's use_rdma slot)
        self.device_index = device_index
        # Pooled per-connection user data (reference
        # ServerOptions.session_local_data_factory + simple_data_pool):
        # lazily borrowed on first cntl.session_local_data() per
        # connection, returned to the pool when the connection dies,
        # reused by the next one. The factory is an object with
        # create()/destroy(obj) or a zero-arg callable.
        self.session_local_data_factory = session_local_data_factory
        self.reserved_session_local_data = reserved_session_local_data
        # Pooled per-worker-thread user data (reference
        # thread_local_data_factory + brpc::thread_local_data()): one
        # object per thread that runs this server's handlers, created on
        # first thread_local_data() there, destroyed at server stop.
        self.thread_local_data_factory = thread_local_data_factory
        self.reserved_thread_local_data = reserved_thread_local_data
        # Serve the collective session plane's proposals
        # (``_tpu_transport.collective`` and ``.collective_dispatch``):
        # True/False, or None = on where this process joined a job at
        # ``Server.start`` (the deployment where sessions rendezvous).
        self.enable_collective_service = enable_collective_service
        # per-method admission limit of the collective services (0 =
        # unlimited); sessions past it are refused with ELIMIT
        self.collective_max_concurrency = collective_max_concurrency
        self.device = device

    @property
    def native_loops(self) -> Optional[int]:
        """Legacy spelling of ``num_reactors``: a live alias, so code that
        assigns ``opts.native_loops = N`` after construction still steers
        the reactor count."""
        return self.num_reactors

    @native_loops.setter
    def native_loops(self, value: Optional[int]) -> None:
        self.num_reactors = value


class Server:
    def __init__(self, options: Optional[ServerOptions] = None):
        self.options = options or ServerOptions()
        # server-wide admission limiter (int spec or "auto"); limit moves
        # are pushed to natively registered methods so the C++ dispatch
        # path honors the adaptive limit too
        self._server_limiter = create_concurrency_limiter(
            self.options.max_concurrency, on_limit_change=self._on_server_limit_change
        )
        self._limit_gauges: list = []  # PassiveStatus rows, hidden at stop
        self._methods = _MethodMap()
        self._acceptor: Optional[Acceptor] = None
        self._native_plane = None  # NativeServerPlane when options ask for it
        self._messenger = InputMessenger()
        self._stopping = False
        self._lame_duck = False  # draining: no new work, conns stay up
        self._lame_duck_thread: Optional[threading.Thread] = None
        self._idle_reap_timer_id = None
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
        self._http_handlers: Dict[str, Callable] = {}
        self._http_progressive: set = set()  # routes streaming chunked bodies
        # restful rows: (prefix, postfix, has_wildcard, service, method)
        self._restful: list = []
        # session/thread-local data pools (simple_data_pool.h; built from
        # the option factories at start)
        self._session_pool: Optional[SimpleDataPool] = None
        self._tls_pool: Optional[SimpleDataPool] = None
        self._tls_slots = threading.local()  # .data: per-thread object
        self._tls_borrowed: list = []  # every live thread object (stop cleanup)
        self._session_lock = threading.Lock()  # session borrow/release state

    def device(self) -> torch.device:
        """The device this server's links and device methods use:
        ``options.device`` (the card unless ``"cpu"``), with
        ``options.device_index`` picking the card among several."""
        dev = resolve_device(self.options.device)
        if dev.type == "cuda" and self.options.device_index is not None:
            dev = torch.device("cuda", int(self.options.device_index))
        return dev

    # -- registration --------------------------------------------------------

    def _method_limit_pusher(self, full_name: str) -> Callable[[int], None]:
        """on_limit_change hook for a method's adaptive limiter: keep the
        native plane's per-request limit in step with the Python one."""

        def push(new_limit: int) -> None:
            plane = self._native_plane
            if plane is not None:
                plane.set_native_max_concurrency(full_name, new_limit)

        return push

    def _on_server_limit_change(self, new_limit: int) -> None:
        """The server-wide adaptive limit moved: natively registered
        methods without their own limit follow it (the C++ plane has no
        server-level gate, so the server-wide limit is distributed as a
        per-method ceiling — tb_server_set_native_max_concurrency)."""
        plane = self._native_plane
        if plane is None:
            return
        for full in plane.auto_limit_targets():
            plane.set_native_max_concurrency(full, new_limit)

    def _on_native_completion(
        self,
        full_name: str,
        error_code: int,
        latency_us: float,
        now_us: Optional[int] = None,
    ) -> None:
        """Limiter feedback for a request the C++ plane dispatched and
        answered without the interpreter (drained from the telemetry
        ring). Feeds the same AutoConcurrencyLimiters the Python route's
        _release feeds, so a wholly native server's adaptive limit tracks
        load instead of holding its last pushed value. Admission refusals
        (ELIMIT) never reach here: the Python route does not call
        on_responded for refused requests either. ``now_us`` is the
        completion's monotonic timestamp from the record itself, so batch
        drains keep the limiter's sampling windows honest."""
        prop = self._methods.get(full_name)
        if prop is not None and prop.status.limiter is not None:
            prop.status.limiter.on_responded(error_code, latency_us, now_us)
        if self._server_limiter is not None:
            self._server_limiter.on_responded(error_code, latency_us, now_us)

    def add_service(
        self,
        name: str,
        handlers: Dict[str, Callable],
        max_concurrency: Union[int, str, None] = None,
        restful_mappings: str = "",
    ) -> None:
        """Register ``name.method → handler`` rows (Server::AddService builds
        the same flat _method_map, server.cpp:1209). ``max_concurrency``
        (an int or ``"auto"``) limits each of these methods; None takes
        ``options.method_max_concurrency``.

        ``restful_mappings`` exposes methods on custom HTTP paths instead
        of the gateway's /<service>/<method> (reference
        ServiceOptions.restful_mappings, server.h:255-260 + restful.cpp):
        ``"PATH1 => NAME1, PATH2 => NAME2"`` where a PATH may carry one
        ``*`` wildcard (``/v1/*/echo``, ``*.flv``)."""
        if self._started:
            raise RuntimeError("add_service after start")
        # validate EVERYTHING before mutating: a ValueError must leave no
        # partially-registered service behind
        restful_rows = (
            self._parse_restful_mappings(name, handlers, restful_mappings)
            if restful_mappings else []
        )
        for method in handlers:
            if f"{name}.{method}" in self._methods:
                raise ValueError(f"method {name}.{method} already registered")
        mc = max_concurrency if max_concurrency is not None else self.options.method_max_concurrency
        for method, handler in handlers.items():
            full = f"{name}.{method}"
            status = MethodStatus(full, mc, on_limit_change=self._method_limit_pusher(full))
            self._methods.insert(full, MethodProperty(handler, status, full))
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
        self._restful.extend(restful_rows)

    def _parse_restful_mappings(
        self, service: str, handlers: Dict[str, Callable], mappings: str
    ) -> list:
        rows: list = []
        for pair in mappings.split(","):
            pair = pair.strip()
            if not pair:
                continue
            if "=>" not in pair:
                raise ValueError(f"restful mapping {pair!r} lacks '=>'")
            path, _, method = pair.partition("=>")
            path, method = path.strip(), method.strip()
            if method not in handlers:
                raise ValueError(
                    f"restful mapping {pair!r}: no method {method!r} in "
                    f"service {service!r}"
                )
            if path.count("*") > 1:
                raise ValueError(f"restful path {path!r} has more than one wildcard")
            prefix, star, postfix = path.partition("*")
            key = (prefix, postfix, bool(star))
            for p2, q2, w2, s2, m2 in self._restful + rows:
                if (p2, q2, w2) == key:
                    # the reference's RestfulMap rejects conflicts at
                    # AddService time rather than letting a dead mapping
                    # linger (restful.cpp AddMethod)
                    raise ValueError(f"restful path {path!r} already mapped to {s2}.{m2}")
            rows.append((prefix, postfix, bool(star), service, method))
        return rows

    def find_restful(self, path: str) -> Optional[tuple]:
        """(service, method) for a restful-mapped path, most-specific
        (longest prefix+postfix) wildcard match winning — the RestfulMap
        ordering (restful.cpp)."""
        best = None
        best_len = -1
        for prefix, postfix, wild, service, method in self._restful:
            if not wild:
                if path == prefix:
                    return service, method  # exact always wins
                continue
            if (
                len(path) >= len(prefix) + len(postfix)
                and path.startswith(prefix)
                and path.endswith(postfix)
            ):
                score = len(prefix) + len(postfix)
                if score > best_len:
                    best, best_len = (service, method), score
        return best

    def add_http_handler(self, path: str, handler: Callable, progressive: bool = False) -> None:
        """Register an HTTP handler ``fn(HttpFrame) -> (status, content_type,
        body_bytes)`` at an exact path or a prefix ending in '/'. Builtin
        portal pages win on conflicts (the reference forbids shadowing
        builtins too, server.cpp AddBuiltinServices).

        ``progressive=True``: chunked uploads to this route dispatch the
        handler at header time with ``frame.body`` set to a
        ``protocol.http.ProgressiveReader`` — the handler consumes the
        body while it is still arriving (the reference's ProgressiveReader,
        progressive_reader.h). Content-Length requests to the same route
        still deliver plain bytes."""
        if self._started:
            raise RuntimeError("add_http_handler after start")
        self._http_handlers[path] = handler
        if progressive:
            self._http_progressive.add(path)

    def find_http_handler(self, path: str) -> Optional[Callable]:
        h = self._http_handlers.get(path)
        if h is not None:
            return h
        for prefix, handler in self._http_handlers.items():
            if prefix.endswith("/") and path.startswith(prefix):
                return handler
        return None

    def is_progressive_route(self, path: str) -> bool:
        """Does a chunked upload to ``path`` stream to its handler?"""
        if path in self._http_progressive:
            return True
        return any(p.endswith("/") and path.startswith(p) for p in self._http_progressive)

    def has_method(self, full_name: str) -> bool:
        """Cheap membership check (the gateway route test — methods() copies
        the whole map)."""
        return full_name in self._methods

    def methods(self) -> Dict[str, MethodProperty]:
        return self._methods.as_dict()

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
        if self.options.session_local_data_factory is not None:
            self._session_pool = SimpleDataPool(
                self.options.session_local_data_factory,
                reserved=self.options.reserved_session_local_data,
            )
        if self.options.thread_local_data_factory is not None:
            self._tls_pool = SimpleDataPool(
                self.options.thread_local_data_factory,
                reserved=self.options.reserved_thread_local_data,
            )
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
            self._methods.insert(hs, MethodProperty(make_handshake_handler(self), MethodStatus(hs), hs))
        # the collective session plane shares the transport service: OPT-IN,
        # on by default only in a job (the probe runs once, at start: a
        # process that joins a job after starting its server passes
        # enable_collective_service=True), its runs behind RunLimit
        enable_co = self.options.enable_collective_service
        if enable_co is None:
            from incubator_brpc_tpu_torch.utils.distributed import current_job

            enable_co = current_job() is not None
        if enable_co:
            from incubator_brpc_tpu_torch.parallel.mc_collective import (
                COLLECTIVE_METHOD,
                make_collective_handler,
            )
            from incubator_brpc_tpu_torch.parallel.mc_dispatch import (
                DISPATCH_METHOD,
                make_dispatch_handler,
            )

            for name, make in ((COLLECTIVE_METHOD, make_collective_handler),
                               (DISPATCH_METHOD, make_dispatch_handler)):
                full = f"{HANDSHAKE_SERVICE}.{name}"
                if full not in self._methods:
                    self._methods.insert(full, MethodProperty(make(self), MethodStatus(full), full))
        if isinstance(listen, int):
            ep = EndPoint(ip="127.0.0.1", port=listen)
        elif isinstance(listen, str):
            ep = str2endpoint(listen)
        else:
            ep = listen
        plane = self._start_native_plane(ep) if self.options.native_plane else None
        if plane is not None:
            self._native_plane = plane
            self.listen_endpoint = EndPoint(ip=ep.ip, port=plane.port)
            # adaptive limits reach the C++ dispatch path from the start:
            # seed every natively registered method with the current
            # server-wide auto limit (updates follow via on_limit_change)
            if isinstance(self._server_limiter, AutoConcurrencyLimiter):
                self._on_server_limit_change(self._server_limiter.max_concurrency())
            for full, prop in self._methods.items():
                if isinstance(prop.status.limiter, AutoConcurrencyLimiter):
                    plane.set_native_max_concurrency(full, prop.status.max_concurrency)
        else:
            self._acceptor = Acceptor(
                ep,
                messenger=self._messenger,
                conn_context={"server": self},
                inline_read=self.options.usercode_inline,
            )
            self.listen_endpoint = self._acceptor.endpoint
        self._stopping = False
        self._idle_reap_timer_id = None
        self._started = True
        if self.options.idle_timeout_s is not None and self.options.idle_timeout_s > 0:
            # enforced on BOTH planes: the Python acceptor scan, and
            # tb_server_close_idle for native ports
            self._schedule_idle_reap()
        if self.options.has_builtin_services:
            portal.register_server(self)
        self._expose_limiter_gauges()
        _started_servers.add(self)
        _maybe_install_sigterm()
        logger.info("server started on %s", self.listen_endpoint)
        return True

    def _start_native_plane(self, ep: EndPoint):
        """The listening NativeServerPlane, or None with the reason logged
        (the JAX package's fallbacks: no host runtime, a unix endpoint, or
        an address the AF_INET-only C++ listener cannot take)."""
        from incubator_brpc_tpu_torch import native
        from incubator_brpc_tpu_torch.transport import native_plane as np_mod

        if not np_mod.NET_AVAILABLE:
            logger.warning(
                "native plane unavailable (the host runtime did not build: %s); "
                "serving %s on the Python acceptor", native.BUILD_ERROR, ep,
            )
            return None
        if ep.ip.startswith("unix://"):
            logger.warning("native plane has no unix sockets; serving %s on the Python acceptor", ep)
            return None
        plane = np_mod.NativeServerPlane(
            self, self.options.num_reactors, dispatch_workers=self.options.native_dispatch_workers
        )
        try:
            plane.register_methods()
            plane.listen(ep.ip, ep.port)
        except OSError as e:
            logger.warning(
                "native plane cannot listen on %s (%s); falling back to the Python acceptor", ep, e
            )
            plane.stop()
            return None
        return plane

    def _expose_limiter_gauges(self) -> None:
        """Scrapeable adaptive-limit state: one gauge per auto limiter
        (server-wide + per-method), port-scoped since one process runs
        many servers. Hidden at stop so the names free up."""
        port = self.port
        if isinstance(self._server_limiter, AutoConcurrencyLimiter):
            self._limit_gauges.append(
                PassiveStatus(self._server_limiter.max_concurrency,
                              name=f"server_{port}_max_concurrency")
            )
        for full, prop in self._methods.items():
            lim = prop.status.limiter
            if isinstance(lim, AutoConcurrencyLimiter):
                self._limit_gauges.append(
                    PassiveStatus(lim.max_concurrency, name=f"server_{port}_{full}_max_concurrency")
                )

    def _schedule_idle_reap(self) -> None:
        if self._stopping:
            # a scan that was mid-flight when stop() ran must not re-arm
            return
        # scan at half the timeout so a connection is reaped at most 1.5x
        # late (the reference's idle-connection reaper,
        # Acceptor::CloseIdleConnections acceptor.cpp:111). The timer
        # callback only spawns — set_failed does syscalls and runs user
        # on_failed hooks, too heavy for the shared TimerThread. The id is
        # kept so stop() can cancel the parked scan.
        delay = max(0.05, self.options.idle_timeout_s / 2)
        self._idle_reap_timer_id = global_timer_thread().schedule(
            lambda: global_worker_pool().spawn(self._reap_idle), delay=delay
        )

    def _reap_idle(self) -> None:
        # _stopping ends the chain; servers are not restartable
        if self._stopping:
            return
        if self._acceptor is not None:
            cutoff = time.monotonic() - self.options.idle_timeout_s
            for sock in self._acceptor.connections():
                if sock.last_active < cutoff:
                    sock.set_failed(ErrorCode.ECLOSE, f"idle for > {self.options.idle_timeout_s}s")
        if self._native_plane is not None:
            culled = self._native_plane.close_idle(self.options.idle_timeout_s)
            if culled:
                logger.info(
                    "reaped %d idle native connection(s) (> %gs)", culled, self.options.idle_timeout_s
                )
        self._schedule_idle_reap()

    def enter_lame_duck(self, grace_s: Optional[float] = None) -> Optional[threading.Thread]:
        """Lame-duck drain (the reference's graceful quit → Server::Stop
        (grace) path): stop accepting NEW connections (the listener closes,
        so redials are refused and a balanced client routes elsewhere),
        answer NEW requests on existing connections with ELOGOFF
        (retriable — a balanced client lands on another replica), let
        in-flight RPCs, open collective sessions and open streams finish
        within ``grace_s`` (default: the ``lame_duck_grace_s`` flag), then
        hard-stop. Returns the drain thread (join it to observe the full
        lifecycle), or None if the server wasn't running. ``/health``
        answers 503 through the drain, and ``/quitquitquit`` triggers it
        over HTTP (builtin/pages.py)."""
        if not self._started or self._stopping:
            return None
        with self._lock:
            if self._lame_duck:
                return self._lame_duck_thread
            self._lame_duck = True
        grace = float(get_flag("lame_duck_grace_s")) if grace_s is None else float(grace_s)
        # scrapeable drain marker; dies with the other gauges at stop
        self._limit_gauges.append(
            PassiveStatus(
                lambda: 1 if self._lame_duck and not self._stopping else 0,
                name=f"server_{self.port}_lame_duck",
            )
        )
        if self._acceptor is not None:
            self._acceptor.pause()
        if self._native_plane is not None:
            self._native_plane.pause_accept()
        logger.info("server %s entering lame duck (grace %.1fs)", self.listen_endpoint, grace)
        t = threading.Thread(
            target=self._drain_then_stop,
            args=(grace,),
            name=f"tbtorch-lame-duck-{self.port}",
            daemon=True,
        )
        self._lame_duck_thread = t
        t.start()
        return t

    def _drain_then_stop(self, grace_s: float) -> None:
        from incubator_brpc_tpu_torch.parallel.mc_dispatch import active_sessions

        deadline = time.monotonic() + grace_s
        with self._quiescent:
            self._quiescent.wait_for(
                lambda: self._nprocessing == 0, timeout=max(0.0, deadline - time.monotonic())
            )
        # open collective sessions pin devices across the fabric, and open
        # streaming RPCs are in-flight work with no _nprocessing footprint:
        # both get the rest of the grace window before the hard stop
        while (active_sessions(owner=self) > 0 or self._open_streams()) and time.monotonic() < deadline:
            time.sleep(0.02)
        stragglers = self._open_streams()
        if stragglers:
            # grace expired under live streams: RST them NOW so each
            # peer's writer stops on a clean frame
            logger.warning("lame-duck grace expired with %d open stream(s); sending RST", len(stragglers))
            for st in stragglers:
                try:
                    st.rst(ErrorCode.ELOGOFF, "server drained (lame duck)")
                except Exception:
                    logger.exception("lame-duck stream RST raised")
        drained = self._nprocessing == 0 and active_sessions(owner=self) == 0 and not stragglers
        if not drained:
            logger.warning(
                "lame-duck grace %.1fs expired with work still in flight (%d rpcs, %d sessions); "
                "hard-stopping", grace_s, self._nprocessing, active_sessions(owner=self),
            )
        else:
            # linger briefly before the hard stop: responses written in the
            # last instants (the final ELOGOFFs included) are still in
            # socket buffers — closing under them would turn a clean drain
            # into client-side resets
            time.sleep(min(0.25, max(0.0, deadline - time.monotonic())))
        self.stop()
        self.join(timeout=max(0.5, deadline - time.monotonic()))

    def _open_streams(self):
        """Live streaming RPCs bound to this server's connections — the
        third kind of in-flight work the lame-duck drain waits on (the
        first two: ``_nprocessing`` handlers, collective sessions)."""
        if self._acceptor is None:
            return []
        try:
            conns = list(self._acceptor.connections())
        except Exception:
            return []
        return stream_mod.open_streams(conns)

    @property
    def lame_duck(self) -> bool:
        """True while this server drains toward stop (new work is refused
        with ELOGOFF, existing work finishes)."""
        return self._lame_duck

    def stop(self) -> None:
        """Stop accepting + fail connections; in-flight handlers finish
        (Server::Stop then Join, server.cpp)."""
        if not self._started:
            return
        self._stopping = True
        _started_servers.discard(self)
        tid = self._idle_reap_timer_id
        if tid is not None:
            self._idle_reap_timer_id = None
            global_timer_thread().unschedule(tid)
        for g in self._limit_gauges:
            try:
                g.hide()
            except Exception:
                pass
        self._limit_gauges.clear()
        if self._acceptor is not None:
            self._acceptor.stop()
        if self._native_plane is not None:
            self._native_plane.stop()
        for ds in list(self._device_socks):
            try:
                ds.set_failed(ErrorCode.ECLOSE, "server stopped")
            except Exception:
                logger.exception("device link teardown raised")
        self._device_socks.clear()
        if self.options.has_builtin_services:
            portal.unregister_server(self)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait until every in-flight request finished; a stopped server's
        factory-made user data is destroyed once its handlers drained."""
        with self._quiescent:
            ok = self._quiescent.wait_for(lambda: self._nprocessing == 0, timeout=timeout)
        # only when the server is actually stopping AND the drain finished:
        # a timed-out join leaves live handlers that still hold the objects
        if ok and self._stopping:
            if self._tls_pool is not None:
                with self._lock:
                    borrowed, self._tls_borrowed = self._tls_borrowed, []
                for obj in borrowed:
                    self._tls_pool.give_back(obj)
                self._tls_pool.destroy_all()
            if self._session_pool is not None:
                self._session_pool.destroy_all()
        return ok

    # -- session/thread-local user data (server.h:55-239) -------------------

    def session_local_data(self, sock):
        """Per-connection pooled data: borrowed from the pool on this
        connection's first access, pinned on the socket, given back when
        the connection dies (Controller::session_local_data). Give-back is
        guarded by a per-socket handler refcount: a connection that dies
        while its handler is still running must NOT pool the object out
        from under it — release defers to the last handler's exit."""
        if self._session_pool is None or sock is None:
            return None
        from incubator_brpc_tpu_torch.transport.sock import CONNECTED

        ctx = sock.context
        with self._session_lock:
            # first access is serialized: two pipelined requests on one
            # connection share ONE object
            obj = ctx.get("_session_local_data")
            if obj is not None:
                return obj
            obj = self._session_pool.borrow()
            ctx["_session_local_data"] = obj
            if sock.state == CONNECTED:
                sock.on_failed.append(self._session_give_back)
            else:
                # failed before the hook could land: the last handler's
                # exit releases it
                ctx["_session_release_pending"] = True
        return obj

    def _session_give_back(self, sock) -> None:
        """on_failed hook: pool the connection's session object — unless a
        handler on this connection is still running, in which case the
        release defers to the last handler's exit."""
        with self._session_lock:
            if sock.context.get("_session_nhandlers", 0) > 0:
                sock.context["_session_release_pending"] = True
                return
            data = sock.context.pop("_session_local_data", None)
        if data is not None:
            self._session_pool.give_back(data)

    def _session_handler_enter(self, sock) -> None:
        if self._session_pool is None or sock is None:
            return
        with self._session_lock:
            ctx = sock.context
            ctx["_session_nhandlers"] = ctx.get("_session_nhandlers", 0) + 1

    def _session_handler_exit(self, sock) -> None:
        if self._session_pool is None or sock is None:
            return
        data = None
        with self._session_lock:
            ctx = sock.context
            n = ctx.get("_session_nhandlers", 1) - 1
            ctx["_session_nhandlers"] = n
            if n <= 0 and ctx.pop("_session_release_pending", False):
                data = ctx.pop("_session_local_data", None)
        if data is not None:
            self._session_pool.give_back(data)

    def thread_local_data(self):
        """Per-worker-thread pooled data for THIS server
        (brpc::thread_local_data(); created on a thread's first call,
        reused for every later request on that thread, destroyed with the
        server)."""
        if self._tls_pool is None:
            return None
        slots = getattr(self._tls_slots, "data", None)
        if slots is None:
            slots = self._tls_pool.borrow()
            self._tls_slots.data = slots
            with self._lock:
                self._tls_borrowed.append(slots)
        return slots

    @property
    def port(self) -> int:
        return self.listen_endpoint.port if self.listen_endpoint else 0

    @property
    def running(self) -> bool:
        return self._started and not self._stopping

    def connection_count(self) -> int:
        """Host connections this server holds open."""
        if self._native_plane is not None:
            return self._native_plane.connection_count()
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
        cntl.trace_id = meta.trace_id
        cntl.span_id = meta.span_id
        cntl.call_id = frame.correlation_id
        cntl.compress_type = meta.compress
        cntl.request_attachment = frame.attachment
        cntl._server = self
        cntl._service = meta.service
        cntl._method = meta.method
        cntl._sock = sock  # stream_accept and session data need the connection
        # answer in the protocol the request arrived in (the reference keys
        # SendRpcResponse off the request's protocol the same way)
        cntl._wire_protocol = frame.wire_protocol
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

        inj = self.options.fault_injector
        if inj is not None and get_flag("fault_injection"):
            # the frame-dispatch seam: a scripted brownout fails, delays
            # (decide() sleeps) or drops this request before the handler
            # runs — the deterministic misbehaving backend the limiter and
            # breaker proofs drive against
            action = inj.decide()
            if action == ACTION_CLOSE:
                sock.set_failed(ErrorCode.ECLOSE, "injected close")
                return
            if action == ACTION_ERROR:
                cntl.set_failed(inj.error_code, "injected fault")
                self.nerror << 1
                self._send_response(sock, cntl, b"")
                return

        if self._stopping or self._lame_duck:
            # a stopping or lame-duck server refuses NEW work with the
            # retriable ELOGOFF; in-flight handlers (admitted before) finish
            cntl.set_failed(ErrorCode.ELOGOFF, berror(ErrorCode.ELOGOFF))
            self._send_response(sock, cntl, b"")
            return
        if self.options.auth is not None and not server_check(meta, sock, self.options.auth):
            cntl.set_failed(ErrorCode.ERPCAUTH, berror(ErrorCode.ERPCAUTH))
            self.nerror << 1
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
        if not self._admit(status):
            cntl.set_failed(ErrorCode.ELIMIT, berror(ErrorCode.ELIMIT))
            self.nerror << 1
            self._send_response(sock, cntl, b"")
            return

        try:
            payload = frame.payload
            if meta.compress:
                payload = compress_mod.decompress(meta.compress, payload)
        except Exception as e:
            cntl.set_failed(ErrorCode.EREQUEST, f"decompress failed: {e}")
            self._finish(sock, cntl, b"", status)
            return
        cntl._request_payload = payload

        maybe_dump_request(meta, payload, frame.attachment)

        cntl._span = start_server_span(cntl, meta)
        if cntl._span is not None:
            cntl._span.annotate("processing")

        # wire the async-response closure before running user code. The
        # closure finishes AT MOST ONCE: the async-reap timer below and a
        # late (or duplicate) send_response from the handler must not both
        # release the admission slot and the session refcount.
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

        self._session_handler_enter(sock)
        cntl._session_entered = True  # paired in _finish
        prev_server = getattr(_usercode_tls, "server", None)
        _usercode_tls.server = self
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
            _usercode_tls.server = prev_server
            # the parent-span window is handler execution on THIS thread;
            # an async completion elsewhere must not leave stale TLS here
            clear_parent_span(cntl._span)
        if cntl._async and not cntl.failed():
            # handler owns the response now — but bound how long it can
            # hold the admission slot and the session refcount
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
        if getattr(cntl, "_session_entered", False):
            cntl._session_entered = False
            self._session_handler_exit(sock)
        if cntl.failed() and cntl._accepted_stream_id:
            # handler accepted a stream then failed: the response will carry
            # stream_id=0, so the client kills its half — kill ours too
            s = stream_mod.get_stream(cntl._accepted_stream_id)
            if s is not None:
                s._fail(cntl.error_code, "rpc failed after stream_accept")
        # the admission slot is released BEFORE the response is written
        # (the JAX package releases after): a client that reads this
        # response and sends its next request at once must not find this
        # call still counted, or a serial caller sees ELIMIT whenever an
        # adaptive limit has come down to 1
        cntl._mark_end()
        self._release(status, cntl)
        self._send_response(sock, cntl, response)
        if cntl.failed():
            self.nerror << 1
        if cntl._span is not None:
            end_server_span(cntl, response_size=len(response))

    # -- admission (method_status.h:90-97) -----------------------------------

    def _admit(self, status: MethodStatus) -> bool:
        """Server-level then per-method gate; True = admitted (the caller
        MUST pair it with _release)."""
        with self._lock:
            self._nprocessing += 1
            current = self._nprocessing
        lim = self._server_limiter
        if (lim is None or lim.on_requested(current)) and status.on_requested():
            return True
        # the server or the method gate refused: undo the server add
        with self._lock:
            self._nprocessing -= 1
            if self._nprocessing == 0:
                self._quiescent.notify_all()
        return False

    def _release(self, status: MethodStatus, cntl: Controller) -> None:
        status.on_responded(cntl.error_code, cntl.latency_us)
        lim = self._server_limiter
        if lim is not None:
            lim.on_responded(cntl.error_code, cntl.latency_us)
        with self._lock:
            self._nprocessing -= 1
            if self._nprocessing == 0:
                self._quiescent.notify_all()

    @property
    def max_concurrency(self) -> int:
        """Current server-wide limit (an auto limiter moves it); 0 =
        unlimited."""
        lim = self._server_limiter
        return lim.max_concurrency() if lim is not None else 0

    @property
    def fault_injector(self):
        return self.options.fault_injector

    @fault_injector.setter
    def fault_injector(self, inj) -> None:
        self.options.fault_injector = inj

    def reset_max_concurrency(self, max_concurrency: Union[int, str]) -> Union[int, str]:
        """Change the server-level concurrency spec while RUNNING
        (reference Server::ResetMaxConcurrency, server.h:483-488): an int
        (0 = unlimited) or "auto" (a FRESH adaptive limiter). Returns the
        previous spec. Takes effect on the next admission check —
        in-flight requests are never evicted. A server that started
        without a constant server-wide limit registered its native-kind
        methods for C++ dispatch, which has no server-level gate: a
        constant limit set later bounds the Python-routed methods only,
        and an adaptive one is pushed per method into the plane as it
        moves."""
        prev = self.options.max_concurrency
        spec: Union[int, str] = (
            max_concurrency if isinstance(max_concurrency, str) else max(0, int(max_concurrency))
        )
        self.options.max_concurrency = spec
        self._server_limiter = create_concurrency_limiter(
            spec, on_limit_change=self._on_server_limit_change
        )
        # re-seed the native plane: leaving the OLD adaptive ceiling in the
        # C++ per-method table would keep shedding at a stale limit; an
        # unlimited or constant spec reverts the followers to 0
        if isinstance(self._server_limiter, AutoConcurrencyLimiter):
            self._on_server_limit_change(self._server_limiter.max_concurrency())
        else:
            self._on_server_limit_change(0)
        return prev

    def set_method_max_concurrency(self, full_name: str, n: Union[int, str]) -> bool:
        """Per-method runtime limit (reference MaxConcurrencyOf setter,
        server.h:490): an int or "auto"; True if the method exists.
        Propagates to the native plane, where the limit is read per
        request."""
        prop = self._methods.get(full_name)
        if prop is None:
            return False
        prop.status.max_concurrency = n if isinstance(n, str) else max(0, int(n))
        plane = self._native_plane
        if plane is not None:
            plane.set_native_max_concurrency(full_name, prop.status.max_concurrency)
            # a method with its OWN limiter must no longer follow the
            # server-wide adaptive pushes; clearing back to unlimited
            # resumes following
            plane.set_auto_limit_target(full_name, prop.status.limiter is None)
        return True

    def method_max_concurrency(self, full_name: str) -> Optional[int]:
        prop = self._methods.get(full_name)
        return prop.status.max_concurrency if prop is not None else None

    def invoke_for_http(self, service: str, method: str, body: bytes, sock=None):
        """The http→rpc gateway body (the reference serves every pb service
        over HTTP at /ServiceName/MethodName via json2pb transcoding,
        http_rpc_protocol.cpp): same method map, same admission gates and
        session data, the request body as payload. Returns (status,
        content_type, bytes).

        Async handlers are waited for up to the reloadable
        ``http_gateway_async_timeout_s`` flag — the wait pins this
        connection's reader fiber (HTTP responses must go out in request
        order), so slow async methods belong on the binary protocol.

        The caller has verified the connection against ``options.auth``
        (``builtin/pages.handle`` through ``rpc/auth.http_check``)."""
        self.nrequest << 1  # counted before admission, like the binary path
        prop = self._methods.get(f"{service}.{method}")
        if prop is None:
            return 404, "text/plain", f"no method {service}.{method}\n".encode()
        if self._stopping or self._lame_duck:
            return 503, "text/plain", b"server stopping\n"
        # json2pb transcoding: when the handler carries a schema and the
        # body is JSON, transcode request in / response out — one handler
        # serves binary RPC and curl alike (the reference's http+pb story)
        transcode = None
        from incubator_brpc_tpu_torch.protocol.json2pb import schema_of
        from incubator_brpc_tpu_torch.protocol.tbus_std import ParseError

        schema = schema_of(prop.handler)
        if schema is not None and body.lstrip()[:1] in (b"{", b""):
            req_cls, resp_cls = schema
            try:
                body = req_cls.from_json(body or b"{}").to_binary()
            except ParseError as e:
                return 400, "text/plain", f"bad request json: {e}\n".encode()
            transcode = resp_cls
        status = prop.status
        if not self._admit(status):
            return 503, "text/plain", b"concurrency limit reached\n"

        cntl = Controller()
        cntl._server = self
        cntl._service = service
        cntl._method = method
        cntl._request_payload = body
        # the same request context the binary path provides, so handlers
        # behave identically over both protocols
        meta = Meta(service=service, method=method)
        cntl.request_meta = meta
        cntl._sock = sock
        cntl.remote_side = sock.remote if sock is not None else None
        cntl._mark_start()
        # the same observability hooks as the binary route
        maybe_dump_request(meta, body)
        cntl._span = start_server_span(cntl, meta)

        done = threading.Event()
        holder = {"response": b""}
        cntl._async = False
        cntl.set_async = lambda: setattr(cntl, "_async", True)

        def send_response(response=b""):
            holder["response"] = response or b""
            done.set()

        cntl.send_response = send_response
        self._session_handler_enter(sock)
        prev_server = getattr(_usercode_tls, "server", None)
        _usercode_tls.server = self
        try:
            response = prop.handler(cntl, body)
        except Exception as e:
            logger.exception("handler %s.%s raised (http)", service, method)
            cntl.set_failed(ErrorCode.EINTERNAL, f"handler raised: {e!r}")
            response = b""
        finally:
            _usercode_tls.server = prev_server
            clear_parent_span(cntl._span)
        if cntl._async and not cntl.failed():
            if not done.wait(timeout=float(get_flag("http_gateway_async_timeout_s"))):
                cntl.set_failed(ErrorCode.ERPCTIMEDOUT, "async handler timed out")
            response = holder["response"]
        cntl._mark_end()
        self._session_handler_exit(sock)
        self._release(status, cntl)
        if cntl._span is not None:
            end_server_span(cntl, response_size=len(response or b""))
        if cntl.failed():
            self.nerror << 1
            return 500, "text/plain", f"{cntl.error_text}\n".encode()
        if transcode is not None:
            try:
                return (
                    200,
                    "application/json",
                    transcode.from_binary(response or b"").to_json(),
                )
            except Exception:
                logger.exception("response transcode failed for %s.%s", service, method)
                return 500, "text/plain", b"response transcode failed\n"
        return 200, "application/octet-stream", response or b""

    def _send_response(self, sock, cntl: Controller, response: bytes) -> None:
        """SendRpcResponse (baidu_rpc_protocol.cpp:136): serialize+compress,
        append attachment, write. The response meta carries only what the
        client reads back (error text / stream id / compress / attachment
        size); a plain success with a bare payload travels with NO meta at
        all."""
        failed = cntl.failed()
        payload = b"" if failed else response
        meta = None
        if failed and cntl.error_text:
            meta = Meta(error_text=cntl.error_text)
        elif not failed and cntl._accepted_stream_id:
            meta = Meta(stream_id=cntl._accepted_stream_id)
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
        # the registry's packer for the protocol the request arrived in
        wire = getattr(cntl, "_wire_protocol", "tbus_std")
        data = proto_pkg.protocol_registry.get(wire).pack_response(
            meta,
            payload,
            cntl.call_id,
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
