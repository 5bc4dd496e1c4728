"""Channel — the client endpoint (reference src/brpc/channel.cpp:285
CallMethod, controller.cpp:545-676 OnVersionedRPCReturned / 941 IssueRPC).

Call flow (mirrors SURVEY.md §3.1):
  call_method
    ├ create ranged call id (2 + max_retry versions, channel.cpp:307)
    ├ async or backup: register the timeout / backup timers on the
    │   TimerThread
    ├ _issue_rpc: pick socket (single server or LB), pack, Socket.write
    │   (write failure → CallIdSpace.error → retry arbitration)
    └ sync: poll the socket / join the call id (async: done runs when the
      id is destroyed)

  response path: tbus_std process_response
    └ lock call id → _on_rpc_returned: retry / backup-win / end
      EndRPC: cancel timers, unlock_and_destroy (wakes joiners), run done.

The port's copy of the JAX package's ``rpc/channel.py``. A channel speaks
the protocol ``ChannelOptions.protocol`` names, through the protocol
registry's packer: tbus_std (the default), baidu_std (the reference's PRPC
wire) or http (``POST /<service>/<method>``; its responses carry no ids, so
the connection keeps a FIFO of the calls in flight, and FIFO-correlated
protocols never share a connection with another protocol). It takes
one server address or a naming url behind a load balancer
(``init(url, lb_name)``, ``init_with_lb``; ``lb/``, ``naming/``, with the
per-node circuit breaker of ``rpc/circuit_breaker.py``), sync and async
calls, timeouts, retries that avoid the servers already tried (on
``RETRIABLE``, or where ``ChannelOptions.retry_policy`` says so) under the
channel's retry budget (``RetryBudget``, the ``retry_budget_ratio`` flag),
backup requests (``backup_request_ms``: a duplicate goes to another server
when the first attempt has not answered in time, and the faster reply
wins), credentials (``ChannelOptions.auth``, ``rpc/auth.py``: the first
requests of a connection carry them, and channels with different
credentials share no connection), ``start_cancel``, deadline propagation,
single, pooled and short connections, and the two-party device link
(``ChannelOptions(transport="tpu")``: the handshake rides the host socket,
frames ride ``transport/device_link.py``; behind a load balancer the LB
picks a healthy host socket and the link map supplies the link to that
peer), with ``link_controller="multi"`` the link whose two halves live in
two processes (``transport/mc_link.py``), and the client side of the
streaming RPC (``call_method(..., request_stream=)``, ``rpc/stream.py``).
With ``ChannelOptions(native_plane=True)`` a sync, stream-less call to one
TCP server without a backup request, on tbus_std or baidu_std, rides the
native client of the port's host runtime
(``transport/native_plane.NativeClientChannel``: pack, write, read and
match in C++): uncompressed and without credentials on tbus_std, whose
meta the Python route owns; on baidu_std the credential (RpcMeta field 7,
stamped until the first success) and a native codec (snappy, gzip, zlib)
ride it too. A pooled channel keeps one native connection per caller
thread, and a transport failure falls through to the Python path, which
dials fresh and owns the retries. Every call opens its rpcz client span
(``builtin/rpcz.start_client_span``) on either route and ends it at
completion; the native route stamps the trace on the wire only when it is
observable. ``ChannelOptions(ssl_context=, ssl_server_hostname=)`` carry
every connection of the channel over TLS on the Python route (tbus_std,
baidu_std, HTTP, streams and device-link handshakes alike), on
connections of their own in the socket map; a ``unix://<path>`` target
dials a unix-domain socket. ``protocol=`` takes the legacy family too:
hulu_pbrpc and sofa_pbrpc (correlation ids on the wire), and nova_pbrpc,
public_pbrpc, ubrpc_mcpack2, nshead_mcpack and esp, answered in order on
their connection (``fifo_responses``): such a socket is tagged with the
protocol it speaks (``context["fifo_protocol"]``), which picks its response
decoder and gates the scan of its replies. mongo, thrift and rtmp are
registered with no request packer, as in the JAX package: a call over
any of them fails with "cannot pack requests" (thrift's client is
``protocol/thrift.ThriftClient``, rtmp's ``protocol/rtmp.RtmpClient``).
"""

from __future__ import annotations

import collections
import errno
import logging
import threading
import time
import weakref
from typing import Callable, Optional, Union

from incubator_brpc_tpu_torch import protocol as proto_pkg
from incubator_brpc_tpu_torch.builtin.rpcz import end_client_span, in_trace_context, start_client_span
from incubator_brpc_tpu_torch.bvar import Adder, PassiveStatus
from incubator_brpc_tpu_torch.protocol import compress as compress_mod
from incubator_brpc_tpu_torch.protocol.tbus_std import Meta, ParsedFrame
from incubator_brpc_tpu_torch.rpc import stream as stream_mod
from incubator_brpc_tpu_torch.rpc.auth import attach_credential, mark_authenticated
from incubator_brpc_tpu_torch.rpc.controller import RETRIABLE, Controller
from incubator_brpc_tpu_torch.rpc.deadline import current_deadline
from incubator_brpc_tpu_torch.runtime.correlation_id import EBUSY, call_id_space
from incubator_brpc_tpu_torch.runtime.timer_thread import global_timer_thread
from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool
from incubator_brpc_tpu_torch.transport.event_dispatcher import on_reactor_thread
from incubator_brpc_tpu_torch.transport.messenger import InputMessenger
from incubator_brpc_tpu_torch.transport.sock import CONNECTED, when_drained
from incubator_brpc_tpu_torch.transport.socket_map import SocketMap
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint, str2endpoint
from incubator_brpc_tpu_torch.utils.flags import define_flag, get_flag
from incubator_brpc_tpu_torch.utils.status import ErrorCode, berror

logger = logging.getLogger(__name__)

_client_messenger = InputMessenger()
_client_socket_map = SocketMap(messenger=_client_messenger)


def client_socket_map() -> SocketMap:
    """The process-wide map of client connections every Channel shares."""
    return _client_socket_map


def start_cancel(call_id: int) -> None:
    """Cancel an in-flight RPC by its call id from ANY thread — the
    reference's brpc::StartCancel(CallId) (controller.cpp:699, routed
    through bthread_id_error): the id's error hook runs under the id
    lock, fails the call with ECANCELED (never retried), wakes joiners
    and runs the done callback. A no-op once the call has settled."""
    call_id_space.error(call_id, ErrorCode.ECANCELED, "canceled by caller")


class NoServerError(ConnectionError):
    """LB selection failed: every candidate excluded or the cluster is
    empty (reference ExcludedServers -> EHOSTDOWN)."""


def _recycle_when_drained(sock) -> None:
    """Close once queued writes flushed: recycling immediately would drop
    frames still on the write queue."""
    when_drained(sock, lambda s: s.recycle())


def _track_inflight(sock, cid: int) -> None:
    """Record a written-but-unanswered correlation id on its connection so
    connection death fails the call NOW, not at its deadline (the
    reference fails every id parked on a Socket at SetFailed).

    Error delivery is CLAIM-based: whoever atomically removes the cid
    from the set (response path, EndRPC, a write's on_error, or the
    socket-failure sweep) owns it — a request sitting in the write queue
    at set_failed would otherwise be errored twice."""
    ctx = sock.context
    cids = ctx.get("_inflight_cids")
    if cids is None:
        cids = ctx.setdefault("_inflight_cids", set())

        def _fail_inflight(sk):
            pending = sk.context.get("_inflight_cids")
            while pending:
                try:
                    c = pending.pop()  # atomic claim under the GIL
                except KeyError:
                    break
                global_worker_pool().spawn(
                    call_id_space.error,
                    c,
                    ErrorCode.EFAILEDSOCKET,
                    f"connection to {sk.remote} failed with the call in flight",
                )

        sock.on_failed.append(_fail_inflight)
    cids.add(cid)


def _claim_inflight(sock, cid: int) -> bool:
    """True iff this caller atomically removed the cid (and may deliver
    its error); False = another path already owns it."""
    cids = sock.context.get("_inflight_cids")
    if cids is None:
        return True  # never tracked (pre-track failure): caller owns it
    try:
        cids.remove(cid)
        return True
    except KeyError:
        return False


def process_response(sock, frame: ParsedFrame) -> None:
    """tbus_std Protocol.process_response hook: route a response frame to
    its in-flight RPC via the correlation id (baidu_rpc_protocol.cpp:543).

    On a reactor thread (inline reads) a contended id must not park the
    reactor: the blocking lock is deferred to a pool fiber."""
    cid = frame.correlation_id
    cids = sock.context.get("_inflight_cids")
    if cids is not None:
        cids.discard(cid)
    rc, cntl = call_id_space.lock(cid, nowait=on_reactor_thread())
    if rc == EBUSY:
        global_worker_pool().spawn(_process_response_blocking, sock, frame)
        return
    _returned(rc, cntl, sock, frame)


def _process_response_blocking(sock, frame: ParsedFrame) -> None:
    rc, cntl = call_id_space.lock(frame.correlation_id)
    _returned(rc, cntl, sock, frame)


def _returned(rc: int, cntl, sock, frame: ParsedFrame) -> None:
    if rc != 0 or cntl is None:
        return  # stale/duplicate response after EndRPC: drop
    channel = cntl._channel
    if channel is None:
        call_id_space.unlock(frame.correlation_id)
        return
    channel._on_rpc_returned(cntl, frame, sock)


# bind the live hook (registration itself happens at protocol import)
proto_pkg.TBUS_STD.process_response = process_response


# -- retry budget --------------------------------------------------------------
#
# The SRE retry-budget discipline: retries are only safe while they are a
# small fraction of traffic — once a backend browns out, per-call retry
# caps (max_retry) still multiply offered load by (1 + max_retry), and
# the retry storm finishes the backend off. Every Channel therefore owns
# a token bucket: each issued call deposits ``retry_budget_ratio``
# tokens, each retry withdraws one, and an empty bucket makes the call
# FAIL FAST with the original error instead of retrying. Steady-state
# retry volume is thus capped at ~ratio of call volume, while the bucket
# cap still absorbs short error bursts at full retry fidelity.

define_flag(
    "retry_budget_ratio",
    0.1,
    "per-channel retry budget (SRE-style): each issued call deposits "
    "this many retry tokens and each retry attempt withdraws one, so "
    "sustained retry volume is capped at this fraction of call volume; "
    "an exhausted budget fails the call fast with the original error "
    "instead of amplifying a brownout into a retry storm; 0 disables",
    lambda v: 0 <= v <= 1,
)

# burst allowance: a full bucket funds this many back-to-back retries
# before the ratio gates (and is also the bucket's starting balance, so
# young channels are not penalized for their first errors)
_RETRY_BUDGET_CAP = 50.0

# codes that never draw from the budget: deliberate, non-amplifying
# control signals — a propagated deadline died (EDEADLINE), a collective
# session aborted cooperatively (ESESSION), admission control shed the
# request (ELIMIT). None of them is in the default RETRIABLE set, but a
# custom retry_policy may retry them, and that decision must not burn
# budget meant for connectivity failures.
RETRY_BUDGET_EXEMPT = frozenset({ErrorCode.EDEADLINE, ErrorCode.ESESSION, ErrorCode.ELIMIT})

retry_budget_exhausted = Adder(name="retry_budget_exhausted")
_live_budgets = weakref.WeakSet()
# aggregate balance across live channels (the per-channel value is not a
# bvar: channels are many and short-lived; the aggregate plus the
# exhaustion counter is the signal)
retry_budget_tokens = PassiveStatus(
    lambda: round(sum(b.balance() for b in list(_live_budgets)), 2),
    name="retry_budget_tokens",
)


class RetryBudget:
    """Token-bucket retry budget for one channel (see the note above)."""

    def __init__(self, ratio: float):
        self._ratio = float(ratio)
        self._tokens = _RETRY_BUDGET_CAP
        self._lock = threading.Lock()
        if self._ratio > 0:
            _live_budgets.add(self)

    def on_call(self) -> None:
        """One issued call funds ``ratio`` of a future retry."""
        if self._ratio <= 0:
            return
        with self._lock:
            self._tokens = min(_RETRY_BUDGET_CAP, self._tokens + self._ratio)

    def acquire(self, code: int) -> bool:
        """May one retry for this error run? Exempt codes never draw."""
        if self._ratio <= 0 or code in RETRY_BUDGET_EXEMPT:
            return True
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
        retry_budget_exhausted << 1
        return False

    def balance(self) -> float:
        with self._lock:
            return self._tokens


def tls_key_tag(options: "ChannelOptions") -> str:
    """The socket-map key's TLS partition: TLS and plaintext never share a
    connection, and neither do two channels with different TLS configs
    (client certificates, verification modes), so the context's identity
    partitions too, like the reference SocketMapKey's ssl settings
    (socket_map.h:35)."""
    if options.ssl_context is None:
        return ""
    return f"|ssl-{id(options.ssl_context):x}"


def tls_conn_kwargs(options: "ChannelOptions") -> dict:
    """The ``Socket.connect`` arguments every connection of a TLS channel
    needs."""
    if options.ssl_context is None:
        return {}
    return {"ssl_context": options.ssl_context,
            "ssl_server_hostname": options.ssl_server_hostname}


class ChannelOptions:
    """Reference ChannelOptions (rpc/channel.py) with the reference's
    parameters in the reference's order, so a positional call binds as it
    binds there. The port serves the timeouts, retries, backup requests
    (``backup_request_ms``), credentials (``auth``), the custom retry
    policy (``retry_policy``), the device link (``transport="tpu"``,
    ``device_index`` and ``link_*``), the native client
    (``native_plane``), TLS (``ssl_context``), every registered protocol
    by name and the connection types ("single", "pooled", "short"). Every
    parameter keeps its place and its default, and a value the reference
    itself refuses raises ``ValueError`` as there."""

    def __init__(
        self,
        timeout_ms: float = Controller.DEFAULT_TIMEOUT_MS,
        max_retry: int = Controller.DEFAULT_MAX_RETRY,
        backup_request_ms: float = -1,
        connect_timeout: float = 5.0,
        protocol: str = "tbus_std",
        auth=None,
        connection_type: str = "single",
        transport: str = "tcp",
        device_index: int = 0,
        link_slot_words: int = 16384,
        link_window: int = 8,
        link_ack_mode: str = "local",
        link_controller: str = "single",
        native_plane: bool = False,
        ssl_context=None,
        ssl_server_hostname=None,
        retry_policy=None,
    ):
        if connection_type not in ("single", "pooled", "short"):
            raise ValueError(f"unknown connection_type {connection_type!r}")
        if transport not in ("tcp", "tpu"):
            raise ValueError(f"unknown transport {transport!r}")
        if transport == "tpu" and connection_type != "single":
            raise ValueError("transport='tpu' supports connection_type='single'")
        if link_controller not in ("single", "multi"):
            raise ValueError(f"unknown link_controller {link_controller!r}")
        self.timeout_ms = timeout_ms
        self.max_retry = max_retry
        # duplicate a call to another server when the first attempt has not
        # answered after this long (<= 0 off); the faster reply wins
        self.backup_request_ms = backup_request_ms
        self.connect_timeout = connect_timeout
        # "tbus_std", "baidu_std", "http" or one of the legacy family, by
        # name through the protocol registry (reference AdaptiveProtocolType)
        self.protocol = protocol
        self.auth = auth  # Authenticator (rpc/auth.py)
        # "single" (shared main socket), "pooled" (exclusive connection per
        # in-flight call, parked for reuse), "short" (fresh connection,
        # closed after the call) — reference AdaptiveConnectionType
        self.connection_type = connection_type
        # "tcp" (host sockets) or "tpu" (two-party device link: handshake
        # over the host socket, frames over the device plane — the
        # reference's ChannelOptions.use_rdma slot, channel.h). The value's
        # name is the reference's public switch; on this port the link's
        # devices are CUDA cards (or the CPU, transport/device_link.py).
        self.transport = transport
        self.device_index = device_index
        self.link_slot_words = link_slot_words
        self.link_window = link_window
        # 'local' | 'wire': how the link's credit window learns about
        # drained steps (wire = the multi-controller piggybacked-ack flow)
        self.link_ack_mode = link_ack_mode
        # 'single': both link halves in one process; 'multi': one half per
        # process, lockstep over torch.distributed (transport/mc_link.py)
        self.link_controller = link_controller
        # sync calls to one TCP server over the native client
        # (transport/native_plane.py)
        self.native_plane = native_plane
        # fn(cntl) -> bool: should THIS failed attempt retry? (reference
        # RetryPolicy::DoRetry, retry_policy.h:26 — cntl.error_code is the
        # attempt's error; None = the default retriable-code set). max_retry
        # and the retry budget are enforced regardless.
        self.retry_policy = retry_policy
        # ssl.SSLContext for TLS to the server(s) (reference
        # ChannelOptions.ssl_options): each socket pumps ciphertext through
        # an SSLObject; ssl_server_hostname is the SNI / verified name
        self.ssl_context = ssl_context
        self.ssl_server_hostname = ssl_server_hostname


class Channel:
    """Client channel to a single server or (via ``lb`` + naming) a set.

    ``init()`` accepts an "ip:port" / EndPoint for a single server, or a
    naming url ("list://a:1,b:2", "file://path", "dns://host:port") plus a
    load-balancer name — the reference's dual Init (channel.cpp:201-273).
    """

    def __init__(self):
        self._options = ChannelOptions()
        self._server: Optional[EndPoint] = None
        self._lb = None  # LoadBalancerWithNaming (lb/__init__.py)
        self._socket_map = _client_socket_map
        self._init_done = False
        self._retry_budget: Optional[RetryBudget] = None
        # transport="tpu": the last-used link (the links themselves live in
        # the process-wide DeviceLinkMap)
        self._device_sock = None
        self._native_ch = None  # NativeClientChannel (lazy; native_plane)
        self._native_lock = threading.Lock()
        self._native_tls = threading.local()  # pooled: one conn per thread

    def init(
        self,
        target: Union[str, EndPoint],
        lb_name: str = "",
        options: Optional[ChannelOptions] = None,
    ) -> bool:
        """``target`` is "ip:port" / "host:port" / an EndPoint (one server;
        ``lb_name`` is ignored, as in the reference) or a naming url, whose
        servers ``lb_name`` ("rr" when empty) balances."""
        if options is not None:
            self._options = options
        if isinstance(target, EndPoint):
            self._server = target
        elif "://" in str(target) and not str(target).startswith("unix://"):
            # transport='tpu' works for LB targets too: the LB picks the
            # peer, the DeviceLinkMap resolves it to an established link
            # (one per peer device)
            from incubator_brpc_tpu_torch.lb import LoadBalancerWithNaming

            self._lb = LoadBalancerWithNaming(
                str(target), lb_name or "rr", socket_map=self._socket_map,
                key_tag=self._auth_key_tag(), conn_kwargs=self._conn_kwargs(),
            )
            if not self._lb.start():
                return False
        else:
            self._server = str2endpoint(str(target))
        self._retry_budget = RetryBudget(float(get_flag("retry_budget_ratio")))
        self._init_done = True
        return True

    def init_with_lb(self, lb, options: Optional[ChannelOptions] = None) -> bool:
        """Init with a pre-built LoadBalancerWithNaming-compatible object
        (select_server/feedback/start/stop) — the seam PartitionChannel uses
        to feed each sub-channel a filtered server view
        (partition_channel.cpp builds sub-channels the same way)."""
        if options is not None:
            self._options = options
        if not lb.start():
            return False
        self._lb = lb
        self._retry_budget = RetryBudget(float(get_flag("retry_budget_ratio")))
        self._init_done = True
        return True

    # -- public call surface -------------------------------------------------

    def call_method(
        self,
        service: str,
        method: str,
        request: bytes,
        cntl: Optional[Controller] = None,
        done: Optional[Callable[[Controller], None]] = None,
        attachment: bytes = b"",
        request_stream=None,
    ) -> Controller:
        """The CallMethod entry (channel.cpp:285). Synchronous when ``done``
        is None (waits for the call); asynchronous otherwise.
        ``request_stream`` (``rpc.stream.stream_create``) rides the request
        meta; the stream connects when the server's response accepts it."""
        assert self._init_done, "Channel.init() not called"
        if self._retry_budget is not None:
            self._retry_budget.on_call()
        if cntl is None:
            cntl = Controller(
                timeout_ms=self._options.timeout_ms,
                max_retry=self._options.max_retry,
                backup_request_ms=self._options.backup_request_ms,
            )
        cntl._channel = self
        cntl._service = service
        cntl._method = method
        cntl._request_payload = request
        cntl.request_attachment = attachment
        cntl._done = done
        if request_stream is not None:
            cntl._request_stream = request_stream
        cntl._mark_start()

        # deadline propagation (reference RpcRequestMeta.timeout_ms): a
        # call issued inside a server handler inherits what is LEFT of the
        # caller's propagated budget when that is tighter than this call's
        # own timeout — budgets only shrink across hops. An already-spent
        # budget fails fast with EDEADLINE.
        ambient = current_deadline()
        if ambient is not None:
            if not cntl._deadline or ambient < cntl._deadline:
                cntl._deadline = ambient
                cntl.timeout_ms = max(0.0, (ambient - cntl._start_ts) * 1000.0)
            if cntl._deadline <= cntl._start_ts:
                cntl.set_failed(ErrorCode.EDEADLINE, "propagated deadline already expired")
                cntl._mark_end()
                if done is not None:
                    done(cntl)
                return cntl

        # native fast path: a sync, stream-less call without a backup to a
        # single TCP server (credentials and compression on baidu_std only,
        # _native_eligible) rides the host runtime's native client end to
        # end; a transport failure falls through to the regular path, whose
        # dial/retry machinery owns recovery
        if (
            done is None
            and request_stream is None
            and self._options.native_plane
            and self._native_eligible(cntl)
            and self._native_call(cntl, service, method, request, attachment)
        ):
            return cntl

        # one id covers the first send + every retry/backup
        # (bthread_id_create_ranged with 2 + max_retry, channel.cpp:307)
        cid = call_id_space.create(
            data=cntl,
            on_error=self._handle_id_error,
            version_range=2 + max(0, cntl.max_retry),
        )
        cntl.call_id = cid

        cntl._span = start_client_span(cntl)

        # sync calls without a backup request enforce their deadline from
        # the caller's own wait loop (_sync_wait); async calls and calls
        # with a backup request need the TimerThread
        timer = global_timer_thread()
        pool = global_worker_pool()
        backup = cntl.backup_request_ms is not None and cntl.backup_request_ms > 0
        if (done is not None or backup) and cntl.timeout_ms is not None and cntl.timeout_ms > 0:
            cntl._timer_ids.append(
                timer.schedule(
                    lambda: pool.spawn(
                        call_id_space.error,
                        cid,
                        ErrorCode.ERPCTIMEDOUT,
                        f"deadline {cntl.timeout_ms} ms exceeded",
                    ),
                    delay=cntl.timeout_ms / 1000.0,
                )
            )
        if backup:
            cntl._timer_ids.append(
                timer.schedule(
                    lambda: pool.spawn(call_id_space.error, cid, ErrorCode.EBACKUPREQUEST, ""),
                    delay=cntl.backup_request_ms / 1000.0,
                )
            )

        if done is None:
            cntl._want_poll = True
        rc, _ = call_id_space.lock(cid)
        if rc == 0:
            self._issue_rpc(cntl)
            call_id_space.unlock(cid)
        # Only the initial caller-thread issue may pre-claim read ownership:
        # a later retry on a pool thread claiming a socket after the sync
        # caller stopped polling would leave a connection nobody reads.
        cntl._want_poll = False

        if done is None:
            self._sync_wait(cntl, cid)
        return cntl

    # convenience alias
    call = call_method

    # -- native fast path ----------------------------------------------------

    def _native_eligible(self, cntl: Controller) -> bool:
        from incubator_brpc_tpu_torch.transport.native_plane import _NATIVE_COMPRESS_WIRE

        baidu = self._options.protocol == "baidu_std"
        return (
            self._server is not None
            and not self._server.ip.startswith("unix://")
            and self._options.transport == "tcp"
            # the two protocols the C++ channel packs natively (tbnet.h)
            and self._options.protocol in ("tbus_std", "baidu_std")
            # auth and compression ride the fast path on baidu_std: the
            # credential stamps RpcMeta field 7 (the first-request fight in
            # C++), a compressed payload stamps field 3 and the server's
            # native codec table answers in kind. tbus_std carries both in
            # the JSON meta the Python route owns.
            and (self._options.auth is None or baidu)
            and self._options.connection_type in ("single", "pooled")
            and (not cntl.compress_type or (baidu and cntl.compress_type in _NATIVE_COMPRESS_WIRE))
            # the C++ client has no TLS stack
            and self._options.ssl_context is None
            and not (cntl.backup_request_ms is not None and cntl.backup_request_ms > 0)
            and not cntl._force_host
        )

    def _native_fresh_or_none(self, cached):
        """Reuse ``cached`` if healthy, else dial a replacement (None on a
        connect failure)."""
        from incubator_brpc_tpu_torch.transport import native_plane as np_mod

        if cached is not None and cached.healthy():
            return cached
        if cached is not None:
            cached.close()
        try:
            nch = np_mod.NativeClientChannel(
                self._server.ip,
                self._server.port,
                connect_timeout_ms=int(self._options.connect_timeout * 1000),
                protocol=self._options.protocol,
            )
        except OSError:
            return None
        if self._options.auth is not None and self._options.protocol == "baidu_std":
            # fresh connection, fresh credential: the C++ channel stamps it
            # until the first successful response proves the connection
            # (attach_credential's fight, natively)
            try:
                nch.set_auth(self._options.auth.generate_credential())
            except Exception:
                logger.exception("generate_credential failed; native path disabled")
                nch.close()
                return None
        return nch

    def _native_channel(self):
        from incubator_brpc_tpu_torch.transport import native_plane as np_mod

        if not np_mod.NET_AVAILABLE:
            return None
        if self._options.connection_type == "pooled":
            # pooled + native = one exclusive connection per caller thread
            ch = self._native_fresh_or_none(getattr(self._native_tls, "ch", None))
            self._native_tls.ch = ch
            return ch
        with self._native_lock:
            ch = self._native_fresh_or_none(self._native_ch)
            self._native_ch = ch
            return ch

    def _native_call(self, cntl: Controller, service, method, request, attachment) -> bool:
        """One attempt over the native channel. True = the RPC completed
        (ok, RPC error, or timeout); False = transport trouble, the caller
        falls through to the regular path."""
        nch = self._native_channel()
        if nch is None:
            return False
        # captured BEFORE start_client_span stamps fresh ids: a caller
        # continuing an external trace (cntl.trace_id pre-set) is
        # indistinguishable from a generated id afterwards
        preset_trace = bool(cntl.trace_id or cntl.span_id or cntl.trace_sampled)
        cntl._span = start_client_span(cntl)
        # start_client_span ALWAYS stamps trace ids on the controller, but
        # untraced calls skip the per-call submeta encode: the wire carries
        # the trace only when it is observable — this hop sampled a span,
        # the caller set a log_id or their own trace ids or sampled bit, or
        # the call runs inside a server handler's trace context
        traced = cntl._span is not None or bool(cntl.log_id) or preset_trace or in_trace_context()
        request_wire = request
        if cntl.compress_type:
            # the codec the server's C++ table mirrors: the compressed bytes
            # are identical on both planes
            request_wire = compress_mod.compress(cntl.compress_type, request)
        rc, err_code, resp_meta, body = nch.call(
            service, method, request_wire, attachment, timeout_ms=cntl.timeout_ms,
            log_id=cntl.log_id if traced else 0,
            trace_id=cntl.trace_id if traced else 0,
            span_id=cntl.span_id if traced else 0,
            parent_span_id=cntl.parent_span_id if traced else 0,
            sampled=cntl.trace_sampled if traced else 0,
            compress=cntl.compress_type or "",
        )
        cntl.remote_side = self._server
        if rc == -errno.ETIMEDOUT:
            cntl.set_failed(ErrorCode.ERPCTIMEDOUT, f"deadline {cntl.timeout_ms} ms exceeded")
        elif rc == -errno.EBADMSG:
            # the response's correlation id carried another reactor
            # shard's tag: a bad answer, not a dead connection
            cntl.set_failed(ErrorCode.EREQUEST, "response correlation id from the wrong reactor shard")
        elif rc < 0:
            # connection-level failure: recycle, and let the regular path
            # (fresh dial + retry arbitration) handle this call
            with self._native_lock:
                if self._native_ch is nch:
                    self._native_ch = None
            nch.close()
            cntl.remote_side = None
            if cntl._span is not None:
                end_client_span(cntl)
            cntl._span = None
            return False
        elif err_code:
            meta = nch.decode_resp_meta(resp_meta)
            cntl.set_failed(int(err_code), meta.error_text or berror(int(err_code)))
        else:
            meta = nch.decode_resp_meta(resp_meta) if resp_meta else None
            blen = len(body)
            att = meta.attachment_size if meta is not None else 0
            if att > blen:
                cntl.set_failed(ErrorCode.ERESPONSE, "attachment exceeds body")
            else:
                cntl.response_meta = meta
                payload = body.to_bytes(blen - att)
                if meta is not None and meta.compress:
                    # the server recompressed the response (its floor
                    # permitting): decompress like the Python response path
                    try:
                        payload = compress_mod.decompress(meta.compress, payload)
                    except Exception as e:
                        cntl.set_failed(ErrorCode.ERESPONSE, f"decompress failed: {e}")
                        payload = None
                if payload is not None:
                    cntl.response_payload = payload
                    cntl.response_attachment = body.to_bytes(att, pos=blen - att) if att else b""
        cntl._mark_end()
        if cntl._span is not None:
            end_client_span(cntl)
        return True

    def _sync_wait(self, cntl: Controller, cid: int) -> None:
        """Synchronous completion. When the request's socket is otherwise
        idle, the caller becomes its reader and processes the response on
        its OWN thread — a sync round trip then involves zero reactor or
        fiber wakeups on the client (Socket.poll_and_process). Falls back
        to the plain join when another thread is already reading the
        socket."""
        deadline = cntl._deadline or None
        # whether a TimerThread entry owns this call's deadline (see
        # call_method); if not, THIS loop delivers ERPCTIMEDOUT
        has_timer = bool(cntl._timer_ids)

        def _deadline_hit() -> bool:
            if has_timer or deadline is None or time.monotonic() < deadline:
                return False
            call_id_space.error(
                cid, ErrorCode.ERPCTIMEDOUT, f"deadline {cntl.timeout_ms} ms exceeded"
            )
            return True

        def _join_with_deadline() -> None:
            # the deadline stays enforced without a TimerThread entry: a
            # dead server that never answers must still yield ERPCTIMEDOUT
            while call_id_space.valid(cid):
                remaining = None if deadline is None else deadline - time.monotonic()
                if call_id_space.join(cid, timeout=remaining):
                    return
                if _deadline_hit():
                    break
            call_id_space.join(cid)

        sock = cntl._poll_owned
        if sock is None:
            sock = cntl._sent_sockets[-1] if cntl._sent_sockets else None
            if sock is None or not sock.try_read_ownership():
                _join_with_deadline()
                return
        cntl._poll_sock = sock
        try:
            while call_id_space.valid(cid):
                if _deadline_hit():
                    break
                if sock.state != CONNECTED:
                    break
                # 0.5s safety tick: a missed kick (no eventfd) or a response
                # rerouted to another socket (a retry or a backup) is
                # picked up by the next valid() check
                t = 0.5
                if deadline is not None:
                    t = min(t, max(0.001, deadline - time.monotonic()))
                if not sock.poll_and_process(t):
                    break
        finally:
            cntl._poll_sock = None
            cntl._poll_owned = None
            sock.release_read_ownership()
        _join_with_deadline()

    # -- issue / return paths (run under the call-id lock) -------------------

    def _call_host(self, service, method, request, cntl=None):
        """A call forced onto the HOST (TCP) path even when this channel's
        transport is 'tpu' — the handshake itself must ride the bootstrap
        socket (the reference's deferred-handshake-over-TCP,
        socket.cpp:1692-1704)."""
        if cntl is None:
            cntl = Controller()
        cntl._force_host = True
        return self.call_method(service, method, request, cntl=cntl)

    def _auth_key_tag(self) -> str:
        """Connection-pool partition for this channel's credentials — the
        reference's SocketMapKey carries the Authenticator for the same
        reason (socket_map.h:35): channels with different credentials
        never share a connection. FIFO-correlated protocols (HTTP)
        partition by protocol too: their responses carry no ids, so a
        socket's inbound bytes are only decodable when exactly one such
        protocol ever spoke on it."""
        a = self._options.auth
        tag = ""
        if a is not None:
            tag = getattr(a, "_smap_tag", None)
            if tag is None:
                tag = f"auth-{id(a):x}"
                a._smap_tag = tag
        proto_name = self._options.protocol
        if proto_name != "tbus_std" and proto_name in proto_pkg.protocol_registry:
            if proto_pkg.protocol_registry.get(proto_name).fifo_responses:
                tag = f"{tag}|fifo-{proto_name}"
        return tag + tls_key_tag(self._options)

    def _conn_kwargs(self) -> dict:
        return tls_conn_kwargs(self._options)

    def _dispose_attempt_sock(self, kind: str, sock, reusable: bool = True) -> None:
        """One attempt's connection settles (Call::OnComplete disposition,
        controller.cpp:698): pooled returns to the pool ONLY when the call
        finished cleanly — a timed-out or superseded attempt may still have
        a request in flight, and parking it would head-of-line-block the
        next caller (the reference closes non-single connections on error
        for the same reason). Short connections drain then close."""
        if kind == "pooled" and reusable:
            # keyed by the connection's actual remote: pooled secondaries
            # of LB targets park under their own endpoint's entry
            self._socket_map.return_pooled(sock.remote, sock, key_tag=self._auth_key_tag())
        else:
            _recycle_when_drained(sock)

    def _get_device_socket(self, cntl: Controller, ep: Optional[EndPoint] = None):
        """transport='tpu': the established DeviceSocket for the target
        endpoint, from the process-wide DeviceLinkMap (re-handshaking a
        dead link). Links are shared across channels — the SocketMap
        dedupe semantics on the device plane."""
        from incubator_brpc_tpu_torch.transport.device_link import device_link_map

        ds = device_link_map.get_or_create(
            ep if ep is not None else self._server,
            device_index=self._options.device_index,
            slot_words=self._options.link_slot_words,
            window=self._options.link_window,
            timeout_ms=cntl.timeout_ms or 60000,
            ack_mode=self._options.link_ack_mode,
            controller=self._options.link_controller,
            auth=self._options.auth,
            ssl_context=self._options.ssl_context,
            ssl_server_hostname=self._options.ssl_server_hostname,
        )
        self._device_sock = ds  # last-used link (introspection/tests)
        return ds

    def _pick_socket(self, cntl: Controller):
        ctype = self._options.connection_type
        if self._options.transport == "tpu" and not cntl._force_host:
            # a DeviceSocket answers try_read_ownership() False: the sync
            # caller joins the call id instead of polling a socket
            if self._lb is None:
                return self._get_device_socket(cntl)
            # LB target: the LB resolves a healthy host socket (health
            # checks, the breaker and exclusion run on the host plane),
            # then the link map supplies the device link to that peer
            host = self._lb.select_server(excluded=cntl._excluded_sockets)
            if host is None:
                raise NoServerError("no available server (all excluded or empty)")
            try:
                ds = self._get_device_socket(cntl, ep=host.remote)
            except (OSError, ConnectionError):
                # settle the LB's pick (la charges in-flight on select):
                # an un-settled failed handshake would depress the peer's
                # weight forever
                self._lb.feedback(host, 0.0, ErrorCode.EFAILEDSOCKET)
                raise
            reg = getattr(self._lb, "register_socket", None)
            if reg is not None:
                reg(ds, host.remote)  # feedback/exclusion track the link
            return ds
        if self._lb is None:
            if ctype == "single":
                sock = self._socket_map.get_or_create(
                    self._server, timeout=self._options.connect_timeout,
                    key_tag=self._auth_key_tag(), **self._conn_kwargs(),
                )
                if sock.state != CONNECTED:
                    # dropped-but-healthy peer: reconnect inline instead of
                    # burning the attempt against a dead socket until the
                    # health probe fires (ConnectIfNot, socket.cpp:1591)
                    sock.connect_if_not(self._options.connect_timeout)
                return sock
            if ctype == "pooled":
                sock = self._socket_map.get_pooled(
                    self._server, timeout=self._options.connect_timeout,
                    key_tag=self._auth_key_tag(), **self._conn_kwargs(),
                )
            else:  # short: fresh connection, closed at EndRPC
                sock = self._socket_map.get_short(
                    self._server, timeout=self._options.connect_timeout, **self._conn_kwargs()
                )
            # disposed together at EndRPC — a backup request keeps the
            # previous attempt's connection in flight, so NOTHING may be
            # settled mid-call
            cntl._call_socks.append((ctype, sock))
            return sock
        # LB targets: the LB resolves a healthy MAIN socket per endpoint;
        # pooled/short secondaries hang off that endpoint's map entry (the
        # reference's SharedPart design, socket_map.h:35 +
        # Socket::GetPooledSocket/GetShortSocket)
        sock = self._lb.select_server(excluded=cntl._excluded_sockets)
        if sock is None:
            raise NoServerError("no available server (all excluded or empty)")
        if ctype == "single":
            return sock
        ep = sock.remote
        if ctype == "pooled":
            sec = self._socket_map.get_pooled(
                ep, timeout=self._options.connect_timeout, key_tag=self._auth_key_tag(),
                **self._conn_kwargs(),
            )
        else:  # short
            sec = self._socket_map.get_short(
                ep, timeout=self._options.connect_timeout, **self._conn_kwargs()
            )
        # LB feedback and retry exclusion track the secondary's id too
        reg = getattr(self._lb, "register_socket", None)
        if reg is not None:
            reg(sec, ep)
        cntl._call_socks.append((ctype, sec))
        return sec

    def _issue_rpc(self, cntl: Controller) -> None:
        """IssueRPC (controller.cpp:941): pick socket, pack, write. Called
        with the call id locked."""
        cid = cntl.call_id
        try:
            sock = self._pick_socket(cntl)
        except NoServerError as e:
            # every candidate excluded / empty cluster: EHOSTDOWN, letting
            # retry arbitration decide (reference ExcludedServers,
            # controller.cpp:578-615)
            self._arbitrate_error(cntl, ErrorCode.EHOSTDOWN, str(e))
            return
        except (OSError, ConnectionError) as e:
            # connection failed: arbitrate like a socket failure
            self._arbitrate_error(cntl, ErrorCode.EFAILEDSOCKET, str(e))
            return
        cntl.remote_side = sock.remote
        cntl._sent_sockets.append(sock)
        if cntl._want_poll and cntl._poll_owned is None and sock.try_read_ownership():
            # sync caller will drive this socket's reads (see _sync_wait);
            # claiming before the write keeps the post-send GIL window tiny
            cntl._poll_owned = sock
        # the wire deadline is the budget REMAINING now (retries re-stamp);
        # a sub-ms residue still rides as 1 so "deadline present" survives
        # integer ms truncation
        wire_timeout = 0
        if cntl._deadline:
            wire_timeout = max(1, int((cntl._deadline - time.monotonic()) * 1000))
        meta = Meta(
            service=cntl._service,
            method=cntl._method,
            compress=cntl.compress_type,
            timeout_ms=wire_timeout,
            log_id=cntl.log_id,
            trace_id=cntl.trace_id,
            span_id=cntl.span_id,
            parent_span_id=cntl.parent_span_id,
            sampled=cntl.trace_sampled,
            stream_id=cntl._request_stream.id if cntl._request_stream is not None else 0,
            extra=dict(cntl.request_extra) if cntl.request_extra else {},
        )
        if self._options.auth is not None:
            attach_credential(meta, sock, self._options.auth)
        try:
            payload = cntl._request_payload
            if cntl.compress_type:
                payload = compress_mod.compress(cntl.compress_type, payload)
            # protocol selected by name (reference AdaptiveProtocolType):
            # the registry's packer produces that protocol's exact bytes
            proto_name = self._options.protocol
            if proto_name not in proto_pkg.protocol_registry:
                raise ValueError(f"unknown protocol {proto_name!r}")
            proto = proto_pkg.protocol_registry.get(proto_name)
            if proto.pack_request is None:
                raise ValueError(f"protocol {proto_name!r} cannot pack requests")
            if proto.fifo_responses and sock.remote is not None:
                meta.extra["http_host"] = f"{sock.remote.ip}:{sock.remote.port}"
            if proto.fifo_responses:
                # response frames on this connection belong to this
                # protocol: the legacy client rows gate their scan on it
                # and it names the decoder (a client socket has no Server
                # context to gate by)
                sock.context["fifo_protocol"] = proto_name
            data = proto.pack_request(meta, payload, cid, attachment=cntl.request_attachment)
            if proto.fifo_responses:
                # no wire correlation id: record the cid in the
                # connection's FIFO atomically with the write, so the
                # pending order always equals the wire order
                self._write_fifo_correlated(sock, cntl, cid, data)
                return
        except (ValueError, TypeError) as e:
            # unknown codec / bad frame inputs: fail the RPC, never leak the
            # locked id out of IssueRPC
            cntl.set_failed(ErrorCode.EREQUEST, f"pack failed: {e}")
            self._end_rpc(cntl)
            return
        pool = global_worker_pool()
        remaining = None
        if cntl._deadline:
            remaining = max(0.001, cntl._deadline - time.monotonic())
        _track_inflight(sock, cid)
        rc = sock.write(
            data,
            on_error=lambda code, text: (
                pool.spawn(call_id_space.error, cid, code, text)
                if _claim_inflight(sock, cid)
                else None
            ),
            timeout=remaining,
        )
        if rc != 0:
            self._arbitrate_error(cntl, rc, f"write to {sock.remote} failed")

    def _write_fifo_correlated(self, sock, cntl: Controller, cid: int, data) -> None:
        """Write a frame whose response matches by connection order (HTTP):
        append the cid to the socket's pending FIFO and write under one
        lock so two callers can't interleave order; dead sockets fail the
        FIFO's calls (late responses then fail their id lock and drop).
        Called with the id locked, like the rest of IssueRPC."""
        lock = sock.context.get("_fifo_lock")
        if lock is None:
            lock = sock.context.setdefault("_fifo_lock", threading.Lock())
        pending = sock.context.get("http_pending")
        if pending is None:
            pending = sock.context.setdefault("http_pending", collections.deque())

            def _fail_fifo(s):
                # fail every call still waiting for an ordered response —
                # the fail-fast-at-SetFailed invariant of _track_inflight
                lk = s.context.get("_fifo_lock")
                q = s.context.get("http_pending")
                drained = []
                if lk is not None and q is not None:
                    with lk:
                        drained = list(q)
                        q.clear()
                for c in drained:
                    global_worker_pool().spawn(
                        call_id_space.error,
                        c,
                        ErrorCode.EFAILEDSOCKET,
                        f"connection to {s.remote} failed with the call in flight",
                    )

            sock.on_failed.append(_fail_fifo)
        pool = global_worker_pool()
        with lock:
            # append BEFORE the write: the response can be processed before
            # this thread takes another step, so the cid must already be in
            # the FIFO. A refused write removes it under the SAME lock.
            pending.append(cid)
            try:
                rc = sock.write(
                    data,
                    on_error=lambda code, text: pool.spawn(call_id_space.error, cid, code, text),
                )
            except BaseException:
                # an exception must not strand a dead cid at the FIFO head
                # (it would shift every later response one call off)
                try:
                    pending.remove(cid)
                except ValueError:
                    pass
                raise
            if rc != 0:
                try:
                    pending.remove(cid)
                except ValueError:
                    pass  # a (failed) response path already consumed it
        if rc != 0:
            self._arbitrate_error(cntl, rc, f"write to {sock.remote} failed")

    def _handle_id_error(self, cid: int, cntl: Controller, code: int, text: str) -> None:
        """CallIdSpace on_error: runs with the id locked — the
        OnVersionedRPCReturned error path (controller.cpp:545)."""
        self._arbitrate_error(cntl, code, text)
        # _arbitrate_error either destroyed the id (terminal) or left it
        # locked after re-issuing; unlock in the latter case.
        if call_id_space.valid(cid):
            call_id_space.unlock(cid)

    def _arbitrate_error(self, cntl: Controller, code: int, text: str) -> None:
        """Retry / backup / fail decision. Id is locked; does NOT unlock
        (caller decides), but EndRPC destroys."""
        if code == ErrorCode.EBACKUPREQUEST:
            # backup timer fired: issue a duplicate, keep the original in
            # flight (controller.cpp:565-598)
            if not cntl.has_backup_request:
                cntl.has_backup_request = True
                # the attempts in flight RIGHT NOW are merely raced, not
                # failed: EndRPC settles them as EBACKUPREQUEST (ignored by
                # the circuit breaker) — later retried-away attempts still
                # settle as genuine failures
                cntl._backup_superseded = {s.id for s in cntl._sent_sockets}
                if cntl._sent_sockets:
                    cntl._excluded_sockets.add(cntl._sent_sockets[-1].id)
                self._issue_rpc(cntl)
            return
        if self._should_retry(cntl, code) and cntl.retried_count < cntl.max_retry:
            if self._budget_allows(code):
                cntl.retried_count += 1
                if cntl._sent_sockets:
                    cntl._excluded_sockets.add(cntl._sent_sockets[-1].id)
                cntl._reset_for_retry()
                self._issue_rpc(cntl)
                return
            # budget exhausted: fail fast with the ORIGINAL error — the
            # whole point is NOT multiplying a brownout's offered load
            text = f"{text} (retry budget exhausted)"
        cntl.set_failed(code, text)
        self._end_rpc(cntl)

    def _budget_allows(self, code: int) -> bool:
        """One retry's draw against this channel's retry budget (exempt
        codes pass without drawing; no budget = unlimited)."""
        b = self._retry_budget
        return b is None or b.acquire(code)

    def _should_retry(self, cntl: Controller, code: int) -> bool:
        """RetryPolicy::DoRetry (retry_policy.h): the channel's custom
        policy sees the attempt's error on the controller; default = the
        retriable-code set. ECANCELED never retries — a cancel is the
        caller's decision, not a transient."""
        if code == ErrorCode.ECANCELED:
            return False
        policy = self._options.retry_policy
        if policy is None:
            return code in RETRIABLE
        saved = cntl.error_code
        cntl.error_code = code  # DoRetry reads cntl->ErrorCode()
        try:
            return bool(policy(cntl))
        except Exception:
            logger.exception("retry_policy raised; not retrying")
            return False
        finally:
            cntl.error_code = saved  # probing must not settle the call

    def _on_rpc_returned(self, cntl: Controller, frame: ParsedFrame, sock) -> None:
        """Response arrived (id locked by process_response)."""
        budget_note = ""
        retry = False
        if (
            frame.error_code != 0
            and self._should_retry(cntl, frame.error_code)
            and cntl.retried_count < cntl.max_retry
        ):
            if self._budget_allows(frame.error_code):
                retry = True
            else:
                # the same marker as _arbitrate_error's: budget-capped
                # failures read alike on both response paths
                budget_note = " (retry budget exhausted)"
        if retry:
            cntl.retried_count += 1
            cntl._excluded_sockets.add(sock.id)
            if on_reactor_thread():
                # re-issuing may dial a fresh connection (blocking): hand
                # off to a fiber; the id STAYS locked across the handoff
                # (the lock is state, not thread-bound)
                def _retry_off_reactor():
                    self._issue_rpc(cntl)
                    call_id_space.unlock(cntl.call_id)

                global_worker_pool().spawn(_retry_off_reactor)
                return
            self._issue_rpc(cntl)
            call_id_space.unlock(cntl.call_id)
            return
        if frame.error_code != 0:
            cntl.set_failed(
                frame.error_code,
                ((frame.meta.error_text if frame.meta else "") or f"remote error {frame.error_code}")
                + budget_note,
            )
        else:
            payload = frame.payload
            if frame.meta and frame.meta.compress:
                try:
                    payload = compress_mod.decompress(frame.meta.compress, payload)
                except Exception as e:
                    cntl.set_failed(ErrorCode.ERESPONSE, f"decompress failed: {e}")
                    self._end_rpc(cntl)
                    return
            cntl.response_payload = payload
            cntl.response_attachment = frame.attachment
            cntl.response_meta = frame.meta
            if self._options.auth is not None:
                # a successful response proves the connection: stop sending
                # credentials on it (FightAuthentication settled)
                mark_authenticated(sock)
            if cntl._request_stream is not None and frame.meta is not None and frame.meta.stream_id:
                # handshake complete: the server's stream id arrived
                cntl._request_stream._connect(sock, frame.meta.stream_id)
        self._end_rpc(cntl)

    def _end_rpc(self, cntl: Controller) -> None:
        """EndRPC: cancel timers, destroy the id (wakes joiners), run done.
        Called with the id locked; the id is dead afterwards."""
        cntl._mark_end()
        if self._lb is not None:
            # every issued attempt (retries, backup duplicates) was a
            # select() — feed each back exactly once so LA's in-flight
            # accounting balances (Call::OnComplete does per-call Feedback,
            # controller.cpp:698-777). A backup-raced attempt is not a node
            # failure (it may be healthy but slow): exactly the sockets in
            # flight when the backup fired settle as EBACKUPREQUEST, which
            # the circuit breaker ignores; attempts retried away on a
            # genuine error still charge their node's breaker
            last = cntl._sent_sockets[-1] if cntl._sent_sockets else None
            raced = getattr(cntl, "_backup_superseded", ())
            for sock in cntl._sent_sockets:
                if sock is last:
                    code = cntl.error_code
                elif sock.id in raced:
                    code = ErrorCode.EBACKUPREQUEST
                else:
                    code = ErrorCode.EFAILEDSOCKET
                self._lb.feedback(sock, cntl.latency_us, code)
        timer = global_timer_thread()
        for tid in cntl._timer_ids:
            timer.unschedule(tid)
        cntl._timer_ids.clear()
        for sock in cntl._sent_sockets:
            cids = sock.context.get("_inflight_cids")
            if cids is not None:
                cids.discard(cntl.call_id)
        if cntl._span is not None:
            end_client_span(cntl)
        # settle every attempt's pooled/short connection now — except one a
        # live stream is bound to, which is released when the stream ends.
        # A pooled socket is only reusable when this was a clean,
        # single-attempt success (a timed-out or superseded attempt may
        # still carry a request in flight)
        reusable = cntl.ok() and len(cntl._call_socks) <= 1
        stream = cntl._request_stream
        stream_sock = stream._sock if stream is not None else None
        for kind, sock in cntl._call_socks:
            if sock is stream_sock:
                sock.context["_stream_dispose"] = lambda _k=kind, _s=sock, _r=reusable: (
                    self._dispose_attempt_sock(_k, _s, _r)
                )
                if stream.state == stream_mod.CLOSED:
                    # the stream raced us and already ran _unhook_socket:
                    # whoever pops the callback runs it (dict.pop is atomic)
                    late = sock.context.pop("_stream_dispose", None)
                    if late is not None:
                        late()
                continue
            self._dispose_attempt_sock(kind, sock, reusable)
        cntl._call_socks.clear()
        if stream is not None and stream.state == stream_mod.CONNECTING:
            # RPC ended without the server accepting: kill the half-open
            # stream so writers don't block forever
            stream._fail(
                cntl.error_code or ErrorCode.EREQUEST,
                cntl.error_text or "stream not accepted",
            )
        call_id_space.unlock_and_destroy(cntl.call_id)
        ps = cntl._poll_sock
        if ps is not None:
            # a sync caller is poll-driving some socket: if the RPC ended on
            # a different path (other socket, timer), wake it now
            ps.kick_poller()
        if cntl._done is not None:
            global_worker_pool().spawn(cntl._done, cntl)
