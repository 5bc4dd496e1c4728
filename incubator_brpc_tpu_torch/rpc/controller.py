"""Controller — per-RPC state machine and user knob surface (reference
src/brpc/controller.h:98, controller.cpp).

One Controller accompanies one RPC on either side:
- client side: carries timeout/retry/backup options in, and the response
  payload/meta/error out; the retry/backup arbitration of
  OnVersionedRPCReturned (controller.cpp:545-676) lives in channel.py and
  mutates this object under the call-id lock.
- server side: carries the request meta/attachment and the call id in,
  and the error-code/attachment out (set_failed → error response).
  ``DeviceEndpoint.server_handler`` reads ``call_id`` and calls
  ``set_failed`` with these meanings.

The port's copy of the JAX package's ``rpc/controller.py`` with the
backup request (``backup_request_ms``), session data
(``session_local_data``) and the tracing state of rpcz (``trace_id``,
``span_id``, ``parent_span_id``, the head-based ``trace_sampled`` bit and
the call's span).
The constructor keeps the reference's parameters in their places
(``backup_request_ms`` before ``log_id``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, List, Optional

from incubator_brpc_tpu_torch.protocol.tbus_std import Meta
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint
from incubator_brpc_tpu_torch.utils.status import ErrorCode, berror


class Controller:
    # defaults mirror ChannelOptions (reference channel.h: timeout 500 ms,
    # max_retry 3, backup off)
    DEFAULT_TIMEOUT_MS = 500
    DEFAULT_MAX_RETRY = 3

    def __init__(
        self,
        timeout_ms: Optional[float] = None,
        max_retry: Optional[int] = None,
        backup_request_ms: float = -1,
        log_id: int = 0,
    ):
        # -- options (client) --
        self.timeout_ms = (
            self.DEFAULT_TIMEOUT_MS if timeout_ms is None else timeout_ms
        )
        self.max_retry = self.DEFAULT_MAX_RETRY if max_retry is None else max_retry
        # fire a duplicate to another server when the first attempt has not
        # answered after this long (<= 0 off); the faster reply wins
        self.backup_request_ms = backup_request_ms
        self.log_id = log_id
        self.compress_type: str = ""
        self.request_attachment: bytes = b""
        # request meta extras copied into Meta.extra (an http channel's
        # http_method / http_path override the gateway's POST route)
        self.request_extra: dict = {}

        # -- in/out state --
        self.call_id: int = 0
        self.error_code: int = 0
        self.error_text: str = ""
        self.response_payload: bytes = b""
        self.response_attachment: bytes = b""
        self.response_meta: Optional[Meta] = None
        self.request_meta: Optional[Meta] = None  # server side
        self.remote_side: Optional[EndPoint] = None
        self.retried_count: int = 0
        self.has_backup_request: bool = False
        self.latency_us: float = 0.0
        self.trace_id: int = 0
        self.span_id: int = 0
        self.parent_span_id: int = 0
        # head-based coherent-sampling bit: set by start_client_span (or
        # preset by the caller) and stamped on the wire — a downstream
        # hop seeing 1 collects its span regardless of local election
        self.trace_sampled: int = 0

        # -- internals (owned by channel.py / server.py) --
        self._start_ts: float = 0.0
        self._deadline: float = 0.0
        self._done: Optional[Callable[["Controller"], None]] = None
        self._timer_ids: List[Any] = []
        self._service: str = ""
        self._method: str = ""
        self._request_payload: bytes = b""
        self._channel = None
        self._server = None
        self._sent_sockets: List[Any] = []
        self._excluded_sockets: set = set()  # ExcludedServers retry avoidance
        self._span = None  # this call's rpcz span (builtin/rpcz.py)
        # set while a sync caller is poll-driving a socket's reads; whoever
        # ends the RPC kicks it so the poller stops waiting (sock.py's
        # caller-driven read path)
        self._poll_sock = None
        # sync fast path: _issue_rpc pre-claims read ownership of the
        # request socket BEFORE writing, so the caller reaches select with
        # almost no GIL-held work after the send syscall
        self._want_poll = False
        self._poll_owned = None
        # forces this call onto the host (TCP) socket even on a
        # transport='tpu' channel (the device-link handshake itself)
        self._force_host = False
        # (kind, socket) per attempt for pooled/short connection types —
        # disposed together at EndRPC (never mid-call: a backup request
        # keeps the original attempt's connection in flight)
        self._call_socks: List[Any] = []
        # streaming handshake (rpc/stream.py): client's half-open stream out,
        # server's accepted id back (request_stream in RpcMeta, stream.cpp)
        self._request_stream = None
        self._accepted_stream_id: int = 0

    # -- status surface (reference Controller::Failed/ErrorCode/ErrorText) --

    def failed(self) -> bool:
        return self.error_code != 0

    def set_failed(self, code: int, text: str = "") -> None:
        self.error_code = code
        self.error_text = text or berror(code)

    def ok(self) -> bool:
        return self.error_code == 0

    def session_local_data(self):
        """Per-connection pooled user data, lazily borrowed from the
        server's session pool on this connection's first access
        (reference Controller::session_local_data() backed by
        ServerOptions.session_local_data_factory, server.h:55-239).
        None on the client side or without a factory."""
        if self._server is None:
            return None
        return self._server.session_local_data(getattr(self, "_sock", None))

    def start_cancel(self) -> None:
        """Cancel this in-flight RPC from any thread (reference
        Controller::StartCancel, controller.cpp:699): the call fails with
        ECANCELED — joiners wake, the done callback runs, and any late
        response is dropped at the dead id. Asynchronous: the RPC may still
        complete first; no-op when the call already settled.

        Client-side only: a server-side Controller's call_id is the PEER's
        wire id, so cancelling it against the local id space is refused."""
        if self._server is not None:
            logging.getLogger(__name__).warning(
                "start_cancel on a server-side Controller is a no-op"
            )
            return
        if not self.call_id:
            return  # settled: nothing registered to cancel
        from incubator_brpc_tpu_torch.rpc.channel import start_cancel

        start_cancel(self.call_id)

    # -- internals -----------------------------------------------------------

    def deadline_left_ms(self) -> Optional[float]:
        """Milliseconds of deadline budget left for this RPC (may be
        negative once expired), or None when no deadline applies. Client
        side: remaining of the call's own timeout. Server side: remaining
        of the PROPAGATED budget the request arrived with (meta
        ``timeout_ms``)."""
        if self._deadline:
            return (self._deadline - time.monotonic()) * 1000.0
        return None

    def _reset_for_retry(self) -> None:
        self.error_code = 0
        self.error_text = ""

    def _mark_start(self) -> None:
        self._start_ts = time.monotonic()
        if self.timeout_ms is not None and self.timeout_ms > 0:
            self._deadline = self._start_ts + self.timeout_ms / 1000.0

    def _mark_end(self) -> None:
        if self._start_ts:
            self.latency_us = (time.monotonic() - self._start_ts) * 1e6

    def __repr__(self) -> str:
        st = "ok" if self.ok() else f"err={self.error_code} {self.error_text!r}"
        return (
            f"<Controller {self._service}.{self._method} cid={self.call_id:#x} "
            f"retried={self.retried_count} {st}>"
        )


# retriable errors (reference default RetryPolicy, retry_policy.cpp: retries
# connectivity failures — including EHOSTDOWN — and ELOGOFF (a stopping or
# lame-duck server refusing new work is transient by design: the retry
# lands on another replica), never server-side application errors or
# timeouts)
RETRIABLE = frozenset(
    {
        ErrorCode.EFAILEDSOCKET,
        ErrorCode.EEOF,
        ErrorCode.ECLOSE,
        ErrorCode.EHOSTDOWN,
        ErrorCode.ELOGOFF,
    }
)
