"""Streaming RPC — ordered, flow-controlled byte-message streams riding an
established connection (reference src/brpc/stream.{h,cpp}, stream_impl.h,
policy/streaming_rpc_protocol.cpp).

Kept design points (and where they live in the reference):
- The handshake piggybacks on a normal RPC (``request_stream`` in RpcMeta):
  the client creates a half-open stream whose id travels in the request
  meta; the server accepts inside the handler and returns its own id in
  the response meta (stream.cpp StreamCreate/StreamAccept; SURVEY §3.4).
- Data path: every received message is pushed into a per-stream
  ExecutionQueue so one consumer fiber handles messages in order
  (stream.cpp:86 _fake_socket + execution_queue consumer).
- Flow control: the writer may have at most ``max_buf_size`` bytes
  unconsumed by the remote; past that, ``write`` parks on a butex until a
  feedback frame lifts ``_remote_consumed``
  (Stream::AppendIfNotFull stream.cpp:263-300, SetRemoteConsumed :287).
- Close is a frame like any other; the consumer sees it in order, fires
  ``on_closed``, and the registry entry dies (versioned ids are not needed:
  ids are never reused).

Deviation: the reference routes writes through a fake Socket so the
wait-free write queue is shared (STREAM_FAKE_FD, socket.h:193); here stream
frames are packed directly onto the real Socket's MPSC write queue — same
single-drainer property, one less indirection.

The port's copy of the JAX package's ``rpc/stream.py``, whole, but for the
caller-driven write drain: a data frame goes through ``Socket.write`` like
any other frame (the port's Socket has no ``drain_inline``). A stream
rides a TCP Socket or a DeviceSocket alike (``transport="tpu"``: its
frames ride the link's byte stream).
"""

from __future__ import annotations

import itertools
import logging
import threading
from typing import Callable, Dict, List, Optional

from incubator_brpc_tpu_torch import protocol as proto_pkg
from incubator_brpc_tpu_torch.protocol.tbus_std import (
    FLAG_STREAM,
    Meta,
    ParsedFrame,
    pack_frame,
    pack_frame_iobuf,
)
from incubator_brpc_tpu_torch.runtime.butex import Butex, ETIMEDOUT
from incubator_brpc_tpu_torch.runtime.execution_queue import ExecutionQueue, TaskIterator
from incubator_brpc_tpu_torch.utils.status import ErrorCode

logger = logging.getLogger(__name__)

# frame kinds inside meta.extra["ft"] (reference StreamFrameMeta.frame_type:
# FRAME_TYPE_DATA / FEEDBACK / CLOSE / RST, streaming_rpc_meta.proto)
FT_DATA = "data"
FT_FEEDBACK = "fb"
FT_CLOSE = "close"
FT_RST = "rst"

IDLE = 0
CONNECTING = 1
CONNECTED = 2
CLOSED = 3


class StreamOptions:
    """Reference StreamOptions (stream.h:40-78)."""

    def __init__(
        self,
        handler: Optional["StreamHandler"] = None,
        max_buf_size: int = 2 * 1024 * 1024,
        messages_in_batch: int = 128,
        raw_messages: bool = False,
    ):
        self.handler = handler
        self.max_buf_size = max_buf_size  # 0 = unlimited (no flow control)
        self.messages_in_batch = messages_in_batch
        # True: on_received_messages gets zero-copy IOBuf objects (the
        # reference's contract — stream.h hands butil::IOBuf*s); False
        # (default) keeps this API's bytes convenience, materialized at
        # consumption on the ordered consumer fiber
        self.raw_messages = raw_messages


class StreamHandler:
    """User callbacks (reference StreamInputHandler, stream.h:29-38).
    Subclass and override; all run on the stream's ordered consumer fiber."""

    def on_received_messages(self, stream: "Stream", messages: List[bytes]) -> None:
        pass

    def on_closed(self, stream: "Stream") -> None:
        pass

    def on_failed(self, stream: "Stream", error_code: int, reason: str) -> None:
        """Transport died under the stream (no CLOSE will follow)."""
        self.on_closed(stream)


class Stream:
    """One direction-pair endpoint. Not built directly — use
    ``stream_create`` (client) / ``stream_accept`` (server handler)."""

    def __init__(self, stream_id: int, options: StreamOptions, is_client: bool):
        self.id = stream_id
        self.options = options
        self.is_client = is_client
        self.state = CONNECTING if is_client else IDLE
        self.error_code = 0
        self.error_text = ""
        self.remote_id: int = 0
        self._sock = None
        self._lock = threading.Lock()
        # writer-side window (stream.cpp:263-300)
        self._produced = 0  # bytes written to the wire
        self._remote_consumed = 0  # last feedback
        self._wbutex = Butex(0)
        # reader side
        self._consumed = 0  # bytes this side has handled
        self._last_feedback = 0  # _consumed value last told to the peer
        self._rq: ExecutionQueue = ExecutionQueue(
            self._consume, max_batch=options.messages_in_batch
        )
        self._close_sent = False
        self._connected_event = threading.Event()

    # -- connection plumbing (module-level handshake hooks call these) ------

    def _connect(self, sock, remote_id: int) -> None:
        with self._lock:
            if self.state == CLOSED:
                return
            self._sock = sock
            self.remote_id = remote_id
            self.state = CONNECTED
        sock.on_failed.append(self._on_socket_failed)
        self._connected_event.set()

    def wait_connected(self, timeout: Optional[float] = None) -> bool:
        """Client: block until the handshake response arrived (the reference
        blocks the first StreamWrite instead; explicit is clearer)."""
        return self._connected_event.wait(timeout)

    # -- writer side --------------------------------------------------------

    def write(self, data: bytes, timeout: Optional[float] = None) -> int:
        """Send one message. 0 on success; EAGAIN if the window is full and
        ``timeout`` expired (timeout=0 → immediate EAGAIN, None → block
        forever); EOVERCROWDED if the socket backlog refused the frame
        (transient — retry); EINVAL once closed/failed."""
        import time as _time

        n = len(data)
        limit = self.options.max_buf_size
        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            with self._lock:
                if self.state != CONNECTED:
                    return ErrorCode.EINVAL
                # Admit while the current gap is below the limit — one
                # in-flight message may overshoot the window, so a message
                # larger than max_buf_size still goes out on an idle stream
                # (AppendIfNotFull stream.cpp:263 checks the same way).
                if not limit or (self._produced - self._remote_consumed) < limit:
                    self._produced += n
                    sock, rid = self._sock, self.remote_id
                    break
            if timeout == 0:
                return ErrorCode.EAGAIN
            remaining = None
            if deadline is not None:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return ErrorCode.EAGAIN
            seq = self._wbutex.load()
            with self._lock:
                blocked = (
                    self.state == CONNECTED
                    and limit
                    and (self._produced - self._remote_consumed) >= limit
                )
            if blocked and self._wbutex.wait(seq, timeout=remaining) == ETIMEDOUT:
                return ErrorCode.EAGAIN
        meta = Meta(stream_id=rid, extra={"ft": FT_DATA, "from": self.id})
        # IOBuf pack: no body/frame concat copies on the data hot path. The
        # write gets the REMAINING budget (the window wait above may have
        # consumed most of ``timeout``): a DeviceSocket's send may park on
        # its link window for that long; a TCP Socket never waits.
        budget = None
        if deadline is not None:
            budget = max(0.0, deadline - _time.monotonic())
        rc = sock.write(
            pack_frame_iobuf(meta, data, 0, flags=FLAG_STREAM),
            timeout=budget,
        )
        if rc == ErrorCode.EOVERCROWDED:
            # transient socket backpressure (socket.cpp:1537): surface it,
            # don't kill the stream; the rollback reopens the window so any
            # writer parked on it must be woken (no feedback will do it)
            with self._lock:
                self._produced -= n
            self._wbutex.add(1)
            self._wbutex.wake_all()
            return rc
        if rc != 0:
            self._fail(rc, "stream data write failed")
            return rc
        return 0

    def _set_remote_consumed(self, consumed: int) -> None:
        """Feedback arrived (SetRemoteConsumed stream.cpp:287): lift the
        window and wake blocked writers."""
        with self._lock:
            if consumed <= self._remote_consumed:
                return
            self._remote_consumed = consumed
        self._wbutex.add(1)
        self._wbutex.wake_all()

    # -- reader side --------------------------------------------------------

    def _on_frame(self, frame: ParsedFrame) -> None:
        ft = frame.meta.extra.get("ft", FT_DATA)
        if ft == FT_FEEDBACK:
            self._set_remote_consumed(int(frame.meta.extra.get("consumed", 0)))
            return
        # the IOBuf cut leaves stream payloads as zero-copy IOBuf cuts; the
        # consumer materializes only when the handler wants bytes
        data = frame.payload_iobuf
        self._rq.execute((ft, frame.payload if data is None else data))

    def _consume(self, it: TaskIterator) -> None:
        """Ordered consumer fiber (stream.cpp:86): batch data messages to the
        handler, then feed consumption back to the writer."""
        handler = self.options.handler
        batch: List[bytes] = []
        closed = False
        raw = self.options.raw_messages
        for ft, payload in it:
            if ft == FT_DATA:
                if not raw and not isinstance(payload, (bytes, bytearray)):
                    payload = payload.to_bytes()  # IOBuf -> bytes contract
                elif raw and isinstance(payload, (bytes, bytearray)):
                    # parse paths that materialized bytes (a frame with an
                    # attachment) still honor the raw IOBuf contract: wrap,
                    # don't surprise the handler
                    from incubator_brpc_tpu_torch.iobuf import IOBuf

                    wrapped = IOBuf()
                    wrapped.append(bytes(payload))
                    payload = wrapped
                batch.append(payload)
            elif ft in (FT_CLOSE, FT_RST):
                closed = True
        if batch:
            self._consumed += sum(len(m) for m in batch)
            if handler is not None:
                try:
                    handler.on_received_messages(self, batch)
                except Exception:
                    logger.exception("stream %d handler raised", self.id)
            self._send_feedback()
        if closed or it.is_queue_stopped():
            self._finish_close(notify=closed)

    def _send_feedback(self) -> None:
        with self._lock:
            if self.state != CONNECTED or self._consumed == self._last_feedback:
                return
            self._last_feedback = self._consumed
            sock, rid, consumed = self._sock, self.remote_id, self._consumed
        meta = Meta(stream_id=rid, extra={"ft": FT_FEEDBACK, "consumed": consumed})
        sock.write(pack_frame(meta, b"", 0, flags=FLAG_STREAM))

    # -- close / failure ----------------------------------------------------

    def close(self) -> None:
        """Send CLOSE; the peer's consumer sees it in order after all data
        (StreamClose stream.cpp)."""
        with self._lock:
            if self.state != CONNECTED or self._close_sent:
                self.state = CLOSED
                self._connected_event.set()
                _registry_remove(self.id)
                return
            self._close_sent = True
            sock, rid = self._sock, self.remote_id
        meta = Meta(stream_id=rid, stream_close=True, extra={"ft": FT_CLOSE})
        sock.write(pack_frame(meta, b"", 0, flags=FLAG_STREAM))
        # the local side is closed immediately; the consumer queue keeps
        # draining whatever the peer already sent
        self._finish_close(notify=False)

    def _finish_close(self, notify: bool) -> None:
        with self._lock:
            was_closed = self.state == CLOSED
            self.state = CLOSED
        self._connected_event.set()
        self._wbutex.add(1)
        self._wbutex.wake_all()
        self._unhook_socket()
        _registry_remove(self.id)
        if notify and not was_closed and self.options.handler is not None:
            try:
                self.options.handler.on_closed(self)
            except Exception:
                logger.exception("stream %d on_closed raised", self.id)

    def rst(self, code: int = ErrorCode.ECLOSE, reason: str = "stream reset") -> None:
        """Force-terminate the stream NOW: tell the peer with an RST frame
        (so its writer stops instead of filling a dead window) and fail
        the local side (the lame-duck drain, ``Server.enter_lame_duck``,
        sends it to the streams still open at grace expiry)."""
        with self._lock:
            sock, rid = self._sock, self.remote_id
            alive = self.state == CONNECTED
        if alive and sock is not None and rid:
            meta = Meta(stream_id=rid, extra={"ft": FT_RST})
            try:
                sock.write(pack_frame(meta, b"", 0, flags=FLAG_STREAM))
            except Exception:
                logger.exception("stream %d RST write failed", self.id)
        self._fail(code, reason)

    def _on_socket_failed(self, sock) -> None:
        self._fail(sock.error_code, sock.error_text or "transport failed")

    def _unhook_socket(self) -> None:
        """Drop our on_failed hook so closed streams don't accumulate on a
        long-lived connection, and release a pooled/short connection the
        channel deferred to us (the stream pinned it past EndRPC)."""
        sock = self._sock
        if sock is not None:
            try:
                sock.on_failed.remove(self._on_socket_failed)
            except ValueError:
                pass
            dispose = sock.context.pop("_stream_dispose", None)
            if dispose is not None:
                try:
                    dispose()
                except Exception:
                    logger.exception("stream connection disposal raised")

    def _fail(self, code: int, reason: str) -> None:
        with self._lock:
            if self.state == CLOSED:
                return
            self.state = CLOSED
            self.error_code = code
            self.error_text = reason
        self._connected_event.set()
        self._wbutex.add(1)
        self._wbutex.wake_all()
        self._unhook_socket()
        _registry_remove(self.id)
        if self.options.handler is not None:
            try:
                self.options.handler.on_failed(self, code, reason)
            except Exception:
                logger.exception("stream %d on_failed raised", self.id)

    @property
    def unconsumed_bytes(self) -> int:
        with self._lock:
            return self._produced - self._remote_consumed

    def __repr__(self) -> str:
        st = {IDLE: "idle", CONNECTING: "connecting", CONNECTED: "up", CLOSED: "closed"}
        return f"<Stream id={self.id} remote={self.remote_id} {st[self.state]}>"


# -- registry + module API ---------------------------------------------------

_streams: Dict[int, Stream] = {}
_streams_lock = threading.Lock()
_next_id = itertools.count(1)


def _registry_remove(sid: int) -> None:
    with _streams_lock:
        _streams.pop(sid, None)


def get_stream(sid: int) -> Optional[Stream]:
    with _streams_lock:
        return _streams.get(sid)


def open_streams(socks=None) -> List[Stream]:
    """Live (CONNECTED) streams — all of them, or only those riding one
    of the given sockets (``Server._open_streams``: a long-lived stream is
    in-flight work even when no RPC handler is running)."""
    with _streams_lock:
        items = list(_streams.values())
    live = [s for s in items if s.state == CONNECTED]
    if socks is None:
        return live
    sockset = set(socks)
    return [s for s in live if s._sock in sockset]


def stream_create(options: Optional[StreamOptions] = None) -> Stream:
    """Client side (StreamCreate stream.h:81): make the half-open stream,
    then pass it to ``Channel.call_method(..., request_stream=stream)`` —
    the id rides the request meta and the stream connects when the
    response returns."""
    s = Stream(next(_next_id), options or StreamOptions(), is_client=True)
    with _streams_lock:
        _streams[s.id] = s
    return s


def stream_accept(cntl, options: Optional[StreamOptions] = None) -> Optional[Stream]:
    """Server side (StreamAccept stream.h:96), called inside a handler whose
    request meta carries a stream id. Returns the accepted stream (already
    CONNECTED — the server knows the socket now), or None if the request
    carries no stream."""
    remote_id = getattr(cntl.request_meta, "stream_id", 0) if cntl.request_meta else 0
    sock = getattr(cntl, "_sock", None)
    if not remote_id or sock is None:
        return None
    s = Stream(next(_next_id), options or StreamOptions(), is_client=False)
    with _streams_lock:
        _streams[s.id] = s
    s._connect(sock, remote_id)
    cntl._accepted_stream_id = s.id  # echoed in the response meta
    return s


def process_stream(sock, frame: ParsedFrame) -> None:
    """tbus_std Protocol.process_stream hook: route a FLAG_STREAM frame to
    its stream by meta.stream_id (ParseStreamingMessage →
    Stream::OnReceived, SURVEY §3.4)."""
    s = get_stream(frame.meta.stream_id)
    if s is None:
        # peer doesn't know we're gone yet: answer data with RST so its
        # writer stops (frames carry the sender's id for exactly this)
        sender = frame.meta.extra.get("from", 0)
        if frame.meta.extra.get("ft", FT_DATA) == FT_DATA and sender:
            meta = Meta(stream_id=sender, extra={"ft": FT_RST})
            sock.write(pack_frame(meta, b"", 0, flags=FLAG_STREAM))
        return
    s._on_frame(frame)


proto_pkg.TBUS_STD.process_stream = process_stream
