"""InputMessenger — bytes → protocol messages (reference
src/brpc/input_messenger.cpp).

Kept semantics:
- resumable cut loop over the socket's read IOBuf: try the socket's
  remembered protocol first, then every registered parser
  (CutInputMessage + _preferred_index, input_messenger.cpp:60-129);
- a parser that raises ParseError means "not mine — try others"; all
  parsers rejecting means wire garbage → socket failed with EREQUEST;
- a frame whose header announces more than ``max_body_size`` (plus the
  header peek) is refused from its header, before its body is buffered;
- of N cut messages, the first N-1 are dispatched to fresh fibers and the
  LAST is processed inline in this fiber (locality optimization,
  input_messenger.cpp:143-164);
- stream frames are the exception: each is handed to its protocol's
  ``process_stream`` inline, in wire order, on this (one per socket)
  reading fiber, so a stream's ExecutionQueue receives its frames in the
  order they were sent (the reference routes streaming messages during
  the parse phase for the same reason).

The port's copy of the JAX package's ``transport/messenger.py``. Every
registered protocol sizes its frames from ``parse_header`` (tbus_std then
cuts them off the read IOBuf through ``parse_iobuf``); a protocol with a
stateful per-connection cut (``parse_conn``: HTTP's chunked bodies) owns
its connection's bytes once preferred, and may claim a connection from the
header scan by answering None (the takeover signal). Frames of a protocol
without correlation ids (HTTP) run inline in wire order, through their
ordering hooks (``pre_dispatch``) and, for a handler that reads a body
this fiber still feeds, on a worker spawned in wire order
(``force_worker``). The protocol scan skips a protocol whose option gate
(``enabled_for``) refuses the connection, as the JAX package's does: nshead
only where the server registered an ``nshead_service``, the legacy client
rows only on a socket tagged with their FIFO protocol. The user message
handler is not copied.
"""

from __future__ import annotations

import logging
import time
from typing import Iterator, List, Tuple

from incubator_brpc_tpu_torch.protocol.registry import (
    MAX_HEADER_PEEK,
    Protocol,
    protocol_registry,
)
from incubator_brpc_tpu_torch.protocol.tbus_std import FatalParseError, ParseError
from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool
from incubator_brpc_tpu_torch.utils.flags import get_flag
from incubator_brpc_tpu_torch.utils.status import ErrorCode

logger = logging.getLogger(__name__)

_HEADER_PEEK = 64  # covers every registered protocol's fixed header


class InputMessenger:
    @staticmethod
    def _ordered(sock) -> Iterator[Protocol]:
        """The protocols the scan may try on ``sock``, its preferred one
        first. Lazy: the scan stops at the first that matches, which on a
        settled connection is the preferred one, so no other gate runs."""
        pref = sock.preferred_protocol
        if pref is not None and (pref.enabled_for is None or pref.enabled_for(sock)):
            yield pref
        for p in protocol_registry.ordered():
            if p is not pref and (p.enabled_for is None or p.enabled_for(sock)):
                yield p

    def process(self, sock, defer_tail: bool = False):
        """Cut and dispatch every complete message in sock._read_buf.

        ``defer_tail=True`` (the reactor's ProcessEvent path): the last
        message is NOT processed here — it is returned as ``(proto,
        frame)`` for the caller to run AFTER releasing the socket's read
        state, so a handler that blocks cannot hold this connection's
        reader (the reference gets this for free from M:N bthreads)."""
        cut: List[Tuple[Protocol, object]] = []
        buf = sock._read_buf
        max_body = int(get_flag("max_body_size"))
        while True:
            pref = sock.preferred_protocol
            if pref is not None and pref.parse_conn is not None:
                # stateful per-connection cut: the protocol owns the
                # connection's bytes once preferred, and may hold a
                # decode in progress even when the buffer is empty;
                # consumed-without-frame is progress
                try:
                    frame, consumed = pref.parse_conn(sock, buf)
                except FatalParseError as e:
                    self._dispatch(sock, cut)  # never defer on a dying conn
                    sock.set_failed(ErrorCode.EREQUEST, f"corrupt frame: {e}")
                    return None
                except ParseError as e:
                    self._dispatch(sock, cut)
                    sock.set_failed(ErrorCode.EREQUEST, f"unparsable: {e}")
                    return None
                if frame is not None:
                    cut.append((pref, frame))
                    continue
                if consumed:
                    continue
                break  # incomplete: wait for more bytes
            if len(buf) < 8:
                break
            header = buf.to_bytes(_HEADER_PEEK)
            matched = None
            total = None
            for proto in self._ordered(sock):
                try:
                    total = proto.parse_header(header)
                    if total is None and len(buf) > len(header):
                        # a header block longer than the fast peek (HTTP):
                        # peek deeper before concluding "incomplete"
                        deeper = buf.to_bytes(min(len(buf), MAX_HEADER_PEEK))
                        if len(deeper) > len(header):
                            total = proto.parse_header(deeper)
                except FatalParseError as e:
                    # the protocol MATCHED but the frame is unacceptable
                    # (an unsupported transfer coding): fail with the
                    # protocol's own diagnostic
                    self._dispatch(sock, cut)
                    sock.set_failed(ErrorCode.EREQUEST, f"{proto.name}: {e}")
                    return None
                except ParseError:
                    continue
                matched = proto
                break
            if matched is None:
                self._dispatch(sock, cut)
                sock.set_failed(ErrorCode.EREQUEST, "unparsable bytes on the wire")
                return None
            sock.preferred_protocol = matched
            if total is None:
                if matched.parse_conn is not None:
                    # a stateful protocol signalled takeover (a chunked
                    # body whose size is unknowable up front): loop so
                    # parse_conn sees the bytes already buffered
                    continue
                break  # header itself incomplete
            # flag bounds the *body*; allow any registered header on top
            if total > max_body + MAX_HEADER_PEEK:
                self._dispatch(sock, cut)
                sock.set_failed(
                    ErrorCode.EREQUEST, f"frame of {total} B exceeds max_body_size"
                )
                return None
            if len(buf) < total:
                break
            try:
                if matched.parse_iobuf is not None:
                    frame, consumed = matched.parse_iobuf(buf)
                else:
                    raw = buf.to_bytes(total)
                    buf.popn(total)
                    frame, consumed = matched.parse(raw)
            except ParseError as e:
                self._dispatch(sock, cut)
                sock.set_failed(ErrorCode.EREQUEST, f"corrupt frame: {e}")
                return None
            if frame is None or consumed != total:
                self._dispatch(sock, cut)
                sock.set_failed(ErrorCode.EREQUEST, "parser/header length mismatch")
                return None
            cut.append((matched, frame))
        return self._dispatch(sock, cut, defer_tail=defer_tail)

    def _dispatch(self, sock, cut, defer_tail: bool = False):
        if not cut:
            return None
        # arrival stamp for deadline propagation: a request's remaining
        # budget (meta timeout_ms) is measured from when its frame was cut
        # off the wire, so time spent queued behind the worker pool or
        # earlier frames of this burst counts against it. One clock read
        # per burst.
        now = time.monotonic()
        for _proto, frame in cut:
            frame.arrival_ts = now
        # Two classes of frame are handled inline, in wire order, on this
        # (one per socket) reader fiber: stream frames (module docstring),
        # and frames whose protocol has no correlation ids (HTTP), whose
        # responses must be written in request order. Everything else gets
        # the N-1-fibers + last-inline treatment.
        rest = []
        for proto, frame in cut:
            pre = getattr(frame, "pre_dispatch", None)
            if pre is not None:
                # ordering hooks (HTTP's response-order gates) run at
                # dispatch time, in wire order — never at cut time, where
                # earlier frames of the same burst would observe them
                pre(sock)
            if getattr(frame, "force_worker", False):
                # a progressive-upload handler blocks reading a body THIS
                # fiber feeds: inline would deadlock, and it must spawn IN
                # WIRE ORDER (a later inline frame may park on its gate)
                global_worker_pool().spawn(self._process_one, sock, proto, frame)
                continue
            if getattr(frame, "process_inline", False) or (
                frame.is_stream and proto.process_stream is not None
            ):
                self._process_one(sock, proto, frame)
            else:
                rest.append((proto, frame))
        if not rest:
            return None
        pool = global_worker_pool()
        for proto, frame in rest[:-1]:
            pool.spawn(self._process_one, sock, proto, frame)
        proto, frame = rest[-1]
        if defer_tail:
            return (proto, frame)
        self._process_one(sock, proto, frame)  # last message inline
        return None

    @staticmethod
    def _process_one(sock, proto: Protocol, frame) -> None:
        try:
            if frame.is_stream and proto.process_stream is not None:
                proto.process_stream(sock, frame)
            elif frame.is_response:
                if proto.process_response is not None:
                    proto.process_response(sock, frame)
            elif proto.process_request is not None:
                proto.process_request(sock, frame)
            else:
                logger.warning("no handler for %s message on %r", proto.name, sock)
        except Exception:
            logger.exception("message handler failed on %r", sock)
