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

The port's copy of the JAX package's ``transport/messenger.py`` on its
header-peek path (every registered protocol of the port sizes its frames
from ``parse_header``, and tbus_std cuts them off the read IOBuf through
``parse_iobuf``); stateful per-connection protocols and the HTTP ordering
hooks are not copied.
"""

from __future__ import annotations

import logging
import time
from typing import List, Tuple

from incubator_brpc_tpu_torch.protocol.registry import (
    MAX_HEADER_PEEK,
    Protocol,
    protocol_registry,
)
from incubator_brpc_tpu_torch.protocol.tbus_std import ParseError
from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool
from incubator_brpc_tpu_torch.utils.flags import get_flag
from incubator_brpc_tpu_torch.utils.status import ErrorCode

logger = logging.getLogger(__name__)

_HEADER_PEEK = 64  # covers every registered protocol's fixed header


class InputMessenger:
    @staticmethod
    def _ordered(sock) -> List[Protocol]:
        protos = protocol_registry.ordered()
        pref = sock.preferred_protocol
        if pref is not None and pref in protos and protos[0] is not pref:
            protos = [pref] + [p for p in protos if p is not pref]
        return protos

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
        while len(buf) >= 8:
            header = buf.to_bytes(_HEADER_PEEK)
            matched = None
            total = None
            for proto in self._ordered(sock):
                try:
                    total = proto.parse_header(header)
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
        # stream frames run inline, in wire order (module docstring);
        # everything else gets the N-1-fibers + last-inline treatment
        rest = []
        for proto, frame in cut:
            if frame.is_stream and proto.process_stream is not None:
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
