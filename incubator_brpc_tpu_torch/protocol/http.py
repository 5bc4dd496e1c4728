"""HTTP/1.x protocol — the second wire protocol on the shared port
(reference src/brpc/policy/http_rpc_protocol.{h,cpp} + details/http_parser;
the server tries registered protocols per connection and remembers the
match, exactly as InputMessenger does here).

Server side: parses requests off the socket byte stream (resumable — an
incomplete request returns (None, 0)), routes them through the builtin
portal pages plus any handlers the owning Server registered with
``add_http_handler``, and writes an HTTP/1.1 keep-alive response.

Client side: ``http_call`` issues one request over a plain blocking socket
(tests and tools; the reference's full async http client rides the same
Socket machinery as everything else — ours can once needed).

Progressive responses: a handler returning an iterator of byte chunks
streams Transfer-Encoding: chunked (the ProgressiveAttachment /
ProgressiveReader analog, progressive_attachment.{h,cpp}); the client
decoder in ``http_call`` understands chunked bodies. Chunked *request*
bodies are dechunked up to the messenger's 64 KiB cut window (larger
uploads get a loud ParseError — use Content-Length or a stream). HTTP/2
remains out of scope (the reference fork has HPACK tables but no h2
framing either — SURVEY §2.4).

The port's copy of the JAX package's ``protocol/http.py``, whole. Requests
route through ``builtin/pages.handle``: the builtin portal pages first,
then the server's own custom handlers, restful mappings and the
``/<service>/<method>`` gateway.
"""

from __future__ import annotations

import logging
import socket as _pysocket
import threading
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qsl, urlsplit

from incubator_brpc_tpu_torch.protocol.registry import Protocol, protocol_registry
from incubator_brpc_tpu_torch.protocol.tbus_std import FatalParseError, ParseError

logger = logging.getLogger(__name__)

_METHODS = (b"GET ", b"POST ", b"PUT ", b"DELETE ", b"HEAD ", b"OPTIONS ", b"PATCH ")
_MAX_HEADER_BYTES = 64 * 1024
# Chunked request bodies are sized inside the shared deep-peek window:
# the oversize backstop only fires if that window actually reaches it, so
# the bound is DERIVED from the same constant the messenger uses, not
# declared independently (decoupled constants would reintroduce the
# stall-forever failure mode).
from incubator_brpc_tpu_torch.protocol.registry import (  # noqa: E402
    MAX_HEADER_PEEK as _CHUNKED_WINDOW,
)

assert _MAX_HEADER_BYTES <= _CHUNKED_WINDOW, (
    "http header cap must not exceed the messenger peek window"
)


class HttpFrame:
    """One parsed request (HttpMessage analog)."""

    is_response = False  # server-side frames only
    is_stream = False
    # HTTP/1.1 has no correlation ids: responses MUST go out in request
    # order, so the messenger processes these inline on the reader fiber
    # instead of fanning out to concurrent fibers
    process_inline = True

    def __init__(
        self,
        method: str,
        path: str,
        query: Dict[str, str],
        headers: Dict[str, str],
        body: bytes,
    ):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers  # keys lower-cased (CaseIgnoredFlatMap analog)
        self.body = body

    def __repr__(self) -> str:
        size = (
            f"{len(self.body)}B"
            if isinstance(self.body, (bytes, bytearray, memoryview))
            else type(self.body).__name__  # progressive: a reader, no len
        )
        return f"<HttpFrame {self.method} {self.path} {size}>"


def looks_like_http(buf: bytes) -> bool:
    head = buf[:8]
    return any(head.startswith(m[: len(head)]) for m in _METHODS)


def looks_like_http_response(buf: bytes) -> bool:
    head = buf[:5]
    return b"HTTP/"[: len(head)] == head


class HttpResponseFrame:
    """One parsed response (the client side of the Channel http stack).
    HTTP/1.1 has no correlation ids: responses match requests in FIFO
    order per connection, so processing is pinned inline on the reader."""

    is_response = True
    is_stream = False
    process_inline = True

    def __init__(self, status: int, headers: Dict[str, str], body: bytes):
        self.status = status
        self.headers = headers
        self.body = body

    def __repr__(self) -> str:
        return f"<HttpResponseFrame {self.status} {len(self.body)}B>"


def _transfer_encoding(headers_blob: str) -> Optional[str]:
    """The Transfer-Encoding value, lowercased/stripped, or None. A parsed
    predicate — substring scans over the whole blob would false-positive
    on 'chunked' in a URL, and header VALUES keep their original case
    (transfer-coding names are case-insensitive, RFC 9112)."""
    for line in headers_blob.split("\r\n"):
        k, _, v = line.partition(":")
        if k.strip().lower() == "transfer-encoding":
            return v.strip().lower()
    return None


def _content_length(headers_blob: str) -> int:
    """Extract+validate Content-Length from a raw header block. ParseError
    on malformed or negative values (the InputMessenger contract: anything
    other than ParseError would escape the cut loop and wedge the
    connection)."""
    for line in headers_blob.split("\r\n"):
        k, _, v = line.partition(":")
        if k.strip().lower() == "content-length":
            v = v.strip()
            if not v.isdigit():  # rejects negatives and garbage
                raise ParseError(f"bad Content-Length {v!r}")
            return int(v)
    return 0


def _dechunk(data, off: int):
    """Walk a chunked body from ``off``. Returns (body_bytes, end_offset)
    or None while incomplete; ParseError on malformed framing. Trailer
    headers after the terminal 0-chunk are skipped (RFC 9112 §7.1)."""
    out = bytearray()
    while True:
        nl = data.find(b"\r\n", off)
        if nl < 0:
            return None
        size_token = bytes(data[off:nl]).split(b";", 1)[0].strip()
        try:
            size = int(size_token, 16)
        except ValueError:
            raise ParseError(f"bad chunk size {size_token!r}")
        if size < 0:
            raise ParseError("negative chunk size")
        off = nl + 2
        if size == 0:
            while True:  # trailers, then one empty line
                nl2 = data.find(b"\r\n", off)
                if nl2 < 0:
                    return None
                if nl2 == off:
                    return bytes(out), off + 2
                off = nl2 + 2
        if off + size + 2 > len(data):
            return None
        out += data[off : off + size]
        if bytes(data[off + size : off + size + 2]) != b"\r\n":
            raise ParseError("chunk data not CRLF-terminated")
        off += size + 2


def _parse_request_head(head: str):
    """Shared request-line + header-block parser for the stateless cut
    (``parse``) and the stateful pinned path (``parse_conn``) — ONE copy,
    so validation (version check, header folding) cannot drift between
    them. Returns (method, target, headers)."""
    lines = head.split("\r\n")
    try:
        method, target, version = lines[0].split(" ", 2)
    except ValueError:
        raise ParseError(f"bad request line {lines[0]!r}") from None
    if not version.startswith("HTTP/1."):
        raise ParseError(f"unsupported version {version!r}")
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return method, target, headers


def parse_header(header: bytes) -> Optional[int]:
    """Total frame size once the header block is visible (the sizing hook —
    lets the messenger cut without copying the whole pending buffer, and
    puts HTTP bodies under the same max_body_size guard as tbus_std).
    None = header block incomplete (the messenger re-peeks deeper) OR a
    chunked request whose decode is stateful: the messenger pins this
    protocol and hands the connection to ``parse_conn``, which resumes
    dechunking across cut windows — uploads are bounded by max_body_size,
    not the peek window."""
    is_resp = looks_like_http_response(header)
    if not is_resp and not looks_like_http(header):
        raise ParseError("not http")
    head_end = header.find(b"\r\n\r\n")
    if head_end < 0:
        if len(header) >= _MAX_HEADER_BYTES:
            raise ParseError("http header block too large")
        return None
    blob = header[:head_end].decode("latin-1", errors="replace")
    te = _transfer_encoding(blob)
    if te is not None:
        if is_resp:
            if te != "chunked":
                raise FatalParseError(
                    f"unsupported transfer-encoding {te!r}"
                )
            # chunked RESPONSE (a progressive server body consumed over a
            # channel): stateful takeover, same as chunked requests
            return None
        if te != "chunked":
            # 'gzip, chunked' etc.: dechunking alone would hand handlers
            # still-encoded bytes — refuse rather than corrupt. Fatal: the
            # protocol matched, the frame is simply unacceptable.
            raise FatalParseError(f"unsupported transfer-encoding {te!r}")
        return None  # stateful takeover: parse_conn dechunks incrementally
    return head_end + 4 + _content_length(blob)


class ProgressiveReader:
    """Incremental request-body consumer (the reference's ProgressiveReader,
    progressive_reader.h + input_messenger.cpp:343-351): handlers registered
    with ``add_http_handler(..., progressive=True)`` run while the chunked
    upload is still arriving, with ``frame.body`` set to one of these.
    ``read()`` blocks until data is available (b"" at EOF); ``error`` is set
    if the connection died mid-upload."""

    def __init__(self):
        from incubator_brpc_tpu_torch.runtime.butex import Butex

        self._butex = Butex(0)
        self._lock = threading.Lock()
        self._chunks: list = []
        self._eof = False
        self.error: Optional[str] = None
        self.received = 0

    def _feed(self, data: bytes) -> None:
        with self._lock:
            self._chunks.append(data)
            self.received += len(data)
        self._butex.add(1)
        self._butex.wake_all()

    def _finish(self, error: Optional[str] = None) -> None:
        with self._lock:
            if self._eof:
                return  # a later conn failure must not stamp an error onto
                # a body that already arrived intact
            self._eof = True
            if error and self.error is None:
                self.error = error
        self._butex.add(1)
        self._butex.wake_all()

    def read(self, timeout: Optional[float] = 60.0) -> bytes:
        """Next buffered piece (blocking), b"" at EOF. Raises IOError when
        the upload failed mid-stream or the wait timed out."""
        while True:
            with self._lock:
                if self._chunks:
                    return self._chunks.pop(0)
                if self._eof:
                    if self.error is not None:
                        raise IOError(self.error)
                    return b""
                seq = self._butex.load()
            from incubator_brpc_tpu_torch.runtime.butex import ETIMEDOUT

            if self._butex.wait(seq, timeout=timeout) == ETIMEDOUT:
                with self._lock:
                    if not self._chunks and not self._eof:
                        raise IOError("progressive body read timed out")

    def read_all(self, timeout: Optional[float] = 60.0) -> bytes:
        out = bytearray()
        while True:
            piece = self.read(timeout=timeout)
            if not piece:
                return bytes(out)
            out += piece


class _ChunkState:
    """Resumable chunked-request decode for one connection: survives cut
    windows (the stateful per-conn decode RTMP uses, Protocol.parse_conn).
    Tracks the current chunk's remaining bytes so arbitrarily large chunks
    stream through without ever being buffered whole."""

    __slots__ = (
        "frame", "sink", "reader", "remaining", "expect_crlf",
        "in_trailer", "received", "max_total", "fail_hook",
    )

    def __init__(self, frame, reader: Optional[ProgressiveReader], max_total: int):
        self.frame = frame
        self.reader = reader
        self.sink = bytearray() if reader is None else None
        self.remaining = 0  # data bytes left in the current chunk
        self.expect_crlf = False  # chunk data done, its CRLF not yet seen
        self.in_trailer = False
        self.received = 0
        self.max_total = max_total
        self.fail_hook = None  # sock.on_failed entry, removed at EOF

    def feed(self, data: bytes) -> None:
        self.received += len(data)
        if self.received > self.max_total:
            raise FatalParseError(
                f"chunked body exceeds max_body_size ({self.max_total} B)"
            )
        if self.reader is not None:
            self.reader._feed(data)
        else:
            self.sink += data


def _conn_chunk_continue(sock, st: _ChunkState, buf) -> Tuple[Optional[HttpFrame], int]:
    """Consume whatever complete chunk pieces are visible; returns a frame
    only for the accumulate (non-progressive) mode's terminal chunk."""
    consumed = 0
    while True:
        n = len(buf)
        if n == 0:
            return None, consumed
        if st.remaining > 0:
            take = min(st.remaining, n)
            st.feed(buf.to_bytes(take))
            buf.popn(take)
            consumed += take
            st.remaining -= take
            if st.remaining == 0:
                st.expect_crlf = True
            continue
        if st.expect_crlf:
            if n < 2:
                return None, consumed
            if buf.to_bytes(2) != b"\r\n":
                raise FatalParseError("chunk data not CRLF-terminated")
            buf.popn(2)
            consumed += 2
            st.expect_crlf = False
            continue
        # at a size line or trailer line: peek a bounded window for CRLF
        head = buf.to_bytes(min(n, 4096))
        nl = head.find(b"\r\n")
        if nl < 0:
            if len(head) >= 4096:
                raise FatalParseError("oversized chunk-size/trailer line")
            return None, consumed
        line = head[:nl]
        buf.popn(nl + 2)
        consumed += nl + 2
        if st.in_trailer:
            if line == b"":  # end of trailers: the request is complete
                sock.context.pop("_http_chunk", None)
                if st.reader is not None:
                    # the frame was dispatched at header time; the
                    # handler's pending read returns b"" (EOF) now. Wire
                    # order for later pipelined frames is kept by the
                    # _http_stream_done gate installed at dispatch.
                    st.reader._finish()
                    if st.fail_hook is not None:
                        # the upload survived: a keep-alive connection must
                        # not accumulate one dead hook (and pinned reader)
                        # per historical upload
                        try:
                            sock.on_failed.remove(st.fail_hook)
                        except ValueError:
                            pass
                    return None, consumed
                st.frame.body = bytes(st.sink)
                return st.frame, consumed
            continue  # a trailer header: skipped (RFC 9112 §7.1)
        size_token = line.split(b";", 1)[0].strip()
        try:
            size = int(size_token, 16)
        except ValueError:
            raise FatalParseError(f"bad chunk size {size_token!r}") from None
        if size < 0:
            raise FatalParseError("negative chunk size")
        if size == 0:
            st.in_trailer = True
            continue
        st.remaining = size


def parse_conn(sock, buf) -> Tuple[Optional[object], int]:
    """Stateful per-connection cut (Protocol.parse_conn): installed once a
    connection is known to speak HTTP. Ordinary frames size via
    parse_header and cut exactly like the stateless path; chunked requests
    decode incrementally across cut windows (the
    reference's resumable http_parser + ProgressiveReader,
    input_messenger.cpp:343-351), bounded by max_body_size."""
    st = sock.context.get("_http_chunk")
    if st is not None:
        return _conn_chunk_continue(sock, st, buf)
    n = len(buf)
    if n == 0:
        return None, 0
    from incubator_brpc_tpu_torch.utils.flags import get_flag as _get_flag

    window = buf.to_bytes(min(n, _MAX_HEADER_BYTES + 4))
    total = parse_header(window)  # ParseError kills the conn (it IS http now)
    if total is not None:
        # same body bound the stateless messenger path enforces — a pinned
        # connection must not be able to buffer the world via one huge
        # Content-Length
        if total > int(_get_flag("max_body_size")) + _CHUNKED_WINDOW:
            raise FatalParseError(
                f"frame of {total} B exceeds max_body_size"
            )
        if n < total:
            return None, 0
        raw = buf.to_bytes(total)
        buf.popn(total)
        frame, consumed = parse(raw)
        if frame is None or consumed != total:
            raise FatalParseError("parser/header length mismatch")
        return frame, total
    head_end = window.find(b"\r\n\r\n")
    if head_end < 0:
        return None, 0  # header block incomplete
    from incubator_brpc_tpu_torch.utils.flags import get_flag

    if looks_like_http_response(window):
        # a chunked RESPONSE: the channel client consuming a progressive
        # server body — accumulate statefully, deliver one response frame
        # at the terminal chunk (the reference's full http client reads
        # chunked responses through the same resumable parser)
        head = window[:head_end].decode("latin-1")
        lines = head.split("\r\n")
        parts_line = lines[0].split(" ", 2)
        if len(parts_line) < 2 or not parts_line[1].isdigit():
            raise ParseError(f"bad status line {lines[0]!r}")
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        frame = HttpResponseFrame(int(parts_line[1]), headers, b"")
        buf.popn(head_end + 4)
        st = _ChunkState(frame, None, max_total=int(get_flag("max_body_size")))
        sock.context["_http_chunk"] = st
        frame2, consumed2 = _conn_chunk_continue(sock, st, buf)
        return frame2, head_end + 4 + consumed2

    # a chunked request: build the frame shell, install the decode state
    method, target, headers = _parse_request_head(
        window[:head_end].decode("latin-1")
    )
    parts = urlsplit(target)
    query = dict(parse_qsl(parts.query, keep_blank_values=True))
    frame = HttpFrame(method.upper(), parts.path or "/", query, headers, b"")
    buf.popn(head_end + 4)
    server = sock.context.get("server")
    progressive = bool(
        server is not None and server.is_progressive_route(frame.path)
    )
    reader = ProgressiveReader() if progressive else None
    st = _ChunkState(frame, reader, max_total=int(get_flag("max_body_size")))
    sock.context["_http_chunk"] = st
    if progressive:
        # dispatch NOW: the handler reads the body while chunks arrive.
        # It MUST run on a worker fiber (it blocks on the reader THIS
        # fiber feeds — inline dispatch would deadlock). Ordering gates
        # install in pre_dispatch — at DISPATCH time, in wire order — not
        # here at cut time: a gate installed during the cut would be seen
        # by EARLIER frames of the same burst (they dispatch after the
        # whole burst is cut) and deadlock-then-kill the connection.
        from incubator_brpc_tpu_torch.runtime.butex import Butex

        frame.body = reader
        frame.process_inline = False
        frame.force_worker = True
        frame._prog_gate = Butex(0)
        frame._wait_gate = None

        def _pre_dispatch(dsock, _frame=frame):
            # chain: answer only after the connection's previous in-flight
            # response (possibly another progressive upload) completes
            _frame._wait_gate = dsock.context.get("_http_stream_done")
            dsock.context["_http_stream_done"] = _frame._prog_gate

        frame.pre_dispatch = _pre_dispatch
        # a connection death mid-upload must unblock the handler's read
        st.fail_hook = lambda s, _r=reader: _r._finish(
            "connection failed mid-upload"
        )
        sock.on_failed.append(st.fail_hook)
        done2, consumed2 = _conn_chunk_continue(sock, st, buf)
        assert done2 is None  # progressive mode never returns a frame here
        return frame, head_end + 4 + consumed2
    frame2, consumed2 = _conn_chunk_continue(sock, st, buf)
    return frame2, head_end + 4 + consumed2


def _parse_response(buf: bytes) -> Tuple[Optional[HttpResponseFrame], int]:
    head_end = buf.find(b"\r\n\r\n")
    if head_end < 0:
        if len(buf) > _MAX_HEADER_BYTES:
            raise ParseError("http header block too large")
        return None, 0
    head = buf[:head_end].decode("latin-1")
    lines = head.split("\r\n")
    parts = lines[0].split(" ", 2)
    if len(parts) < 2 or not parts[1].isdigit():
        raise ParseError(f"bad status line {lines[0]!r}")
    status = int(parts[1])
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    if "chunked" in headers.get("transfer-encoding", ""):
        raise ParseError("chunked responses not supported on channels")
    total = head_end + 4 + _content_length(head)  # shared validation
    if len(buf) < total:
        return None, 0
    return HttpResponseFrame(status, headers, bytes(buf[head_end + 4 : total])), total


def parse(buf: bytes) -> Tuple[Optional[HttpFrame], int]:
    """Cut one request (server side) or response (channel client side) off
    ``buf``. (None, 0) = incomplete; ParseError = not HTTP (try other
    protocols / fail the connection)."""
    if looks_like_http_response(buf):
        return _parse_response(buf)
    if not looks_like_http(buf):
        raise ParseError("not http")
    head_end = buf.find(b"\r\n\r\n")
    if head_end < 0:
        if len(buf) > _MAX_HEADER_BYTES:
            raise ParseError("http header block too large")
        return None, 0
    method, target, headers = _parse_request_head(
        bytes(buf[:head_end]).decode("latin-1")
    )
    te = headers.get("transfer-encoding")
    if te is not None:
        te = te.strip().lower()  # same predicate as parse_header: the two
        # MUST size identically or the messenger sees a length mismatch
        if te != "chunked":
            raise FatalParseError(f"unsupported transfer-encoding {te!r}")
        done = _dechunk(buf, head_end + 4)
        if done is None:
            if len(buf) >= _CHUNKED_WINDOW:
                raise FatalParseError(
                    "chunked request body exceeds the cut window"
                )
            return None, 0
        body, total = done
    else:
        raw_len = headers.get("content-length", "0") or "0"
        if not raw_len.isdigit():
            raise ParseError(f"bad Content-Length {raw_len!r}")
        body_len = int(raw_len)
        total = head_end + 4 + body_len
        if len(buf) < total:
            return None, 0
        body = bytes(buf[head_end + 4 : total])
    parts = urlsplit(target)
    query = dict(parse_qsl(parts.query, keep_blank_values=True))
    frame = HttpFrame(method.upper(), parts.path or "/", query, headers, body)
    return frame, total


_REASONS = {
    200: "OK",
    302: "Found",
    400: "Bad Request",
    403: "Forbidden",
    404: "Not Found",
    405: "Method Not Allowed",
    500: "Internal Server Error",
    503: "Service Unavailable",
}


def build_response(
    status: int = 200,
    body: bytes = b"",
    content_type: str = "text/plain",
    extra_headers: Optional[Dict[str, str]] = None,
    keep_alive: bool = True,
) -> bytes:
    reason = _REASONS.get(status, "OK")
    lines = [
        f"HTTP/1.1 {status} {reason}",
        f"Content-Length: {len(body)}",
        f"Content-Type: {content_type}",
        "Connection: " + ("keep-alive" if keep_alive else "close"),
    ]
    for k, v in (extra_headers or {}).items():
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


def build_chunked_head(
    status: int, content_type: str, keep_alive: bool = True
) -> bytes:
    reason = _REASONS.get(status, "OK")
    return (
        f"HTTP/1.1 {status} {reason}\r\n"
        f"Content-Type: {content_type}\r\n"
        "Transfer-Encoding: chunked\r\n"
        "Connection: " + ("keep-alive" if keep_alive else "close") + "\r\n\r\n"
    ).encode("latin-1")


def build_chunk(data: bytes) -> bytes:
    return b"%x\r\n%s\r\n" % (len(data), data)


CHUNK_END = b"0\r\n\r\n"


def _send_progressive(
    sock, status: int, ctype: str, body_iter, close: bool, gate=None
) -> None:
    """ProgressiveAttachment analog (reference progressive_attachment.{h,cpp}
    + ProgressiveReader): headers go out now, chunks stream as the producer
    yields them — unbounded bodies without buffering. The producer runs on
    its own fiber so a slow source never pins the reader fiber; the
    ``_http_stream_done`` gate in sock.context keeps a later pipelined
    response from interleaving with the stream (HTTP in-order contract).

    ``gate``: a progressive-UPLOAD frame whose handler streams its response
    passes its own ordering gate — the drain releases it only when the
    stream completes. Installing a fresh context gate here would clobber a
    pipelined successor's, letting its response interleave mid-stream."""
    from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool

    from incubator_brpc_tpu_torch.runtime.butex import Butex

    # a Butex, not a threading.Event: waiters must count as BLOCKED so the
    # worker pool grows past them (N stalled streams + N pipelined requests
    # would otherwise deadlock every carrier thread)
    if gate is not None:
        done = gate
    else:
        done = Butex(0)
        sock.context["_http_stream_done"] = done

    def finish_gate():
        done.store(1)
        done.wake_all()

    if sock.write(build_chunked_head(status, ctype, keep_alive=not close)) != 0:
        # can't even start the response: the stream is unrecoverable
        finish_gate()
        sock.set_failed()
        return

    def drain():
        try:
            try:
                for chunk in body_iter:
                    if chunk:
                        if sock.write(build_chunk(bytes(chunk))) != 0:
                            # EVERY mid-stream write failure (including
                            # transient EOVERCROWDED) kills the connection:
                            # a truncated chunk stream on a live socket
                            # would desync everything after it
                            sock.set_failed()
                            return
            except Exception:
                logger.exception("progressive body producer raised")
                sock.set_failed()  # can't signal mid-stream errors in HTTP/1.1
                return
            if sock.write(CHUNK_END) != 0:
                sock.set_failed()  # client must not wait forever for the 0-chunk
                return
            if close:
                _close_when_drained(sock)
        finally:
            finish_gate()

    global_worker_pool().spawn(drain)


def process_request(sock, frame: HttpFrame) -> None:
    """Route a request through the owning server's portal (the reference
    wires builtin services into every server, server.cpp:433)."""
    from incubator_brpc_tpu_torch.builtin import pages

    server = sock.context.get("server")
    frame.sock = sock  # the rpc gateway threads the connection through
    extra_headers = None
    try:
        resp = pages.handle(server, frame)
        # handlers return (status, ctype, body) or, when the response
        # needs headers of its own (Retry-After on a 503, cache
        # control...), (status, ctype, body, {header: value})
        status, ctype, body = resp[0], resp[1], resp[2]
        if len(resp) > 3:
            extra_headers = resp[3]
    except Exception as e:
        logger.exception("http handler failed for %s", frame.path)
        status, ctype, body = 500, "text/plain", f"error: {e!r}".encode()
    close = frame.headers.get("connection", "").lower() == "close"
    # a still-streaming earlier response (or a progressive-upload handler
    # still answering) owns the connection: wait (we run on the per-socket
    # reader fiber, so blocking preserves wire order; the butex wait counts
    # as blocked → the pool grows a replacement). A progressive frame never
    # waits on its OWN gate.
    own_gate = getattr(frame, "_prog_gate", None)
    from incubator_brpc_tpu_torch.runtime.butex import ETIMEDOUT as _ETIMEDOUT

    if own_gate is not None:
        # progressive frame: wait on the chain predecessor captured at
        # dispatch (the context gate may already be a SUCCESSOR's)
        pred = getattr(frame, "_wait_gate", None)
        if pred is not None and pred.load() == 0:
            if pred.wait(0, timeout=60) == _ETIMEDOUT and pred.load() == 0:
                sock.set_failed()
                return
    else:
        while True:
            # loop: the gate may be REPLACED (a prior frame's handler
            # started a chunked response stream) between our wake and our
            # write — a single wait would let this response interleave
            prior = sock.context.get("_http_stream_done")
            if prior is None or prior.load() != 0:
                break
            if prior.wait(0, timeout=60) == _ETIMEDOUT and prior.load() == 0:
                sock.set_failed()
                return
    try:
        if isinstance(body, str):
            body = body.encode()
        if (
            not isinstance(body, (bytes, bytearray, memoryview))
            and hasattr(body, "__iter__")
            and not isinstance(body, dict)
        ):
            if frame.method == "HEAD":
                # HEAD responses carry no body: headers only, iterator dropped
                sock.write(build_chunked_head(status, ctype, keep_alive=not close))
                if close:
                    _close_when_drained(sock)
                return
            # a handler returned an iterator: stream it chunked
            # (progressive). A progressive-upload frame hands its OWN
            # ordering gate to the drain — released at stream end, so a
            # pipelined successor cannot interleave mid-stream
            _send_progressive(sock, status, ctype, iter(body), close, gate=own_gate)
            own_gate = None  # the drain owns its release now
            return
        if not isinstance(body, (bytes, bytearray, memoryview)):
            status, ctype, body = 500, "text/plain", (
                f"handler returned non-bytes body {type(body).__name__}\n".encode()
            )
        if frame.method == "HEAD":
            # RFC 9110: Content-Length reflects what GET would return, body
            # omitted — sending it would desync the keep-alive byte stream
            head_only = build_response(
                status,
                body,
                content_type=ctype,
                extra_headers=extra_headers,
                keep_alive=not close,
            )
            head_only = head_only[: len(head_only) - len(body)]
            sock.write(head_only)
        else:
            sock.write(
                build_response(
                    status, body, content_type=ctype,
                    extra_headers=extra_headers, keep_alive=not close,
                )
            )
        if close:
            _close_when_drained(sock)
    finally:
        if own_gate is not None:
            # our response is written (or streaming under a NEWER gate):
            # release frames queued behind this progressive upload
            if sock.context.get("_http_stream_done") is own_gate:
                sock.context.pop("_http_stream_done", None)
            own_gate.store(1)
            own_gate.wake_all()


def _close_when_drained(sock) -> None:
    """Half-close once the response drains; the client reads to EOF. A hard
    set_failed before the drain could cut the queued write."""
    from incubator_brpc_tpu_torch.transport.sock import when_drained
    from incubator_brpc_tpu_torch.utils.status import ErrorCode

    when_drained(sock, lambda s: s.set_failed(ErrorCode.ECLOSE, "http connection: close"))


# -- channel client side (the reference's full http client rides the same
#    Channel/Socket machinery as baidu_std, http_rpc_protocol.cpp's
#    SerializeHttpRequest/PackHttpRequest + ProcessHttpResponse) -------------


def pack_channel_request(
    meta,
    payload: bytes,
    correlation_id: int,
    flags: int = 0,
    error_code: int = 0,
    attachment: bytes = b"",
) -> bytes:
    """Protocol.pack_request slot: service/method map to POST
    /<service>/<method> (the same route the server's gateway serves), the
    payload is the body. No wire correlation id — the channel records the
    cid in the connection's FIFO (fifo_responses)."""
    if attachment:
        raise ValueError("attachments do not exist in HTTP; use the body")
    if meta is not None and meta.compress:
        # the channel compressed the payload, but nothing here would carry
        # Content-Encoding or decompress on the server: reject loudly
        # rather than hand the handler gzip bytes it can't parse
        raise ValueError("compress_type is not supported on http channels")
    extra = (meta.extra or {}) if meta else {}
    host = extra.get("http_host", "")
    # generic requests (tools/parallel_http, restful callers) can override
    # the gateway's POST /<service>/<method> route via request extras
    verb = str(extra.get("http_method", "POST")).upper()
    path = str(extra.get("http_path", "")) or (
        f"/{meta.service}/{meta.method}" if meta else "/"
    )
    head = (
        f"{verb} {path} HTTP/1.1\r\n"
        f"Host: {host}\r\n"
        f"Content-Length: {len(payload)}\r\n"
        "Content-Type: application/octet-stream\r\n"
        "Connection: keep-alive\r\n"
    )
    if meta is not None and meta.log_id:
        head += f"x-tbrpc-log-id: {meta.log_id}\r\n"
    if extra.get("auth"):
        # the channel's credential (rpc/auth.attach_credential), checked by
        # the server's http_check; the JAX package's packer drops it
        head += f"Authorization: {extra['auth']}\r\n"
    return head.encode("latin-1") + b"\r\n" + payload


def process_response(sock, frame: HttpResponseFrame) -> None:
    """Match the response to the OLDEST in-flight call on this connection
    (HTTP/1.1 pipelining is strictly FIFO) and complete it through the
    ordinary channel return path. On a reactor thread a contended id (a
    concurrent timeout holder, possibly mid-reconnect) must not park the
    reactor — the blocking completion is deferred to a pool fiber, same
    discipline as the tbus response path."""
    from incubator_brpc_tpu_torch.runtime.correlation_id import EBUSY, call_id_space
    from incubator_brpc_tpu_torch.transport.event_dispatcher import on_reactor_thread

    pending = sock.context.get("http_pending")
    cid = None
    if pending:
        try:
            cid = pending.popleft()
        except IndexError:
            cid = None
    if cid is None:
        logger.warning("http response on %r with no in-flight call", sock)
        return
    rc, cntl = call_id_space.lock(cid, nowait=on_reactor_thread())
    if rc == EBUSY:
        from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool

        global_worker_pool().spawn(_complete_blocking, sock, frame, cid)
        return
    if rc != 0 or cntl is None:
        return  # call already settled (timeout): drop the late response
    _complete_locked(sock, frame, cid, cntl)


def _complete_blocking(sock, frame: HttpResponseFrame, cid: int) -> None:
    from incubator_brpc_tpu_torch.runtime.correlation_id import call_id_space

    rc, cntl = call_id_space.lock(cid)
    if rc != 0 or cntl is None:
        return
    _complete_locked(sock, frame, cid, cntl)


def _complete_locked(sock, frame: HttpResponseFrame, cid: int, cntl) -> None:
    from incubator_brpc_tpu_torch.runtime.correlation_id import call_id_space
    from incubator_brpc_tpu_torch.utils.status import ErrorCode

    channel = cntl._channel
    if channel is None:
        call_id_space.unlock(cid)
        return
    cntl.http_status = frame.status
    if 200 <= frame.status < 300:  # any 2xx is an HTTP success
        cntl.response_payload = frame.body
    else:
        cntl.set_failed(
            ErrorCode.EHTTP,
            f"HTTP {frame.status}: {frame.body[:200].decode(errors='replace')}",
        )
    channel._end_rpc(cntl)
    if frame.headers.get("connection", "").lower() == "close":
        sock.set_failed(ErrorCode.ECLOSE, "server sent Connection: close")


HTTP = Protocol(
    name="http",
    parse=parse,
    parse_header=parse_header,
    # stateful per-conn cut: once a connection is known to speak HTTP the
    # messenger routes its bytes here, which resumes chunked-request
    # decoding across cut windows (unbounded uploads, ProgressiveReader)
    parse_conn=parse_conn,
    process_request=process_request,
    process_response=process_response,
    pack_request=pack_channel_request,
    fifo_responses=True,
)

if "http" not in protocol_registry:
    protocol_registry.register(HTTP)


# -- minimal client (tools/tests; reference uses the full Channel stack) -----


def http_call(
    host: str,
    port: int,
    path: str,
    method: str = "GET",
    body: bytes = b"",
    timeout: float = 5.0,
) -> Tuple[int, Dict[str, str], bytes]:
    """One blocking request → (status, headers, body)."""
    req = (
        f"{method} {path} HTTP/1.1\r\n"
        f"Host: {host}:{port}\r\n"
        f"Content-Length: {len(body)}\r\n"
        f"Connection: close\r\n\r\n"
    ).encode("latin-1") + body
    with _pysocket.create_connection((host, port), timeout=timeout) as conn:
        conn.sendall(req)
        raw = b""
        head_end = -1
        while head_end < 0:
            data = conn.recv(65536)
            if not data:
                break
            raw += data
            head_end = raw.find(b"\r\n\r\n")
        if head_end < 0:
            raise ConnectionError("connection closed before response headers")
        head = raw[:head_end].decode("latin-1")
        lines = head.split("\r\n")
        status = int(lines[0].split(" ", 2)[1])
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        rest = raw[head_end + 4 :]
        if "chunked" in headers.get("transfer-encoding", "").lower():
            # progressive body: read + decode until the 0-length chunk
            body = b""
            while True:
                nl = rest.find(b"\r\n")
                while nl < 0:
                    data = conn.recv(65536)
                    if not data:
                        return status, headers, body
                    rest += data
                    nl = rest.find(b"\r\n")
                size = int(rest[:nl].split(b";")[0], 16)  # tolerate extensions
                need = nl + 2 + size + 2
                while len(rest) < need:
                    data = conn.recv(65536)
                    if not data:
                        return status, headers, body
                    rest += data
                if size == 0:
                    return status, headers, body
                body += rest[nl + 2 : nl + 2 + size]
                rest = rest[need:]
        body_len = int(headers.get("content-length", "0") or "0")
        while len(rest) < body_len:
            data = conn.recv(65536)
            if not data:
                break
            rest += data
    return status, headers, rest[:body_len]
