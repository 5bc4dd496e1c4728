"""tbus_std — the canonical host wire protocol.

Layout (little-endian). The header shares the magic and the 8×uint32 shape
with the device frame of ops/framing.py, but field semantics differ (word 1
is body *bytes* here vs payload *words* there; word 5 is meta length vs
method id; word 6 is crc32c vs sum-xor) — host frames are re-framed at the
host↔HBM boundary by the device transport, they do not parse as device
frames:

    8 × uint32 header:
        0 magic "TPRC"
        1 body length in BYTES (meta + payload + attachment)
        2 flags (bit0 response, bit1 stream, bit2 has-meta, bit3 body-crc)
        3 correlation id low
        4 correlation id high
        5 meta length in bytes
        6 crc32c (over meta; over the whole body when bit3 is set)
        7 error code (responses)
    body = meta (JSON, self-describing like baidu_std's RpcMeta proto —
    policy/baidu_rpc_meta.proto) + payload + attachment.

The reference carries service/method/compress/attachment_size in a protobuf
RpcMeta; a JSON meta keeps the frame self-describing without a codegen
dependency.

Checksum model: CRC32C always covers the meta — the routing information.
Payload bytes are covered only when FLAG_BODY_CRC is set per frame (flag
``tbus_body_crc``); the default trusts the transport's own integrity exactly
like the reference, whose baidu_std header carries sizes and NO checksum at
all (baidu_rpc_protocol.cpp:53-58) because TCP already checksums segments.

The port's copy of the JAX package's ``protocol/tbus_std.py``. With the
port's host runtime loaded (``native.py``), ``pack_frame_iobuf`` builds
header and meta and sums the CRC in one native pass (``tb_tbus_pack``), and
``parse_frame_iobuf`` peeks, checks and cuts a frame off a native read
chain in C++ (``tb_tbus_peek`` / ``tb_tbus_cut``), as the JAX package's
do. Their plain versions stay beside them: ``pack_frame_iobuf_plain`` and
``parse_frame_iobuf_plain`` (the cut in Python, which any IOBuf takes), with
``pack_frame``, ``parse_header``, ``try_parse_frame`` and the stream
layer's hooks (``ParsedFrame.payload_iobuf`` with the lazy ``payload``,
``is_stream``, ``_stream_layer_live``). CRC32C is ``utils/crc32c.py``'s.
Both cuts keep a stream frame's body as a zero-copy cut of the chain.
"""

from __future__ import annotations

import ctypes
import json
import struct
from dataclasses import dataclass, field
from typing import Optional, Tuple

from incubator_brpc_tpu_torch.iobuf import IOBuf, _NativeIOBuf
from incubator_brpc_tpu_torch.native import LIB, TbusHdr
from incubator_brpc_tpu_torch.utils.crc32c import crc32c
from incubator_brpc_tpu_torch.utils.flags import define_flag, get_flag

MAGIC = 0x54505243  # "TPRC" — same as ops.framing.MAGIC
MAGIC_BYTES = struct.pack("<I", MAGIC)
HEADER_BYTES = 32
_HDR = struct.Struct("<8I")

FLAG_RESPONSE = 1
FLAG_STREAM = 2
FLAG_HAS_META = 4
FLAG_BODY_CRC = 8
# payloads this large ride the native frame as external blocks, uncopied
_EXTERNAL_THRESHOLD = 32 * 1024

define_flag(
    "tbus_body_crc",
    False,
    "checksum full frame bodies (default: meta only, like the reference "
    "whose baidu_std trusts TCP's checksums for payload bytes)",
    lambda v: True,
)


@dataclass
class Meta:
    """Request/response metadata — the RpcMeta analog
    (policy/baidu_rpc_meta.proto fields: service/method/compress/attachment/
    trace ids)."""

    service: str = ""
    method: str = ""
    compress: str = ""  # "", "gzip", "snappy" (zlib stands in for snappy)
    attachment_size: int = 0
    # remaining deadline budget in ms, stamped by the client at send time
    # (the reference's RpcRequestMeta.timeout_ms): 0 = no deadline rides
    # this request; servers shed expired-at-arrival work with EDEADLINE
    timeout_ms: int = 0
    log_id: int = 0
    trace_id: int = 0
    span_id: int = 0
    parent_span_id: int = 0
    # head-based coherent-sampling bit: the edge's sampling decision,
    # propagated hop to hop like the deadline (the PRPC twin is
    # RpcRequestMeta field 9); 1 forces span collection at this hop
    sampled: int = 0
    stream_id: int = 0
    stream_offset: int = 0
    stream_close: bool = False
    error_text: str = ""
    extra: dict = field(default_factory=dict)

    def to_bytes(self, attachment_size: Optional[int] = None) -> bytes:
        """Wire meta. ``attachment_size`` overrides the field (so frame
        packers never need a Meta copy just to stamp it). Explicit field
        checks — this runs per frame; a dict comprehension over __dict__
        costs ~4x."""
        d = {}
        if self.service:
            d["service"] = self.service
        if self.method:
            d["method"] = self.method
        if self.compress:
            d["compress"] = self.compress
        att = self.attachment_size if attachment_size is None else attachment_size
        if att:
            d["attachment_size"] = att
        if self.timeout_ms:
            d["timeout_ms"] = self.timeout_ms
        if self.log_id:
            d["log_id"] = self.log_id
        if self.trace_id:
            d["trace_id"] = self.trace_id
        if self.span_id:
            d["span_id"] = self.span_id
        if self.parent_span_id:
            d["parent_span_id"] = self.parent_span_id
        if self.sampled:
            d["sampled"] = 1
        if self.stream_id:
            d["stream_id"] = self.stream_id
        if self.stream_offset:
            d["stream_offset"] = self.stream_offset
        if self.stream_close:
            d["stream_close"] = True
        if self.error_text:
            d["error_text"] = self.error_text
        if self.extra:
            d["extra"] = self.extra
        return json.dumps(d, separators=(",", ":")).encode()

    @classmethod
    def from_bytes(cls, b: bytes) -> "Meta":
        m = cls()
        if b:
            o = json.loads(b)
            g = o.get
            m.service = g("service", "")
            m.method = g("method", "")
            m.compress = g("compress", "")
            m.attachment_size = g("attachment_size", 0)
            m.timeout_ms = g("timeout_ms", 0)
            m.log_id = g("log_id", 0)
            m.trace_id = g("trace_id", 0)
            m.span_id = g("span_id", 0)
            m.parent_span_id = g("parent_span_id", 0)
            m.sampled = 1 if g("sampled", 0) else 0
            m.stream_id = g("stream_id", 0)
            m.stream_offset = g("stream_offset", 0)
            m.stream_close = g("stream_close", False)
            m.error_text = g("error_text", "")
            m.extra = g("extra", {})
        return m


def _effective_flags(flags: int) -> int:
    if get_flag("tbus_body_crc"):
        flags |= FLAG_BODY_CRC
    return flags


def _build_header(
    meta: Optional[Meta],
    payload: bytes,
    correlation_id: int,
    flags: int,
    error_code: int,
    attachment: bytes,
):
    """The single source of truth for the frame layout: returns
    (header_bytes, meta_bytes, flags). attachment_size is authoritative per
    frame (as in the reference's RpcMeta): always (re)computed, never
    inherited from a reused Meta, and the caller's Meta is never mutated.
    CRC is computed incrementally so callers never need a body
    concatenation."""
    if attachment and meta is None:
        raise ValueError("non-empty attachment requires a Meta to carry its size")
    flags = _effective_flags(flags)
    meta_bytes = b""
    if meta is not None:
        meta_bytes = meta.to_bytes(attachment_size=len(attachment))
        flags |= FLAG_HAS_META
    crc = crc32c(meta_bytes)
    if flags & FLAG_BODY_CRC:
        crc = crc32c(payload, crc)
        if attachment:
            crc = crc32c(attachment, crc)
    header = _HDR.pack(
        MAGIC,
        len(meta_bytes) + len(payload) + len(attachment),
        flags,
        correlation_id & 0xFFFFFFFF,
        (correlation_id >> 32) & 0xFFFFFFFF,
        len(meta_bytes),
        crc & 0xFFFFFFFF,
        error_code,
    )
    return header, meta_bytes, flags


def pack_frame(
    meta: Optional[Meta],
    payload: bytes,
    correlation_id: int,
    flags: int = 0,
    error_code: int = 0,
    attachment: bytes = b"",
) -> bytes:
    """Serialize one frame to bytes. The reference splits this between
    SerializeRequest and PackRpcRequest (baidu_rpc_protocol.cpp:585-668)."""
    header, meta_bytes, _ = _build_header(
        meta, payload, correlation_id, flags, error_code, attachment
    )
    return header + meta_bytes + payload + attachment


def pack_frame_iobuf(
    meta: Optional[Meta],
    payload: bytes,
    correlation_id: int,
    flags: int = 0,
    error_code: int = 0,
    attachment: bytes = b"",
) -> IOBuf:
    """pack_frame without the body/frame concatenations: header+meta are
    built (and the CRC summed) in ONE native pass, then payload and
    attachment are appended to the IOBuf, as external refs when large.
    The wire bytes are identical to pack_frame."""
    if LIB is None:
        return pack_frame_iobuf_plain(meta, payload, correlation_id, flags, error_code, attachment)
    if attachment and meta is None:
        raise ValueError("non-empty attachment requires a Meta to carry its size")
    buf = IOBuf()
    flags = _effective_flags(flags)
    meta_bytes = b""
    if meta is not None:
        meta_bytes = meta.to_bytes(attachment_size=len(attachment))
        flags |= FLAG_HAS_META
    copy_body = len(payload) < _EXTERNAL_THRESHOLD and len(attachment) < _EXTERNAL_THRESHOLD
    LIB.tb_tbus_pack(
        buf._h,
        meta_bytes,
        len(meta_bytes),
        payload,
        len(payload),
        attachment,
        len(attachment),
        correlation_id & 0xFFFFFFFF,
        (correlation_id >> 32) & 0xFFFFFFFF,
        flags,
        error_code,
        1 if copy_body else 0,
    )
    if not copy_body:
        for part in (payload, attachment):
            if len(part) >= _EXTERNAL_THRESHOLD:
                buf.append_external(part)
            elif part:
                buf.append(part)
    return buf


def pack_response_iobuf(
    meta: Optional[Meta],
    payload: bytes,
    correlation_id: int,
    flags: int = 0,
    error_code: int = 0,
    attachment: bytes = b"",
) -> IOBuf:
    """The registry's response packer: ``pack_frame_iobuf`` with
    FLAG_RESPONSE set."""
    return pack_frame_iobuf(
        meta, payload, correlation_id, flags | FLAG_RESPONSE, error_code, attachment
    )


def pack_frame_iobuf_plain(
    meta: Optional[Meta],
    payload: bytes,
    correlation_id: int,
    flags: int = 0,
    error_code: int = 0,
    attachment: bytes = b"",
) -> IOBuf:
    """The plain version of pack_frame_iobuf: header+meta in one block
    built in Python, payload and attachment appended after it."""
    buf = IOBuf()
    header, meta_bytes, _ = _build_header(
        meta, payload, correlation_id, flags, error_code, attachment
    )
    buf.append(header + meta_bytes)  # header+meta are small: one append
    if payload:
        buf.append(payload)
    if attachment:
        buf.append(attachment)
    return buf


class ParsedFrame:
    """One cut frame. ``arrival_ts`` is stamped by the messenger when the
    frame is cut off the wire (the server measures propagated deadlines
    from it).

    Stream data frames keep their body as a zero-copy IOBuf cut of the
    read chain (the reference hands stream handlers butil::IOBufs,
    stream.h on_received_messages): ``payload_iobuf`` is None on every
    other frame kind. ``payload`` is LAZY: when only ``payload_iobuf`` was
    populated, the bytes materialize from it on first access, so a
    non-stream consumer of a FLAG_STREAM frame reads the real payload; the
    stream layer reads ``payload_iobuf`` and never pays the copy."""

    def __init__(
        self,
        meta: Meta,
        payload: bytes = b"",
        attachment: bytes = b"",
        correlation_id: int = 0,
        flags: int = 0,
        error_code: int = 0,
        payload_iobuf: Optional[IOBuf] = None,
    ) -> None:
        self.meta = meta
        self._payload = payload
        self.attachment = attachment
        self.correlation_id = correlation_id
        self.flags = flags
        self.error_code = error_code
        self.payload_iobuf = payload_iobuf
        self.arrival_ts: Optional[float] = None
        # the protocol the frame arrived in: the server answers in it
        # (protocol/baidu_std.py tags its frames "baidu_std")
        self.wire_protocol = "tbus_std"

    @property
    def payload(self) -> bytes:
        if not self._payload and self.payload_iobuf is not None:
            # materialize once, cache; to_bytes is a non-destructive copy
            self._payload = self.payload_iobuf.to_bytes()
        return self._payload

    @payload.setter
    def payload(self, value: bytes) -> None:
        self._payload = value

    @property
    def is_response(self) -> bool:
        return bool(self.flags & FLAG_RESPONSE)

    @property
    def is_stream(self) -> bool:
        return bool(self.flags & FLAG_STREAM)

    def __repr__(self) -> str:
        return (
            f"<ParsedFrame {self.meta.service}.{self.meta.method} "
            f"cid={self.correlation_id:#x} flags={self.flags} "
            f"err={self.error_code} payload={len(self._payload)}B"
            + (
                f" iobuf={len(self.payload_iobuf)}B"
                if self.payload_iobuf is not None
                else ""
            )
            + ">"
        )


class ParseError(Exception):
    """Unrecoverable garbage on the wire (magic/crc mismatch) — the
    reference's PARSE_ERROR_TRY_OTHERS→close path."""


class FatalParseError(ParseError):
    """Corruption detected AFTER bytes were irreversibly consumed from the
    read chain (or a frame of the right protocol that cannot be served):
    the connection cannot re-synchronize and must be failed — 'try other
    protocols' is not an option."""


def parse_header(header: bytes) -> Optional[int]:
    """Total frame size from the fixed header, None if the header itself is
    still incomplete, ParseError if these bytes are not tbus_std. The
    InputMessenger sizing hook (input_messenger.cpp:60-129 cuts the same
    way off baidu_std's 12-byte header)."""
    if len(header) < 8:
        if not MAGIC_BYTES.startswith(header[:4]) and len(header) >= 4:
            raise ParseError("bad magic")
        return None
    (magic,) = struct.unpack_from("<I", header)
    if magic != MAGIC:
        raise ParseError(f"bad magic {magic:#x}")
    if len(header) < HEADER_BYTES:
        return None
    (body_len,) = struct.unpack_from("<I", header, 4)
    return HEADER_BYTES + body_len


def _split_body(meta: Meta, body_mv) -> Tuple[bytes, bytes]:
    att = meta.attachment_size
    if att > len(body_mv):
        raise ParseError(f"attachment_size {att} exceeds body remainder {len(body_mv)}")
    if att:
        return bytes(body_mv[: len(body_mv) - att]), bytes(body_mv[len(body_mv) - att :])
    return bytes(body_mv), b""


def try_parse_frame(buf: bytes) -> Tuple[Optional[ParsedFrame], int]:
    """Attempt to cut one frame off ``buf`` (the messenger's cut, after
    ``parse_header`` sized it).

    Returns (frame, consumed). (None, 0) means not enough bytes yet — the
    resumable-parse contract of InputMessenger::CutInputMessage
    (input_messenger.cpp:60-129). Raises ParseError on corruption.
    """
    if len(buf) < HEADER_BYTES:
        return None, 0
    magic, body_len, flags, cid_lo, cid_hi, meta_len, crc, err = _HDR.unpack_from(buf)
    if magic != MAGIC:
        raise ParseError(f"bad magic {magic:#x}")
    if meta_len > body_len:
        raise ParseError("meta longer than body")
    total = HEADER_BYTES + body_len
    if len(buf) < total:
        return None, 0
    body = memoryview(buf)[HEADER_BYTES:total]
    span = body_len if flags & FLAG_BODY_CRC else meta_len
    if crc32c(body[:span]) != crc:
        raise ParseError("crc mismatch")
    meta = Meta.from_bytes(bytes(body[:meta_len]))
    payload, attachment = _split_body(meta, body[meta_len:])
    frame = ParsedFrame(
        meta=meta,
        payload=payload,
        attachment=attachment,
        correlation_id=cid_lo | (cid_hi << 32),
        flags=flags,
        error_code=err,
    )
    return frame, total


def _stream_layer_live() -> bool:
    """True once rpc.stream bound its FLAG_STREAM consumer to the tbus_std
    protocol entry (it owns frames carrying payload_iobuf)."""
    from incubator_brpc_tpu_torch import protocol as _pkg

    return getattr(_pkg.TBUS_STD, "process_stream", None) is not None


def parse_frame_iobuf(buf, max_total: Optional[int] = None) -> Tuple[Optional[ParsedFrame], int]:
    """Native cut: header peek, CRC walk and zero-copy body cut all happen
    in ``csrc/host/tbutil`` over the socket's read chain, and Python never
    copies the frame wholesale (the reference's CutInputMessage on the
    IOPortal, input_messenger.cpp:60-129). A chain of the plain IOBuf goes
    to ``parse_frame_iobuf_plain``.

    Same contract as try_parse_frame: (frame, consumed) | (None, 0);
    ParseError on corruption. ``max_total`` rejects oversized frames at
    HEADER time, before their body is buffered."""
    if not isinstance(buf, _NativeIOBuf):
        return parse_frame_iobuf_plain(buf, max_total)
    hdr = TbusHdr()
    rc = LIB.tb_tbus_peek(buf._h, ctypes.byref(hdr))
    if rc == 1:
        return None, 0
    if rc == -1:
        raise ParseError("bad magic")
    total = HEADER_BYTES + hdr.body_len
    if max_total is not None and total > max_total:
        raise ParseError(f"frame of {total} B exceeds limit {max_total}")
    if hdr.meta_len > hdr.body_len:
        # both fields are untrusted (the crc does not cover the header)
        raise ParseError("meta longer than body")
    if len(buf) < total:
        return None, 0
    meta_buf = ctypes.create_string_buffer(hdr.meta_len) if hdr.meta_len else None
    body = IOBuf()
    rc = LIB.tb_tbus_cut(buf._h, ctypes.byref(hdr), meta_buf, body._h)
    if rc == -2:
        raise ParseError("crc mismatch")
    if rc == -3:
        raise ParseError("meta longer than body")
    if rc != 0:
        return None, 0
    meta = Meta.from_bytes(meta_buf.raw if meta_buf is not None else b"")
    att = meta.attachment_size
    body_rest = hdr.body_len - hdr.meta_len
    if att > body_rest:
        # the frame is consumed: the connection cannot re-sync
        raise ParseError(f"attachment_size {att} exceeds body remainder {body_rest}")
    cid = hdr.cid_lo | (hdr.cid_hi << 32)
    if hdr.flags & FLAG_STREAM and att == 0 and _stream_layer_live():
        # stream data: the body IOBuf rides the frame to the stream layer
        frame = ParsedFrame(
            meta=meta, correlation_id=cid, flags=hdr.flags, error_code=hdr.error_code,
            payload_iobuf=body,
        )
        return frame, total
    payload_len = body_rest - att
    frame = ParsedFrame(
        meta=meta,
        payload=body.to_bytes(payload_len),
        attachment=body.to_bytes(att, pos=payload_len) if att else b"",
        correlation_id=cid,
        flags=hdr.flags,
        error_code=hdr.error_code,
    )
    return frame, total


def parse_frame_iobuf_plain(buf, max_total: Optional[int] = None) -> Tuple[Optional[ParsedFrame], int]:
    """The plain version of parse_frame_iobuf: the cut in Python, on any
    IOBuf. Same contract.

    A stream data frame (FLAG_STREAM, no attachment) whose stream layer is
    bound keeps its body as a zero-copy cut of the chain: the payload
    materializes only if a consumer asks for bytes. Every other frame is
    copied out and parsed by try_parse_frame."""
    if len(buf) < HEADER_BYTES:
        return None, 0
    magic, body_len, flags, cid_lo, cid_hi, meta_len, crc, err = _HDR.unpack(
        buf.to_bytes(HEADER_BYTES)
    )
    if magic != MAGIC:
        raise ParseError(f"bad magic {magic:#x}")
    if meta_len > body_len:
        raise ParseError("meta longer than body")
    total = HEADER_BYTES + body_len
    if max_total is not None and total > max_total:
        raise ParseError(f"frame of {total} B exceeds limit {max_total}")
    if len(buf) < total:
        return None, 0
    if not (flags & FLAG_STREAM and _stream_layer_live()):
        raw = buf.to_bytes(total)
        buf.popn(total)
        return try_parse_frame(raw)
    buf.popn(HEADER_BYTES)
    meta_bytes = buf.to_bytes(meta_len)
    buf.popn(meta_len)
    body = buf.cutn(body_len - meta_len)
    # the frame is consumed before its checks: a failed check fails the
    # connection, which cannot re-sync anyway
    sum_ = crc32c(meta_bytes)
    if flags & FLAG_BODY_CRC:
        for view in body.views():
            sum_ = crc32c(view, sum_)
    if sum_ != crc:
        raise ParseError("crc mismatch")
    meta = Meta.from_bytes(meta_bytes)
    att = meta.attachment_size
    if att > len(body):
        raise ParseError(f"attachment_size {att} exceeds body remainder {len(body)}")
    cid = cid_lo | (cid_hi << 32)
    if att:
        n = len(body) - att
        frame = ParsedFrame(
            meta=meta,
            payload=body.to_bytes(n),
            attachment=body.to_bytes(att, pos=n),
            correlation_id=cid,
            flags=flags,
            error_code=err,
        )
        return frame, total
    frame = ParsedFrame(
        meta=meta, correlation_id=cid, flags=flags, error_code=err, payload_iobuf=body
    )
    return frame, total
