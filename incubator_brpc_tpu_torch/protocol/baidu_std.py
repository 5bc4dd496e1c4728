"""baidu_std — the reference's canonical binary protocol, wire-compatible.

Format (policy/baidu_rpc_protocol.cpp:53-58):
    12-byte header: "PRPC" + body_size(u32, network order) + meta_size(u32)
    body = RpcMeta(protobuf) + payload + attachment
    attachment_size is set in the meta iff an attachment follows; body_size
    counts meta + payload + attachment.

RpcMeta (policy/baidu_rpc_meta.proto) is encoded with a hand-rolled proto2
wire codec — varints and length-delimited fields only, no protobuf
dependency (SURVEY §7 step 4 wants the exact bytes so this stack can be
interop-tested against reference binaries over TCP):

    RpcMeta:        1 request(msg)  2 response(msg)  3 compress_type(i32)
                    4 correlation_id(i64)  5 attachment_size(i32)
                    7 authentication_data(bytes)  8 stream_settings(msg)
    RpcRequestMeta: 1 service_name(str)  2 method_name(str)  3 log_id(i64)
                    4 trace_id(i64)  5 span_id(i64)  6 parent_span_id(i64)
                    8 timeout_ms(i32)  — the propagated deadline budget
                    9 traced_sampled(i32) — head-based coherent-sampling
                      bit (this stack's extension; docs/PARITY.md): the
                      edge's sampling decision rides every hop and
                      overrides local 1/N election, like the deadline
    RpcResponseMeta: 1 error_code(i32)  2 error_text(str)

CompressType values follow options.proto (NONE=0 SNAPPY=1 GZIP=2 ZLIB=3);
this build maps its named codecs onto them where they exist.

The port's copy of the JAX package's ``protocol/baidu_std.py``, whole: the
same codec, frame cut and packers, so the two packages put the same bytes
on the wire. The native plane (``transport/native_plane.py``) cuts and
answers the same frames in C++ (``csrc/host/tbnet``) and hands the rest to
``rpc_meta_to_meta`` and the server's Python route.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from incubator_brpc_tpu_torch.protocol.registry import Protocol, protocol_registry
from incubator_brpc_tpu_torch.protocol.tbus_std import (
    FLAG_RESPONSE,
    Meta,
    ParseError,
    ParsedFrame,
)

MAGIC = b"PRPC"
HEADER_BYTES = 12

# options.proto CompressType <-> this build's named codec registry
_COMPRESS_TO_WIRE = {"": 0, "snappy": 1, "gzip": 2, "zlib1": 3}
_WIRE_TO_COMPRESS = {v: k for k, v in _COMPRESS_TO_WIRE.items()}


# -- proto2 wire codec (varint + length-delimited; the two wire types
#    RpcMeta uses) --------------------------------------------------------


def _varint(n: int) -> bytes:
    if n < 0:  # proto2 int32/int64: negatives are 10-byte two's complement
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: memoryview, off: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if off >= len(buf) or shift > 63:
            raise ParseError("truncated varint in RpcMeta")
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def _tag(field_no: int, wire_type: int) -> bytes:
    return _varint((field_no << 3) | wire_type)


def _f_varint(field_no: int, value: int) -> bytes:
    if not value:
        return b""
    return _tag(field_no, 0) + _varint(value)


def _f_bytes(field_no: int, value: bytes) -> bytes:
    if not value:
        return b""
    return _tag(field_no, 2) + _varint(len(value)) + value


def _walk_fields(buf: memoryview):
    """Yield (field_no, wire_type, value) where value is int (varint) or
    memoryview (length-delimited); skips fixed32/64 it never expects."""
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field_no, wt = key >> 3, key & 7
        if wt == 0:
            v, off = _read_varint(buf, off)
            yield field_no, wt, v
        elif wt == 2:
            n, off = _read_varint(buf, off)
            if n < 0 or off + n > len(buf):
                raise ParseError("bad length-delimited field in RpcMeta")
            yield field_no, wt, buf[off : off + n]
            off += n
        elif wt == 1:
            if off + 8 > len(buf):
                raise ParseError("truncated fixed64")
            yield field_no, wt, buf[off : off + 8]
            off += 8
        elif wt == 5:
            if off + 4 > len(buf):
                raise ParseError("truncated fixed32")
            yield field_no, wt, buf[off : off + 4]
            off += 4
        else:
            raise ParseError(f"unsupported proto wire type {wt}")


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def encode_request_submeta(
    service: str,
    method: str,
    log_id: int = 0,
    trace_id: int = 0,
    span_id: int = 0,
    parent_span_id: int = 0,
    timeout_ms: int = 0,
    sampled: int = 0,
) -> bytes:
    """The RpcRequestMeta SUBMESSAGE bytes (RpcMeta field 1) — the single
    source of the request field table, shared by RpcMeta.encode and the
    native client plane (src/tbnet wraps these bytes into a full RpcMeta,
    splicing in its own correlation_id/attachment_size, so native frames
    stay byte-identical to this codec's pack_request). ``timeout_ms`` is
    the propagated deadline budget (RpcRequestMeta field 8); ``sampled``
    is the head-based coherent-sampling bit (field 9) — propagated once
    from the edge, it forces span collection at every hop."""
    return (
        _f_bytes(1, service.encode())
        + _f_bytes(2, method.encode())
        + _f_varint(3, log_id)
        + _f_varint(4, trace_id)
        + _f_varint(5, span_id)
        + _f_varint(6, parent_span_id)
        + _f_varint(8, timeout_ms)
        + _f_varint(9, 1 if sampled else 0)
    )


# -- RpcMeta --------------------------------------------------------------


@dataclass
class RpcMeta:
    """The decoded reference meta (policy/baidu_rpc_meta.proto)."""

    service_name: str = ""
    method_name: str = ""
    log_id: int = 0
    trace_id: int = 0
    span_id: int = 0
    parent_span_id: int = 0
    timeout_ms: int = 0
    sampled: int = 0  # head-based coherent-sampling bit (field 9)
    is_response: bool = False
    error_code: int = 0
    error_text: str = ""
    compress_type: int = 0
    correlation_id: int = 0
    attachment_size: int = 0
    authentication_data: bytes = b""
    unknown: Dict[int, object] = field(default_factory=dict)

    def encode(self) -> bytes:
        out = bytearray()
        if self.is_response:
            sub = _f_varint(1, self.error_code) + _f_bytes(
                2, self.error_text.encode()
            )
            out += _tag(2, 2) + _varint(len(sub)) + sub
        else:
            sub = encode_request_submeta(
                self.service_name,
                self.method_name,
                self.log_id,
                self.trace_id,
                self.span_id,
                self.parent_span_id,
                self.timeout_ms,
                self.sampled,
            )
            out += _tag(1, 2) + _varint(len(sub)) + sub
        out += _f_varint(3, self.compress_type)
        out += _f_varint(4, self.correlation_id)
        out += _f_varint(5, self.attachment_size)
        out += _f_bytes(7, self.authentication_data)
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "RpcMeta":
        m = cls()
        for field_no, wt, v in _walk_fields(memoryview(buf)):
            if field_no == 1 and wt == 2:
                for f2, w2, v2 in _walk_fields(v):
                    if f2 == 1 and w2 == 2:
                        m.service_name = bytes(v2).decode(errors="replace")
                    elif f2 == 2 and w2 == 2:
                        m.method_name = bytes(v2).decode(errors="replace")
                    # trace ids are 64-bit on every plane: masked here so
                    # an overlong wire varint decodes to the SAME value
                    # the C++ scanner's u64 arithmetic yields (the
                    # wire-differential fuzz pins the twins field-exact)
                    elif f2 == 3 and w2 == 0:
                        m.log_id = v2 & ((1 << 64) - 1)
                    elif f2 == 4 and w2 == 0:
                        m.trace_id = v2 & ((1 << 64) - 1)
                    elif f2 == 5 and w2 == 0:
                        m.span_id = v2 & ((1 << 64) - 1)
                    elif f2 == 6 and w2 == 0:
                        m.parent_span_id = v2 & ((1 << 64) - 1)
                    elif f2 == 8 and w2 == 0:
                        m.timeout_ms = v2
                    elif f2 == 9 and w2 == 0:
                        m.sampled = 1 if v2 else 0
            elif field_no == 2 and wt == 2:
                m.is_response = True
                for f2, w2, v2 in _walk_fields(v):
                    if f2 == 1 and w2 == 0:
                        m.error_code = _signed64(v2) & 0xFFFFFFFF
                        if m.error_code >= 1 << 31:
                            m.error_code -= 1 << 32
                    elif f2 == 2 and w2 == 2:
                        m.error_text = bytes(v2).decode(errors="replace")
            elif field_no == 3 and wt == 0:
                m.compress_type = v
            elif field_no == 4 and wt == 0:
                m.correlation_id = _signed64(v) & ((1 << 64) - 1)
            elif field_no == 5 and wt == 0:
                m.attachment_size = v
            elif field_no == 7 and wt == 2:
                m.authentication_data = bytes(v)
            else:
                m.unknown[field_no] = bytes(v) if wt == 2 else v
        return m


# -- frame pack / parse ---------------------------------------------------


def pack_frame(meta: RpcMeta, payload: bytes, attachment: bytes = b"") -> bytes:
    """Header + meta + payload + attachment, byte-exact to
    SerializeRpcHeaderAndMeta (baidu_rpc_protocol.cpp:69-90)."""
    meta.attachment_size = len(attachment)
    mb = meta.encode()
    body_size = len(mb) + len(payload) + len(attachment)
    header = MAGIC + struct.pack(">II", body_size, len(mb))
    return header + mb + payload + attachment


def parse_header(header: bytes) -> Optional[int]:
    """InputMessenger sizing hook (ParseRpcMessage's header phase,
    baidu_rpc_protocol.cpp:92-134)."""
    n = min(len(header), 4)
    if header[:n] != MAGIC[:n]:
        raise ParseError("not baidu_std")
    if len(header) < HEADER_BYTES:
        return None
    body_size, meta_size = struct.unpack_from(">II", header, 4)
    if meta_size > body_size:
        raise ParseError("meta_size bigger than body_size")
    return HEADER_BYTES + body_size


def rpc_meta_to_meta(rm: RpcMeta) -> Meta:
    """Bridge a decoded RpcMeta into the framework's Meta shape (shared by
    the Python parse path below and the native plane's per-frame PRPC
    callback route)."""
    meta = Meta(
        service=rm.service_name,
        method=rm.method_name,
        # out-of-enum compress values surface as an unknown codec NAME so
        # the decompress step rejects them cleanly (EREQUEST) instead of
        # silently treating the payload as uncompressed; the native plane
        # answers the identical error text for the identical wire value
        compress=_WIRE_TO_COMPRESS.get(
            rm.compress_type, f"wire-{rm.compress_type}"
        ),
        attachment_size=rm.attachment_size,
        timeout_ms=rm.timeout_ms,
        log_id=rm.log_id,
        trace_id=rm.trace_id,
        span_id=rm.span_id,
        parent_span_id=rm.parent_span_id,
        sampled=rm.sampled,
        error_text=rm.error_text,
    )
    if rm.authentication_data:
        meta.extra["auth"] = rm.authentication_data.decode(errors="replace")
    return meta


def try_parse_frame(buf: bytes) -> Tuple[Optional[ParsedFrame], int]:
    """Cut one frame; returns (frame, consumed) | (None, 0). The parsed
    result is bridged into the framework's ParsedFrame/Meta shape so the
    ordinary server/channel hooks process it."""
    if len(buf) < HEADER_BYTES:
        if buf[: min(len(buf), 4)] != MAGIC[: min(len(buf), 4)]:
            raise ParseError("not baidu_std")
        return None, 0
    total = parse_header(buf[:HEADER_BYTES])
    if total is None or len(buf) < total:
        return None, 0
    body_size, meta_size = struct.unpack_from(">II", buf, 4)
    mv = memoryview(buf)
    rm = RpcMeta.decode(bytes(mv[HEADER_BYTES : HEADER_BYTES + meta_size]))
    rest = mv[HEADER_BYTES + meta_size : total]
    att = rm.attachment_size
    if att > len(rest):
        raise ParseError("attachment_size exceeds body")
    payload = bytes(rest[: len(rest) - att])
    attachment = bytes(rest[len(rest) - att :]) if att else b""
    meta = rpc_meta_to_meta(rm)
    frame = ParsedFrame(
        meta=meta,
        payload=payload,
        attachment=attachment,
        correlation_id=rm.correlation_id,
        flags=FLAG_RESPONSE if rm.is_response else 0,
        error_code=rm.error_code,
    )
    frame.wire_protocol = "baidu_std"  # type: ignore[attr-defined]
    return frame, total


def pack_request(
    meta: Meta,
    payload: bytes,
    correlation_id: int,
    flags: int = 0,
    error_code: int = 0,
    attachment: bytes = b"",
) -> bytes:
    """Channel-side packer with the tbus_std pack_frame signature, so a
    Channel can select the protocol by name (PackRpcRequest,
    baidu_rpc_protocol.cpp:585-668)."""
    rm = RpcMeta(
        service_name=meta.service if meta else "",
        method_name=meta.method if meta else "",
        log_id=meta.log_id if meta else 0,
        trace_id=meta.trace_id if meta else 0,
        span_id=meta.span_id if meta else 0,
        parent_span_id=meta.parent_span_id if meta else 0,
        sampled=meta.sampled if meta else 0,
        timeout_ms=meta.timeout_ms if meta else 0,
        compress_type=_COMPRESS_TO_WIRE.get(meta.compress if meta else "", 0),
        correlation_id=correlation_id,
        authentication_data=(
            meta.extra.get("auth", "").encode() if meta and meta.extra else b""
        ),
    )
    return pack_frame(rm, payload, attachment)


def pack_response(
    meta: Optional[Meta],
    payload: bytes,
    correlation_id: int,
    flags: int = 0,
    error_code: int = 0,
    attachment: bytes = b"",
) -> bytes:
    rm = RpcMeta(
        is_response=True,
        error_code=error_code,
        error_text=(meta.error_text if meta else "") or "",
        compress_type=_COMPRESS_TO_WIRE.get(meta.compress if meta else "", 0),
        correlation_id=correlation_id,
    )
    return pack_frame(rm, payload, attachment)


def _process_request(sock, frame) -> None:
    from incubator_brpc_tpu_torch.rpc import server as server_mod

    server_mod.process_request(sock, frame)


def _process_response(sock, frame) -> None:
    from incubator_brpc_tpu_torch.rpc import channel as channel_mod

    channel_mod.process_response(sock, frame)


BAIDU_STD = Protocol(
    name="baidu_std",
    parse=try_parse_frame,
    parse_header=parse_header,
    pack_request=pack_request,
    pack_response=pack_response,
    process_request=_process_request,
    process_response=_process_response,
)

if "baidu_std" not in protocol_registry:
    protocol_registry.register(BAIDU_STD)
