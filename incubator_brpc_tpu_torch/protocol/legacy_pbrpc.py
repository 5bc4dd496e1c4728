"""legacy_pbrpc — the legacy Baidu protocol family on the shared port.

The reference proves its Protocol struct's reach with ~6 kLoC of
`policy/*_protocol.cpp` speaking the pre-brpc wire formats; this module is
that family for this stack:

  hulu_pbrpc     full client+server. 12-byte header ``"HULU" +
                 u32le(body_size=meta+payload) + u32le(meta_size)`` —
                 fields NOT in network order (policy/hulu_pbrpc_protocol.cpp:46)
                 — with HuluRpcRequestMeta / HuluRpcResponseMeta
                 (policy/hulu_pbrpc_meta.proto) encoded by the same
                 hand-rolled proto2 codec baidu_std uses. Attachments ride
                 ``user_message_size`` (protocol note :51-52).
  sofa_pbrpc     full client+server. 24-byte header ``"SOFA" +
                 u32le(meta_size) + u64le(body_size) + u64le(message_size)``
                 (policy/sofa_pbrpc_protocol.cpp:44, PackSofaHeader :130)
                 with SofaRpcMeta (type/sequence_id/method/failed/
                 error_code/reason, policy/sofa_pbrpc_meta.proto).
  nova_pbrpc     client + server adaptor. nshead framing, method index in
                 ``head.reserved``, body = raw pb bytes, snappy flagged in
                 ``head.version`` (policy/nova_pbrpc_protocol.cpp:40-49).
  public_pbrpc   client + server adaptor. nshead (version=1000) wrapping
                 PublicPbrpcRequest/Response — meta and payload both live
                 INSIDE the body proto (policy/public_pbrpc_meta.proto,
                 policy/public_pbrpc_protocol.cpp:236-267).
  ubrpc_mcpack2  client + server adaptor. nshead + mcpack body shaped
                 ``{header:{connection}, content:[{service_name, id,
                 method, params:{...}}]}``; responses carry
                 ``content:[{id, result_params:{...}}]`` or
                 ``content:[{id, error:{code, message}}]``
                 (policy/ubrpc2pb_protocol.cpp:100-210,489-510).
  nshead_mcpack  client for the existing server-side adaptor in
                 protocol/mcpack.py (policy/nshead_mcpack_protocol.cpp).
  esp            client. 32-byte packed EspHead {from, to, msg, msg_id,
                 body_len} with no magic (esp_head.h); gated to sockets
                 that spoke esp so the scan never misfires.

Client-side correlation matches the reference's connection-type contract:
hulu/sofa carry correlation ids on the wire (CONNECTION_TYPE_ALL); the
nshead family and esp are CONNECTION_TYPE_POOLED_AND_SHORT — responses
match requests strictly in order per connection, which this stack
expresses as ``fifo_responses`` (the HTTP-client FIFO machinery). The
channel partitions fifo-protocol connections by protocol (SocketMap
key_tag), so every such socket speaks exactly one protocol and its
``fifo_protocol`` tag names the response decoder.

Deviations (documented, deliberate):
- method_index: the reference derives it from the pb ServiceDescriptor;
  services here register ordered method dicts, so the index is the
  registration position. Clients may pass an explicit index via
  ``meta.extra["method_index"]``; hulu servers prefer ``method_name``
  when present.
- sofa/nova/public carry no attachment on the wire; a response attachment
  is appended to the payload rather than failing the call late.

The port's copy of the JAX package's ``protocol/legacy_pbrpc.py``, whole,
on the port's ``baidu_std`` proto2 codec: every frame of the family packs
to the same bytes in both packages. On a ``native_plane=True`` server the
family's connections are handed to the Python plane (their magic is
neither tbus_std's nor baidu_std's) and served here.
"""

from __future__ import annotations

import logging
import struct
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch.protocol import mcpack as mcpack_mod
from incubator_brpc_tpu_torch.protocol import nshead as nshead_mod
from incubator_brpc_tpu_torch.protocol.baidu_std import (
    _f_bytes,
    _f_varint,
    _signed64,
    _tag,
    _varint,
    _walk_fields,
)
from incubator_brpc_tpu_torch.protocol.registry import Protocol, protocol_registry
from incubator_brpc_tpu_torch.protocol.tbus_std import (
    FLAG_RESPONSE,
    Meta,
    ParsedFrame,
    ParseError,
)

logger = logging.getLogger(__name__)


# -- proto2 extras the baidu_std codec doesn't need ------------------------


def _zigzag64(n: int) -> int:
    return ((n << 1) ^ (n >> 63)) & ((1 << 64) - 1)


def _unzigzag64(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _f_varint0(field_no: int, value: int) -> bytes:
    """Emit even when zero (required proto2 fields: sofa ``type``)."""
    return _tag(field_no, 0) + _varint(value)


def _methods_of(server, service: str) -> List[str]:
    """Ordered method names of one registered service (the stand-in for
    the reference's pb ServiceDescriptor method order). Cached per server:
    the table is immutable after Server.start, and index dispatch runs on
    the per-request hot path."""
    cache = getattr(server, "_legacy_method_names", None)
    if cache is None:
        cache = server._legacy_method_names = {}
    names = cache.get(service)
    if names is None:
        pre = service + "."
        names = cache[service] = [
            k[len(pre):] for k in server._methods if k.startswith(pre)
        ]
    return names


def _services_of(server) -> List[str]:
    """Registered service names in registration order, cached."""
    services = getattr(server, "_legacy_service_names", None)
    if services is None:
        services = server._legacy_service_names = list(
            dict.fromkeys(k.split(".", 1)[0] for k in server._methods)
        )
    return services


def _utf8(v) -> str:
    return bytes(v).decode("utf-8", errors="replace")


# ==========================================================================
# hulu_pbrpc
# ==========================================================================

HULU_MAGIC = b"HULU"
HULU_HEADER = 12
# HuluCompressType (hulu_pbrpc_protocol.cpp:57-62) happens to match
# options.proto numbering
_HULU_TO_WIRE = {"": 0, "snappy": 1, "gzip": 2, "zlib1": 3}
_WIRE_TO_HULU = {v: k for k, v in _HULU_TO_WIRE.items()}


def _hulu_request_meta(
    meta: Optional[Meta], cid: int, method_index: int,
    user_message_size: Optional[int],
) -> bytes:
    out = bytearray()
    out += _f_bytes(1, (meta.service if meta else "").encode())
    out += _f_varint0(2, method_index)  # required
    out += _f_varint(3, _HULU_TO_WIRE.get(meta.compress if meta else "", 0))
    out += _f_varint(4, cid)
    if meta is not None:
        out += _f_varint(5, meta.log_id)
        out += _f_varint(7, meta.trace_id)
        out += _f_varint(8, meta.parent_span_id)
        out += _f_varint(9, meta.span_id)
    if user_message_size is not None:  # present iff attachment follows
        out += _f_varint0(12, user_message_size)
    out += _f_bytes(14, (meta.method if meta else "").encode())
    return bytes(out)


def _hulu_response_meta(
    meta: Optional[Meta], cid: int, error_code: int,
    user_message_size: Optional[int],
) -> bytes:
    out = bytearray()
    out += _f_varint(1, error_code)
    out += _f_bytes(2, ((meta.error_text if meta else "") or "").encode())
    out += _tag(3, 0) + _varint(_zigzag64(cid))  # sint64
    out += _f_varint(4, _HULU_TO_WIRE.get(meta.compress if meta else "", 0))
    if user_message_size is not None:  # response meta field 8
        out += _f_varint0(8, user_message_size)
    return bytes(out)


def _hulu_frame(meta_bytes: bytes, payload: bytes) -> bytes:
    return (
        HULU_MAGIC
        + struct.pack("<II", len(meta_bytes) + len(payload), len(meta_bytes))
        + meta_bytes
        + payload
    )


def hulu_pack_request(
    meta: Optional[Meta],
    payload: bytes,
    correlation_id: int,
    flags: int = 0,
    error_code: int = 0,
    attachment: bytes = b"",
) -> bytes:
    if meta is None or not meta.service:
        # requests are classified by the presence of service_name (required
        # in HuluRpcRequestMeta); an empty one would parse as a response
        raise ValueError("hulu_pbrpc requires a service name")
    idx = int(meta.extra.get("method_index", 0)) if meta.extra else 0
    # user_message_size present iff there is an attachment (protocol note
    # hulu_pbrpc_protocol.cpp:668-672: always setting it breaks old peers)
    ums = len(payload) if attachment else None
    mb = _hulu_request_meta(meta, correlation_id, idx, ums)
    return _hulu_frame(mb, payload + attachment)


def hulu_pack_response(
    meta: Optional[Meta],
    payload: bytes,
    correlation_id: int,
    flags: int = 0,
    error_code: int = 0,
    attachment: bytes = b"",
) -> bytes:
    ums = len(payload) if attachment else None
    mb = _hulu_response_meta(meta, correlation_id, error_code, ums)
    return _hulu_frame(mb, payload + attachment)


def hulu_parse_header(header: bytes) -> Optional[int]:
    n = min(len(header), 4)
    if header[:n] != HULU_MAGIC[:n]:
        raise ParseError("not hulu")
    if len(header) < HULU_HEADER:
        return None
    (body,) = struct.unpack_from("<I", header, 4)
    return HULU_HEADER + body


def hulu_try_parse(buf: bytes) -> Tuple[Optional[ParsedFrame], int]:
    if len(buf) < HULU_HEADER:
        if buf[: min(len(buf), 4)] != HULU_MAGIC[: min(len(buf), 4)]:
            raise ParseError("not hulu")
        return None, 0
    if buf[:4] != HULU_MAGIC:
        raise ParseError("not hulu")
    body, meta_size = struct.unpack_from("<II", buf, 4)
    total = HULU_HEADER + body
    if len(buf) < total:
        return None, 0
    if meta_size > body:
        raise ParseError(f"hulu meta_size {meta_size} > body_size {body}")
    mv = memoryview(buf)
    meta_mv = mv[HULU_HEADER : HULU_HEADER + meta_size]
    payload = bytes(mv[HULU_HEADER + meta_size : total])
    # Request iff field 1 is a length-delimited service_name (required in
    # requests); responses start with varint error_code / sint64 cid.
    fields: Dict[int, Any] = {}
    for fno, wt, v in _walk_fields(meta_mv):
        fields[(fno, wt)] = v

    def _split(ums) -> Tuple[bytes, bytes]:
        # user_message_size present = an attachment follows the message
        # (0 is meaningful: empty message, everything is attachment)
        if ums is None or not 0 <= int(ums) <= len(payload):
            return payload, b""
        return payload[: int(ums)], payload[int(ums):]

    # requests carry a length-delimited service_name (required) and/or
    # method_name(14); a response's field 1 is a varint error_code and its
    # meta has no field 14 at all
    if (1, 2) in fields or (14, 2) in fields:  # request
        meta = Meta(
            service=_utf8(fields.get((1, 2), b"")),
            method=_utf8(fields.get((14, 2), b"")),
            compress=_WIRE_TO_HULU.get(int(fields.get((3, 0), 0)), ""),
            log_id=int(fields.get((5, 0), 0)),
            trace_id=int(fields.get((7, 0), 0)),
            parent_span_id=int(fields.get((8, 0), 0)),
            span_id=int(fields.get((9, 0), 0)),
            extra={"method_index": int(fields.get((2, 0), 0))},
        )
        cid = _signed64(int(fields.get((4, 0), 0)))
        payload, att = _split(fields.get((12, 0)))
        frame = ParsedFrame(
            meta=meta, payload=payload, attachment=att,
            correlation_id=cid, flags=0, error_code=0,
        )
    else:  # response
        err = int(fields.get((1, 0), 0))
        meta = Meta(
            error_text=_utf8(fields.get((2, 2), b"")),
            compress=_WIRE_TO_HULU.get(int(fields.get((4, 0), 0)), ""),
        )
        cid = _unzigzag64(int(fields.get((3, 0), 0)))
        payload, att = _split(fields.get((8, 0)))
        frame = ParsedFrame(
            meta=meta, payload=payload, attachment=att,
            correlation_id=cid, flags=FLAG_RESPONSE, error_code=err,
        )
    frame.wire_protocol = "hulu_pbrpc"
    return frame, total


def _hulu_process_request(sock, frame: ParsedFrame) -> None:
    from incubator_brpc_tpu_torch.rpc import server as server_mod

    server = sock.context.get("server")
    if server is not None and not frame.meta.method:
        # resolve method_index -> registered name (descriptor order analog)
        idx = int(frame.meta.extra.get("method_index", 0))
        names = _methods_of(server, frame.meta.service)
        if 0 <= idx < len(names):
            frame.meta.method = names[idx]
    server_mod.process_request(sock, frame)


def _process_response_via_channel(sock, frame) -> None:
    from incubator_brpc_tpu_torch.rpc import channel as channel_mod

    channel_mod.process_response(sock, frame)


HULU = Protocol(
    name="hulu_pbrpc",
    parse=hulu_try_parse,
    parse_header=hulu_parse_header,
    pack_request=hulu_pack_request,
    pack_response=hulu_pack_response,
    process_request=_hulu_process_request,
    process_response=_process_response_via_channel,
)


# ==========================================================================
# sofa_pbrpc
# ==========================================================================

SOFA_MAGIC = b"SOFA"
SOFA_HEADER = 24
# SofaCompressType (sofa_pbrpc_meta.proto): NONE=0 GZIP=1 ZLIB=2 SNAPPY=3
_SOFA_TO_WIRE = {"": 0, "gzip": 1, "zlib1": 2, "snappy": 3}
_WIRE_TO_SOFA = {v: k for k, v in _SOFA_TO_WIRE.items()}


def _sofa_frame(meta_bytes: bytes, payload: bytes) -> bytes:
    return (
        SOFA_MAGIC
        + struct.pack(
            "<IQQ",
            len(meta_bytes),
            len(payload),
            len(meta_bytes) + len(payload),
        )
        + meta_bytes
        + payload
    )


def sofa_pack_request(
    meta: Optional[Meta],
    payload: bytes,
    correlation_id: int,
    flags: int = 0,
    error_code: int = 0,
    attachment: bytes = b"",
) -> bytes:
    full = ""
    if meta is not None:
        full = f"{meta.service}.{meta.method}" if meta.service else meta.method
    out = bytearray()
    out += _f_varint0(1, 0)  # type = REQUEST (required)
    out += _f_varint0(2, correlation_id)  # sequence_id (required)
    out += _f_bytes(100, full.encode())
    out += _f_varint(300, _SOFA_TO_WIRE.get(meta.compress if meta else "", 0))
    return _sofa_frame(bytes(out), payload + attachment)


def sofa_pack_response(
    meta: Optional[Meta],
    payload: bytes,
    correlation_id: int,
    flags: int = 0,
    error_code: int = 0,
    attachment: bytes = b"",
) -> bytes:
    out = bytearray()
    out += _f_varint0(1, 1)  # type = RESPONSE
    out += _f_varint0(2, correlation_id)
    if error_code:
        # sofa-pbrpc clients need `failed` set (sofa_pbrpc_protocol.cpp:261)
        out += _f_varint0(200, 1)
        out += _f_varint0(201, error_code)
        out += _f_bytes(202, ((meta.error_text if meta else "") or "").encode())
    out += _f_varint(300, _SOFA_TO_WIRE.get(meta.compress if meta else "", 0))
    return _sofa_frame(bytes(out), payload + attachment)


def sofa_parse_header(header: bytes) -> Optional[int]:
    n = min(len(header), 4)
    if header[:n] != SOFA_MAGIC[:n]:
        raise ParseError("not sofa")
    if len(header) < SOFA_HEADER:
        return None
    meta_size, body, msg = struct.unpack_from("<IQQ", header, 4)
    if msg != meta_size + body:
        raise ParseError("sofa message_size != meta_size + body_size")
    return SOFA_HEADER + msg


def sofa_try_parse(buf: bytes) -> Tuple[Optional[ParsedFrame], int]:
    if len(buf) < SOFA_HEADER:
        if buf[: min(len(buf), 4)] != SOFA_MAGIC[: min(len(buf), 4)]:
            raise ParseError("not sofa")
        return None, 0
    if buf[:4] != SOFA_MAGIC:
        raise ParseError("not sofa")
    meta_size, body, msg = struct.unpack_from("<IQQ", buf, 4)
    if msg != meta_size + body:
        raise ParseError("sofa message_size != meta_size + body_size")
    total = SOFA_HEADER + msg
    if len(buf) < total:
        return None, 0
    mv = memoryview(buf)
    fields: Dict[Tuple[int, int], Any] = {}
    for fno, wt, v in _walk_fields(mv[SOFA_HEADER : SOFA_HEADER + meta_size]):
        fields[(fno, wt)] = v
    payload = bytes(mv[SOFA_HEADER + meta_size : total])
    mtype = int(fields.get((1, 0), 0))
    cid = int(fields.get((2, 0), 0))
    compress = _WIRE_TO_SOFA.get(int(fields.get((300, 0), 0)), "")
    if mtype == 0:  # request
        full = _utf8(fields.get((100, 2), b""))
        service, _, method = full.rpartition(".")
        meta = Meta(service=service, method=method, compress=compress)
        frame = ParsedFrame(
            meta=meta, payload=payload, attachment=b"",
            correlation_id=cid, flags=0, error_code=0,
        )
    else:
        failed = bool(int(fields.get((200, 0), 0)))
        err = int(fields.get((201, 0), 0)) if failed else 0
        if failed and err == 0:
            err = 1  # failed w/o code: still an error
        meta = Meta(
            error_text=_utf8(fields.get((202, 2), b"")), compress=compress
        )
        frame = ParsedFrame(
            meta=meta, payload=payload, attachment=b"",
            correlation_id=cid, flags=FLAG_RESPONSE, error_code=err,
        )
    frame.wire_protocol = "sofa_pbrpc"
    return frame, total


def _sofa_process_request(sock, frame: ParsedFrame) -> None:
    from incubator_brpc_tpu_torch.rpc import server as server_mod

    server_mod.process_request(sock, frame)


SOFA = Protocol(
    name="sofa_pbrpc",
    parse=sofa_try_parse,
    parse_header=sofa_parse_header,
    pack_request=sofa_pack_request,
    pack_response=sofa_pack_response,
    process_request=_sofa_process_request,
    process_response=_process_response_via_channel,
)


# ==========================================================================
# FIFO client plumbing shared by the nshead family and esp
# ==========================================================================

# protocol name -> response decoder. The channel partitions fifo-protocol
# sockets by protocol (SocketMap key_tag), so one socket only ever carries
# one fifo protocol and the socket's fifo_protocol tag names its decoder —
# no per-call registration, nothing to leak when a call dies early.
_FIFO_DECODERS: Dict[str, Any] = {}


def _fifo_process_response(sock, frame) -> None:
    """Complete the OLDEST in-flight call on this connection (the
    CONNECTION_TYPE_POOLED_AND_SHORT contract: one stream of ordered
    responses per socket), decoding with the packer-registered decoder."""
    from incubator_brpc_tpu_torch.runtime.correlation_id import (
        EBUSY,
        call_id_space,
    )
    from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool
    from incubator_brpc_tpu_torch.transport.event_dispatcher import (
        on_reactor_thread,
    )

    pending = sock.context.get("http_pending")
    cid = None
    if pending:
        try:
            cid = pending.popleft()
        except IndexError:
            cid = None
    if cid is None:
        logger.warning("legacy response on %r with no in-flight call", sock)
        return
    rc, cntl = call_id_space.lock(cid, nowait=on_reactor_thread())
    if rc == EBUSY:
        global_worker_pool().spawn(_fifo_complete_blocking, sock, frame, cid)
        return
    if rc != 0 or cntl is None:
        return  # call settled already (timeout): drop the late response
    _fifo_complete_locked(sock, frame, cid, cntl)


def _fifo_complete_blocking(sock, frame, cid: int) -> None:
    from incubator_brpc_tpu_torch.runtime.correlation_id import call_id_space

    rc, cntl = call_id_space.lock(cid)
    if rc != 0 or cntl is None:
        return
    _fifo_complete_locked(sock, frame, cid, cntl)


def _fifo_complete_locked(sock, frame, cid: int, cntl) -> None:
    from incubator_brpc_tpu_torch.runtime.correlation_id import call_id_space
    from incubator_brpc_tpu_torch.utils.status import ErrorCode

    channel = cntl._channel
    if channel is None:
        call_id_space.unlock(cid)
        return
    decode = _FIFO_DECODERS.get(sock.context.get("fifo_protocol"))
    if decode is None:
        cntl.set_failed(ErrorCode.ERESPONSE, "no decoder for response")
        channel._end_rpc(cntl)
        return
    try:
        err, text, payload, meta = decode(frame)
    except ParseError as e:
        err, text, payload, meta = (
            ErrorCode.ERESPONSE, f"undecodable response: {e}", b"", None,
        )
    if err:
        cntl.set_failed(err, text or f"remote error {err}")
    else:
        cntl.response_payload = payload
        cntl.response_meta = meta
    channel._end_rpc(cntl)


_NSHEAD_FIFO = {"nova_pbrpc", "public_pbrpc", "ubrpc_mcpack2", "nshead_mcpack"}


def _nshead_client_enabled(sock) -> bool:
    return sock.context.get("fifo_protocol") in _NSHEAD_FIFO


def _nshead_client_parse(buf: bytes):
    frame, consumed = nshead_mod.try_parse_frame(buf)
    if frame is not None:
        frame.is_response = True
        # FIFO pop order must equal wire order: process inline on the
        # single reader fiber (same rule as HTTP client responses)
        frame.process_inline = True
    return frame, consumed


def _never_parse(buf: bytes):
    raise ParseError("client-only protocol")


def _never_header(header: bytes):
    # pack-only rows never match inbound bytes; failing fast here keeps
    # the scan from running the copying full-parse fallback
    raise ParseError("client-only protocol")


NSHEAD_CLIENT = Protocol(
    name="nshead_client",
    parse=_nshead_client_parse,
    parse_header=nshead_mod.parse_header,
    process_response=_fifo_process_response,
    enabled_for=_nshead_client_enabled,
)


# ==========================================================================
# nova_pbrpc
# ==========================================================================

NOVA_SNAPPY_FLAG = 0x1  # head.version bit (nova_pbrpc_protocol.cpp:50)


def _nova_decode(frame):
    return 0, "", frame.payload, None


def nova_pack_request(
    meta: Optional[Meta],
    payload: bytes,
    correlation_id: int,
    flags: int = 0,
    error_code: int = 0,
    attachment: bytes = b"",
) -> bytes:
    idx = int(meta.extra.get("method_index", 0)) if meta and meta.extra else 0
    version = 0
    if meta is not None and meta.compress == "snappy":
        version |= NOVA_SNAPPY_FLAG
    return nshead_mod.pack_frame(
        payload + attachment,
        version=version,
        log_id=meta.log_id if meta else 0,
        reserved=idx,
    )


NOVA = Protocol(
    parse_header=_never_header,
    name="nova_pbrpc",
    parse=_never_parse,
    pack_request=nova_pack_request,
    fifo_responses=True,
)


def NovaServiceAdaptor(cntl, head, body) -> bytes:
    """``ServerOptions(nshead_service=NovaServiceAdaptor)``: dispatch to the
    server's FIRST registered service by ``head.reserved`` method index
    (NovaServiceAdaptor::ParseNsheadMeta — nova carries no service name).
    A snappy-flagged request body is decompressed and the flag is cleared
    for the reply (this stack does not compress nova responses)."""
    from incubator_brpc_tpu_torch.protocol import compress as compress_mod

    server = cntl._server
    services = _services_of(server)
    if not services:
        cntl.set_failed(1, "no service registered")
        return b""
    service = services[0]
    names = _methods_of(server, service)
    idx = int(head.get("reserved", 0))
    if not 0 <= idx < len(names):
        cntl.set_failed(1, f"no method index {idx}")
        return b""
    prop = server._methods.get(f"{service}.{names[idx]}")
    if prop is None:
        cntl.set_failed(1, f"no method {service}.{names[idx]}")
        return b""
    if head.get("version", 0) & NOVA_SNAPPY_FLAG:
        try:
            body = compress_mod.decompress("snappy", body)
        except Exception as e:
            cntl.set_failed(1, f"nova snappy decompress failed: {e}")
            return b""
        # the reply echoes head.version; ours is uncompressed
        head["version"] = head.get("version", 0) & ~NOVA_SNAPPY_FLAG
    cntl._service, cntl._method = service, names[idx]
    return prop.handler(cntl, body) or b""


# ==========================================================================
# public_pbrpc
# ==========================================================================

_PUBLIC_VERSION = "pbrpc=1.0"
_PUBLIC_CHARSET = "utf-8"
_PUBLIC_SUCCESS = "success"
_PUBLIC_CONTENT_TYPE = 1
_PUBLIC_NSHEAD_VERSION = 1000


def _msg(field_no: int, body: bytes) -> bytes:
    return _tag(field_no, 2) + _varint(len(body)) + body


def public_pack_request(
    meta: Optional[Meta],
    payload: bytes,
    correlation_id: int,
    flags: int = 0,
    error_code: int = 0,
    attachment: bytes = b"",
) -> bytes:
    idx = int(meta.extra.get("method_index", 0)) if meta and meta.extra else 0
    head = bytearray()
    head += _f_varint0(2, _PUBLIC_CONTENT_TYPE)  # from_host(1) left unset
    head += _f_varint0(3, 1)  # connection: keep-alive
    head += _f_bytes(4, _PUBLIC_CHARSET.encode())
    head += _f_bytes(
        6, time.strftime("%Y%m%d%H%M%S").encode()
    )  # create_time
    if meta is not None and meta.log_id:
        head += _f_varint(7, meta.log_id)
    body = bytearray()
    body += _f_bytes(1, _PUBLIC_VERSION.encode())
    body += _f_bytes(2, _PUBLIC_CHARSET.encode())
    body += _f_bytes(3, (meta.service if meta else "").encode())
    body += _f_varint0(4, idx)  # method_id (required)
    body += _f_varint0(5, correlation_id)  # id (required)
    body += _f_bytes(6, payload + attachment)
    wrapper = _msg(1, bytes(head)) + _msg(2, bytes(body))
    return nshead_mod.pack_frame(
        wrapper,
        version=_PUBLIC_NSHEAD_VERSION,
        log_id=meta.log_id if meta else 0,
    )


def _public_decode(frame):
    code, text, payload = 0, "", b""
    for fno, wt, v in _walk_fields(memoryview(frame.payload)):
        if fno == 1 and wt == 2:  # responseHead
            for f2, w2, v2 in _walk_fields(v):
                if f2 == 1 and w2 == 0:
                    code = _unzigzag64(int(v2))  # sint32
                elif f2 == 2 and w2 == 2:
                    text = _utf8(v2)
        elif fno == 2 and wt == 2:  # responseBody (first one wins)
            for f2, w2, v2 in _walk_fields(v):
                if f2 == 1 and w2 == 2 and not payload:
                    payload = bytes(v2)
                elif f2 == 3 and w2 == 0 and not code:
                    code = _signed64(int(v2))
    return code, text, payload, None


PUBLIC_PBRPC = Protocol(
    parse_header=_never_header,
    name="public_pbrpc",
    parse=_never_parse,
    pack_request=public_pack_request,
    fifo_responses=True,
)


def PublicPbrpcServiceAdaptor(cntl, head, body) -> bytes:
    """``ServerOptions(nshead_service=PublicPbrpcServiceAdaptor)``: unwrap
    PublicPbrpcRequest, dispatch by (service, method_id), wrap the
    response (public_pbrpc_protocol.cpp:63-141)."""
    server = cntl._server
    service = ""
    method_id = 0
    call_id = 0
    payload = b""
    try:
        for fno, wt, v in _walk_fields(memoryview(body)):
            if fno == 2 and wt == 2:  # first requestBody
                for f2, w2, v2 in _walk_fields(v):
                    if f2 == 3 and w2 == 2:
                        service = _utf8(v2)
                    elif f2 == 4 and w2 == 0:
                        method_id = int(v2)
                    elif f2 == 5 and w2 == 0:
                        call_id = int(v2)
                    elif f2 == 6 and w2 == 2:
                        payload = bytes(v2)
                break
    except ParseError as e:
        cntl.set_failed(1, f"bad PublicPbrpcRequest: {e}")
        return b""
    names = _methods_of(server, service)
    prop = (
        server._methods.get(f"{service}.{names[method_id]}")
        if 0 <= method_id < len(names) else None
    )
    code, text, out = 0, _PUBLIC_SUCCESS, b""
    if prop is None:
        code, text = 1, f"no method {service}#{method_id}"
    else:
        cntl._service, cntl._method = service, names[method_id]
        try:
            out = prop.handler(cntl, payload) or b""
        except Exception as e:  # mirror the server's EINTERNAL contract
            logger.exception("public_pbrpc handler raised")
            code, text, out = 2003, f"handler raised: {e!r}", b""
        if cntl.error_code:
            code, text, out = cntl.error_code, cntl.error_text, b""
    rhead = bytearray()
    rhead += _tag(1, 0) + _varint(_zigzag64(code))  # sint32, required
    rhead += _f_bytes(2, text.encode())
    rbody = bytearray()
    rbody += _f_bytes(1, out)
    rbody += _f_varint0(4, call_id)  # id (required)
    return _msg(1, bytes(rhead)) + _msg(2, bytes(rbody))


# ==========================================================================
# ubrpc (mcpack2)
# ==========================================================================


def ubrpc_pack_request(
    meta: Optional[Meta],
    payload: bytes,
    correlation_id: int,
    flags: int = 0,
    error_code: int = 0,
    attachment: bytes = b"",
) -> bytes:
    """``payload`` is the mcpack-encoded params object (protocol/mcpack
    ``dumps``/``Message.encode`` output); it lands under
    ``content[0].params`` (ubrpc2pb_protocol.cpp:489-510)."""
    try:
        params = mcpack_mod.loads(payload) if payload else {}
    except Exception as e:
        raise ValueError(f"ubrpc payload must be mcpack: {e}")
    req = {
        "header": {"connection": True},
        "content": [
            {
                "service_name": meta.service if meta else "",
                "id": correlation_id,
                "method": meta.method if meta else "",
                "params": params,
            }
        ],
    }
    return nshead_mod.pack_frame(
        mcpack_mod.dumps(req), log_id=meta.log_id if meta else 0
    )


def _ubrpc_decode(frame):
    try:
        obj = mcpack_mod.loads(frame.payload)
    except Exception as e:
        raise ParseError(f"ubrpc response not mcpack: {e}")
    content = obj.get("content")
    if not isinstance(content, list) or not content:
        raise ParseError("ubrpc response has no content[0]")
    c0 = content[0]
    err = c0.get("error")
    if isinstance(err, dict):
        code = int(err.get("code", 1)) or 1
        return code, str(err.get("message", "")), b"", None
    rp = c0.get("result_params")
    payload = mcpack_mod.dumps(rp) if isinstance(rp, dict) else b""
    meta = None
    if "result" in c0:
        meta = Meta(extra={"idl_result": c0["result"]})
    return 0, "", payload, meta


UBRPC_MCPACK2 = Protocol(
    parse_header=_never_header,
    name="ubrpc_mcpack2",
    parse=_never_parse,
    pack_request=ubrpc_pack_request,
    fifo_responses=True,
)


def UbrpcServiceAdaptor(cntl, head, body) -> bytes:
    """``ServerOptions(nshead_service=UbrpcServiceAdaptor)``: dispatch
    ``content[0].{service_name, method, params}``; handlers receive the
    mcpack-encoded params and return mcpack bytes that are wrapped as
    ``result_params`` (UbrpcAdaptor, ubrpc2pb_protocol.cpp:60-210)."""
    server = cntl._server
    try:
        obj = mcpack_mod.loads(body)
        content = obj.get("content")
        c0 = content[0] if isinstance(content, list) and content else {}
        service = str(c0.get("service_name", ""))
        method = str(c0.get("method", ""))
        call_id = int(c0.get("id", 0))
        params = c0.get("params")
    except Exception as e:
        cntl.set_failed(1, f"bad ubrpc request: {e}")
        return b""

    def _error(code: int, message: str) -> bytes:
        return mcpack_mod.dumps(
            {"content": [{"id": call_id,
                          "error": {"code": code, "message": message}}]}
        )

    if not service or not method or not isinstance(params, dict):
        return _error(1, "missing service_name/method/params")
    prop = server._methods.get(f"{service}.{method}")
    if prop is None:
        return _error(1, f"unknown {service}.{method}")
    cntl._service, cntl._method = service, method
    try:
        out = prop.handler(cntl, mcpack_mod.dumps(params)) or b""
    except Exception as e:
        logger.exception("ubrpc handler raised")
        return _error(2003, f"handler raised: {e!r}")
    if cntl.error_code:
        return _error(cntl.error_code, cntl.error_text)
    try:
        result_params = mcpack_mod.loads(out) if out else {}
    except Exception:
        return _error(2004, "handler returned non-mcpack bytes")
    return mcpack_mod.dumps(
        {"content": [{"id": call_id, "result": 0,
                      "result_params": result_params}]}
    )


# ==========================================================================
# nshead_mcpack client (server adaptor lives in protocol/mcpack.py)
# ==========================================================================


def _nshead_mcpack_decode(frame):
    return 0, "", frame.payload, None


def nshead_mcpack_pack_request(
    meta: Optional[Meta],
    payload: bytes,
    correlation_id: int,
    flags: int = 0,
    error_code: int = 0,
    attachment: bytes = b"",
) -> bytes:
    return nshead_mod.pack_frame(
        payload, log_id=meta.log_id if meta else 0
    )


NSHEAD_MCPACK = Protocol(
    parse_header=_never_header,
    name="nshead_mcpack",
    parse=_never_parse,
    pack_request=nshead_mcpack_pack_request,
    fifo_responses=True,
)


# ==========================================================================
# esp
# ==========================================================================

# EspHead (esp_head.h, packed little-endian):
#   from{u16 stub, u16 port, u32 ip} to{...} u32 msg u64 msg_id i32 body_len
_ESP_HEAD = struct.Struct("<HHIHHIIQi")
ESP_HEADER = _ESP_HEAD.size  # 32


@dataclass
class EspFrame:
    head: dict
    payload: bytes
    is_response: bool = True
    is_stream: bool = False
    correlation_id: int = 0
    process_inline: bool = True
    meta: object = None
    extra: dict = field(default_factory=dict)


def esp_pack_request(
    meta: Optional[Meta],
    payload: bytes,
    correlation_id: int,
    flags: int = 0,
    error_code: int = 0,
    attachment: bytes = b"",
) -> bytes:
    x = meta.extra if meta and meta.extra else {}
    body = payload + attachment
    return _ESP_HEAD.pack(
        0, 0, 0,  # from: filled by intermediaries in the reference
        int(x.get("to_stub", 0)) & 0xFFFF,
        int(x.get("to_port", 0)) & 0xFFFF,
        int(x.get("to_ip", 0)) & 0xFFFFFFFF,
        int(x.get("esp_msg", 0)) & 0xFFFFFFFF,
        correlation_id & ((1 << 64) - 1),
        len(body),
    ) + body


def _esp_decode(frame: EspFrame):
    return 0, "", frame.payload, Meta(extra={"esp_head": frame.head})


def _esp_enabled(sock) -> bool:
    return sock.context.get("fifo_protocol") == "esp"


def esp_parse_header(header: bytes) -> Optional[int]:
    # no magic: the enabled_for gate (socket spoke esp) is the classifier
    if len(header) < ESP_HEADER:
        return None
    body_len = struct.unpack_from("<i", header, ESP_HEADER - 4)[0]
    if body_len < 0:
        raise ParseError("esp body_len < 0")
    return ESP_HEADER + body_len


def esp_try_parse(buf: bytes) -> Tuple[Optional[EspFrame], int]:
    if len(buf) < ESP_HEADER:
        return None, 0
    vals = _ESP_HEAD.unpack_from(buf)
    body_len = vals[8]
    if body_len < 0:
        raise ParseError("esp body_len < 0")
    total = ESP_HEADER + body_len
    if len(buf) < total:
        return None, 0
    head = {
        "from": {"stub": vals[0], "port": vals[1], "ip": vals[2]},
        "to": {"stub": vals[3], "port": vals[4], "ip": vals[5]},
        "msg": vals[6],
        "msg_id": vals[7],
        "body_len": body_len,
    }
    return EspFrame(head=head, payload=bytes(buf[ESP_HEADER:total])), total


ESP = Protocol(
    name="esp",
    parse=esp_try_parse,
    parse_header=esp_parse_header,
    pack_request=esp_pack_request,
    process_response=_fifo_process_response,
    enabled_for=_esp_enabled,
    fifo_responses=True,
)


_FIFO_DECODERS.update(
    nova_pbrpc=_nova_decode,
    public_pbrpc=_public_decode,
    ubrpc_mcpack2=_ubrpc_decode,
    nshead_mcpack=_nshead_mcpack_decode,
    esp=_esp_decode,
)

for _p in (HULU, SOFA, NSHEAD_CLIENT, NOVA, PUBLIC_PBRPC, UBRPC_MCPACK2,
           NSHEAD_MCPACK, ESP):
    if _p.name not in protocol_registry:
        protocol_registry.register(_p)
