"""nshead — the legacy Baidu binary framing, served on the shared port.

Wire format (reference src/brpc/nshead.h struct nshead_t, little-endian,
36 bytes):

    uint16 id | uint16 version | uint32 log_id | char provider[16] |
    uint32 magic_num (0xfb709394) | uint32 reserved | uint32 body_len

followed by ``body_len`` opaque bytes. The reference's NsheadService
(nshead_service.h, policy/nshead_protocol.cpp) hands the raw head+body to
one registered handler per server — there is no method name on the wire —
and the response is another nshead frame echoing id/version/log_id. This
row exists to prove the Protocol struct's reach (legacy protocols
multiplex on the same port as tbus_std/baidu_std/http via the registry
scan), matching that contract: register a handler with
``ServerOptions(nshead_service=fn(cntl, head, body) -> bytes)``.

The port's copy of the JAX package's ``protocol/nshead.py``, whole: the
same head and cut, so the two packages put the same bytes on the wire. On a
``native_plane=True`` server an nshead connection is handed to the Python
plane (its first four bytes are neither tbus_std's nor baidu_std's magic)
and served here.
"""

from __future__ import annotations

import logging
import struct
from dataclasses import dataclass, field
from typing import Optional, Tuple

from incubator_brpc_tpu_torch.protocol.registry import Protocol, protocol_registry
from incubator_brpc_tpu_torch.protocol.tbus_std import ParseError

logger = logging.getLogger(__name__)

MAGIC = 0xFB709394
HEADER_BYTES = 36
_HDR = struct.Struct("<HHI16sIII")
_MAGIC_OFF = 24  # byte offset of magic_num (2+2+4+16 bytes precede it)


@dataclass
class NsheadFrame:
    head: dict
    payload: bytes
    # messenger routing surface (matches ParsedFrame's duck shape)
    is_response: bool = False
    is_stream: bool = False
    correlation_id: int = 0
    meta: object = None
    wire_protocol: str = "nshead"
    extra: dict = field(default_factory=dict)


def pack_frame(
    body: bytes,
    id: int = 0,
    version: int = 0,
    log_id: int = 0,
    provider: bytes = b"tbrpc",
    reserved: int = 0,
) -> bytes:
    # `reserved` is protocol-defined: nova_pbrpc carries the method index
    # there (policy/nova_pbrpc_protocol.cpp ParseNsheadMeta)
    return _HDR.pack(
        id & 0xFFFF,
        version & 0xFFFF,
        log_id & 0xFFFFFFFF,
        provider[:16].ljust(16, b"\x00"),
        MAGIC,
        reserved & 0xFFFFFFFF,
        len(body),
    ) + body


def parse_header(header: bytes) -> Optional[int]:
    """Size the frame off the fixed header. nshead's magic sits at byte 24,
    so fewer than 28 bytes cannot be classified: raise only when the magic
    is provably wrong, else ask for more."""
    if len(header) >= _MAGIC_OFF + 4:
        (magic,) = struct.unpack_from("<I", header, _MAGIC_OFF)
        if magic != MAGIC:
            raise ParseError("not nshead")
        if len(header) < HEADER_BYTES:
            return None
        (body_len,) = struct.unpack_from("<I", header, 32)
        return HEADER_BYTES + body_len
    return None


def try_parse_frame(buf: bytes) -> Tuple[Optional[NsheadFrame], int]:
    if len(buf) < HEADER_BYTES:
        if len(buf) >= _MAGIC_OFF + 4:
            (magic,) = struct.unpack_from("<I", buf, _MAGIC_OFF)
            if magic != MAGIC:
                raise ParseError("not nshead")
        return None, 0
    hid, version, log_id, provider, magic, _res, body_len = _HDR.unpack_from(buf)
    if magic != MAGIC:
        raise ParseError("not nshead")
    total = HEADER_BYTES + body_len
    if len(buf) < total:
        return None, 0
    head = {
        "id": hid,
        "version": version,
        "log_id": log_id,
        "provider": provider.rstrip(b"\x00").decode(errors="replace"),
        "reserved": _res,
    }
    return NsheadFrame(head=head, payload=bytes(buf[HEADER_BYTES:total])), total


def _process_request(sock, frame: NsheadFrame) -> None:
    """Route to the owning server's registered nshead service (the
    reference's Server::options().nshead_service single-handler model)."""
    from incubator_brpc_tpu_torch.rpc.controller import Controller
    from incubator_brpc_tpu_torch.utils.status import ErrorCode

    server = sock.context.get("server")
    handler = getattr(server.options, "nshead_service", None) if server else None
    if handler is None:
        logger.warning("nshead frame on %r with no nshead_service registered", sock)
        sock.set_failed(ErrorCode.EREQUEST, "no nshead service")
        return
    cntl = Controller()
    cntl._server = server
    cntl.remote_side = sock.remote
    cntl.log_id = frame.head["log_id"]
    cntl._sock = sock
    cntl._mark_start()
    from incubator_brpc_tpu_torch.rpc import server as server_mod

    _prev_server = getattr(server_mod._usercode_tls, "server", None)
    server_mod._usercode_tls.server = server  # thread_local_data() works here
    try:
        body = handler(cntl, frame.head, frame.payload) or b""
    except Exception as e:
        logger.exception("nshead service raised")
        cntl.set_failed(ErrorCode.EINTERNAL, f"nshead handler raised: {e!r}")
        body = b""
    finally:
        server_mod._usercode_tls.server = _prev_server
    cntl._mark_end()
    sock.write(
        pack_frame(
            body,
            id=frame.head["id"],
            version=frame.head["version"],
            log_id=frame.head["log_id"],
        )
    )


def _enabled_for(sock) -> bool:
    """Scan nshead only on connections whose server registered a handler:
    its magic sits 24 bytes deep, so including it unconditionally would
    make short garbage look 'incomplete' instead of failing fast."""
    server = sock.context.get("server") if sock.context else None
    return (
        server is not None
        and getattr(server.options, "nshead_service", None) is not None
    )


NSHEAD = Protocol(
    name="nshead",
    parse=try_parse_frame,
    parse_header=parse_header,
    process_request=_process_request,
    enabled_for=_enabled_for,
)

if "nshead" not in protocol_registry:
    protocol_registry.register(NSHEAD)
