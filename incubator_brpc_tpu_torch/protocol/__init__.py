"""protocol — the host wire protocol and its registry (reference L4,
src/brpc/policy/).

tbus_std is the port's one host protocol: ``parse=try_parse_frame`` and
``parse_iobuf=parse_frame_iobuf`` (the cut on the read IOBuf, native).
Frames are sized by ``parse_header`` first, so a frame over
``max_body_size`` is refused from its header (transport/messenger.py).
``rpc/channel.py`` and ``rpc/server.py`` bind its response and request
hooks at import, and ``rpc/stream.py`` its stream hook.
"""

from incubator_brpc_tpu_torch.protocol import tbus_std
from incubator_brpc_tpu_torch.protocol.registry import Protocol, protocol_registry
from incubator_brpc_tpu_torch.protocol.tbus_std import (
    HEADER_BYTES,
    Meta,
    ParseError,
    ParsedFrame,
    pack_frame,
    parse_frame_iobuf,
    parse_header,
    try_parse_frame,
)

TBUS_STD = Protocol(
    name="tbus_std",
    parse=try_parse_frame,
    parse_header=parse_header,
    parse_iobuf=parse_frame_iobuf,
)

if "tbus_std" not in protocol_registry:
    protocol_registry.register(TBUS_STD)

__all__ = [
    "HEADER_BYTES",
    "Meta",
    "ParseError",
    "ParsedFrame",
    "TBUS_STD",
    "pack_frame",
    "parse_header",
    "try_parse_frame",
    "Protocol",
    "protocol_registry",
    "tbus_std",
]
