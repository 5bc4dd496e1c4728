"""protocol — the host wire protocols and their registry (reference L4,
src/brpc/policy/).

Three protocols share a port, registered in the JAX package's order, which
is the order the messenger probes a new connection in: tbus_std
(``parse=try_parse_frame``, ``parse_iobuf=parse_frame_iobuf``, the cut on
the read IOBuf, native; packed by ``pack_frame_iobuf``, responses by
``pack_response_iobuf``, where the JAX package registers ``pack_frame``), http (``protocol/http.py``: the builtin pages,
custom handlers, restful mappings and the ``/<service>/<method>``
gateway; the channel's FIFO-correlated client) and baidu_std
(``protocol/baidu_std.py``: the reference's PRPC wire). Frames are sized by
``parse_header`` first, so a frame over ``max_body_size`` is refused from
its header (transport/messenger.py). ``rpc/channel.py`` and
``rpc/server.py`` bind tbus_std's response and request hooks at import,
and ``rpc/stream.py`` its stream hook. The other protocols of the JAX
package wait for ROADMAP A11.
"""

from incubator_brpc_tpu_torch.protocol import tbus_std
from incubator_brpc_tpu_torch.protocol.registry import Protocol, protocol_registry
from incubator_brpc_tpu_torch.protocol.tbus_std import (
    HEADER_BYTES,
    Meta,
    ParseError,
    ParsedFrame,
    pack_frame,
    pack_frame_iobuf,
    pack_response_iobuf,
    parse_frame_iobuf,
    parse_header,
    try_parse_frame,
)

TBUS_STD = Protocol(
    name="tbus_std",
    parse=try_parse_frame,
    parse_header=parse_header,
    pack_request=pack_frame_iobuf,
    pack_response=pack_response_iobuf,
    parse_iobuf=parse_frame_iobuf,
)

if "tbus_std" not in protocol_registry:
    protocol_registry.register(TBUS_STD)

# http registers itself on import, after tbus_std so the binary protocol
# keeps first-try priority in the InputMessenger loop
from incubator_brpc_tpu_torch.protocol import http as _http  # noqa: E402,F401

# baidu_std: the reference's exact wire format ("PRPC" header + protobuf
# RpcMeta), selectable per channel and recognized per connection
from incubator_brpc_tpu_torch.protocol import baidu_std as _baidu_std  # noqa: E402,F401

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
