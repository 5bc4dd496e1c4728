"""protocol — the host wire protocols and their registry (reference L4,
src/brpc/policy/).

The protocols share a port, registered in the JAX package's order, which
is the order the messenger probes a new connection in: tbus_std
(``parse=try_parse_frame``, ``parse_iobuf=parse_frame_iobuf``, the cut on
the read IOBuf, native; packed by ``pack_frame_iobuf``, responses by
``pack_response_iobuf``, where the JAX package registers ``pack_frame``), http (``protocol/http.py``: the builtin pages,
custom handlers, restful mappings and the ``/<service>/<method>``
gateway; the channel's FIFO-correlated client) and baidu_std
(``protocol/baidu_std.py``: the reference's PRPC wire), nshead
(``protocol/nshead.py``: the 36-byte legacy head, scanned only where the
server registered an ``nshead_service``), mongo (``protocol/mongo.py``:
the server side behind a ``mongo_service_adaptor``), thrift
(``protocol/thrift.py``: framed thrift behind a ``thrift_service``, the
client in the same module), rtmp (``protocol/rtmp.py``: the stateful media
protocol behind an ``rtmp_service``, its handshake cut by the scan and its
chunks by the connection's ``parse_conn``; the client in the same module,
``amf0``, ``flv`` and ``mpegts`` beside it), each scanned only where the
server registered its option, and the legacy pbrpc family (``protocol/legacy_pbrpc.py``:
hulu_pbrpc, sofa_pbrpc, the FIFO-correlated nshead clients and esp). RESP
(``protocol/resp.py``) and memcache (``protocol/memcache.py``, text, and
``protocol/memcache_binary.py``) are clients beside mock servers, with no
row here, as in the JAX package. Frames are sized by
``parse_header`` first, so a frame over ``max_body_size`` is refused from
its header (transport/messenger.py). ``rpc/channel.py`` and
``rpc/server.py`` bind tbus_std's response and request hooks at import,
and ``rpc/stream.py`` its stream hook.
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

# nshead: the legacy framing family's representative, multiplexed on the
# same port via the registry scan (policy/nshead_protocol.cpp)
from incubator_brpc_tpu_torch.protocol import nshead as _nshead  # noqa: E402,F401

# mongo: server-side wire protocol behind a MongoServiceAdaptor, gated to
# servers that registered one (policy/mongo_protocol.cpp)
from incubator_brpc_tpu_torch.protocol import mongo as _mongo  # noqa: E402,F401

# thrift: framed-thrift server behind ServerOptions.thrift_service
# (policy/thrift_protocol.cpp) — the client half lives in the same module
from incubator_brpc_tpu_torch.protocol import thrift as _thrift  # noqa: E402,F401

# rtmp: stateful media protocol behind an RtmpService — the extension
# ceiling of the shared-port registry (policy/rtmp_protocol.cpp)
from incubator_brpc_tpu_torch.protocol import rtmp as _rtmp  # noqa: E402,F401

# the legacy Baidu family: hulu/sofa (full duplex), nova/public_pbrpc/
# ubrpc_mcpack2/nshead_mcpack/esp clients + server adaptors
# (policy/hulu_pbrpc_protocol.cpp and friends)
from incubator_brpc_tpu_torch.protocol import legacy_pbrpc as _legacy  # noqa: E402,F401

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
