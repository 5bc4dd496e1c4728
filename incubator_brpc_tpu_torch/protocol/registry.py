"""Protocol registry (reference src/brpc/protocol.h:64-158 + global.cpp).

A Protocol is a bundle of parse/pack callbacks registered per name; servers
try registered protocols in order on each connection and remember the first
that matches (_preferred_index, input_messenger.cpp:60-129).

The port's copy of the JAX package's ``protocol/registry.py``, with the
same fields in the same order, ``enabled_for`` (the option-gated scan of
nshead and the legacy client rows) included.
"""

from __future__ import annotations

from dataclasses import KW_ONLY, dataclass
from typing import Callable, Dict, List, Optional

# Deep-peek window shared by the transport cut loop and variable-length
# header protocols (HTTP): protocols that size their frames inside this
# window derive their caps from it, and InputMessenger bounds how many
# bytes it will copy for a header probe. Lives here — the one module both
# layers already import — so protocol code never reaches up into transport.
MAX_HEADER_PEEK = 64 * 1024


@dataclass
class Protocol:
    name: str
    # every field after the name is keyword-only, as every protocol of the
    # port builds its row: a positional call binds by name or fails
    _: KW_ONLY
    # (buf) -> (parsed_or_None, consumed); raises ParseError if not this protocol
    parse: Callable
    # (first header bytes) -> total frame size, or None if more header bytes
    # are needed; raises ParseError if the bytes are not this protocol.
    # Lets InputMessenger size the cut without copying the whole buffer.
    parse_header: Optional[Callable] = None
    # client side: (meta, payload, cid, ...) -> bytes
    pack_request: Optional[Callable] = None
    # server side: (meta, payload, cid, error_code=, attachment=) -> bytes.
    # The server answers in the protocol the request arrived in (the
    # reference keys SendRpcResponse off the request's protocol); frames
    # tag themselves with wire_protocol and the server looks the packer up
    # here instead of hardcoding per-protocol imports.
    pack_response: Optional[Callable] = None
    # server side: (socket, frame) -> None
    process_request: Optional[Callable] = None
    # client side: (socket, frame) -> None
    process_response: Optional[Callable] = None
    # either side: (socket, frame) -> None for FLAG_STREAM frames (the
    # reference registers streaming_rpc as its own Protocol; here the
    # stream frames share tbus_std's header so they share its row)
    process_stream: Optional[Callable] = None
    # (read IOBuf) -> (parsed_or_None, consumed): the cut on the socket's
    # read chain; the messenger prefers it to copying the frame for parse
    parse_iobuf: Optional[Callable] = None
    # stateful per-connection cut: (sock, read IOBuf) -> (parsed_or_None,
    # consumed) for protocols whose framing depends on connection state
    # (HTTP's chunked bodies, resumed across cut windows). The reference
    # hangs such state off the Socket as a parsing context (socket.h
    # reset_parsing_context); here the hook keeps it in sock.context.
    # consumed>0 with no frame = progress; the messenger keeps cutting.
    parse_conn: Optional[Callable] = None
    # (sock) -> bool: whether this protocol participates in the scan for
    # this connection. Lets option-dependent protocols (nshead needs a
    # registered service; its magic sits too deep to classify short
    # garbage) stay out of connections that can never speak them — the
    # reference gates serving on ServerOptions the same way.
    enabled_for: Optional[Callable] = None
    # True: the wire carries no correlation ids, responses match requests
    # strictly in order per connection (HTTP) — the channel keeps a FIFO of
    # in-flight cids on the socket instead of reading ids off the frame.
    fifo_responses: bool = False


class ProtocolRegistry:
    def __init__(self) -> None:
        self._protocols: Dict[str, Protocol] = {}
        self._order: List[Protocol] = []

    def register(self, proto: Protocol) -> None:
        if proto.name in self._protocols:
            raise ValueError(f"protocol {proto.name!r} already registered")
        self._protocols[proto.name] = proto
        self._order.append(proto)

    def get(self, name: str) -> Protocol:
        return self._protocols[name]

    def __contains__(self, name: str) -> bool:
        return name in self._protocols

    def ordered(self) -> List[Protocol]:
        return list(self._order)


protocol_registry = ProtocolRegistry()
