"""Protocol registry (reference src/brpc/protocol.h:64-158 + global.cpp).

A Protocol is a bundle of parse/pack callbacks registered per name; servers
try registered protocols in order on each connection and remember the first
that matches (_preferred_index, input_messenger.cpp:60-129).

The port's copy of the JAX package's ``protocol/registry.py``, trimmed to
the fields tbus_std fills: the port registers no other protocol yet, and
tbus_std cuts frames through ``parse_header`` and ``parse`` (the JAX
package's native ``parse_iobuf`` cut needs its C++ runtime).
"""

from __future__ import annotations

from dataclasses import KW_ONLY, dataclass
from typing import Callable, Dict, List, Optional

# Deep-peek window of the transport cut loop: frames are bounded by
# ``max_body_size`` plus this much header.
MAX_HEADER_PEEK = 64 * 1024


@dataclass
class Protocol:
    name: str
    # every field after the name is keyword-only: the reference's dataclass
    # has fields (pack_request, pack_response, ...) between these, so a
    # positional call written for it must fail here, not bind elsewhere
    _: KW_ONLY
    # (buf) -> (parsed_or_None, consumed); raises ParseError if not this protocol
    parse: Callable
    # (first header bytes) -> total frame size, or None if more header bytes
    # are needed; raises ParseError if the bytes are not this protocol.
    # Lets InputMessenger size the cut without copying the whole buffer.
    parse_header: Optional[Callable] = None
    # server side: (socket, frame) -> None
    process_request: Optional[Callable] = None
    # client side: (socket, frame) -> None
    process_response: Optional[Callable] = None


class ProtocolRegistry:
    def __init__(self) -> None:
        self._protocols: Dict[str, Protocol] = {}
        self._order: List[Protocol] = []

    def register(self, proto: Protocol) -> None:
        if proto.name in self._protocols:
            raise ValueError(f"protocol {proto.name!r} already registered")
        self._protocols[proto.name] = proto
        self._order.append(proto)

    def __contains__(self, name: str) -> bool:
        return name in self._protocols

    def ordered(self) -> List[Protocol]:
        return list(self._order)


protocol_registry = ProtocolRegistry()
