"""EndPoint — host addressing (reference src/butil/endpoint.h).

The port's copy of the JAX package's ``utils/endpoint.py``, trimmed to
host endpoints: ``ip:port`` values with the naming tag, and
``str2endpoint``. The device and mesh coordinates (``tpu://`` endpoints)
belong to the mesh (ROADMAP A3).
"""

from __future__ import annotations

import re
import socket as _socket
from dataclasses import dataclass

IP_ANY = "0.0.0.0"


@dataclass(frozen=True)
class EndPoint:
    """ip:port; ordered and hashable (socket maps key on it)."""

    ip: str = IP_ANY
    port: int = 0
    # naming-source tag (reference ServerNode.tag, naming_service.h:38):
    # descriptive, excluded from hash/eq. PartitionChannel parses "N/M"
    # partition tags out of it.
    tag: str = ""

    def __hash__(self) -> int:
        return hash((self.ip, self.port))

    def __eq__(self, other) -> bool:
        if not isinstance(other, EndPoint):
            return NotImplemented
        return (self.ip, self.port) == (other.ip, other.port)

    def __str__(self) -> str:
        return f"{self.ip}:{self.port}"

    def __lt__(self, other: "EndPoint") -> bool:
        return (self.ip, self.port) < (other.ip, other.port)


_EP_RE = re.compile(r"^(?:(?P<host>[^:/\[\]]+)|\[(?P<v6>[^\]]+)\])(?::(?P<port>\d+))?$")


def str2endpoint(s: str, default_port: int = 0) -> EndPoint:
    """Parse 'ip:port' or 'host:port' into an EndPoint (reference
    str2endpoint/hostname2endpoint, src/butil/endpoint.cpp) — hostname
    resolution included."""
    s = s.strip()
    m = _EP_RE.match(s)
    if not m:
        raise ValueError(f"bad endpoint: {s!r}")
    host = m.group("host") or m.group("v6")
    port = int(m.group("port")) if m.group("port") else default_port
    # a numeric literal (v4 or v6) passes through; otherwise resolve
    for family in (_socket.AF_INET, _socket.AF_INET6):
        try:
            _socket.inet_pton(family, host)
            return EndPoint(ip=host, port=port)
        except OSError:
            pass
    try:
        ip = _socket.gethostbyname(host)
    except OSError as e:
        raise ValueError(f"cannot resolve endpoint host {host!r}: {e}") from e
    return EndPoint(ip=ip, port=port)
