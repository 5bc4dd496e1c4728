"""EndPoint — addressing for the fabric (reference src/butil/endpoint.h).

The port's copy of the JAX package's ``utils/endpoint.py``. An endpoint
addresses a host socket (``ip:port``, or ``unix://<path>``) or a device:
``tpu://ip:port/dP.O`` adds the device's coordinates (process index and
local device ordinal) and optional mesh coordinates, which are descriptive
and excluded from hash and equality.
"""

from __future__ import annotations

import re
import socket as _socket
from dataclasses import dataclass, field
from typing import Mapping, Optional, Tuple

IP_ANY = "0.0.0.0"


@dataclass(frozen=True)
class EndPoint:
    """ip:port plus optional device/mesh coordinates.

    ``device`` is None for plain host endpoints. For device endpoints it is a
    tuple ``(process_index, local_device_ordinal)`` and ``mesh_coords`` maps
    mesh axis name -> index (e.g. {'dp': 0, 'tp': 3}).
    """

    ip: str = IP_ANY
    port: int = 0
    device: Optional[Tuple[int, int]] = None
    mesh_coords: Mapping[str, int] = field(default_factory=dict)
    # naming-source tag (reference ServerNode.tag, naming_service.h:38):
    # descriptive like mesh_coords — excluded from hash/eq. PartitionChannel
    # parses "N/M" partition tags out of it.
    tag: str = ""

    def is_device(self) -> bool:
        return self.device is not None

    def __hash__(self) -> int:
        # mesh_coords is descriptive, not identity: two endpoints naming the
        # same ip:port/device are the same server (LBs key sets by EndPoint)
        return hash((self.ip, self.port, self.device))

    def __eq__(self, other) -> bool:
        if not isinstance(other, EndPoint):
            return NotImplemented
        return (self.ip, self.port, self.device) == (
            other.ip, other.port, other.device,
        )

    def __str__(self) -> str:
        base = f"{self.ip}:{self.port}"
        if self.device is not None:
            coords = ",".join(f"{k}={v}" for k, v in sorted(self.mesh_coords.items()))
            return f"tpu://{base}/d{self.device[0]}.{self.device[1]}[{coords}]"
        return base

    def __lt__(self, other: "EndPoint") -> bool:
        return (self.ip, self.port, self.device or (-1, -1)) < (
            other.ip,
            other.port,
            other.device or (-1, -1),
        )


_EP_RE = re.compile(r"^(?:(?P<host>[^:/\[\]]+)|\[(?P<v6>[^\]]+)\])(?::(?P<port>\d+))?$")


def str2endpoint(s: str, default_port: int = 0) -> EndPoint:
    """Parse 'ip:port', 'host:port' or 'tpu://ip:port/dP.O' into an EndPoint.

    Analog of reference str2endpoint/hostname2endpoint
    (src/butil/endpoint.cpp) — hostname resolution included.
    """
    s = s.strip()
    device = None
    if s.startswith("unix://"):
        # unix domain sockets (reference butil/unix_socket.cpp): the whole
        # "unix://<path>" travels in ip with port 0 — every consumer
        # (Socket, Acceptor, SocketMap keys) branches on the prefix
        return EndPoint(ip=s, port=0)
    if s.startswith("tpu://"):
        rest = s[len("tpu://"):]
        if "/" in rest:
            rest, dev = rest.split("/", 1)
            m = re.match(r"^d(\d+)\.(\d+)", dev)
            if not m:
                raise ValueError(f"bad device endpoint: {s}")
            device = (int(m.group(1)), int(m.group(2)))
        s = rest
    m = _EP_RE.match(s)
    if not m:
        raise ValueError(f"bad endpoint: {s!r}")
    host = m.group("host") or m.group("v6")
    port = int(m.group("port")) if m.group("port") else default_port
    # numeric literal (v4 or v6) passes through; otherwise resolve the
    # hostname (reference hostname2endpoint, src/butil/endpoint.cpp)
    for family in (_socket.AF_INET, _socket.AF_INET6):
        try:
            _socket.inet_pton(family, host)
            return EndPoint(ip=host, port=port, device=device)
        except OSError:
            pass
    try:
        ip = _socket.gethostbyname(host)
    except OSError as e:
        raise ValueError(f"cannot resolve endpoint host {host!r}: {e}") from e
    return EndPoint(ip=ip, port=port, device=device)
