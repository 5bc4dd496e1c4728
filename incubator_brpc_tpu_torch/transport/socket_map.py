"""SocketMap — client-side connection dedup (reference
src/brpc/socket_map.{h,cpp}): one main socket per remote endpoint, shared
by every Channel targeting it; failed sockets stay in the map while their
health checker probes (socket_map.cpp:35), so revival is transparent.

The port's copy of the JAX package's ``transport/socket_map.py`` for the
single connection type (pooled and short connections are a later slice).
"""

from __future__ import annotations

import threading
from typing import Dict, Union

from incubator_brpc_tpu_torch.transport.sock import RECYCLED, Socket
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint, str2endpoint


class SocketMap:
    def __init__(self, messenger=None):
        self._messenger = messenger
        self._lock = threading.Lock()
        self._map: Dict[str, Socket] = {}

    def get_or_create(
        self, remote: Union[str, EndPoint], timeout: float = 5.0, **kwargs
    ) -> Socket:
        ep = str2endpoint(remote) if isinstance(remote, str) else remote
        key = f"{ep.ip}:{ep.port}"
        with self._lock:
            sock = self._map.get(key)
            if sock is not None and sock.state != RECYCLED:
                return sock  # FAILED sockets stay: health check may revive
        # client response processing is framework-only (done callbacks are
        # spawned to the pool), so reads run inline on the reactor
        kwargs.setdefault("inline_read", True)
        sock = Socket.connect(ep, messenger=self._messenger, timeout=timeout, **kwargs)
        with self._lock:
            cur = self._map.get(key)
            if cur is not None and cur.state != RECYCLED:
                sock.recycle()  # lost the race: reuse the established one
                return cur
            self._map[key] = sock
        return sock

    def recycle_all(self) -> None:
        with self._lock:
            socks, self._map = list(self._map.values()), {}
        for s in socks:
            s.recycle()
