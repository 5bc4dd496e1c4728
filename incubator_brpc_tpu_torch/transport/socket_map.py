"""SocketMap — client-side connection dedup (reference
src/brpc/socket_map.{h,cpp}): one main socket per remote endpoint, shared
by every Channel targeting it; failed sockets stay in the map while their
health checker probes (socket_map.cpp:35), so revival is transparent.

The port's copy of the JAX package's ``transport/socket_map.py``: the
main socket per (endpoint, key tag), and the pooled and short secondary
connections of ``ChannelOptions(connection_type=...)``. Secondaries never
probe: the port's Socket takes no ``health_check_interval`` argument, so
the map sets the attribute to 0 on each one it dials.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Union

from incubator_brpc_tpu_torch.transport.sock import CONNECTED, RECYCLED, Socket
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint, str2endpoint


class SocketMap:
    def __init__(self, messenger=None):
        self._messenger = messenger
        self._lock = threading.Lock()
        self._map: Dict[str, Socket] = {}
        self._pooled: Dict[str, list] = {}  # key -> idle pooled sockets

    def get_or_create(
        self,
        remote: Union[str, EndPoint],
        timeout: float = 5.0,
        key_tag: str = "",
        **kwargs,
    ) -> Socket:
        """``key_tag`` partitions connections the way the reference's
        SocketMapKey{EndPoint, auth, ssl, ...} does (socket_map.h:35): a
        channel with credentials must NOT share a connection with one
        without — the shared socket would be authenticated for both."""
        ep = str2endpoint(remote) if isinstance(remote, str) else remote
        key = f"{ep.ip}:{ep.port}|{key_tag}"
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

    def remove(self, remote: Union[str, EndPoint], key_tag: str = "") -> Optional[Socket]:
        ep = str2endpoint(remote) if isinstance(remote, str) else remote
        key = f"{ep.ip}:{ep.port}|{key_tag}"
        with self._lock:
            return self._map.pop(key, None)

    # -- pooled secondary sockets (reference Socket::GetPooledSocket:
    # an exclusive connection per in-flight call, parked for reuse) -------

    def get_pooled(
        self,
        remote: Union[str, EndPoint],
        timeout: float = 5.0,
        key_tag: str = "",
        **kwargs,
    ) -> Socket:
        """Pop an idle pooled connection or dial a fresh one. The caller
        owns it exclusively until return_pooled()."""
        ep = str2endpoint(remote) if isinstance(remote, str) else remote
        key = f"{ep.ip}:{ep.port}|{key_tag}"
        dead = []
        with self._lock:
            idle = self._pooled.get(key)
            sock = None
            while idle:
                cand = idle.pop()
                if cand.state == CONNECTED:
                    sock = cand
                    break
                dead.append(cand)
        for d in dead:
            d.recycle()  # free the registry slot, don't just drop the ref
        if sock is not None:
            return sock
        # no health checking: a dead pooled connection is simply discarded
        # at the next pop (the pool replaces, it never revives)
        return self._dial_secondary(ep, timeout, kwargs)

    def return_pooled(
        self,
        remote: Union[str, EndPoint],
        sock: Socket,
        key_tag: str = "",
        max_idle: int = 32,
    ) -> None:
        """Park a healthy connection for reuse; broken or surplus ones are
        recycled (the reference caps pooled idle connections too)."""
        if sock.state != CONNECTED:
            sock.recycle()  # free the registry slot
            return
        ep = str2endpoint(remote) if isinstance(remote, str) else remote
        key = f"{ep.ip}:{ep.port}|{key_tag}"
        with self._lock:
            idle = self._pooled.setdefault(key, [])
            if len(idle) < max_idle:
                idle.append(sock)
                return
        sock.recycle()

    def get_short(
        self,
        remote: Union[str, EndPoint],
        timeout: float = 5.0,
        **kwargs,
    ) -> Socket:
        """A fresh connection the caller closes after one call (reference
        Socket::GetShortSocket) — dialed with THIS map's messenger so
        short-connection traffic parses like everything else."""
        ep = str2endpoint(remote) if isinstance(remote, str) else remote
        return self._dial_secondary(ep, timeout, kwargs)

    def _dial_secondary(self, ep: EndPoint, timeout: float, kwargs: dict) -> Socket:
        """A pooled or short connection: dialed with this map's messenger,
        read inline, never health-checked."""
        kwargs.setdefault("inline_read", True)
        sock = Socket.connect(ep, messenger=self._messenger, timeout=timeout, **kwargs)
        sock.health_check_interval = 0
        return sock

    def recycle_all(self) -> None:
        with self._lock:
            socks, self._map = list(self._map.values()), {}
            for idle in self._pooled.values():
                socks.extend(idle)
            self._pooled = {}
        for s in socks:
            s.recycle()

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)
