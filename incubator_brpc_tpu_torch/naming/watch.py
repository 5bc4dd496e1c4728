"""watch:// — long-poll (consul-style) naming.

The reference's ConsulNamingService (policy/consul_naming_service.cpp)
issues blocking queries: GET .../v1/health/service/<name>?index=N&wait=60s
holds until the server set changes past N, so updates propagate in one RTT
instead of a poll interval. Same shape here, self-hosted:

- **Server side**: a ``WatchRegistry`` holds named server sets with a
  version; ``install_watch_endpoint(server, registry)`` serves
  ``GET /naming/<name>?index=N&wait=S`` on any framework Server — the
  handler parks (fiber; only that connection) until version > N or the
  wait expires, then answers ``{"index": V, "servers": ["host:port tag"]}``.
- **Client side**: ``watch://host:port/name`` runs a dedicated watch loop
  on a worker fiber (the reference's RunNamingService push model, not the
  periodic poll): each response pushes the list; the next request blocks
  at the new index. Errors back off and re-poll, keeping the last good
  list (naming hiccups never wipe servers).

The port's copy of the JAX package's ``naming/watch.py``, whole.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch.naming import (
    NamingService,
    _parse_node,
    register_naming_service,
)
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint

logger = logging.getLogger(__name__)

WATCH_PATH_PREFIX = "/naming/"
MAX_WAIT_S = 60.0


class WatchRegistry:
    """Named server sets with versions; updates wake parked watchers."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._sets: Dict[str, Tuple[int, List[str]]] = {}

    def update(self, name: str, servers: List[str]) -> int:
        """Replace the set; returns the new version."""
        with self._cond:
            version = self._sets.get(name, (0, []))[0] + 1
            self._sets[name] = (version, list(servers))
            self._cond.notify_all()
            return version

    def get(self, name: str) -> Tuple[int, List[str]]:
        with self._cond:
            return self._sets.get(name, (0, []))

    def wait_past(self, name: str, index: int, wait_s: float) -> Tuple[int, List[str]]:
        """Block until version > index (or timeout); the consul blocking
        query. Runs on the serving fiber — only its connection waits."""
        deadline = time.monotonic() + min(max(0.0, wait_s), MAX_WAIT_S)
        with self._cond:
            while True:
                version, servers = self._sets.get(name, (0, []))
                if version > index:
                    return version, list(servers)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return version, list(servers)
                self._cond.wait(remaining)


def install_watch_endpoint(server, registry: WatchRegistry) -> None:
    """Serve the blocking-query endpoint on a framework Server."""

    def handler(frame):
        name = frame.path[len(WATCH_PATH_PREFIX):]
        if not name:
            return 404, "text/plain", b"missing watch name\n"
        try:
            index = int(frame.query.get("index", "0"))
            wait_s = float(frame.query.get("wait", "30"))
        except ValueError:
            return 400, "text/plain", b"bad index/wait\n"
        version, servers = registry.wait_past(name, index, wait_s)
        body = json.dumps({"index": version, "servers": servers}).encode()
        return 200, "application/json", body

    server.add_http_handler(WATCH_PATH_PREFIX, handler)


class WatchNamingService(NamingService):
    """watch://host:port/name — push-model watcher (no poll interval; the
    NamingServiceThread runs ``watch_loop`` on a dedicated fiber)."""

    watch = True

    def __init__(self, service_name: str):
        super().__init__(service_name)
        authority, _, name = service_name.partition("/")
        host, _, port = authority.partition(":")
        if not host or not port or not name:
            raise ValueError(f"watch url needs host:port/name, got {service_name!r}")
        self.host = host
        self.port = int(port)
        self.name = name
        self.wait_s = 30.0
        self.backoff_s = 0.5

    def get_servers(self) -> Optional[List[EndPoint]]:
        """One non-blocking fetch (index=0 returns immediately) — used for
        the initial list before the watch loop takes over."""
        try:
            _, servers = self._fetch(index=0, wait_s=0.0, timeout=5.0)
        except OSError:
            return None
        return servers

    def _fetch(self, index: int, wait_s: float, timeout: float):
        from incubator_brpc_tpu_torch.protocol.http import http_call

        status, _, body = http_call(
            self.host,
            self.port,
            f"{WATCH_PATH_PREFIX}{self.name}?index={index}&wait={wait_s:g}",
            timeout=timeout,
        )
        if status != 200:
            raise OSError(f"watch endpoint returned {status}")
        obj = json.loads(body)
        servers = [_parse_node(s) for s in obj.get("servers", [])]
        return int(obj.get("index", 0)), servers

    def watch_loop(self, push, stopped) -> None:
        """Blocking-query loop (RunNamingService, naming_service.h:49-74):
        ``push(list)`` on every change; ``stopped()`` polls the thread's
        shutdown flag between queries."""
        index = 0
        while not stopped():
            try:
                new_index, servers = self._fetch(
                    index, self.wait_s, timeout=self.wait_s + 10.0
                )
            except (OSError, ValueError) as e:
                if stopped():
                    return
                logger.debug("watch %s: %s; backing off", self.name, e)
                time.sleep(self.backoff_s)
                continue
            if new_index != index:
                index = new_index
                push(servers)
            # unchanged (wait expired): immediately re-arm at the same index


register_naming_service("watch", WatchNamingService)
