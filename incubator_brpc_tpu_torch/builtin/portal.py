"""Server registry for the builtin observability portal (reference
Server::AddBuiltinServices, server.cpp:433 — every started server is wired
into the builtin HTTP surface automatically).

The HTTP portal's pages live in builtin/pages.py; this module holds the
process-wide set of running servers they introspect. The port's copy of
the JAX package's ``builtin/portal.py``.
"""

from __future__ import annotations

import threading
from typing import List

_lock = threading.Lock()
_servers: List[object] = []


def register_server(server) -> None:
    with _lock:
        if server not in _servers:
            _servers.append(server)


def unregister_server(server) -> None:
    with _lock:
        if server in _servers:
            _servers.remove(server)


def running_servers() -> List[object]:
    with _lock:
        return list(_servers)
