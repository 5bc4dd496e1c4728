"""Acceptor — server-side connection intake (reference
src/brpc/acceptor.cpp:52-115,173-240): a oneshot IN handler on the listen
fd runs an accept-until-EAGAIN loop in a fiber, creating a Socket per
connection; stop() closes the listener and fails every accepted socket.

The port's copy of the JAX package's ``transport/acceptor.py`` on TCP
listeners, with the lame-duck ``pause``; TLS and unix-domain sockets wait
for ROADMAP A10.
"""

from __future__ import annotations

import logging
import socket as _pysocket
import threading
from typing import Dict, Optional

from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool
from incubator_brpc_tpu_torch.transport.event_dispatcher import (
    EVENT_IN,
    global_dispatcher,
)
from incubator_brpc_tpu_torch.transport.sock import Socket
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint
from incubator_brpc_tpu_torch.utils.status import ErrorCode

logger = logging.getLogger(__name__)


class Acceptor:
    def __init__(
        self,
        endpoint: EndPoint,
        *,
        messenger=None,
        conn_context: Optional[dict] = None,
        backlog: int = 128,
        inline_read: bool = False,
    ):
        self._messenger = messenger
        self._inline_read = inline_read
        # seeded into every accepted Socket BEFORE it goes live (a request
        # can arrive in the same burst as the accept)
        self._conn_context = conn_context
        self._connections: Dict[int, Socket] = {}
        self._conn_lock = threading.Lock()
        self._accepting = False
        self._stopped = False
        self._paused = False  # lame-duck: listener closed, conns live

        lsock = _pysocket.socket(_pysocket.AF_INET, _pysocket.SOCK_STREAM)
        lsock.setsockopt(_pysocket.SOL_SOCKET, _pysocket.SO_REUSEADDR, 1)
        try:
            lsock.bind((endpoint.ip, endpoint.port))
        except OSError:
            lsock.close()  # a failed bind must not leak the listen fd
            raise
        lsock.listen(backlog)
        lsock.setblocking(False)
        self._lsock = lsock
        self.endpoint = EndPoint(ip=endpoint.ip, port=lsock.getsockname()[1])
        self._dispatcher = global_dispatcher(lsock.fileno())
        self._pool = global_worker_pool()
        self._dispatcher.add_consumer(lsock.fileno(), self._on_event, EVENT_IN)

    @property
    def port(self) -> int:
        return self.endpoint.port

    def connection_count(self) -> int:
        with self._conn_lock:
            return len(self._connections)

    def connections(self):
        with self._conn_lock:
            return list(self._connections.values())

    # -- intake -------------------------------------------------------------

    def _on_event(self, revents: int) -> None:
        with self._conn_lock:
            if self._accepting or self._stopped:
                return
            self._accepting = True
        self._pool.spawn(self._accept_loop)

    def _accept_loop(self) -> None:
        try:
            while not self._stopped:
                try:
                    conn, peer = self._lsock.accept()
                except BlockingIOError:
                    break
                except OSError:
                    return  # listener closed
                sock = Socket.from_accepted(
                    conn,
                    peer,
                    messenger=self._messenger,
                    context=self._conn_context,
                    inline_read=self._inline_read,
                )
                with self._conn_lock:
                    self._connections[sock.id] = sock
                sock.on_failed.append(self._forget)
        finally:
            with self._conn_lock:
                self._accepting = False
            if not self._stopped and not self._paused:
                self._dispatcher.rearm(self._lsock.fileno(), EVENT_IN)

    def _forget(self, sock: Socket) -> None:
        with self._conn_lock:
            self._connections.pop(sock.id, None)

    # -- teardown -----------------------------------------------------------

    def pause(self) -> None:
        """Lame-duck: close the listener (new connects are refused by the
        kernel, so an LB redials elsewhere) while every accepted
        connection keeps being served. Irreversible; ``stop`` still
        performs the full teardown."""
        with self._conn_lock:
            if self._stopped or self._paused:
                return
            self._paused = True
        self._close_listener()

    def _close_listener(self) -> None:
        self._dispatcher.remove_consumer(self._lsock.fileno())
        try:
            self._lsock.close()
        except OSError:
            pass

    def stop(self) -> None:
        was_paused = self._paused
        self._stopped = True
        if not was_paused:  # pause already tore the listener down
            self._close_listener()
        for sock in self.connections():
            sock.set_failed(ErrorCode.ECLOSE, "acceptor stopped")
