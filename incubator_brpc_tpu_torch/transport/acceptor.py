"""Acceptor — server-side connection intake (reference
src/brpc/acceptor.cpp:52-115,173-240): a oneshot IN handler on the listen
fd runs an accept-until-EAGAIN loop in a fiber, creating a Socket per
connection; stop() closes the listener and fails every accepted socket.

The port's copy of the JAX package's ``transport/acceptor.py``: TCP and
``unix://<path>`` listeners (a stale socket file is unlinked, a live
listener's path refused, the path unlinked at stop), server-side TLS
(``ssl_context``: each accepted socket pumps its handshake from the
reactor), and the lame-duck ``pause``. An accepted socket is registered,
or failed, under the lock ``stop`` takes, so a connection accepted while
the acceptor stops is closed with the rest (ROADMAP C14: the JAX package's
copy can register it after ``stop``'s snapshot, leaving a live connection
to a stopped server).
"""

from __future__ import annotations

import logging
import os
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


def _unlink_if_stale(path: str) -> None:
    """Unlink a unix socket file only if it is DEAD: hijacking a live
    listener would silently black-hole its traffic (a TCP bind gets this
    from EADDRINUSE). A connect timeout is ambiguous (a live listener with
    a full backlog) and refuses like a connect that succeeds; only a clean
    refusal proves the file stale."""
    probe = _pysocket.socket(_pysocket.AF_UNIX, _pysocket.SOCK_STREAM)
    try:
        probe.settimeout(0.2)
        probe.connect(path)
    except (ConnectionRefusedError, FileNotFoundError):
        try:
            os.unlink(path)
        except OSError:
            pass
        return
    finally:
        probe.close()
    raise OSError(f"unix socket {path} has a live listener")


class Acceptor:
    def __init__(
        self,
        endpoint: EndPoint,
        *,
        messenger=None,
        conn_context: Optional[dict] = None,
        backlog: int = 128,
        inline_read: bool = False,
        ssl_context=None,
    ):
        self._messenger = messenger
        self._inline_read = inline_read
        # server-side TLS: every accepted socket wraps with this context
        self._ssl_context = ssl_context
        # seeded into every accepted Socket BEFORE it goes live (a request
        # can arrive in the same burst as the accept)
        self._conn_context = conn_context
        self._connections: Dict[int, Socket] = {}
        self._conn_lock = threading.Lock()
        self._accepting = False
        self._stopped = False
        self._paused = False  # lame-duck: listener closed, conns live

        # a unix endpoint carries "unix://<path>" in ip, with port 0
        self._unix_path: Optional[str] = None
        if endpoint.ip.startswith("unix://"):
            self._unix_path = endpoint.ip[len("unix://"):]
            if os.path.exists(self._unix_path):
                _unlink_if_stale(self._unix_path)
            lsock = _pysocket.socket(_pysocket.AF_UNIX, _pysocket.SOCK_STREAM)
            addr = self._unix_path
        else:
            lsock = _pysocket.socket(_pysocket.AF_INET, _pysocket.SOCK_STREAM)
            lsock.setsockopt(_pysocket.SOL_SOCKET, _pysocket.SO_REUSEADDR, 1)
            addr = (endpoint.ip, endpoint.port)
        try:
            lsock.bind(addr)
        except OSError:
            lsock.close()  # a failed bind must not leak the listen fd
            raise
        self.endpoint = (endpoint if self._unix_path is not None
                         else EndPoint(ip=endpoint.ip, port=lsock.getsockname()[1]))
        lsock.listen(backlog)
        lsock.setblocking(False)
        self._lsock = lsock
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
                    ssl_context=self._ssl_context,
                    ssl_server_side=self._ssl_context is not None,
                )
                with self._conn_lock:
                    live = not self._stopped
                    if live:
                        self._connections[sock.id] = sock
                if not live:
                    # stop() ran while this one was being accepted and did
                    # not see it: fail it as stop() failed the others
                    sock.set_failed(ErrorCode.ECLOSE, "acceptor stopped")
                    return
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
        if self._unix_path is not None:
            # unlink BEFORE close: while we still own the listener, a
            # successor's liveness probe connects (live → refuses to bind),
            # so we can never delete a successor's fresh socket file
            try:
                os.unlink(self._unix_path)
            except OSError:
                pass
        try:
            self._lsock.close()
        except OSError:
            pass

    def stop(self) -> None:
        with self._conn_lock:
            was_paused = self._paused
            self._stopped = True
        if not was_paused:  # pause already tore the listener down
            self._close_listener()
        for sock in self.connections():
            sock.set_failed(ErrorCode.ECLOSE, "acceptor stopped")
