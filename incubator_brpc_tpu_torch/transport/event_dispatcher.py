"""EventDispatcher — the epoll reactor (reference
src/brpc/event_dispatcher.cpp:275-343).

N dispatcher threads (flag ``event_dispatcher_num``) each own one epoll fd;
sockets are hashed onto dispatchers by fd (event_dispatcher.cpp:366-373).
Events are armed EPOLLONESHOT: when IN fires the dispatcher hands off to
the socket's handler (which schedules a fiber — the StartInputEvent
dedupe+bthread pattern, socket.cpp:2113-2158) and the fd stays disarmed
until the handler drains to EAGAIN and calls ``rearm``. That keeps the
reactor thread from spinning on a readable fd while a fiber is mid-read,
which is the same property the reference gets from edge-triggering.

Registration/modification from arbitrary threads goes through a command
queue drained by the dispatcher thread, kicked by a self-pipe.

The port's copy of the JAX package's dispatcher; its threads are named
``tbtorch-dispatcher-N`` and ``shutdown_global_dispatchers`` joins them.
"""

from __future__ import annotations

import logging
import os
import select
import threading
from typing import Callable, Dict, List, Tuple

from incubator_brpc_tpu_torch.utils.flags import get_flag

logger = logging.getLogger(__name__)

EVENT_IN = select.EPOLLIN
EVENT_OUT = select.EPOLLOUT
EVENT_ERR = select.EPOLLERR | select.EPOLLHUP

_tls = threading.local()


def on_reactor_thread() -> bool:
    """True on an EventDispatcher loop thread. Work that may block for a
    long bound (connects, lock waits) checks this and defers to the worker
    pool instead of stalling a reactor's other sockets."""
    return getattr(_tls, "is_reactor", False)


class EventDispatcher:
    """One epoll loop thread. Handlers run inline and must be cheap
    (schedule a fiber / wake a butex and return)."""

    def __init__(self, name: str = "dispatcher"):
        self._epoll = select.epoll()
        self._handlers: Dict[int, Callable[[int], None]] = {}
        self._registered: Dict[int, int] = {}  # fd -> armed event mask
        self._lock = threading.Lock()
        self._cmds: List[Tuple] = []
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        self._stopped = False
        self._thread = threading.Thread(
            target=self._run, name=f"tbtorch-{name}", daemon=True
        )
        self._thread.start()

    # -- public API (any thread) -------------------------------------------

    def add_consumer(
        self, fd: int, handler: Callable[[int], None], events: int = EVENT_IN
    ) -> None:
        """Register ``handler(revents)`` for oneshot ``events`` on fd."""
        self._post(("add", fd, handler, events))

    def rearm(self, fd: int, events: int = EVENT_IN) -> None:
        """Re-enable oneshot events after the handler drained the fd."""
        self._post(("arm", fd, None, events))

    def remove_consumer(self, fd: int) -> None:
        self._post(("del", fd, None, 0))

    def stop_and_join(self) -> None:
        self._stopped = True
        self._kick()
        self._thread.join(timeout=5)
        try:
            self._epoll.close()
            os.close(self._wake_r)
            os.close(self._wake_w)
        except OSError:
            pass

    # -- internals ----------------------------------------------------------

    def _post(self, cmd: Tuple) -> None:
        with self._lock:
            self._cmds.append(cmd)
        self._kick()

    def _kick(self) -> None:
        try:
            os.write(self._wake_w, b"x")
        except OSError:
            pass

    def _apply_cmds(self) -> None:
        with self._lock:
            cmds, self._cmds = self._cmds, []
        for op, fd, handler, events in cmds:
            try:
                if op == "add":
                    self._handlers[fd] = handler
                    mask = events | EVENT_ERR | select.EPOLLONESHOT
                    if fd in self._registered:
                        self._epoll.modify(fd, mask)
                    else:
                        self._epoll.register(fd, mask)
                    self._registered[fd] = events
                elif op == "arm":
                    if fd in self._handlers:
                        self._epoll.modify(
                            fd, events | EVENT_ERR | select.EPOLLONESHOT
                        )
                        self._registered[fd] = events
                elif op == "del":
                    self._handlers.pop(fd, None)
                    if self._registered.pop(fd, None) is not None:
                        try:
                            self._epoll.unregister(fd)
                        except OSError:
                            pass
            except OSError as e:
                logger.debug("dispatcher cmd %s fd=%d failed: %s", op, fd, e)

    def _run(self) -> None:
        _tls.is_reactor = True
        wake_fd = self._wake_r
        self._epoll.register(wake_fd, select.EPOLLIN)
        while not self._stopped:
            self._apply_cmds()
            try:
                events = self._epoll.poll(1.0)
            except (OSError, ValueError):
                break
            for fd, revents in events:
                if fd == wake_fd:
                    try:
                        while os.read(wake_fd, 4096):
                            pass
                    except OSError:
                        pass
                    continue
                handler = self._handlers.get(fd)
                if handler is None:
                    continue
                try:
                    handler(revents)
                except Exception:  # noqa: BLE001 — a handler bug must not kill the reactor
                    logger.exception("event handler failed for fd %d", fd)


_dispatchers: List[EventDispatcher] = []
_dispatchers_lock = threading.Lock()


def global_dispatcher(fd: int = 0) -> EventDispatcher:
    """Dispatcher for this fd — hashed like the reference
    (event_dispatcher.cpp:366-373)."""
    global _dispatchers
    if not _dispatchers:
        with _dispatchers_lock:
            if not _dispatchers:
                n = max(1, int(get_flag("event_dispatcher_num")))
                _dispatchers = [
                    EventDispatcher(name=f"dispatcher-{i}") for i in range(n)
                ]
    return _dispatchers[fd % len(_dispatchers)]


def shutdown_global_dispatchers() -> None:
    """Stop and join the process-global dispatchers; the next
    ``global_dispatcher()`` starts new ones. Sockets keep the dispatcher
    they registered with, so fail them first."""
    global _dispatchers
    with _dispatchers_lock:
        ds, _dispatchers = _dispatchers, []
    for d in ds:
        d.stop_and_join()
