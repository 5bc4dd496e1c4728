"""naming — server-list discovery (reference src/brpc/naming_service.h:49-74,
policy/*_naming_service.cpp, details/naming_service_thread.{h,cpp}).

Push model kept from the reference: a NamingService runs in its own watcher
(here a TimerThread-driven poll instead of a dedicated pthread) and pushes
full server lists into NamingServiceActions; the NamingServiceThread diffs
consecutive lists into add/remove calls on its observers (load balancers).

Supported urls:
- ``list://host:port,host:port``  inline list (policy/list_naming_service)
- ``file://path``                 watched file, one host:port per line
                                  (policy/file_naming_service)
- ``dns://host:port``             every A record (policy/domain_naming_service;
                                  also registered as ``http://``)
- ``remotefile://host:port/path`` a list fetched over HTTP, polled like file://
                                  (policy/remotefile_naming_service)
- ``watch://host:port/name``      a consul-style long poll over HTTP, pushed
                                  as it changes (``naming/watch.py``)

The port's copy of the JAX package's ``naming/__init__.py``, whole.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

from incubator_brpc_tpu_torch.runtime.timer_thread import global_timer_thread
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint, str2endpoint
from incubator_brpc_tpu_torch.utils.flags import get_flag

logger = logging.getLogger(__name__)


class NamingService:
    """Base: subclasses produce full server lists. ``poll_interval_s`` of
    None means one-shot (list://); otherwise PeriodicNamingService.
    ``offload_refresh`` = True moves ``get_servers`` off the TimerThread
    onto a worker fiber (required for anything that does network I/O —
    a blocked TimerThread stalls every timer in the process)."""

    poll_interval_s: Optional[float] = None
    offload_refresh: bool = False

    def __init__(self, service_name: str):
        self.service_name = service_name

    def get_servers(self) -> Optional[List[EndPoint]]:
        """Return the current full list, or None if unchanged/unavailable."""
        raise NotImplementedError


def _parse_node(s: str) -> EndPoint:
    """'host:port[ tag]' → EndPoint; the optional whitespace-separated tag
    (reference ServerNode.tag — PartitionChannel reads "N/M" out of it)."""
    import dataclasses

    parts = s.split(None, 1)
    ep = str2endpoint(parts[0])
    if len(parts) > 1 and parts[1].strip():
        ep = dataclasses.replace(ep, tag=parts[1].strip())
    return ep


class ListNamingService(NamingService):
    """list://h1:p1[ tag],h2:p2[ tag] — inline, never changes."""

    def __init__(self, service_name: str):
        super().__init__(service_name)
        self._servers = [
            _parse_node(part.strip())
            for part in service_name.split(",")
            if part.strip()
        ]

    def get_servers(self) -> Optional[List[EndPoint]]:
        return list(self._servers)


class FileNamingService(NamingService):
    """file://path — re-read on mtime change (the reference watches with
    a periodic stat as well)."""

    def __init__(self, service_name: str):
        super().__init__(service_name)
        self.path = service_name
        self.poll_interval_s = float(get_flag("ns_refresh_interval_s"))
        self._last_raw: Optional[bytes] = None

    def get_servers(self) -> Optional[List[EndPoint]]:
        """None on unchanged content OR any transient error — a failed read
        must keep the previous server list, never wipe it (the reference
        keeps serving the last good list across NS hiccups). Change is
        detected on the BYTES, not st_mtime: several filesystems (and this
        container's) keep second-granularity mtimes, so a same-size rewrite
        within one tick is invisible to stat — and a server list is small
        enough that re-reading it every poll costs nothing."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except OSError:
            return None
        if raw == self._last_raw:
            return None
        servers: List[EndPoint] = []
        try:
            for line in raw.decode().splitlines():
                line = line.split("#", 1)[0].strip()
                if line:
                    servers.append(_parse_node(line))
        except (ValueError, UnicodeDecodeError):
            return None  # content NOT recorded: retried next tick
        self._last_raw = raw
        return servers


class DnsNamingService(NamingService):
    """dns://host:port — every A record becomes a server, re-resolved each
    refresh tick (the reference's http:// DomainNamingService,
    policy/domain_naming_service.cpp). Also registered as http://."""

    offload_refresh = True  # getaddrinfo can block for seconds

    def __init__(self, service_name: str):
        import socket as _pysocket

        super().__init__(service_name)
        self.poll_interval_s = float(get_flag("ns_refresh_interval_s"))
        # strip any URL path: "host:port/svc" and "host/svc" are valid
        # channel targets (the reference's DomainNamingService does the same)
        authority = service_name.split("/", 1)[0]
        host, _, port = authority.partition(":")
        self._host = host
        self._port = int(port) if port else 80
        self._pysocket = _pysocket

    def get_servers(self) -> Optional[List[EndPoint]]:
        try:
            infos = self._pysocket.getaddrinfo(
                self._host, self._port, proto=self._pysocket.IPPROTO_TCP
            )
        except OSError:
            return None  # keep the previous list across DNS hiccups
        seen = []
        for _, _, _, _, sockaddr in infos:
            ep = EndPoint(ip=sockaddr[0], port=self._port)
            if ep not in seen:
                seen.append(ep)
        return seen


class RemoteFileNamingService(NamingService):
    """remotefile://host:port/path — a server list fetched over HTTP, one
    'host:port [tag]' per line (reference policy/remotefile_naming_service;
    same poll cadence as file://, same keep-last-good-list error posture)."""

    offload_refresh = True  # network fetch must not run on the TimerThread

    def __init__(self, service_name: str):
        super().__init__(service_name)
        self.poll_interval_s = float(get_flag("ns_refresh_interval_s"))
        authority, slash, path = service_name.partition("/")
        host, _, port = authority.partition(":")
        if not host:
            raise ValueError(f"remotefile url needs host[:port]/path, got {service_name!r}")
        self._host = host
        self._port = int(port) if port else 80
        self._path = (slash + path) if slash else "/"
        self._last_body: Optional[bytes] = None

    def get_servers(self) -> Optional[List[EndPoint]]:
        from incubator_brpc_tpu_torch.protocol.http import http_call

        try:
            status, _, body = http_call(self._host, self._port, self._path, timeout=5.0)
        except OSError:
            return None  # keep the previous list across fetch hiccups
        if status != 200:
            return None
        if body == self._last_body:
            return None  # unchanged: no diff churn
        servers: List[EndPoint] = []
        try:
            for line in body.decode(errors="replace").splitlines():
                line = line.split("#", 1)[0].strip()
                if line:
                    servers.append(_parse_node(line))
        except ValueError:
            return None
        self._last_body = body
        return servers


_factories: Dict[str, Callable[[str], NamingService]] = {}


def register_naming_service(
    scheme: str, factory: Callable[[str], NamingService]
) -> None:
    _factories[scheme] = factory


register_naming_service("list", ListNamingService)
register_naming_service("file", FileNamingService)
register_naming_service("dns", DnsNamingService)
register_naming_service("http", DnsNamingService)
register_naming_service("remotefile", RemoteFileNamingService)


def create_naming_service(url: str) -> NamingService:
    """"scheme://rest" → NamingService (global.cpp:324-330 registry)."""
    scheme, _, rest = url.partition("://")
    try:
        factory = _factories[scheme]
    except KeyError:
        raise ValueError(f"unknown naming scheme {scheme!r}") from None
    return factory(rest)


class NamingServiceThread:
    """Runs one NamingService and diffs its lists into observer callbacks
    (details/naming_service_thread.cpp — shared per url in the reference;
    cheap enough here to be per-LB)."""

    def __init__(self, url: str):
        self.ns = create_naming_service(url)
        self._observers: List[object] = []  # objects with add_server/remove_server
        self._current: List[EndPoint] = []
        self._lock = threading.Lock()
        self._timer_id = None
        self._stopped = False

    def start(self) -> bool:
        self._refresh()
        if getattr(self.ns, "watch", False):
            # push-model service (watch://): a dedicated fiber runs the
            # blocking-query loop (the reference's RunNamingService thread,
            # naming_service.h:49-74) instead of the periodic poll
            from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool

            global_worker_pool().spawn(self.ns.watch_loop, self._apply, lambda: self._stopped)
            return True
        if self.ns.poll_interval_s:
            self._schedule()
        return True

    def stop(self) -> None:
        self._stopped = True
        if self._timer_id is not None:
            global_timer_thread().unschedule(self._timer_id)
            self._timer_id = None

    def add_observer(self, obs) -> None:
        with self._lock:
            self._observers.append(obs)
            current = list(self._current)
        for ep in current:
            obs.add_server(ep)

    def remove_observer(self, obs) -> None:
        """Detach an observer. A shared NamingServiceThread outlives the
        LBs watching it (PartitionChannel feeds N filtered views off one
        watcher) — a stopped LB must unhook itself or it keeps receiving
        add/remove callbacks and is pinned for the watcher's lifetime."""
        with self._lock:
            try:
                self._observers.remove(obs)
            except ValueError:
                pass

    def servers(self) -> List[EndPoint]:
        with self._lock:
            return list(self._current)

    def _schedule(self) -> None:
        if self._stopped:
            return
        self._timer_id = global_timer_thread().schedule(
            self._tick, delay=self.ns.poll_interval_s
        )

    def _tick(self) -> None:
        # timer callbacks must be cheap; a file stat+read runs inline, a
        # remote fetch (DNS) hands off to the worker pool and reschedules
        # only after it finishes (so a slow resolver can't pile up fibers)
        if self.ns.offload_refresh:
            from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool

            global_worker_pool().spawn(self._refresh_and_reschedule)
            return
        self._refresh_and_reschedule()

    def _refresh_and_reschedule(self) -> None:
        try:
            self._refresh()
        except Exception:
            logger.exception("naming refresh failed for %s", self.ns.service_name)
        self._schedule()

    def _refresh(self) -> None:
        fresh = self.ns.get_servers()
        if fresh is None:
            return
        self._apply(fresh)

    def _apply(self, fresh: List[EndPoint]) -> None:
        with self._lock:
            # diff on (endpoint, tag): EndPoint identity ignores the tag, but
            # a server whose tag changed (e.g. moved partitions) must be seen
            # as remove+add by observers (reference ServerNode compares tags).
            # Dedup keeps the tag too: one address may publish several tags.
            old = {(ep, ep.tag) for ep in self._current}
            new = {(ep, ep.tag) for ep in fresh}
            added = [ep for ep in fresh if (ep, ep.tag) not in old]
            removed = [ep for ep in self._current if (ep, ep.tag) not in new]
            self._current = list(
                {(ep, ep.tag): ep for ep in fresh}.values()
            )
            observers = list(self._observers)
        for obs in observers:
            # removes BEFORE adds: on a tag-only change the two lists hold
            # eq-equal EndPoints, and a tag-blind LB doing add-first would
            # no-op the add then delete the server on the remove
            for ep in removed:
                obs.remove_server(ep)
            for ep in added:
                obs.add_server(ep)
        if added or removed:
            logger.info(
                "naming %s: +%d -%d → %d servers",
                self.ns.service_name, len(added), len(removed), len(self._current),
            )


# watch:// (consul-style long poll) registers itself on import; imported
# last so its `from incubator_brpc_tpu_torch.naming import ...` resolves
from incubator_brpc_tpu_torch.naming import watch as _watch  # noqa: E402,F401

__all__ = [
    "NamingService",
    "ListNamingService",
    "FileNamingService",
    "DnsNamingService",
    "NamingServiceThread",
    "create_naming_service",
    "register_naming_service",
]
