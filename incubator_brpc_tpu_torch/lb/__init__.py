"""lb — load balancers (reference src/brpc/load_balancer.h:33-106 +
policy/*_load_balancer.cpp, registered in global.cpp:333-339).

Policies: "rr" round-robin, "random", "wrr" weighted round-robin,
"c_hash" ketama consistent hashing, "la" locality-aware (inverse EWMA
latency with in-flight penalty — policy/locality_aware_load_balancer.cpp).

All policies read server lists from a DoublyBufferedData snapshot so
``select`` never blocks ``add_server``/``remove_server`` (the reference's
wait-free-read property). ``LoadBalancerWithNaming`` glues a naming watcher
to an LB and resolves the chosen EndPoint to a live Socket.

The port's copy of the JAX package's ``lb/__init__.py``. Its map from
socket ids to endpoints holds host sockets and device-link sockets
(``register_socket``) alike: both take their ids from the one registry of
``transport/sock.py``, so an id names one live socket of either kind. An
LB built without a socket map resolves through the client map every
Channel shares (``rpc.client_socket_map()``), which
``rpc.shutdown_host_plane()`` closes.
"""

from __future__ import annotations

import bisect
import hashlib
import logging
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Set

from incubator_brpc_tpu_torch.utils.doubly_buffered import DoublyBufferedData
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint
from incubator_brpc_tpu_torch.utils.status import ErrorCode

logger = logging.getLogger(__name__)


class LoadBalancer:
    """Base (load_balancer.h:33-106). Servers are EndPoints; ``select``
    must skip ``excluded`` (the ExcludedServers retry-avoidance set)."""

    name = "base"

    def add_server(self, ep: EndPoint, weight: int = 1) -> bool:
        raise NotImplementedError

    def remove_server(self, ep: EndPoint) -> bool:
        raise NotImplementedError

    def select(
        self,
        excluded: Optional[Set[EndPoint]] = None,
        request_code: Optional[int] = None,
    ) -> Optional[EndPoint]:
        raise NotImplementedError

    def feedback(self, ep: EndPoint, latency_us: float, error_code: int) -> None:
        """Called after each RPC completes (Controller Call::OnComplete →
        LoadBalancer::Feedback). Default: ignore."""

    def settle(self, ep: EndPoint) -> None:
        """Release a selection that never became an RPC (e.g. a fused
        collective dispatch probed the pick then went another way) WITHOUT
        recording a latency sample. Default: ignore; la undoes its
        in-flight charge."""

    def servers(self) -> List[EndPoint]:
        raise NotImplementedError


class _SnapshotLB(LoadBalancer):
    """Shared list-snapshot plumbing over DoublyBufferedData."""

    def __init__(self) -> None:
        self._dbd: DoublyBufferedData[list] = DoublyBufferedData(list)

    def add_server(self, ep: EndPoint, weight: int = 1) -> bool:
        added = []

        def _add(lst: list) -> None:
            if ep not in lst:
                lst.append(ep)
                added.append(True)

        self._dbd.modify(_add)
        return bool(added)

    def remove_server(self, ep: EndPoint) -> bool:
        removed = []

        def _rm(lst: list) -> None:
            if ep in lst:
                lst.remove(ep)
                removed.append(True)

        self._dbd.modify(_rm)
        return bool(removed)

    def servers(self) -> List[EndPoint]:
        with self._dbd.read() as lst:
            return list(lst)


class RoundRobinLB(_SnapshotLB):
    name = "rr"

    def __init__(self) -> None:
        super().__init__()
        self._cursor = 0
        self._cursor_lock = threading.Lock()

    def select(self, excluded=None, request_code=None) -> Optional[EndPoint]:
        with self._dbd.read() as lst:
            n = len(lst)
            if n == 0:
                return None
            with self._cursor_lock:
                start = self._cursor
                self._cursor = (self._cursor + 1) % n
            for i in range(n):
                ep = lst[(start + i) % n]
                if not excluded or ep not in excluded:
                    return ep
            # All excluded: FAIL the selection and let retry arbitration
            # decide (reference ExcludedServers, controller.cpp:578-615) —
            # silently re-picking a just-failed server defeats retry
            # avoidance on small clusters.
            return None


class RandomLB(_SnapshotLB):
    name = "random"

    def select(self, excluded=None, request_code=None) -> Optional[EndPoint]:
        with self._dbd.read() as lst:
            if not lst:
                return None
            cand = [ep for ep in lst if not excluded or ep not in excluded]
            # all excluded -> fail selection (ExcludedServers semantics)
            return random.choice(cand) if cand else None


class WeightedRoundRobinLB(LoadBalancer):
    """wrr — smooth weighted round robin (policy/weighted_round_robin_\
load_balancer.cpp; smooth-WRR gives the same proportional schedule)."""

    name = "wrr"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._weights: Dict[EndPoint, int] = {}
        self._current: Dict[EndPoint, int] = {}

    def add_server(self, ep: EndPoint, weight: int = 1) -> bool:
        with self._lock:
            if ep in self._weights:
                return False
            self._weights[ep] = max(1, weight)
            self._current[ep] = 0
            return True

    def remove_server(self, ep: EndPoint) -> bool:
        with self._lock:
            if ep not in self._weights:
                return False
            del self._weights[ep]
            del self._current[ep]
            return True

    def select(self, excluded=None, request_code=None) -> Optional[EndPoint]:
        with self._lock:
            # all excluded -> fail the selection (ExcludedServers semantics,
            # consistent across every LB policy)
            cand = {
                ep: w
                for ep, w in self._weights.items()
                if not excluded or ep not in excluded
            }
            if not cand:
                return None
            total = sum(cand.values())
            best = None
            for ep, w in cand.items():
                self._current[ep] += w
                if best is None or self._current[ep] > self._current[best]:
                    best = ep
            self._current[best] -= total
            return best

    def servers(self) -> List[EndPoint]:
        with self._lock:
            return list(self._weights)


class ConsistentHashLB(LoadBalancer):
    """c_hash — ketama ring with virtual nodes
    (policy/consistent_hashing_load_balancer.cpp: 100+ replicas/server,
    md5-derived points; requests route by ``request_code``)."""

    name = "c_hash"
    VIRTUAL_NODES = 100

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ring: List[int] = []
        self._owners: Dict[int, EndPoint] = {}
        self._servers: Set[EndPoint] = set()

    @staticmethod
    def _points(ep: EndPoint, n: int) -> List[int]:
        pts = []
        for i in range(n):
            h = hashlib.md5(f"{ep.ip}:{ep.port}-{i}".encode()).digest()
            pts.append(int.from_bytes(h[:8], "little"))
        return pts

    def add_server(self, ep: EndPoint, weight: int = 1) -> bool:
        with self._lock:
            if ep in self._servers:
                return False
            self._servers.add(ep)
            for p in self._points(ep, self.VIRTUAL_NODES * max(1, weight)):
                if p not in self._owners:
                    bisect.insort(self._ring, p)
                    self._owners[p] = ep
            return True

    def remove_server(self, ep: EndPoint) -> bool:
        with self._lock:
            if ep not in self._servers:
                return False
            self._servers.discard(ep)
            dead = [p for p, o in self._owners.items() if o == ep]
            for p in dead:
                del self._owners[p]
                idx = bisect.bisect_left(self._ring, p)
                if idx < len(self._ring) and self._ring[idx] == p:
                    self._ring.pop(idx)
            return True

    def select(self, excluded=None, request_code=None) -> Optional[EndPoint]:
        if request_code is None:
            request_code = random.getrandbits(64)
        key = int.from_bytes(
            hashlib.md5(request_code.to_bytes(8, "little", signed=False)).digest()[:8],
            "little",
        )
        with self._lock:
            if not self._ring:
                return None
            idx = bisect.bisect(self._ring, key) % len(self._ring)
            for i in range(len(self._ring)):
                ep = self._owners[self._ring[(idx + i) % len(self._ring)]]
                if not excluded or ep not in excluded:
                    return ep
            return None  # every ring owner excluded: fail the selection

    def servers(self) -> List[EndPoint]:
        with self._lock:
            return list(self._servers)


class _LAStat:
    __slots__ = ("ewma_latency_us", "inflight", "lock")

    def __init__(self) -> None:
        self.ewma_latency_us = 0.0  # 0 = no sample yet (optimistic)
        self.inflight = 0
        self.lock = threading.Lock()


class LocalityAwareLB(_SnapshotLB):
    """la — weight servers by inverse EWMA latency with an in-flight
    penalty; errors are punished as a large latency sample
    (policy/locality_aware_load_balancer.{h,cpp}: weight = base/latency,
    in-flight extrapolation, punish_inflight on timeouts)."""

    name = "la"
    DECAY = 0.8  # EWMA keep factor per sample
    PUNISH_FACTOR = 10.0  # error = 10× current average latency sample
    DEFAULT_LATENCY_US = 1000.0

    def __init__(self, rng: Optional[random.Random] = None) -> None:
        """``rng`` makes the weighted pick injectable: tests seed it so
        distribution assertions are deterministic instead of riding the
        process-global random stream (the round-3 flake)."""
        super().__init__()
        self._stats: Dict[EndPoint, _LAStat] = {}
        self._stats_lock = threading.Lock()
        self._rng = rng if rng is not None else random.Random()

    def _stat(self, ep: EndPoint) -> _LAStat:
        with self._stats_lock:
            st = self._stats.get(ep)
            if st is None:
                st = self._stats[ep] = _LAStat()
            return st

    def _weight(self, ep: EndPoint) -> float:
        st = self._stat(ep)
        with st.lock:
            lat = st.ewma_latency_us or self.DEFAULT_LATENCY_US
            return 1e6 / (lat * (1.0 + st.inflight))

    def select(self, excluded=None, request_code=None) -> Optional[EndPoint]:
        with self._dbd.read() as lst:
            # all excluded -> None (ExcludedServers), like every other policy
            cand = [ep for ep in lst if not excluded or ep not in excluded]
        if not cand:
            return None
        weights = [self._weight(ep) for ep in cand]
        total = sum(weights)
        r = self._rng.random() * total
        chosen = cand[-1]
        for ep, w in zip(cand, weights):
            r -= w
            if r <= 0:
                chosen = ep
                break
        st = self._stat(chosen)
        with st.lock:
            st.inflight += 1
        return chosen

    def feedback(self, ep: EndPoint, latency_us: float, error_code: int) -> None:
        st = self._stat(ep)
        with st.lock:
            if st.inflight > 0:
                st.inflight -= 1
            if error_code != 0:
                latency_us = max(
                    latency_us,
                    (st.ewma_latency_us or self.DEFAULT_LATENCY_US)
                    * self.PUNISH_FACTOR,
                )
            if st.ewma_latency_us == 0.0:
                st.ewma_latency_us = latency_us
            else:
                st.ewma_latency_us = (
                    self.DECAY * st.ewma_latency_us + (1 - self.DECAY) * latency_us
                )

    def settle(self, ep: EndPoint) -> None:
        st = self._stat(ep)
        with st.lock:
            if st.inflight > 0:
                st.inflight -= 1

    def expected_latency_us(self, ep: EndPoint) -> float:
        st = self._stat(ep)
        with st.lock:
            return st.ewma_latency_us


_lb_factories: Dict[str, Callable[[], LoadBalancer]] = {
    "rr": RoundRobinLB,
    "random": RandomLB,
    "wrr": WeightedRoundRobinLB,
    "c_hash": ConsistentHashLB,
    "la": LocalityAwareLB,
}


def register_load_balancer(name: str, factory: Callable[[], LoadBalancer]) -> None:
    _lb_factories[name] = factory


def create_load_balancer(name: str) -> LoadBalancer:
    try:
        return _lb_factories[name]()
    except KeyError:
        raise ValueError(f"unknown load balancer {name!r}") from None


class LoadBalancerWithNaming:
    """Naming-watcher + LB + socket resolution (the reference's
    LoadBalancerWithNaming in details/load_balancer_with_naming.{h,cpp}).

    ``select_server(excluded)`` takes *socket ids* (what the channel's
    ExcludedServers carries) and returns a connected Socket.

    Per-node failure isolation (reference circuit_breaker.cpp feeding
    SetLogOff on the node's Socket): every endpoint carries a
    ``CircuitBreaker`` fed from the channel's end-of-RPC ``feedback``.
    A tripped node leaves the candidate set for its (exponentially
    doubling) isolation duration, then re-enters HALF_OPEN — and an
    isolated node whose underlying socket health-check revives
    (``on_revived``) re-enters early. All nodes isolated ⇒ ``select``
    fails ⇒ the channel surfaces EHOSTDOWN."""

    MAX_PICK_ATTEMPTS = 3

    def __init__(
        self,
        url: str = "",
        lb_name: str = "rr",
        socket_map=None,
        ns_thread=None,
        server_filter=None,
        key_tag: str = "",
        conn_kwargs=None,
        circuit_breaker: Optional[bool] = None,
    ):
        """Either ``url`` (owns a fresh NamingServiceThread) or ``ns_thread``
        (shared, not stopped by us — how PartitionChannel feeds N filtered
        views off one watcher). ``server_filter(ep) -> bool`` limits which
        naming entries reach the LB (the reference's ns_filter seam).
        ``circuit_breaker`` None follows the ``enable_circuit_breaker``
        flag; True/False force per-node isolation on/off."""
        from incubator_brpc_tpu_torch.utils.flags import get_flag

        self.lb = create_load_balancer(lb_name)
        if ns_thread is not None:
            self.ns_thread = ns_thread
            self._owns_ns = False
        else:
            from incubator_brpc_tpu_torch.naming import NamingServiceThread

            self.ns_thread = NamingServiceThread(url)
            self._owns_ns = True
        self._server_filter = server_filter
        self._key_tag = key_tag
        # extra Socket.connect kwargs for every target (TLS contexts)
        self._conn_kwargs = dict(conn_kwargs) if conn_kwargs else {}
        if socket_map is None:
            from incubator_brpc_tpu_torch.rpc.channel import client_socket_map

            socket_map = client_socket_map()
        self._socket_map = socket_map
        self._ep_by_sid: Dict[int, EndPoint] = {}
        self._map_lock = threading.Lock()
        self._cb_enabled = (
            bool(get_flag("enable_circuit_breaker"))
            if circuit_breaker is None
            else bool(circuit_breaker)
        )
        self._cb_tag = f"{url or lb_name}@{id(self):x}"
        self._breakers: Dict[EndPoint, object] = {}
        self._isolated: Dict[EndPoint, float] = {}  # ep -> monotonic deadline
        self._cb_lock = threading.Lock()
        # (sock, callback) pairs appended to long-lived global sockets —
        # removed at stop() so a dead LB is not pinned by its hooks
        self._revival_hooks: list = []
        # ep -> latest armed revival timer id, unscheduled at stop(): a
        # parked timer holds a closure over this LB for the whole
        # isolation window otherwise — a stopped LB would be pinned (and
        # its _maybe_revive fired into torn-down state) per isolated node
        self._revive_timers: Dict[EndPoint, int] = {}
        self._stopped = False

    def start(self) -> bool:
        if self._owns_ns and not self.ns_thread.start():
            return False
        self.ns_thread.add_observer(self)
        return True

    def stop(self) -> None:
        self._stopped = True
        # detach from the naming thread FIRST: a shared watcher (the
        # PartitionChannel shape) keeps running after this LB dies, and a
        # still-registered observer would keep feeding it server churn
        try:
            self.ns_thread.remove_observer(self)
        except AttributeError:
            pass  # duck-typed test doubles without observer tracking
        if self._owns_ns:
            self.ns_thread.stop()
        if self._cb_enabled:
            from incubator_brpc_tpu_torch.runtime.timer_thread import (
                global_timer_thread,
            )

            with self._cb_lock:
                timers, self._revive_timers = dict(self._revive_timers), {}
                self._isolated.clear()
            for tid in timers.values():
                global_timer_thread().unschedule(tid)
        if self._cb_enabled:
            from incubator_brpc_tpu_torch.rpc.circuit_breaker import breaker_registry

            breaker_registry.unregister_owner(self._cb_tag)
            # unpin this LB from the process-global sockets it hooked
            # (sockets outlive channels; a leaked closure per dead LB
            # would accumulate for the process lifetime)
            with self._cb_lock:
                hooks, self._revival_hooks = self._revival_hooks, []
            for sock, cb in hooks:
                try:
                    sock.on_revived.remove(cb)
                    sock.context.pop(f"_cb_revive_{self._cb_tag}", None)
                except (ValueError, AttributeError):
                    pass

    # -- per-node circuit breaking ------------------------------------------

    def _breaker(self, ep: EndPoint):
        from incubator_brpc_tpu_torch.rpc.circuit_breaker import (
            CircuitBreaker,
            breaker_registry,
            ensure_breaker_gauge,
        )

        with self._cb_lock:
            cb = self._breakers.get(ep)
            if cb is None:
                ensure_breaker_gauge()
                cb = self._breakers[ep] = CircuitBreaker()
                breaker_registry.register(
                    self._cb_tag, f"{ep.ip}:{ep.port}", cb
                )
            return cb

    def _isolate(self, ep: EndPoint) -> None:
        """The node's breaker tripped: take it out of the candidate set
        for its isolation duration, then revive HALF_OPEN. Revival is
        both timer-driven (so the gauge/page freshen without traffic) and
        lazily enforced in select_server (so tests need no timer races)."""
        if self._stopped:
            # a trip verdict racing stop(): arming a timer / re-registering
            # the breaker here would undo stop()'s cleanup (and leak the
            # registry row under a dead owner tag for the process lifetime)
            return
        cb = self._breaker(ep)
        duration_s = cb.isolation_duration_ms / 1e3
        now = time.monotonic()
        with self._cb_lock:
            already = ep in self._isolated
            self._isolated[ep] = now + duration_s
        if not already:
            logger.warning(
                "circuit breaker isolated %s:%s for %.0f ms (trip #%d)",
                ep.ip, ep.port, cb.isolation_duration_ms, cb.isolated_times,
            )
        from incubator_brpc_tpu_torch.runtime.timer_thread import global_timer_thread

        # a timer per deadline move: straggler failures extend the window
        # and the previously parked timer bails on the not-yet-due check
        # in _maybe_revive, so the EXTENDED deadline needs its own timer
        # or an idle channel would stay 'isolated' until its next select.
        # The latest id per ep is kept so stop() can cancel it (an older
        # superseded timer no-ops at fire on the deadline check).
        tid = global_timer_thread().schedule(
            lambda: self._maybe_revive(ep), delay=duration_s
        )
        with self._cb_lock:
            old = self._revive_timers.get(ep)
            self._revive_timers[ep] = tid
        if old is not None:
            # the superseded timer would only no-op at fire (deadline
            # moved), but left armed it pins this LB past stop()
            global_timer_thread().unschedule(old)

    def _maybe_revive(self, ep: EndPoint) -> None:
        if self._stopped:
            return  # a straggler timer must not resurrect a dead LB
        now = time.monotonic()
        with self._cb_lock:
            deadline = self._isolated.get(ep)
            if deadline is None:
                return
            if deadline > now + 1e-4:
                # re-isolated while this timer was parked: a fresh timer
                # owns the new deadline (and the _revive_timers entry)
                return
            del self._isolated[ep]
            self._revive_timers.pop(ep, None)
            cb = self._breakers.get(ep)
        if cb is not None:
            cb.reset()  # HALF_OPEN: candidate again, windows cleared
            logger.info("circuit breaker revived %s:%s", ep.ip, ep.port)

    def _revive_now(self, ep: EndPoint) -> None:
        """Early revival — the node's socket health-check proved the peer
        back (Socket.on_revived): no reason to sit out the rest of the
        isolation window."""
        with self._cb_lock:
            if self._isolated.pop(ep, None) is None:
                return
            cb = self._breakers.get(ep)
        if cb is not None:
            cb.reset()

    def _feed_breaker(self, ep: EndPoint, latency_us: float, error_code: int) -> None:
        """One completed attempt's verdict into the node's breaker;
        isolates on the trip TRANSITION only (stragglers completing after
        the trip must not re-extend the deadline)."""
        if self._stopped or not self._cb_enabled or error_code in (
            ErrorCode.ECANCELED,
            ErrorCode.EBACKUPREQUEST,
            # cooperative fabric-failure answers say nothing about the
            # NODE's health: a survivor answering ESESSION is reporting a
            # PEER's death (charging it would trip breakers on every
            # healthy party of an aborted session), and EDEADLINE is the
            # server faithfully shedding the CLIENT's expired budget
            ErrorCode.ESESSION,
            ErrorCode.EDEADLINE,
        ):
            return
        cb = self._breaker(ep)
        was_broken = cb.broken
        if not cb.on_call_end(error_code, latency_us) and not was_broken:
            self._isolate(ep)

    def _isolated_eps(self) -> Set[EndPoint]:
        """Currently isolated endpoints; expired isolations revive lazily
        here (select-time), keeping revival deterministic under test."""
        if not self._cb_enabled:
            return set()
        now = time.monotonic()
        expired = []
        with self._cb_lock:
            live = set()
            for ep, deadline in self._isolated.items():
                if deadline <= now:
                    expired.append(ep)
                else:
                    live.add(ep)
        for ep in expired:
            self._maybe_revive(ep)
        return live

    def isolated_servers(self) -> List[EndPoint]:
        return sorted(self._isolated_eps())

    def breaker_states(self) -> Dict[str, dict]:
        """Per-endpoint breaker state (the /circuit_breakers page row
        source for this LB)."""
        with self._cb_lock:
            items = list(self._breakers.items())
        return {f"{ep.ip}:{ep.port}": cb.describe() for ep, cb in items}

    # NamingServiceThread observer surface (filtered pass-through to the LB)
    def add_server(self, ep: EndPoint) -> None:
        if self._server_filter is None or self._server_filter(ep):
            self.lb.add_server(ep)

    def remove_server(self, ep: EndPoint) -> None:
        if self._server_filter is None or self._server_filter(ep):
            self.lb.remove_server(ep)
            self._drop_breaker(ep)

    def _drop_breaker(self, ep: EndPoint) -> None:
        """Naming churn: a departed endpoint's breaker, isolation entry
        and registry row go with it — a long-lived LB watching an
        autoscaling pool must not accumulate ghosts (or hold a departed
        node in the isolated gauge until its timer fires)."""
        if not self._cb_enabled:
            return
        from incubator_brpc_tpu_torch.rpc.circuit_breaker import breaker_registry

        with self._cb_lock:
            self._breakers.pop(ep, None)
            self._isolated.pop(ep, None)
            tid = self._revive_timers.pop(ep, None)
        if tid is not None:
            from incubator_brpc_tpu_torch.runtime.timer_thread import (
                global_timer_thread,
            )

            global_timer_thread().unschedule(tid)
        breaker_registry.unregister(self._cb_tag, f"{ep.ip}:{ep.port}")

    def select_server(
        self,
        excluded: Optional[Set[int]] = None,
        request_code: Optional[int] = None,
    ):
        excluded_eps: Set[EndPoint] = self._isolated_eps()
        if excluded:
            with self._map_lock:
                excluded_eps |= {
                    self._ep_by_sid[sid] for sid in excluded if sid in self._ep_by_sid
                }
        for _ in range(self.MAX_PICK_ATTEMPTS):
            ep = self.lb.select(excluded=excluded_eps, request_code=request_code)
            if ep is None:
                return None
            try:
                sock = self._socket_map.get_or_create(
                    ep, key_tag=self._key_tag, **self._conn_kwargs
                )
            except OSError:
                # select() already charged this pick (LA in-flight): settle
                # it — and a refused connect IS node evidence: it feeds the
                # breaker too (the most common hard-down failure mode must
                # isolate like any other, not stay in rotation burning a
                # dial timeout per pick)
                self.lb.feedback(ep, 0.0, ErrorCode.EFAILEDSOCKET)
                self._feed_breaker(ep, 0.0, ErrorCode.EFAILEDSOCKET)
                excluded_eps.add(ep)  # connect refused: try another server
                continue
            from incubator_brpc_tpu_torch.transport.sock import CONNECTED

            if sock.state != CONNECTED and not sock.connect_if_not():
                # dead and not revivable right now: treat like a refused
                # connect instead of burning the attempt (ConnectIfNot)
                self.lb.feedback(ep, 0.0, ErrorCode.EFAILEDSOCKET)
                self._feed_breaker(ep, 0.0, ErrorCode.EFAILEDSOCKET)
                excluded_eps.add(ep)
                continue
            with self._map_lock:
                self._ep_by_sid[sock.id] = ep
            if self._cb_enabled:
                self._hook_revival(sock, ep)
            return sock
        return None

    def _hook_revival(self, sock, ep: EndPoint) -> None:
        """An isolated node whose socket health-check revives re-enters
        the candidate set early (transport/sock.py on_revived) — once per
        socket, marked in its context."""
        marker = f"_cb_revive_{self._cb_tag}"
        ctx = getattr(sock, "context", None)
        if ctx is None or marker in ctx:
            return
        ctx[marker] = True
        hooks = getattr(sock, "on_revived", None)
        if hooks is not None:
            cb = lambda _s, _ep=ep: self._revive_now(_ep)  # noqa: E731
            hooks.append(cb)
            with self._cb_lock:
                self._revival_hooks.append((sock, cb))

    def register_socket(self, sock, ep: EndPoint) -> None:
        """Track a secondary (pooled/short) connection under its endpoint
        so feedback and retry exclusion resolve it (the reference reaches
        the main socket's SharedPart from secondaries the same way)."""
        with self._map_lock:
            self._ep_by_sid[sock.id] = ep

    def feedback(self, sock, latency_us: float, error_code: int) -> None:
        with self._map_lock:
            ep = self._ep_by_sid.get(sock.id)
        if ep is None:
            return
        self.lb.feedback(ep, latency_us, error_code)
        # a canceled call (or a backup-superseded original, settled as
        # EBACKUPREQUEST) says nothing about the NODE; everything else
        # feeds the breaker's error-cost windows
        self._feed_breaker(ep, latency_us, error_code)

    def settle(self, sock) -> None:
        with self._map_lock:
            ep = self._ep_by_sid.get(sock.id)
        if ep is not None:
            self.lb.settle(ep)

    def servers(self) -> List[EndPoint]:
        return self.lb.servers()


__all__ = [
    "LoadBalancer",
    "RoundRobinLB",
    "RandomLB",
    "WeightedRoundRobinLB",
    "ConsistentHashLB",
    "LocalityAwareLB",
    "LoadBalancerWithNaming",
    "create_load_balancer",
    "register_load_balancer",
]
