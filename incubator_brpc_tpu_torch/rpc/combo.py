"""Combo channels — ParallelChannel / SelectiveChannel / PartitionChannel
(reference src/brpc/parallel_channel.{h,cpp}, selective_channel.{h,cpp},
partition_channel.{h,cpp}).

These compose ordinary Channels on the host RPC plane, over TCP or over
device links (``ChannelOptions(transport="tpu")``). The port's copy of the
JAX package's ``rpc/combo.py`` in its host form: the fan-out runs one
sub-call per sub-channel. Where every sub-channel rides a link to a
distinct server and the method is a device method, the reference lowers
the fan-out to one collective dispatch over those servers. Over
multi-controller links (one server a process) the port lowers it as the
reference does, to a one-step session on the collective method plane
(``parallel/mc_dispatch.py`` ``lower_parallel_call``, the servers' ranks
its parties), and falls back to the host fan-out when the session aborts;
the single-controller fused dispatch is ROADMAP A3, and the port raises
``NotImplementedError`` naming it there instead of quietly taking the
host fan-out. Single-controller sub-links that share a device (one card:
every server binds it) cannot form the collective axis, so the host
fan-out runs and ``parallel_channel_host_fanout`` counts it, as in the
reference.

Kept semantics:
- ParallelChannel: CallMapper maps (channel_index, request) → SubCall
  (broadcast / rewritten / skipped, parallel_channel.h:36-101); sub-calls
  run concurrently; the parent fails once ``nfailed >= fail_limit``
  (default: all non-skipped must fail, parallel_channel.cpp:625-627);
  successful responses merge in channel-index order via ResponseMerger.
- SelectiveChannel: sub-channels are schedulable units behind an internal
  LB; retries go to *different* sub-channels (selective_channel.cpp, the
  `_sender` hook controller.cpp:956-964).
- PartitionChannel: one naming service splits into per-partition
  sub-channels via a PartitionParser reading "N/M" server tags
  (partition_channel.h:44-50); the call fans out like ParallelChannel.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional, Tuple

from incubator_brpc_tpu_torch.bvar import Adder
from incubator_brpc_tpu_torch.rpc.channel import (
    Channel,
    ChannelOptions,
    tls_conn_kwargs,
    tls_key_tag,
)
from incubator_brpc_tpu_torch.rpc.controller import RETRIABLE, Controller
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint
from incubator_brpc_tpu_torch.utils.status import ErrorCode, berror

logger = logging.getLogger(__name__)

# /vars observability for the collective lowering: how many combo calls
# fused into one collective dispatch vs ran the host fan-out
fused_dispatches = Adder(name="parallel_channel_fused")
host_fanouts = Adder(name="parallel_channel_host_fanout")


# -- ParallelChannel ---------------------------------------------------------


class SubCall:
    """What a CallMapper returns per sub-channel (parallel_channel.h:36)."""

    __slots__ = ("service", "method", "request", "skipped")

    def __init__(
        self,
        service: Optional[str] = None,
        method: Optional[str] = None,
        request: Optional[bytes] = None,
        skipped: bool = False,
    ):
        self.service = service
        self.method = method
        self.request = request
        self.skipped = skipped

    @classmethod
    def skip(cls) -> "SubCall":
        return cls(skipped=True)


class CallMapper:
    """Default: broadcast the original request to every sub-channel."""

    def map(
        self, channel_index: int, nchannels: int, service: str, method: str,
        request: bytes,
    ) -> SubCall:
        return SubCall()


class ResponseMerger:
    """Incremental merge in channel-index order (parallel_channel.h:103).
    Default: concatenate payload bytes."""

    def merge(self, merged: bytes, sub_response: bytes) -> bytes:
        return merged + sub_response


class ParallelChannel:
    """Scatter/gather across sub-channels (parallel_channel.cpp).

    When every non-skipped sub-channel rides a device link (transport=
    'tpu') to a DISTINCT server device and the target method is a
    registered device method (rpc/device_method.py), the reference fuses
    the whole scatter → execute → gather into ONE collective dispatch over
    those devices (an all-gather of every response; a 1-step N-party
    session for multi-controller links). The port checks the same
    preconditions in the same order; over multi-controller links it runs
    the session, and over single-controller ones it raises
    ``NotImplementedError`` naming ROADMAP A3, where
    ``fuse_device_calls=False`` takes the host fan-out. Any precondition
    miss runs the host fan-out, as in the reference."""

    def __init__(self, fail_limit: int = -1, fuse_device_calls: bool = True):
        self.fail_limit = fail_limit
        self.fuse_device_calls = fuse_device_calls
        self._subs: List[Tuple[Channel, CallMapper, ResponseMerger]] = []

    def add_channel(
        self,
        channel: Channel,
        call_mapper: Optional[CallMapper] = None,
        response_merger: Optional[ResponseMerger] = None,
    ) -> None:
        self._subs.append(
            (channel, call_mapper or CallMapper(), response_merger or ResponseMerger())
        )

    @property
    def channel_count(self) -> int:
        return len(self._subs)

    def call_method(
        self,
        service: str,
        method: str,
        request: bytes,
        cntl: Optional[Controller] = None,
        done: Optional[Callable[[Controller], None]] = None,
    ) -> Controller:
        if cntl is None:
            cntl = Controller()
        nchan = len(self._subs)
        if nchan == 0:
            cntl.set_failed(ErrorCode.EINVAL, "ParallelChannel has no sub channels")
            if done:
                done(cntl)
            return cntl

        plan: List[Optional[Tuple[Channel, ResponseMerger, SubCall]]] = []
        for i, (ch, mapper, merger) in enumerate(self._subs):
            sub = mapper.map(i, nchan, service, method, request)
            plan.append(None if sub.skipped else (ch, merger, sub))
        ndone = sum(1 for p in plan if p is not None)
        if ndone == 0:
            cntl.set_failed(ErrorCode.EREQUEST, "all sub calls skipped")
            if done:
                done(cntl)
            return cntl
        if self.fuse_device_calls and ndone >= 2:
            fused = self._maybe_fused_device_call(service, method, request, plan, cntl)
            if fused is not None:
                fused_dispatches << 1
                cntl.response_payload = fused
                cntl.collective_fused = True
                if done is not None:
                    done(cntl)
                return cntl
        host_fanouts << 1

        # 1 <= fail_limit <= ndone (parallel_channel.cpp:625-637)
        fail_limit = self.fail_limit
        if fail_limit < 0:
            fail_limit = ndone
        fail_limit = max(1, min(fail_limit, ndone))

        state = {
            "remaining": ndone,
            "nfailed": 0,
            "first_error": (0, ""),
            "finished": False,
        }
        lock = threading.Lock()
        all_done = threading.Event()
        sub_cntls: List[Optional[Controller]] = [None] * nchan

        def finish() -> None:
            if state["nfailed"] >= fail_limit:
                code, text = state["first_error"]
                cntl.set_failed(
                    code or ErrorCode.EINTERNAL,
                    f"{state['nfailed']}/{ndone} sub calls failed "
                    f"(fail_limit={fail_limit}): {text}",
                )
            else:
                merged = b""
                for i, p in enumerate(plan):
                    if p is None:
                        continue
                    sc = sub_cntls[i]
                    if sc is not None and sc.ok():
                        merged = p[1].merge(merged, sc.response_payload)
                cntl.response_payload = merged
            all_done.set()
            if done is not None:
                done(cntl)

        def sub_done(i: int, sc: Controller) -> None:
            with lock:
                sub_cntls[i] = sc
                if sc.failed():
                    state["nfailed"] += 1
                    if state["first_error"][0] == 0:
                        state["first_error"] = (sc.error_code, sc.error_text)
                state["remaining"] -= 1
                # early finish once the verdict is decided either way
                # (parallel_channel.cpp:221-224 cancels the rest; our
                # remaining sub-calls just complete into a dead closure)
                decided = (
                    state["remaining"] == 0 or state["nfailed"] >= fail_limit
                )
                if not decided or state["finished"]:
                    return
                state["finished"] = True
            finish()

        for i, p in enumerate(plan):
            if p is None:
                continue
            ch, _, sub = p
            sc = Controller(timeout_ms=cntl.timeout_ms, max_retry=cntl.max_retry)
            sc.compress_type = cntl.compress_type
            sc.log_id = cntl.log_id
            ch.call_method(
                sub.service or service,
                sub.method or method,
                request if sub.request is None else sub.request,
                cntl=sc,
                done=(lambda c, _i=i: sub_done(_i, c)),
            )
        if done is None:
            all_done.wait()
        return cntl

    call = call_method

    # -- the collective lowering (ROADMAP A3; BASELINE #3/#4) ---------------

    def _maybe_fused_device_call(
        self, service, method, request, plan, cntl
    ) -> Optional[bytes]:
        """None when the preconditions of the collective lowering do not
        hold, or its session aborted (the host fan-out runs instead); the
        merged responses where the multi-controller lowering ran; where
        every precondition holds over single-controller links, raises
        ``NotImplementedError`` naming ROADMAP A3.

        Preconditions, in the reference's order: the method has a
        registered device kernel; no mapper redirects a sub-call; every
        non-skipped sub-channel uses transport='tpu', its sub-request fits
        the kernel row width, and it resolves a live device link whose peer
        advertised this kernel; the links are all multi-controller (their
        server ranks pairwise distinct) or all single-controller (their
        server devices pairwise distinct); they form the collective axis.
        Every LB pick made to probe a link is settled before returning or
        raising, with the session's latency where it ran.
        """
        from incubator_brpc_tpu_torch.rpc.device_method import lookup_device_method

        dm = lookup_device_method(service, method)
        if dm is None:
            return None
        full = f"{service}.{method}"
        fp = dm.fingerprint()
        subs = [(i, p) for i, p in enumerate(plan) if p is not None]
        devices = []
        probed: List[tuple] = []  # (channel, device socket) picks to settle

        def _settle_probes() -> None:
            # release LB picks that never became an RPC (la charges
            # in-flight on select; an un-settled probe would depress the
            # peer's weight forever) — no latency sample is recorded
            for pch, pds in probed:
                if pch._lb is not None:
                    pch._lb.settle(pds)

        links = []
        requests = []
        for _i, (ch, _merger, sub) in subs:
            if sub.service is not None or sub.method is not None:
                # a mapper that redirects a sub-call to a different method
                # must run on the host path (the fused program compiles ONE
                # kernel for the whole axis)
                _settle_probes()
                return None
            if getattr(ch._options, "transport", "") != "tpu":
                _settle_probes()
                return None
            req = request if sub.request is None else sub.request
            if len(req) > dm.width:
                _settle_probes()
                return None
            try:
                ds = ch._pick_socket(Controller(timeout_ms=cntl.timeout_ms))
            except Exception:
                _settle_probes()
                return None  # cannot resolve a link: host path arbitrates
            probed.append((ch, ds))
            link = getattr(ds, "link", None)
            if link is None:
                _settle_probes()
                return None  # not a device link
            if getattr(ds, "device_methods", {}).get(full) != fp:
                # the peer did not advertise THIS kernel under this name —
                # fusing would run a kernel the server never registered
                _settle_probes()
                return None
            devices.append(link.devices[1])
            links.append(link)
            requests.append(req)
        mc = [getattr(lk, "own_side", None) is not None for lk in links]
        if any(mc):
            # multi-controller sub-links cannot take the single-dispatch
            # fuse (this process cannot place operands in another process):
            # they lower through the collective method plane instead — one
            # 1-step N-party session of the SAME kernel, the servers'
            # ranks its parties, scheduled over the host plane
            if not all(mc):
                _settle_probes()
                return None  # mixed planes cannot form one party axis
            ranks = [int(lk.ranks[1]) for lk in links]
            if len(set(ranks)) != len(ranks):
                _settle_probes()
                return None  # one server process cannot be two parties
            t0 = time.perf_counter()
            try:
                from incubator_brpc_tpu_torch.parallel import mc_dispatch

                outs = mc_dispatch.lower_parallel_call(
                    [ch for _i, (ch, _m, _s) in subs], ranks, service, method, requests,
                    timeout_ms=cntl.timeout_ms,
                )
            except Exception:
                logger.exception("mc collective lowering failed; using host fan-out")
                _settle_probes()
                return None
            latency_us = (time.perf_counter() - t0) * 1e6
            for pch, pds in probed:
                if pch._lb is not None:
                    pch._lb.feedback(pds, latency_us, 0)
            merged = b""
            for pos, (_i, (_ch, merger, _sub)) in enumerate(subs):
                merged = merger.merge(merged, outs[pos])
            return merged
        ids = [str(d) for d in devices]
        if len(set(ids)) != len(ids):
            _settle_probes()
            return None  # shared devices cannot form the collective axis
        _settle_probes()
        raise NotImplementedError(
            f"ParallelChannel fused collective dispatch of {full} over "
            f"{len(ids)} distinct server devices ({', '.join(ids)}) is not in the "
            "port yet (ROADMAP A3); ParallelChannel(fuse_device_calls=False) "
            "takes the host fan-out"
        )


# -- SelectiveChannel --------------------------------------------------------


class SelectiveChannel:
    """Replica-set chooser: each sub-channel is a schedulable unit; retries
    move to a different sub-channel (selective_channel.cpp). Like the
    reference — which wraps sub-channels in fake SocketIds and feeds them
    to an embedded LoadBalancer — the scheduler here IS a real LB from the
    registry (rr/random/wrr/la) over per-sub pseudo-endpoints reading
    through DoublyBufferedData snapshots, with latency/error feedback
    after every attempt, so ``lb_name="la"`` gives locality-aware replica
    selection across clusters.

    Health integrates the way the reference's fake Sockets do (a failed
    sub-channel's SocketId is excluded by the LB until its health check
    revives it, selective_channel.cpp + the Socket health-check loop):
    ``health_check_fails`` consecutive transport-class failures take the
    sub OUT of the LB's candidate set; after an exponentially backed-off
    interval the sub is revived in place — the next real call is the
    probe (Socket revives in place the same way), success resets it,
    failure re-downs it with a doubled interval."""

    # errors that indict the REPLICA (transport/overload), not the request
    _HEALTH_ERRORS = frozenset(
        {
            ErrorCode.EFAILEDSOCKET,
            ErrorCode.EHOSTDOWN,
            ErrorCode.ERPCTIMEDOUT,
            ErrorCode.EOVERCROWDED,
            ErrorCode.ECLOSE,
        }
    )

    def __init__(
        self,
        max_retry: int = 3,
        lb_name: str = "rr",
        health_check_fails: int = 2,
        health_check_interval_s: float = 1.0,
    ):
        from incubator_brpc_tpu_torch.lb import create_load_balancer

        self.max_retry = max_retry
        self.health_check_fails = health_check_fails
        self.health_check_interval_s = health_check_interval_s
        self._subs: List[Channel] = []
        self._eps: List[EndPoint] = []  # pseudo endpoint per sub-channel
        self._fail_streak: List[int] = []
        self._down_until: List[float] = []  # 0 = healthy
        self._backoff: List[float] = []
        self._lb = create_load_balancer(lb_name)
        self._lock = threading.Lock()

    def add_channel(self, channel: Channel) -> int:
        with self._lock:
            idx = len(self._subs)
            self._subs.append(channel)
            ep = EndPoint(ip="subchannel", port=idx)
            self._eps.append(ep)
            self._fail_streak.append(0)
            self._down_until.append(0.0)
            self._backoff.append(self.health_check_interval_s)
        self._lb.add_server(ep)
        return idx

    @property
    def channel_count(self) -> int:
        return len(self._subs)

    def _pick(self, excluded: set) -> Optional[int]:
        import time as _time

        now = _time.monotonic()
        with self._lock:
            excluded_eps = {self._eps[i] for i in excluded if i < len(self._eps)}
            # downed subs stay out of the candidate set until their
            # revive time — then they rejoin and the next call probes them
            for i, until in enumerate(self._down_until):
                if until > now:
                    excluded_eps.add(self._eps[i])
        ep = self._lb.select(excluded=excluded_eps)
        if ep is None and excluded_eps:
            # every replica is either excluded or down: rather than fail
            # the call outright, probe the least-recently-downed sub not
            # excluded by THIS call (the reference likewise degrades to
            # trying an unhealthy node when nothing healthy remains)
            with self._lock:
                candidates = [
                    (self._down_until[i], i)
                    for i in range(len(self._subs))
                    if i not in excluded
                ]
            if candidates:
                return min(candidates)[1]
        return ep.port if ep is not None else None

    def _feedback(
        self,
        index: int,
        latency_us: float,
        error_code: int,
        budget_starved: bool = False,
    ) -> None:
        """``budget_starved``: the attempt ran on the dregs of the shared
        per-call deadline (an earlier slow replica ate it); its timeout
        indicts the BUDGET, not this replica — feed the LB but leave the
        health streak alone."""
        import time as _time

        with self._lock:
            if index >= len(self._eps):
                return
            ep = self._eps[index]
            if error_code in self._HEALTH_ERRORS:
                if not (
                    budget_starved and error_code == ErrorCode.ERPCTIMEDOUT
                ):
                    self._fail_streak[index] += 1
                    if self._fail_streak[index] >= self.health_check_fails:
                        # down: excluded from _pick until the backed-off
                        # revive time, then probed in place
                        self._down_until[index] = (
                            _time.monotonic() + self._backoff[index]
                        )
                        self._backoff[index] = min(
                            self._backoff[index] * 2, 30.0
                        )
            else:
                # a completed response — success OR application error —
                # proves the replica reachable: 'consecutive' means what
                # it says, so the streak resets and a downed replica whose
                # probe got through revives
                self._fail_streak[index] = 0
                self._down_until[index] = 0.0
                self._backoff[index] = self.health_check_interval_s
        self._lb.feedback(ep, latency_us, error_code)

    def health(self) -> List[dict]:
        """Introspection: per-sub health (mirrors /connections for subs)."""
        import time as _time

        now = _time.monotonic()
        with self._lock:
            return [
                {
                    "index": i,
                    "down": self._down_until[i] > now,
                    "fail_streak": self._fail_streak[i],
                    "revive_in_s": max(0.0, self._down_until[i] - now),
                }
                for i in range(len(self._subs))
            ]

    def call_method(
        self,
        service: str,
        method: str,
        request: bytes,
        cntl: Optional[Controller] = None,
        done: Optional[Callable[[Controller], None]] = None,
    ) -> Controller:
        if cntl is None:
            cntl = Controller(max_retry=self.max_retry)
        if not self._subs:
            cntl.set_failed(ErrorCode.EINVAL, "SelectiveChannel has no sub channels")
            if done:
                done(cntl)
            return cntl
        if done is not None:
            # honor the async contract: the retry loop joins sub-calls, so it
            # runs on a worker fiber and the caller returns immediately
            from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool

            global_worker_pool().spawn(
                self._call_blocking, service, method, request, cntl, done
            )
            return cntl
        return self._call_blocking(service, method, request, cntl, None)

    def _call_blocking(
        self,
        service: str,
        method: str,
        request: bytes,
        cntl: Controller,
        done: Optional[Callable[[Controller], None]],
    ) -> Controller:
        import time as _time

        excluded: set = set()
        # the per-call retry knob wins (Controller.max_retry, as Channel
        # honors it); the whole call shares ONE deadline — each attempt gets
        # the remaining budget, not a fresh timeout (controller.cpp deadline)
        attempts = 1 + max(0, cntl.max_retry)
        deadline = None
        if cntl.timeout_ms is not None and cntl.timeout_ms > 0:
            deadline = _time.monotonic() + cntl.timeout_ms / 1000.0
        last: Optional[Controller] = None
        for attempt_no in range(attempts):
            remaining_ms = cntl.timeout_ms
            if deadline is not None:
                remaining_ms = (deadline - _time.monotonic()) * 1000.0
                if remaining_ms <= 0:
                    if last is None:
                        cntl.set_failed(
                            ErrorCode.ERPCTIMEDOUT, berror(ErrorCode.ERPCTIMEDOUT)
                        )
                        if done:
                            done(cntl)
                        return cntl
                    break
            i = self._pick(excluded)
            if i is None:
                break
            sub = self._subs[i]
            sc = Controller(
                timeout_ms=remaining_ms,
                max_retry=0,  # retry here moves channels, not servers
            )
            sc.compress_type = cntl.compress_type
            sc.log_id = cntl.log_id
            sub.call_method(service, method, request, cntl=sc)
            last = sc
            # only a LATER attempt can be budget-starved: the first one
            # had the whole deadline, so its timeout indicts the replica
            starved = (
                attempt_no > 0
                and cntl.timeout_ms is not None
                and cntl.timeout_ms > 0
                and remaining_ms is not None
                and remaining_ms < max(50.0, 0.2 * cntl.timeout_ms)
            )
            self._feedback(
                i, sc.latency_us, sc.error_code, budget_starved=starved
            )
            if sc.ok():
                cntl.response_payload = sc.response_payload
                cntl.response_attachment = sc.response_attachment
                cntl.remote_side = sc.remote_side
                if done:
                    done(cntl)
                return cntl
            excluded.add(i)
            if sc.error_code not in RETRIABLE and sc.error_code != ErrorCode.ERPCTIMEDOUT:
                break  # application error: switching replicas won't help
        if last is not None:
            cntl.set_failed(last.error_code, f"all replicas failed: {last.error_text}")
        else:
            cntl.set_failed(ErrorCode.EINTERNAL, "no selectable sub channel")
        if done:
            done(cntl)
        return cntl

    call = call_method


# -- PartitionChannel --------------------------------------------------------


class PartitionParser:
    """Parse a server tag into (partition_index, partition_count) or None if
    the tag doesn't belong to this scheme (partition_channel.h:44-50 parses
    "N/M")."""

    def parse(self, tag: str) -> Optional[Tuple[int, int]]:
        try:
            n, m = tag.split("/", 1)
            idx, cnt = int(n), int(m)
        except (ValueError, AttributeError):
            return None
        if 0 <= idx < cnt:
            return idx, cnt
        return None


def _build_partition_channels(
    ns_thread,
    parser: "PartitionParser",
    partition_count: int,
    lb_name: str,
    options: Optional[ChannelOptions],
):
    """Per-partition filtered LB views over ONE shared naming watcher
    (partition_channel.cpp builds sub-channels the same way) — shared by
    PartitionChannel and DynamicPartitionChannel so the construction (and
    its error handling) cannot drift. Returns (channels, lbs) or None if a
    sub-channel failed to init. The client socket map carries the response
    messenger."""
    from incubator_brpc_tpu_torch.lb import LoadBalancerWithNaming
    from incubator_brpc_tpu_torch.rpc.channel import _client_socket_map

    # sub-channel sockets honor the caller's TLS config: the LB dials main
    # sockets itself, so the context and the ssl-partitioned key tag have
    # to reach it here (a Channel.init target gets them from the Channel)
    opts = options if options is not None else ChannelOptions()
    key_tag, conn_kwargs = tls_key_tag(opts), tls_conn_kwargs(opts)

    channels, lbs = [], []
    for part in range(partition_count):
        def _filter(ep, _part=part):
            return parser.parse(getattr(ep, "tag", "") or "") == (
                _part,
                partition_count,
            )

        lb = LoadBalancerWithNaming(
            lb_name=lb_name,
            socket_map=_client_socket_map,
            ns_thread=ns_thread,
            server_filter=_filter,
            key_tag=key_tag,
            conn_kwargs=conn_kwargs,
        )
        ch = Channel()
        if not ch.init_with_lb(lb, options=options):
            return None
        channels.append(ch)
        lbs.append(lb)
    return channels, lbs


class PartitionChannel(ParallelChannel):
    """One naming service, M partitions, one sub-channel per partition
    (partition_channel.cpp). Servers publish tags ("0/3", "1/3", ...) next
    to their address in the naming source; each sub-channel only sees its
    partition's servers."""

    def __init__(self, fail_limit: int = -1):
        super().__init__(fail_limit=fail_limit)
        self.partition_count = 0
        self._ns_thread = None
        self._lbs: list = []

    def init(
        self,
        naming_url: str,
        partition_count: int,
        lb_name: str = "rr",
        parser: Optional[PartitionParser] = None,
        options: Optional[ChannelOptions] = None,
        call_mapper: Optional[CallMapper] = None,
        response_merger: Optional[ResponseMerger] = None,
    ) -> bool:
        from incubator_brpc_tpu_torch.naming import NamingServiceThread

        parser = parser or PartitionParser()
        self.partition_count = partition_count
        self._ns_thread = NamingServiceThread(naming_url)
        if not self._ns_thread.start():
            return False
        built = _build_partition_channels(
            self._ns_thread, parser, partition_count, lb_name, options
        )
        if built is None:
            return False
        for ch in built[0]:
            self.add_channel(ch, call_mapper, response_merger)
        self._lbs = built[1]
        return True

    def stop(self) -> None:
        """Stop every partition's LB (each detaches its observer from the
        shared naming thread, cancels its revival timers and drops its
        breakers), then the naming thread. The reference stops the naming
        thread alone and leaves the LBs attached to it."""
        for lb in self._lbs:
            lb.stop()
        if self._ns_thread is not None:
            self._ns_thread.stop()


class DynamicPartitionChannel:
    """Mixed partitioning schemes behind one naming service, traffic
    weighted by per-scheme capacity (reference partition_channel.h:134 +
    policy/dynpart_load_balancer.cpp: servers tagged "0/3" and "0/4"
    coexist while a fleet re-partitions; each call picks ONE scheme with
    probability proportional to live-servers/partition-count — full replica
    sets attract more traffic — then fans out across that scheme's
    partitions like an ordinary PartitionChannel)."""

    def __init__(self, fail_limit: int = -1):
        self.fail_limit = fail_limit
        self._ns_thread = None
        self._parser: Optional[PartitionParser] = None
        self._lb_name = "rr"
        self._options: Optional[ChannelOptions] = None
        self._lock = threading.Lock()
        # scheme M -> (ParallelChannel, [per-partition LBs for weighting])
        self._schemes = {}
        self._rng_state = 0x9E3779B97F4A7C15

    def init(
        self,
        naming_url: str,
        lb_name: str = "rr",
        parser: Optional[PartitionParser] = None,
        options: Optional[ChannelOptions] = None,
    ) -> bool:
        from incubator_brpc_tpu_torch.naming import NamingServiceThread

        self._parser = parser or PartitionParser()
        self._lb_name = lb_name
        self._options = options
        self._ns_thread = NamingServiceThread(naming_url)
        if not self._ns_thread.start():
            return False
        # observe to DISCOVER schemes; the per-partition filtered LBs do
        # their own add/remove through the same thread
        self._ns_thread.add_observer(self)
        return True

    def stop(self) -> None:
        if self._ns_thread is not None:
            # detach before stop — observer symmetry with init(): were the
            # watcher ever shared, a stopped channel must not keep
            # receiving (and acting on) scheme churn
            self._ns_thread.remove_observer(self)
            # each scheme's partition LBs detach too (the reference leaves
            # them attached to the stopped thread)
            with self._lock:
                schemes = list(self._schemes.values())
            for _pc, lbs in schemes:
                for lb in lbs:
                    lb.stop()
            self._ns_thread.stop()

    # NamingServiceThread observer: build a scheme on first sighting
    def add_server(self, ep) -> None:
        parsed = self._parser.parse(getattr(ep, "tag", "") or "")
        if parsed is None:
            return
        _, count = parsed
        # the whole check+build is under the lock: two concurrent observer
        # callbacks discovering the same scheme must not both build it (the
        # loser's LBs would stay registered on the naming thread forever).
        # No inversion risk: the naming thread never holds its own lock
        # while calling observers.
        with self._lock:
            if count in self._schemes:
                return
            built = _build_partition_channels(
                self._ns_thread, self._parser, count, self._lb_name, self._options
            )
            if built is None:
                logger.warning("scheme /%d failed to build; skipped", count)
                return
            channels, lbs = built
            pc = ParallelChannel(fail_limit=self.fail_limit)
            for ch in channels:
                pc.add_channel(ch)
            self._schemes[count] = (pc, lbs)

    def remove_server(self, ep) -> None:
        pass  # the filtered LBs see the removal themselves

    def _pick_scheme(self):
        with self._lock:
            schemes = list(self._schemes.values())
        weighted = []
        for pc, lbs in schemes:
            nservers = sum(len(lb.servers()) for lb in lbs)
            if nservers > 0:
                weighted.append((nservers / pc.channel_count, pc))
        if not weighted:
            return None
        # xorshift-weighted pick (no global random state)
        self._rng_state ^= (self._rng_state << 13) & 0xFFFFFFFFFFFFFFFF
        self._rng_state ^= self._rng_state >> 7
        self._rng_state ^= (self._rng_state << 17) & 0xFFFFFFFFFFFFFFFF
        total = sum(w for w, _ in weighted)
        x = (self._rng_state / 2**64) * total
        for w, pc in weighted:
            x -= w
            if x <= 0:
                return pc
        return weighted[-1][1]

    def call_method(
        self,
        service: str,
        method: str,
        request: bytes,
        cntl: Optional[Controller] = None,
        done: Optional[Callable[[Controller], None]] = None,
    ) -> Controller:
        pc = self._pick_scheme()
        if pc is None:
            if cntl is None:
                cntl = Controller()
            cntl.set_failed(ErrorCode.EINTERNAL, "no partitioning scheme has servers")
            if done:
                done(cntl)
            return cntl
        return pc.call_method(service, method, request, cntl=cntl, done=done)

    call = call_method
