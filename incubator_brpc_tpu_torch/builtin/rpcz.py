"""rpcz — sampled per-RPC spans (reference src/brpc/span.{h,cpp,proto} and
builtin/rpcz_service.cpp).

Reproduced design points:
- spans are *sampled*, not always-on: a token-bucket speed limiter caps the
  collection rate (the reference shares bvar::Collector's sampling-speed
  limiter, collector.h:38-122, ~COLLECTOR_SAMPLING_BASE samples/s);
- client spans are created in Channel.call_method (channel.cpp:343), server
  spans in the protocol's process_request, with trace/span/parent ids
  carried in the request meta (Dapper-style, baidu_rpc_meta.proto);
- nested client calls made while serving a request pick up the server
  span as parent via a thread-local (tls_bls.rpcz_parent_span, span.h:72-75);
- storage is in-memory ring (the reference persists to LevelDB under
  rpcz_database_dir; an in-memory ring serves the same /rpcz queries
  without the on-disk dependency).

The port's copy of the JAX package's ``builtin/rpcz.py``. The ids are
drawn from a ``random.Random`` the caller can set (``set_id_rng``); by
default the process-global generator of ``random``, as the JAX package
draws them. The hooks sit in ``rpc/channel.py`` (both client routes),
``rpc/server.py`` (the binary route and the HTTP gateway), the native
plane's telemetry drain (``transport/native_plane.py``) and the session
plane (``parallel/mc_dispatch.py``, ``parallel/mc_collective.py``).
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import json
import logging
import os
import re

from incubator_brpc_tpu_torch.utils.flags import get_flag

logger = logging.getLogger(__name__)

SPAN_TYPE_CLIENT = "client"
SPAN_TYPE_SERVER = "server"
# non-RPC device-plane work (collective sessions): same store, same
# queries, parented into the proposing RPC's trace
SPAN_TYPE_COLLECTIVE = "collective"

# start_real_us values below this are clearly not wall time (synthetic
# test clocks, replayed traces): such spans are exempt from age
# retention and only bounded by the ring size.  1e15 us ~ 2001-09-09.
_WALL_EPOCH_US = 1e15

_tls = threading.local()  # .parent_span: active server span on this thread


@dataclass
class Span:
    trace_id: int = 0
    span_id: int = 0
    parent_span_id: int = 0
    span_type: str = SPAN_TYPE_CLIENT
    service: str = ""
    method: str = ""
    remote_side: str = ""
    log_id: int = 0
    error_code: int = 0
    start_real_us: int = 0
    latency_us: float = 0.0
    request_size: int = 0
    response_size: int = 0
    # (offset_us_from_start, text) — Span::Annotate analog
    annotations: List[Tuple[float, str]] = field(default_factory=list)

    def annotate(self, text: str) -> None:
        now_us = time.time() * 1e6
        self.annotations.append((now_us - self.start_real_us, text))


class _SpeedLimiter:
    """Token bucket bounding spans collected per second (the reference's
    Collector sampling-speed share, collector.cpp:35)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tokens = 0.0
        self._last = time.monotonic()

    def grab(self) -> bool:
        rate = float(get_flag("rpcz_samples_per_second"))
        with self._lock:
            now = time.monotonic()
            self._tokens = min(rate, self._tokens + (now - self._last) * rate)
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


class SpanStore:
    """In-memory ring of finished spans, queryable by trace id / latency.
    With ``rpcz_database_dir`` set, finished spans also append to a
    rotated ``rpcz.jsonl`` — the durable record the reference keeps in
    LevelDB (span.cpp:41 rpcz_database_dir); /rpcz itself serves from the
    ring either way."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=int(get_flag("rpcz_max_spans")))
        # trace_id -> [spans], maintained at submit/eviction so
        # ``by_trace`` (the /rpcz?trace_id= query and the fleet puller)
        # is an O(spans-in-trace) lookup instead of an O(ring) scan
        # under the store lock — a fleet assembly pull must not stall
        # the submit path every hot drain races
        self._by_trace: dict = {}
        # the file has no shared invariant with the ring: its own lock, so
        # disk flushes never stall ring submits or /rpcz queries
        self._db_lock = threading.Lock()
        self._db_file = None
        self._db_path = ""

    def _index_add(self, span: Span) -> None:
        if span.trace_id:
            self._by_trace.setdefault(span.trace_id, []).append(span)

    def _index_drop(self, span: Span) -> None:
        if not span.trace_id:
            return
        bucket = self._by_trace.get(span.trace_id)
        if bucket is None:
            return
        try:
            bucket.remove(span)
        except ValueError:
            pass
        if not bucket:
            del self._by_trace[span.trace_id]

    def submit(self, span: Span) -> None:
        # re-check the ring-size flag per submit: ``rpcz_max_spans`` is
        # reloadable, but deque(maxlen=...) froze the value read at
        # construction — setting the flag later silently did nothing
        maxlen = int(get_flag("rpcz_max_spans"))
        # age retention (rpcz_keep_span_seconds, reference span.cpp keeps
        # spans ~30 min): prune entries whose COMPLETION is more than the
        # horizon before the HOST clock.  Spans are submitted at
        # completion, so the deque is completion-ordered (start order is
        # not — a long span submits after shorter ones that started
        # later) and the popleft walk is amortized O(1).  The horizon
        # deliberately comes from the host, not the incoming span's
        # producer clock: the store is process-global, so one span with a
        # skewed/synthetic clock must never purge everyone else's.
        # Symmetrically, spans whose own clock is clearly not wall time
        # (synthetic test fixtures, replayed traces — anything before
        # ``_WALL_EPOCH_US``) are exempt from age pruning and only bound
        # by the ring size.
        horizon_us = (
            time.time() - float(get_flag("rpcz_keep_span_seconds"))
        ) * 1e6

        with self._lock:
            if self._spans.maxlen != maxlen:
                if maxlen is not None and len(self._spans) > maxlen:
                    # the shrink evicts from the left: drop those spans
                    # from the trace index too
                    for old in list(self._spans)[: len(self._spans) - maxlen]:
                        self._index_drop(old)
                self._spans = deque(self._spans, maxlen=maxlen)
            # walk stale wall-clock spans off the left; exempt
            # (non-wall-time) heads are set aside so they don't shield
            # stale spans behind them, then restored in order.  The
            # set-aside is capped so a synthetic-heavy store (tests)
            # keeps submit O(1) amortized — production stores hold no
            # exempt spans and never touch the cap.
            exempt_heads = []
            while self._spans and len(exempt_heads) < 128:
                head = self._spans[0]
                if head.start_real_us <= _WALL_EPOCH_US:
                    exempt_heads.append(self._spans.popleft())
                    continue
                if head.start_real_us + head.latency_us < horizon_us:
                    self._index_drop(self._spans.popleft())
                    continue
                break  # completion-ordered: the rest are fresher
            while exempt_heads:
                self._spans.appendleft(exempt_heads.pop())
            if (
                self._spans.maxlen is not None
                and len(self._spans) == self._spans.maxlen
                and self._spans
            ):
                # deque(maxlen) evicts the head SILENTLY on append —
                # capture it first or the index leaks the evicted span
                self._index_drop(self._spans[0])
            self._spans.append(span)
            if self._spans and self._spans[-1] is span:
                self._index_add(span)  # maxlen=0 discards the append
        dbdir = str(get_flag("rpcz_database_dir"))
        if dbdir:
            self._persist(dbdir, span)

    def _persist(self, dbdir: str, span: Span) -> None:
        line = json.dumps(span_to_dict(span)) + "\n"
        path = os.path.join(dbdir, "rpcz.jsonl")
        with self._db_lock:
            try:
                if self._db_file is None or self._db_path != path:
                    os.makedirs(dbdir, exist_ok=True)
                    if self._db_file is not None:
                        self._db_file.close()
                    self._db_file = open(path, "a", encoding="utf-8")
                    self._db_path = path
                self._db_file.write(line)
                self._db_file.flush()
                if self._db_file.tell() > int(
                    get_flag("rpcz_database_max_bytes")
                ):
                    # rotate: one previous generation kept (.1), like the
                    # dump-file rotation elsewhere in this stack
                    self._db_file.close()
                    self._db_file = None
                    os.replace(path, path + ".1")
            except OSError:
                logger.warning("rpcz persistence failed", exc_info=True)
                try:
                    if self._db_file is not None:
                        self._db_file.close()
                except OSError:
                    pass
                self._db_file = None

    def close_db(self) -> None:
        """Close the persistence file (tests / reconfiguration)."""
        with self._db_lock:
            if self._db_file is not None:
                try:
                    self._db_file.close()
                except OSError:
                    pass
                self._db_file = None
                self._db_path = ""

    def recent(self, limit: int = 100) -> List[Span]:
        with self._lock:
            return list(self._spans)[-limit:]

    def by_trace(self, trace_id: int) -> List[Span]:
        # O(spans-in-trace) via the index maintained at submit/eviction
        # (a full-ring scan here stalled the submit path under the lock)
        with self._lock:
            return list(self._by_trace.get(trace_id, ()))

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._by_trace.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


def load_spans(path: str) -> List[Span]:
    """Read a persisted ``rpcz.jsonl`` back into ``Span`` objects — the
    round-trip twin of ``SpanStore._persist``. JSON has no tuple type, so
    annotation entries come back as lists; they are normalized to the
    ``(offset_us, text)`` tuples ``Span.annotations`` holds live (the
    asymmetry that made persisted and live spans compare unequal).
    Malformed lines are skipped, not fatal: a rotation or crash can leave
    a torn tail."""
    spans: List[Span] = []
    try:
        fh = open(path, "r", encoding="utf-8")
    except OSError:
        return spans
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue
            if not isinstance(d, dict):
                continue
            span = span_from_dict(d)
            if span is not None:
                spans.append(span)
    return spans


def span_to_dict(span: Span) -> dict:
    """One span as THE serialization schema — shared by ``rpcz.jsonl``
    persistence and ``/rpcz?json=1`` so ``span_from_dict`` reads either
    source; keep this the only copy of the key set."""
    return {
        "trace_id": span.trace_id,
        "span_id": span.span_id,
        "parent_span_id": span.parent_span_id,
        "type": span.span_type,
        "service": span.service,
        "method": span.method,
        "remote_side": span.remote_side,
        "log_id": span.log_id,
        "error_code": span.error_code,
        "start_real_us": span.start_real_us,
        "latency_us": span.latency_us,
        "request_size": span.request_size,
        "response_size": span.response_size,
        "annotations": [list(a) for a in span.annotations],
    }


def span_line(sp: Span) -> str:
    """The one-line human rendering shared by /rpcz and rpc_view."""
    return (
        f"trace={sp.trace_id:x} span={sp.span_id:x} parent={sp.parent_span_id:x} "
        f"{sp.span_type} {sp.service}.{sp.method} error={sp.error_code} "
        f"latency={sp.latency_us:.0f}us annotations={sp.annotations}"
    )


def render_trace_tree(spans: List[Span]) -> List[str]:
    """One trace as indented parent→child lines (span_id-keyed; spans
    whose parent is outside the set — usually parent 0 — are roots).
    Start-time ordering among siblings; cycle/orphan-safe."""
    by_id = {sp.span_id: sp for sp in spans}
    children: dict = {}
    roots = []
    for sp in sorted(spans, key=lambda s: s.start_real_us):
        if sp.parent_span_id in by_id and sp.parent_span_id != sp.span_id:
            children.setdefault(sp.parent_span_id, []).append(sp)
        else:
            roots.append(sp)
    lines: List[str] = []
    seen = set()

    def walk(root: Span) -> None:
        # explicit stack: a parent chain can be as deep as the ring is
        # large (rpcz_max_spans), far past the interpreter's frame limit
        stack = [(root, 0)]
        while stack:
            sp, depth = stack.pop()
            if sp.span_id in seen:
                continue
            seen.add(sp.span_id)
            lines.append("  " * depth + span_line(sp))
            for child in reversed(children.get(sp.span_id, [])):
                stack.append((child, depth + 1))

    for root in roots:
        walk(root)
    for sp in spans:  # cycles with no root: still shown, flat
        if sp.span_id not in seen:
            walk(sp)
    return lines


# the overlap scheduler's span annotation schema (parallel/mc_dispatch.py
# _start_step_span/_start_chunk_span; docs/OBSERVABILITY.md): a step's
# compute span vs its chunk sub-collectives' dispatch→ack spans
_COMPUTE_ANN_RE = re.compile(
    r"^compute step=(\d+)/(\d+) chunks=(\d+) schedule=(\S+)$"
)
_CHUNK_ANN_RE = re.compile(r"^chunk=(\d+)/(\d+) step=(\d+)$")


def overlap_report(spans: List[Span]) -> List[str]:
    """Quantify compute/communication overlap in one collective session's
    trace (the T3 proof view, docs/DEVICE_PLANE.md "overlap scheduler").

    Each chunk span is a sub-collective's dispatch→ack interval; step
    k's chunks are checked against step k+1's COMPUTE span — an ack that
    lands inside the next step's compute window is communication hidden
    behind compute, while a trace whose every chunk closes before the
    next compute span begins has regressed to the serialized schedule.
    Chunks are paired only with compute spans of the SAME party's chain
    (chunk spans parent to their step's compute span; step spans share a
    per-party session parent) — concurrent parties in one store run with
    mutual skew that would otherwise read as overlap.
    Returns human lines: one per overlapped chunk plus a verdict summary
    (``OVERLAPPED`` / ``SERIALIZED``); empty when the trace carries no
    chunk annotations (not an overlap session)."""
    by_id = {sp.span_id: sp for sp in spans}
    computes: dict = {}  # (party key, step index) -> (start_us, end_us)
    chunks = []  # (step, j, C, party key, start_us, end_us)
    for sp in spans:
        for _, text in sp.annotations:
            m = _COMPUTE_ANN_RE.match(text)
            if m is not None:
                computes[(sp.parent_span_id, int(m.group(1)))] = (
                    sp.start_real_us, sp.start_real_us + sp.latency_us
                )
                continue
            m = _CHUNK_ANN_RE.match(text)
            if m is not None:
                parent = by_id.get(sp.parent_span_id)
                party = parent.parent_span_id if parent is not None else 0
                chunks.append((
                    int(m.group(3)), int(m.group(1)), int(m.group(2)),
                    party,
                    sp.start_real_us, sp.start_real_us + sp.latency_us,
                ))
    if not chunks:
        return []
    chunks.sort()
    lines = []
    judged = overlapped = 0
    for step, j, c, party, cs, ce in chunks:
        nxt = computes.get((party, step + 1))
        if nxt is None:
            continue  # last step (or its compute span wasn't sampled)
        judged += 1
        ov = min(ce, nxt[1]) - max(cs, nxt[0])
        if ov > 0:
            overlapped += 1
            lines.append(
                f"step {step} chunk {j}/{c}: ack {ov:.0f}us inside step "
                f"{step + 1}'s compute window — overlapped"
            )
        else:
            lines.append(
                f"step {step} chunk {j}/{c}: closed {-ov:.0f}us before "
                f"step {step + 1}'s compute began — serialized"
            )
    verdict = "OVERLAPPED" if overlapped else "SERIALIZED"
    lines.append(
        f"# overlap: {overlapped}/{judged} chunk acks inside the next "
        f"step's compute window — {verdict}"
        + ("" if judged else " (no adjacent compute spans sampled)")
    )
    return lines


def span_from_dict(d: dict) -> Optional[Span]:
    """One persisted/serialized span dict (the rpcz.jsonl and
    ``/rpcz?json=1`` schema) back into a ``Span``; None when the dict is
    malformed."""
    try:
        return Span(
            trace_id=int(d.get("trace_id", 0)),
            span_id=int(d.get("span_id", 0)),
            parent_span_id=int(d.get("parent_span_id", 0)),
            span_type=str(d.get("type", SPAN_TYPE_CLIENT)),
            service=str(d.get("service", "")),
            method=str(d.get("method", "")),
            remote_side=str(d.get("remote_side", "")),
            log_id=int(d.get("log_id", 0)),
            error_code=int(d.get("error_code", 0)),
            start_real_us=int(d.get("start_real_us", 0)),
            latency_us=float(d.get("latency_us", 0.0)),
            request_size=int(d.get("request_size", 0)),
            response_size=int(d.get("response_size", 0)),
            annotations=[
                (float(a[0]), str(a[1]))
                for a in d.get("annotations", [])
                if isinstance(a, (list, tuple)) and len(a) == 2
            ],
        )
    except (TypeError, ValueError, AttributeError):
        return None


span_store = SpanStore()
_limiter = _SpeedLimiter()


# the generator span and trace ids come from: None = the process-global
# generator of ``random`` (the JAX package's draw)
_id_rng: Optional[random.Random] = None


def set_id_rng(rng: Optional[random.Random]) -> Optional[random.Random]:
    """Draw span and trace ids from ``rng`` (None restores the
    process-global generator); returns the previous one. A seeded
    ``random.Random`` makes a traced script's ids reproducible."""
    global _id_rng
    old, _id_rng = _id_rng, rng
    return old


def _new_id() -> int:
    return (_id_rng or random).getrandbits(63) | 1


def in_trace_context() -> bool:
    """True when a server span is active on this thread — a cascaded
    client call made here belongs to an observable trace, so its Dapper
    ids must reach the wire even if this hop doesn't sample."""
    return getattr(_tls, "parent_span", None) is not None


def current_trace_context():
    """The ambient (thread-local) trace context, or ``(0, 0)``: the
    active server span's ``(trace_id, span_id)`` — what a piece of
    non-RPC work started inside a handler (a collective session
    proposal, a background pump) should stamp on ITS outbound calls so
    the whole fan-out joins the caller's trace."""
    parent: Optional[Span] = getattr(_tls, "parent_span", None)
    if parent is None:
        return 0, 0
    return parent.trace_id, parent.span_id


def rpcz_enabled() -> bool:
    return bool(get_flag("enable_rpcz"))


# -- client side (channel.cpp:343 Span::CreateClientSpan) --------------------


def start_client_span(cntl) -> Optional[Span]:
    """Create a sampled client span; always propagates trace ids into the
    controller (so downstream server spans correlate even when this hop
    doesn't sample).  Also decides the HEAD-BASED sampled bit for the
    wire (``cntl.trace_sampled``): set when this hop collects a span, or
    when it is inside an already-sampled trace (the ambient server span
    exists, or the caller pre-set the bit) — the decision is made once
    at the edge and then propagated like the deadline, so a sampled
    trace yields spans at EVERY hop instead of an incoherent scatter."""
    parent: Optional[Span] = getattr(_tls, "parent_span", None)
    if parent is not None:
        cntl.trace_id = parent.trace_id
        cntl.parent_span_id = parent.span_id
        if not cntl.span_id:
            cntl.span_id = _new_id()
    elif not cntl.trace_id:
        cntl.trace_id = _new_id()
        cntl.span_id = _new_id()
    elif not cntl.span_id:
        cntl.span_id = _new_id()
    span = None
    if rpcz_enabled() and _limiter.grab():
        span = Span(
            trace_id=cntl.trace_id,
            span_id=cntl.span_id,
            parent_span_id=parent.span_id if parent is not None else 0,
            span_type=SPAN_TYPE_CLIENT,
            service=cntl._service,
            method=cntl._method,
            log_id=cntl.log_id,
            start_real_us=int(time.time() * 1e6),
            request_size=len(cntl._request_payload),
        )
    if span is not None or parent is not None:
        # this hop sampled, or the serving span upstream did: the bit
        # rides the wire so downstream hops sample coherently
        cntl.trace_sampled = 1
    return span


def end_client_span(cntl) -> None:
    span = cntl._span
    if span is None:
        return
    span.latency_us = cntl.latency_us
    span.error_code = cntl.error_code
    span.remote_side = str(cntl.remote_side) if cntl.remote_side else ""
    span.response_size = len(cntl.response_payload)
    span_store.submit(span)
    cntl._span = None


# -- server side (protocol ProcessRequest, Span::CreateServerSpan) -----------


def start_server_span(cntl, meta) -> Optional[Span]:
    """Server span for one request.  The wire's head-based sampled bit
    (``meta.sampled`` — RpcRequestMeta field 9 / the tbus ``sampled``
    key) OVERRIDES the local token-bucket election: the edge already
    decided this trace is observed, so this hop must not break it (the
    edge's own limiter bounded how many traces start sampled)."""
    forced = bool(getattr(meta, "sampled", 0))
    if not rpcz_enabled() or (not _limiter.grab() and not forced):
        return None
    span = Span(
        trace_id=meta.trace_id or _new_id(),
        span_id=_new_id(),
        parent_span_id=meta.span_id,
        span_type=SPAN_TYPE_SERVER,
        service=meta.service,
        method=meta.method,
        log_id=meta.log_id,
        start_real_us=int(time.time() * 1e6),
        request_size=len(cntl._request_payload),
    )
    _tls.parent_span = span  # nested client calls inherit (span.h:72-75)
    return span


def clear_parent_span(span) -> None:
    """Called by the server on the *worker thread* when the handler returns
    (sync or async): the parent-span window is handler execution only, so an
    async completion on another thread can never leave a stale parent in
    this worker's TLS."""
    if span is not None and getattr(_tls, "parent_span", None) is span:
        _tls.parent_span = None


def start_custom_span(
    span_type: str,
    service: str,
    method: str,
    trace_id: int = 0,
    parent_span_id: int = 0,
    forced: bool = False,
) -> Optional[Span]:
    """Sampled span for non-RPC work (collective sessions, background
    pumps). With no explicit ids it parents to this thread's active server
    span (the tls_bls.rpcz_parent_span rule, span.h:72-75); a caller that
    has the proposing RPC's ids passes them so the span lands in the
    client's trace even across the async handoff.  ``forced`` is the
    head-based coherent-sampling override: work inside a trace the edge
    already sampled must not drop its span to a dry local bucket."""
    if not rpcz_enabled() or (not _limiter.grab() and not forced):
        return None
    parent: Optional[Span] = getattr(_tls, "parent_span", None)
    if not trace_id and parent is not None:
        trace_id = parent.trace_id
        parent_span_id = parent.span_id
    return Span(
        trace_id=trace_id or _new_id(),
        span_id=_new_id(),
        parent_span_id=parent_span_id,
        span_type=span_type,
        service=service,
        method=method,
        start_real_us=int(time.time() * 1e6),
    )


def end_custom_span(span: Optional[Span], error_code: int = 0) -> None:
    if span is None:
        return
    span.latency_us = time.time() * 1e6 - span.start_real_us
    span.error_code = error_code
    span_store.submit(span)


def end_server_span(cntl, response_size: int = 0) -> None:
    span = cntl._span
    if span is None:
        return
    if getattr(_tls, "parent_span", None) is span:
        _tls.parent_span = None
    span.latency_us = cntl.latency_us
    span.error_code = cntl.error_code
    span.remote_side = str(cntl.remote_side) if cntl.remote_side else ""
    span.response_size = response_size
    span_store.submit(span)
    cntl._span = None
