"""Collective method plane — the session plane of
``incubator_brpc_tpu/parallel/mc_dispatch.py``: a session runs K lockstep
steps of ANY registered device method over P parties, proposed over the
host RPC plane.

A session runs K lockstep steps of a registered device method's kernel
over P parties, the operands staying on the device through the chain. The
kernel takes the party axis (``parallel/mesh.py``) where the JAX kernel
names ``"par"``:

    kernel(data: uint8[P_local, width], n: int32[P_local], axis)
        -> (uint8[P_local, width], int32[P_local])

Two forms, chosen by the JAX package's rule "a party places the shards it
can address" (its ``run_dispatch_session``, :1043-1051):

- **single controller** (this process joined no job,
  ``utils/distributed.py``): every party is addressable. The state is one
  ``[P, width]`` uint8 tensor on one device (``n`` an int32 ``[P]``), party
  ``i``'s row is row ``i``, and party ids are labels of the rows. A
  handler serving one party of a session computes the whole session, as
  the JAX package's in-process tier does.
- **one party per rank** (this process is a rank of a job): party ids are
  ranks, only ``party_ids[own_index]`` (this process's rank) is
  addressable, and the state is this party's own row ``[1, width]``. The
  session's collectives run over a process group of its ranks in party
  order, one group a run (``session_group``, keyed by session id and
  epoch), released at the run's end and on abort: dropping it closes its
  connections, which fails a peer's pending collective at once (gloo's
  ``abort()`` does not). The group's timeout is the session's deadline.

What a session offers is the JAX function's: ``steps``,
``resume_from``/``resume_state`` and ``checkpoint_every`` (the checkpoint
rings, which hold the rows this process holds: every row, or its own),
the step watchdog (``step_deadline_ms``), ``chunks``/``double_buffer``/
``chunk_order`` (the overlap scheduler: a chunk is a view of the state cut
at a multiple of the method's ``chunk_align``), ``quantize`` (the K2
variants of ``parallel/quantized.py``, whose rings hold the quantized
state), and the same counters. The chunk acks are CUDA events recorded
after each chunk's launch (always ready on the CPU); the serialized
schedule's barrier is their ``synchronize()``.

The RPC half is the JAX module's: a proposer (``propose_dispatch``)
validates the session against every party's registry by fingerprint (the
accept phase; ``make_dispatch_handler`` answers it), folds the parties'
step targets with max, runs it (the run phase, watched: a dead or
rejecting party aborts the session on every survivor), and collects every
party's final row; ``propose_with_recovery`` heals a dead party from a
spare, resuming from the survivors' common checkpoint where the dead
slot's rows are reachable; ``lower_parallel_call`` runs a ParallelChannel
call over multi-controller links as a one-step session. The
topology-aware scheduler (``schedule_session_order``) orders parties and
chunks by the measured speed of this process's device links
(``transport/device_link.py`` ``link_profile()``). Every session, and in
an overlapped session every step's compute window and every chunk's
dispatch→ack, leaves an rpcz span of type ``collective``
(``builtin/rpcz.py``) annotated with the method's identity; the proposal
carries the proposer's trace context (its ambient server span, or a fresh
trace with rpcz on, sampled at the edge), so every party's spans join one
trace.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from incubator_brpc_tpu_torch.builtin import rpcz
from incubator_brpc_tpu_torch.bvar import Adder, LatencyRecorder, PassiveStatus
from incubator_brpc_tpu_torch.parallel import quantized as _quantized
from incubator_brpc_tpu_torch.parallel.mesh import DistributedPartyAxis, PartyLost, party_axis
from incubator_brpc_tpu_torch.rpc.device_method import lookup_device_method
from incubator_brpc_tpu_torch.utils import distributed as _dist
from incubator_brpc_tpu_torch.utils.device import DeviceLike, resolve_device
from incubator_brpc_tpu_torch.utils.flags import get_flag
from incubator_brpc_tpu_torch.utils.status import ErrorCode, berror

logger = logging.getLogger(__name__)

DISPATCH_METHOD = "collective_dispatch"

# Bounds a proposal must sit inside before anything is resolved or run
# (the JAX module's, mc_collective's admission checks mirror them)
MAX_STEPS = 100_000
MAX_WIDTH = 1 << 20
MAX_PARTIES = 1024
# chunked overlap sessions: a step's operand may split into at most this
# many independently-dispatched sub-collectives
MAX_CHUNKS = 64

# plane-level observability: sessions/steps/errors/rejects across every
# kernel, plus a latency summary; per-kernel counters are minted lazily
# below. errors, rejects, resumes and replaced_parties are bumped by the
# proposal path.
dispatch_sessions = Adder(name="mc_dispatch_sessions")
dispatch_steps = Adder(name="mc_dispatch_steps")
dispatch_errors = Adder(name="mc_dispatch_errors")
dispatch_rejects = Adder(name="mc_dispatch_rejects")
dispatch_aborts = Adder(name="mc_dispatch_aborts")
dispatch_resumes = Adder(name="mc_dispatch_resumes")
dispatch_replaced_parties = Adder(name="mc_dispatch_replaced_parties")
dispatch_session_us = LatencyRecorder(name="mc_dispatch_session_us")
# the overlap scheduler's proof-of-overlap counters: chunk sub-collectives
# dispatched, and how many of them were dispatched while the SAME slice's
# predecessor was still in flight (its ack event not yet reached) — their
# ratio is the measured overlap, mc_dispatch_overlap_ratio.  Tallied once
# per session, not per chunk.
dispatch_chunks = Adder(name="mc_dispatch_chunks")
dispatch_overlapped_chunks = Adder(name="mc_dispatch_overlapped_chunks")
# the quantized-collective plane (parallel/quantized.py): sessions that
# ran a quantized kernel variant, and the cumulative wire bytes the
# quantization removed vs the same session at exact float32 width
# (parties x replayed steps x (width - quantized wire bytes), tallied
# once per session)
dispatch_quantized_sessions = Adder(name="mc_dispatch_quantized_sessions")
dispatch_bytes_saved = Adder(name="mc_dispatch_bytes_saved")


def _overlap_ratio() -> float:
    total = dispatch_chunks.get_value()
    if not total:
        return 0.0
    return dispatch_overlapped_chunks.get_value() / total


overlap_ratio_gauge = PassiveStatus(
    _overlap_ratio, name="mc_dispatch_overlap_ratio"
)

_method_counters: Dict[Tuple[str, str], Adder] = {}
_method_counters_lock = threading.Lock()


def _method_counter(service: str, method: str) -> Adder:
    """Per-kernel session counter (``mc_dispatch_<svc>_<m>_sessions``),
    minted on first use — the bvar registry keeps it scrapeable."""
    key = (service, method)
    with _method_counters_lock:
        ctr = _method_counters.get(key)
        if ctr is None:
            safe = "_".join(
                "".join(c if c.isalnum() else "_" for c in part)
                for part in key
            )
            ctr = Adder(name=f"mc_dispatch_{safe}_sessions")
            _method_counters[key] = ctr
        return ctr


# -- session fault plane -------------------------------------------------------
#
# Every party that serves a session registers it here with a deadline and
# an abort event; an abort (party death, deadline, the step watchdog)
# flips every local registrant, and each party's ``should_abort`` reads its
# registrant, so the chain exits between steps with a clean ESESSION.


class SessionAborted(RuntimeError):
    """A collective session aborted (party death, deadline, or reject).

    ``dead_indexes``/``survivor_indexes`` are party positions in the
    proposal's order — the re-propose path runs the next session over
    exactly ``survivor_indexes``."""

    def __init__(
        self,
        reason: str,
        dead_indexes=(),
        survivor_indexes=(),
        rejects=(),
        session_id: str = "",
        final_steps: int = 0,
    ):
        super().__init__(reason)
        self.error_code = int(ErrorCode.ESESSION)
        self.reason = reason
        self.dead_indexes = tuple(dead_indexes)
        self.survivor_indexes = tuple(survivor_indexes)
        self.rejects = tuple(rejects)  # (index, error_text) non-death fails
        # what the resume path needs: the aborted session's identity (its
        # checkpoint rings are keyed on it) and the agreed step count the
        # resumed run must still converge to
        self.session_id = session_id
        self.final_steps = int(final_steps)


class _SessionState:
    __slots__ = (
        "session_id", "party_ids", "owner", "deadline", "abort_event",
        "abort_reason", "aborted", "epoch",
    )

    def __init__(self, session_id, party_ids, deadline, owner, epoch=0):
        self.session_id = session_id
        self.party_ids = tuple(party_ids)
        self.owner = owner  # the serving Server (None on the proposer)
        self.deadline = deadline  # absolute monotonic seconds (0 = none)
        self.abort_event = threading.Event()
        self.abort_reason = ""
        self.aborted = False
        # which RUN of this session this registrant belongs to: a RESUMED
        # run re-registers the SAME session id at epoch+1, and an abort
        # stamped with an older epoch must not kill the healed run
        self.epoch = int(epoch)


# session id -> every local registrant (in a single-controller run several
# parties of ONE session live in one process; an abort must unwedge all)
_sessions: Dict[str, List[_SessionState]] = {}
_sessions_lock = threading.Lock()

# abort tombstones: session id -> highest epoch aborted SO FAR, so a run
# of an already-aborted epoch that registers after the abort is refused
# instead of starting a chain no peer will join.  Insertion-ordered,
# capped (dead sessions age out).
_MAX_TOMBSTONES = 256
_aborted_epochs: Dict[str, int] = {}


def aborted_epoch(session_id: str) -> int:
    """Highest aborted epoch for a session (-1 = never aborted here)."""
    with _sessions_lock:
        return _aborted_epochs.get(session_id, -1)


def _register_session(session_id, party_ids, deadline, owner=None, epoch=0):
    st = _SessionState(session_id, party_ids, deadline, owner, epoch=epoch)
    with _sessions_lock:
        _sessions.setdefault(session_id, []).append(st)
    return st


def _unregister_session(st: _SessionState) -> None:
    with _sessions_lock:
        states = _sessions.get(st.session_id)
        if states is not None:
            try:
                states.remove(st)
            except ValueError:
                pass
            if not states:
                del _sessions[st.session_id]


def active_sessions(owner=None) -> int:
    """Live (registered, not yet closed) session registrations — all of
    them, or only those served by ``owner``."""
    with _sessions_lock:
        return sum(
            1
            for states in _sessions.values()
            for st in states
            if owner is None or st.owner is owner
        )


def abort_session(
    session_id: str, reason: str, epoch: Optional[int] = None
) -> bool:
    """Flip local registrants of one session to aborted (idempotent;
    counted once per session per process).  ``epoch`` scopes the abort to
    registrants of that run or older; None aborts every registrant.
    Returns False when nothing matched — already closed, never registered
    here, or all registrants newer than the stamped epoch."""
    with _sessions_lock:
        states = [
            st
            for st in _sessions.get(session_id, ())
            if epoch is None or st.epoch <= epoch
        ]
        # tombstone the aborted epoch(s): an epoch-stamped abort
        # tombstones even with no registrant yet; an unstamped (local)
        # abort tombstones whatever it actually hit.
        stone = epoch if epoch is not None else max(
            (st.epoch for st in states), default=None
        )
        if stone is not None and _aborted_epochs.get(session_id, -1) < stone:
            while len(_aborted_epochs) >= _MAX_TOMBSTONES:
                _aborted_epochs.pop(next(iter(_aborted_epochs)))
            _aborted_epochs[session_id] = stone
        if not states:
            return False
        first = any(not st.aborted for st in states)
        for st in states:
            st.aborted = True
            if not st.abort_reason:
                st.abort_reason = reason
    if first:
        dispatch_aborts << 1
        logger.warning("mc_dispatch session %s aborted: %s", session_id, reason)
    for st in states:
        st.abort_event.set()
    return True


def abort_sessions_for_owner(owner, reason: str) -> int:
    """Abort every session served by one Server — the chaos drill's
    clean-death seam (a killed party's own handler must unwedge promptly
    instead of burning its session deadline) and a stop-time sweep for
    anything that outlived a drain. Returns the number of sessions hit."""
    with _sessions_lock:
        hit = [
            sid for sid, states in _sessions.items()
            if any(st.owner is owner for st in states)
        ]
    for sid in hit:
        abort_session(sid, reason)
    return len(hit)


def abort_sessions_for_devices(ranks, reason: str) -> int:
    """Link-death feedback (``DeviceLink.fail`` calls here): any active
    session with a party on one of these job RANKS aborts — the link that
    carried traffic between them is gone. The JAX package keys this by
    global device id; a multi-controller link's party is its rank here,
    since on one card every process holds ``cuda:0``. Returns the number
    of sessions aborted."""
    dead = set(int(r) for r in ranks)
    with _sessions_lock:
        hit = [
            sid for sid, states in _sessions.items()
            if any(dead & set(st.party_ids) for st in states)
        ]
    for sid in hit:
        abort_session(sid, reason)
    return len(hit)


# -- step-granular checkpoint rings --------------------------------------------
#
# With ``checkpoint_every`` set, each party retains a device-resident ring
# of its last ``mc_dispatch_checkpoint_depth`` completed-step states, keyed
# by (session_id, own party index).  An aborted session's rings survive the
# abort so a resume can start from the last COMMON checkpointed step and
# replay only the steps past it.  Rings are released on clean completion
# and capped by an oldest-session eviction.  Entries hold the session's
# tensors (the rows this process holds, ``ring.slots``: every party's, or
# its own; a step's kernel returns new tensors, so retaining them is free)
# and a CUDA event recorded after them: an entry counts toward the resume
# census only once the card has reached it.

_MAX_CHECKPOINT_SESSIONS = 16


class _QuantCk:
    """A quantized checkpoint payload: the ring entry of a QUANTIZED
    session stores the block-quantized state (values + int8 scale
    exponents, from K2a) instead of the float32 rows — the same ~4x the
    wire saves, applied to the ring's device memory.  Power-of-two scales
    make dequantize→requantize exactly idempotent (parallel/quantized.py),
    so a chain restored from this entry replays byte-identically."""

    __slots__ = ("q", "e", "mode", "block", "width")

    def __init__(self, q, e, mode: str, block: int, width: int):
        self.q = q
        self.e = e
        self.mode = mode
        self.block = int(block)
        self.width = int(width)

    def shard_row(self, row: int) -> np.ndarray:
        """The full-width uint8 state row of one party (host-side
        dequantize via the numpy twin — bitwise equal to K2b, resume path
        only)."""
        with np.errstate(over="ignore"):  # a block at FLT_MAX dequantizes to inf
            f = _quantized.np_dequantize(
                self.q[row].cpu().numpy().reshape(-1),
                self.e[row].cpu().numpy().reshape(-1),
                self.mode,
                self.block,
            )
        return np.frombuffer(f.astype(np.float32).tobytes(), dtype=np.uint8).copy()


def _payload_row(payload, row: int) -> np.ndarray:
    """Full-width uint8 state row ``row`` of a ring payload.  One accessor
    for both entry formats so the reshard and restore paths cannot diverge
    on representation."""
    if isinstance(payload, _QuantCk):
        return payload.shard_row(row)
    return payload[row].cpu().numpy().astype(np.uint8)


def _record_event(device: torch.device) -> Optional["torch.cuda.Event"]:
    """An event after everything queued so far on ``device``'s current
    stream (None on the CPU, where everything has run)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class _CheckpointRing:
    __slots__ = ("session_id", "own_index", "party_ids", "slots", "entries",
                 "entry_bytes")

    def __init__(self, session_id, own_index, party_ids, entry_bytes, slots=None):
        self.session_id = session_id
        self.own_index = int(own_index)
        self.party_ids = tuple(party_ids)  # the session's party labels
        # the party slots of the payload's rows, in row order: every slot
        # (single controller) or the own one (one party per rank)
        self.slots = tuple(range(len(party_ids)) if slots is None else slots)
        self.entries = []  # ascending [(completed_step, x, ns, event)]
        self.entry_bytes = int(entry_bytes)  # retained bytes per entry

    def put(self, step: int, x, ns, depth: int) -> None:
        # a RESUMED run replays step numbers the aborted run already
        # checkpointed: the fresh entry REPLACES the stale one
        step = int(step)
        self.entries = [e for e in self.entries if e[0] != step]
        self.entries.append((step, x, ns, _record_event(ns.device)))
        self.entries.sort(key=lambda e: e[0])
        while len(self.entries) > depth:
            self.entries.pop(0)

    @staticmethod
    def _ready(event) -> bool:
        """Checkpoints are retained when their step is dispatched (the
        chain is asynchronous); an entry only counts toward the resume
        census once the card has computed it."""
        return event is None or event.query()

    def watermark(self) -> int:
        steps = self.steps()
        return max(steps) if steps else 0

    def steps(self):
        return [s for s, _x, _n, ev in self.entries if self._ready(ev)]

    def get(self, step: int):
        for s, x, ns, _ev in self.entries:
            if s == step:
                return x, ns
        return None


# session id -> {own_index: ring}; insertion-ordered for eviction
_checkpoints: Dict[str, Dict[int, _CheckpointRing]] = {}
_checkpoints_lock = threading.Lock()


def _checkpoint_ring(session_id, own_index, party_ids, entry_bytes, slots=None):
    """Get-or-create the ring for one party of one session (evicting the
    oldest session past the cap — bounded device memory, not a leak).
    Eviction prefers sessions with no LIVE registrant.  (The live set is
    snapshotted before taking the ring lock — no lock nesting.)"""
    with _sessions_lock:
        live = set(_sessions)
    with _checkpoints_lock:
        rings = _checkpoints.get(session_id)
        if rings is None:
            while len(_checkpoints) >= _MAX_CHECKPOINT_SESSIONS:
                victim = next(
                    (s for s in _checkpoints if s not in live),
                    next(iter(_checkpoints)),  # all live: cap still wins
                )
                _checkpoints.pop(victim)
            rings = _checkpoints.setdefault(session_id, {})
        ring = rings.get(int(own_index))
        if ring is None:
            ring = _CheckpointRing(
                session_id, own_index, party_ids, entry_bytes, slots
            )
            rings[int(own_index)] = ring
        return ring


def _checkpoint_lookup(session_id, own_index):
    with _checkpoints_lock:
        return _checkpoints.get(session_id, {}).get(int(own_index))


def checkpoint_watermarks(session_id: str) -> Dict[int, dict]:
    """Every LOCAL party's checkpoint census for one session: {party
    index: {"watermark": last checkpointed step, "steps": retained
    steps}}."""
    with _checkpoints_lock:
        rings = list(_checkpoints.get(session_id, {}).values())
    return {
        r.own_index: {"watermark": r.watermark(), "steps": r.steps()}
        for r in rings
    }


def release_checkpoints(session_id: str) -> bool:
    """Drop every local ring of one session (idempotent)."""
    with _checkpoints_lock:
        return _checkpoints.pop(session_id, None) is not None


def checkpoint_bytes_retained() -> int:
    """Device bytes pinned by checkpoint rings across every session —
    the cost side of the checkpoint-depth tradeoff, scrapeable."""
    with _checkpoints_lock:
        return sum(
            len(r.entries) * r.entry_bytes
            for rings in _checkpoints.values()
            for r in rings.values()
        )


checkpoint_bytes_gauge = PassiveStatus(
    checkpoint_bytes_retained, name="mc_dispatch_checkpoint_bytes"
)


def _checkpoint_rows(
    session_id: str, step: int, slots
) -> Dict[int, Tuple[bytes, int]]:
    """Materialize checkpointed rows for the requested party slots at one
    step, from ANY local ring that holds them — the reshard source a
    replacement party is bootstrapped from.  Returns {slot: (full-width
    row bytes, n)} for every slot this process can serve (possibly
    empty).  The one host-blocking checkpoint operation; resume path
    only."""
    want = [int(s) for s in slots]
    with _checkpoints_lock:
        rings = list(_checkpoints.get(session_id, {}).values())
    out: Dict[int, Tuple[bytes, int]] = {}
    for ring in rings:
        entry = ring.get(int(step))
        if entry is None:
            continue
        x, ns = entry
        for slot in want:
            if slot in out or slot not in ring.slots:
                continue
            pos = ring.slots.index(slot)
            # the wire format is always the FULL-WIDTH row: a quantized
            # ring dequantizes here (exact — power-of-two scales), so
            # the reshard protocol never forks on representation
            out[slot] = (_payload_row(x, pos).tobytes(), int(ns[pos]))
    return out


def checkpoint_fetch(session_id: str, step: int, slots) -> Dict[int, dict]:
    """The wire form of :func:`_checkpoint_rows`:
    {slot: {"row": b64 full-width row bytes, "n": int}}."""
    return {
        slot: {"row": base64.b64encode(row).decode(), "n": int(n)}
        for slot, (row, n) in _checkpoint_rows(session_id, step, slots).items()
    }


def resume_point(watermarks: Dict[int, Optional[dict]]) -> int:
    """The resume barrier's join: the last COMMON checkpointed step over
    the survivors — ``min`` over their watermarks (a session can only
    resume from a step EVERY survivor retained).  ``watermarks[slot]`` is
    a census answer ({"watermark", "steps"}) or None for a survivor that
    answered nothing.  Any survivor with no checkpoint drags the join to
    0 — the full-restart fallback.  When the min is not retained by
    every survivor (an evicted entry), the join falls back to the deepest
    step ALL survivors still retain, then to 0."""
    if not watermarks:
        return 0
    infos = list(watermarks.values())
    if any(not info or int(info.get("watermark", 0)) <= 0 for info in infos):
        return 0
    point = min(int(info["watermark"]) for info in infos)
    sets = [frozenset(int(s) for s in info.get("steps", ())) for info in infos]
    if all(point in s for s in sets):
        return point
    common = frozenset.intersection(*sets) if sets else frozenset()
    return max((s for s in common if s <= point), default=0)


# Between-step seam: chaos drills park parties here and production leaves
# it None.  Called as fn(step_index) — or fn(step_index, own_index) /
# fn(step_index, own_index, chunk) when it accepts more arguments — before
# each step (1/2-arg forms fire once per step; the 3-arg form fires before
# every chunk of a chunked session).
_step_hook: Optional[Callable] = None


def set_step_hook(fn: Optional[Callable]) -> None:
    global _step_hook
    if fn is not None:
        import inspect

        try:
            nparams = len(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            nparams = 1
        if nparams < 2:
            inner1 = fn
            fn = (  # noqa: E731
                lambda step, idx, chunk, _f=inner1:
                _f(step) if chunk == 0 else None
            )
        elif nparams < 3:
            inner2 = fn
            fn = (  # noqa: E731
                lambda step, idx, chunk, _f=inner2:
                _f(step, idx) if chunk == 0 else None
            )
    _step_hook = fn


# -- kernel resolution ---------------------------------------------------------

# Fallback resolvers for builtin kernels that are minted per-geometry
# rather than registered (mc_collective's pmean installs one).
# Signature: (service, method, width_bytes) -> Optional[DeviceMethod].
_resolvers: List[Callable] = []


def register_method_resolver(fn: Callable) -> None:
    if fn not in _resolvers:
        _resolvers.append(fn)


def resolve_method(service: str, method: str, width: Optional[int] = None):
    """Resolve (service, method) to this process's DeviceMethod: the
    process-global registry first, then the builtin resolvers. ``width``
    (row bytes) must match the resolved geometry."""
    dm = lookup_device_method(service, method)
    if dm is None:
        for r in list(_resolvers):
            dm = r(service, method, width)
            if dm is not None:
                break
    if dm is None:
        return None
    if width is not None and dm.width != width:
        return None
    return dm


def _party_ranks(party_ids: List[int]) -> Optional[_dist.Job]:
    """The JAX package's ``_devices_by_id`` as a check of party ids against
    this process's job: None without a job (single controller: every id is
    a label and every party addressable); with one, every id must be a
    rank of it (else ValueError, the proposal's EREQUEST) and the job is
    returned."""
    job = _dist.current_job()
    if job is None:
        return None
    for pid in party_ids:
        if not 0 <= int(pid) < job.world_size:
            raise ValueError(
                f"party id {pid} is no rank of this process's job of "
                f"{job.world_size} (a session across processes names ranks)"
            )
    return job


class RunLimit:
    """The collective services' admission of session RUNS
    (``ServerOptions.collective_max_concurrency``, 0 = unlimited): a run
    past it is refused with ELIMIT instead of stacking device work behind
    a wedged chain. Accepts and the control phases (abort, the resume
    census, the reshard, the release) are never refused, and a run's slot
    is free before its answer leaves: an abort must reach a party whose
    only slot the aborted run holds, and the next session's run must find
    the slot its predecessor held. (The JAX package limits the whole
    method, so there an abort can be refused while a run holds the slot.)"""

    def __init__(self, limit: int):
        self.limit = max(0, int(limit))
        self._n = 0
        self._lock = threading.Lock()

    def enter(self) -> bool:
        with self._lock:
            if self.limit and self._n >= self.limit:
                return False
            self._n += 1
            return True

    def leave(self) -> None:
        with self._lock:
            self._n -= 1


class _GroupHandle:
    """The one strong reference to a run's session group: the party axis
    reaches the group through it, and :meth:`release` drops it, which
    closes the group's connections (the group is destroyed here unless a
    collective on it is still pending). Its first all_gather waits for
    the collective, then calls ``forget`` (which takes this party's
    rendezvous entry out of the job's store)."""

    __slots__ = ("pg", "forget")

    def __init__(self, pg, forget=None):
        self.pg = pg
        self.forget = forget

    def allgather(self, outs, ins):
        if self.pg is None:
            raise RuntimeError("the session group was released")
        work = self.pg.allgather(outs, ins)
        forget, self.forget = self.forget, None
        if forget is not None:
            work.wait()
            forget()
        return work

    def release(self) -> None:
        self.pg = None


def _join_session_group(session_id, epoch, party_ids, job, timeout_s, should_abort):
    """Join this run's session group. gloo's rendezvous cannot be left
    once entered (it waits its timeout for a missing party), so the parties
    first meet on a counter in the job's store, polled every millisecond
    with the abort checked in between: a party that is aborted (or times
    out) before all arrived takes itself off the counter atomically and
    never enters the rendezvous; once the counter reached every party, all
    of them build the group (an aborted one then drops it at its first
    abort check, which fails the others' first gather)."""
    key = f"session-arrivals/{session_id}/{int(epoch)}"
    n = len(party_ids)
    deadline = time.monotonic() + timeout_s
    count = job.store.add(key, 1)
    while count < n:
        why = should_abort() if should_abort is not None else None
        if not why and time.monotonic() > deadline:
            why = f"the session group did not form within {timeout_s:g} s"
        if why:
            if job.store.add(key, -1) != n - 1:
                raise SessionAborted(why)  # left before the last party arrived
            job.store.add(key, 1)  # the last arrived meanwhile: build it too
            break
        time.sleep(0.001)
        count = job.store.add(key, 0)
    pg = _dist.session_group(session_id, epoch, party_ids, job.backend, timeout_s, job=job)
    # the group forms only once every party has left the counter's loop,
    # so the counter is read no more: the first party drops it from the store
    if job.rank == int(party_ids[0]):
        job.store.delete_key(key)
    group_rank = [int(p) for p in party_ids].index(job.rank)
    return _GroupHandle(
        pg,
        lambda: _dist.forget_session_rendezvous(session_id, epoch, group_rank, job.backend, job=job),
    )


# -- the lockstep step ---------------------------------------------------------


def _make_step(dm, axis):
    """One step of the chain: the resolved kernel over every party's row.
    A chunk step is the same call on a chunk's view — a chunk-safe kernel
    applied to a slice yields the slice of the full-width result, so the
    chunked chain's bytes match the unchunked chain's."""

    def step(x, ns):
        return dm.kernel(x, ns, axis)

    return step


def _make_chunk_ops(width: int, chunks: int):
    """Split/concat between the full-width session state and its C
    column chunks: the split hands out views (no copy; each chunk starts
    at a multiple of the chunk width), the concat is one copy."""
    cw = width // chunks

    def split(full):
        return tuple(full[:, j * cw:(j + 1) * cw] for j in range(chunks))

    def concat(*parts):
        return torch.cat(parts, dim=1)

    return split, concat


def _make_ck_quant(dm):
    """Checkpoint quantizer for a quantized session: the uint8 state
    ``[P_local, width]`` -> (wire values, int8 exponents) of every row, one
    K2a launch.  Retaining them IS the checkpoint."""
    mode, block = dm.quant_mode, dm.quant_block

    def qz(x):
        return _quantized._tq_quantize(x.view(torch.float32), mode, block)

    return qz


# fabriclint: hotpath
def _chunk_ready(event) -> bool:
    """Non-blocking chunk-ack probe — the overlap scheduler's per-chunk
    observation point: the CUDA event recorded after the chunk's launch
    (None on the CPU, where the chunk has run)."""
    return event is None or event.query()


def _validate_chunks(dm, chunks, service: str, method: str) -> int:
    """Chunk admission: returns the normalized chunk count; raises
    ValueError before any step."""
    chunks = int(chunks or 1)
    if not (1 <= chunks <= MAX_CHUNKS):
        raise ValueError(f"chunks {chunks} outside 1..{MAX_CHUNKS}")
    if dm.width % chunks != 0:
        raise ValueError(
            f"chunks {chunks} does not divide method width {dm.width}"
        )
    if chunks > 1 and not getattr(dm, "chunkable", False):
        # chunk-safety is a registration-time declaration: a silently
        # mis-chunked kernel would diverge, not fail
        raise ValueError(
            f"device method {service}.{method} is not registered "
            "chunkable (chunked overlap sessions need the chunk-safety "
            "declaration)"
        )
    align = int(getattr(dm, "chunk_align", 1) or 1)
    if chunks > 1 and (dm.width // chunks) % align != 0:
        # block-wise quantized kernels: a chunk cut mid-scale-block
        # would recompute block scales from partial blocks and diverge
        # from the full-width bytes — alignment is part of chunk-safety
        raise ValueError(
            f"chunk width {dm.width // chunks} is not a multiple of "
            f"{service}.{method}'s {align}-byte block alignment"
        )
    return chunks


def _validate_chunk_order(chunk_order, chunks: int) -> List[int]:
    """Session-uniform chunk dispatch order: None is mesh order; anything
    else must be a permutation of the chunk set.  Raises ValueError."""
    if chunk_order is None:
        return list(range(chunks))
    order = [int(j) for j in chunk_order]
    if sorted(order) != list(range(chunks)):
        raise ValueError(
            f"chunk_order {order} is not a permutation of 0..{chunks - 1}"
        )
    return order


# -- topology-aware scheduling (TASP, PAPERS.md 2509.26541) --------------------
#
# The DeviceLinkMap star measures per-link rtt and bytes/s; `link_profile()`
# (transport/device_link.py) snapshots those recorders, and the scheduler
# orders work by MEASURED speed instead of mesh order: the slowest link's
# party is proposed to first — it needs the longest lead before every
# barrier (the TASP rule: schedule the scarce link before the fast ones).


def _profile_speed(info) -> Optional[tuple]:
    """Sort key for one party's measured link: (GB/s ascending, rtt
    DESCENDING) — slowest first; None when the link has no telemetry
    (no evidence of being slow: it keeps mesh order at the tail)."""
    if not info:
        return None
    gbps = float(info.get("gbps", 0.0) or 0.0)
    rtt = float(info.get("rtt_us", 0.0) or 0.0)
    if gbps <= 0.0 and rtt <= 0.0:
        return None
    return (gbps, -rtt)


def schedule_session_order(
    party_ids: List[int], profile, chunks: int = 1
) -> Tuple[List[int], List[int], str]:
    """The TASP join of a link profile and a session shape: returns
    (party_order, chunk_order, note). ``party_order`` is every party
    index, measured links slowest-first, unmeasured parties trailing in
    mesh order. ``chunk_order`` is a deterministic dispatch permutation
    derived from the same measurements via a round-robin route label
    (slice j labeled to party ``j % n``); reordering never changes bytes.
    ``note`` is the audit string (empty with no measured link, where both
    orders are mesh order)."""
    n = len(party_ids)
    profile = profile or {}
    measured, unmeasured = [], []
    for i, pid in enumerate(party_ids):
        key = _profile_speed(profile.get(int(pid)))
        if key is None:
            unmeasured.append(i)
        else:
            measured.append((key, i))
    measured.sort()
    party_order = [i for _k, i in measured] + unmeasured
    # rank only MEASURED parties: with an empty profile the chunk sort
    # key is (inf, j) everywhere and the order stays mesh
    rank = {i: pos for pos, (_k, i) in enumerate(measured)}
    chunk_order = sorted(
        range(int(chunks)),
        key=lambda j: (rank.get(j % n, float("inf")), j),
    )
    if measured:
        gbps = {
            int(party_ids[i]): round(
                float(profile[int(party_ids[i])].get("gbps", 0.0) or 0.0), 4
            )
            for _k, i in measured
        }
        note = f"link_order={party_order} profile_gbps={gbps}"
        if chunks > 1:
            note += f" chunk_order={chunk_order}"
    else:
        note = ""
    return party_order, chunk_order, note


def _default_link_profile():
    """The scheduler's default telemetry source: this process's live
    device-link star (best-effort — a process with no links schedules
    in mesh order)."""
    try:
        from incubator_brpc_tpu_torch.transport.device_link import link_profile

        return link_profile()
    except Exception:  # noqa: BLE001 — scheduling is advisory, never fatal
        return {}


def run_dispatch_session(
    party_ids: List[int],
    own_index: int,
    dm,
    operands: List[bytes],
    steps: int,
    service: str = "?",
    method: str = "?",
    should_abort: Optional[Callable[[], Optional[str]]] = None,
    session_id: Optional[str] = None,
    resume_from: int = 0,
    resume_state: Optional[Dict[int, Tuple[bytes, int]]] = None,
    checkpoint_every: int = 0,
    step_deadline_ms: float = 0.0,
    session_epoch: int = 0,
    chunks: int = 1,
    double_buffer: bool = False,
    quantize: str = "none",
    chunk_order=None,
    trace_id: int = 0,
    parent_span_id: int = 0,
    *,
    device: DeviceLike = None,
    group_timeout_s: Optional[float] = None,
) -> Tuple[np.ndarray, int, float]:
    """Run party ``own_index``'s side of a K-step session of ``dm``'s
    kernel; returns (its final row, its final n, elapsed seconds). Every
    party calls this with the same arguments but ``own_index``. In the
    single-controller form (no job) the call computes every party's row on
    one device (``cuda`` unless ``device="cpu"``); with a job, party ids are
    ranks, ``party_ids[own_index]`` must be this process's rank, the call
    holds that party's row on the job's device (or ``device``) and the
    session's collectives run over its group (joined here and released on
    return; ``group_timeout_s`` bounds the join and every collective,
    default the session deadline flag or 120 s). A collective that fails
    because a peer left the group raises :class:`SessionAborted`. Operands
    stay on the device across the chain: only the initial copy and the
    final fetch cross the host boundary, and the steps are queued without
    a host sync.

    Elastic extensions: with ``checkpoint_every`` > 0 (and a session id)
    every C-th completed step's state is retained in the ring of
    (session, ``own_index``); ``resume_from`` = R restores step R's state
    — from that ring when retained, else from ``resume_state`` ({slot:
    (full-width row bytes, n)}, the reshard a replacement party is
    bootstrapped with) — and replays only steps > R; ``step_deadline_ms``
    arms a watchdog (thread ``tbtorch-mc-step-watchdog``) that aborts the
    session when a SINGLE step (or the final fetch) stalls.

    Overlap extensions: ``chunks=C`` splits every step's operand along
    the width into C independently-dispatched sub-collectives (the kernel
    must be registered ``chunkable`` and C must divide the width, at a
    multiple of ``chunk_align``); each chunk stamps its own watchdog
    progress.  ``double_buffer=True`` dispatches step k+1's chunk j right
    behind step k's — the host never blocks, and a chunk whose
    predecessor's ack event has not fired counts as overlapped — whereas
    ``double_buffer=False`` with chunks waits on every chunk of a step
    before the next (the serialized baseline).  Checkpoints capture WHOLE
    steps (the chunks re-concat before entering the ring).  ``chunks=1,
    double_buffer=False`` is the unchunked chain.

    Quantized extensions: ``quantize`` selects the variant this chain
    binds — "none" runs ``dm`` itself, "int8"/"int4" resolve
    ``dm.quantized(mode)`` (no variant = ValueError before any step); a
    quantized session stores its ring entries quantized, and the
    power-of-two scales keep resume replay byte-identical.
    ``chunk_order`` is a dispatch permutation over the chunk set (None =
    in order); it never changes bytes.

    ``trace_id`` and ``parent_span_id`` place the chained session's step
    and chunk spans (an overlapped session's; ``chunks > 1`` or
    ``double_buffer``) in a trace: the caller's session span, or the
    proposing RPC's ids. ``device`` and ``group_timeout_s`` are
    keyword-only."""
    qdm = dm.quantized(quantize) if hasattr(dm, "quantized") else dm
    if qdm is None:
        raise ValueError(
            f"device method {service}.{method} has no {quantize} "
            "quantized variant"
        )
    dm = qdm
    quant_mode = getattr(dm, "quant_mode", "none") or "none"
    n = len(party_ids)
    if len(set(party_ids)) != n:
        raise ValueError(f"party ids {list(party_ids)} are not distinct labels")
    if not (0 <= own_index < n):
        raise ValueError(f"own_index {own_index} outside 0..{n - 1}")
    if len(operands) != n:
        raise ValueError("one operand per party required")
    if not (0 <= resume_from <= steps):
        raise ValueError(f"resume_from {resume_from} outside 0..{steps}")
    chunks = _validate_chunks(dm, chunks, service, method)
    chunk_order = _validate_chunk_order(chunk_order, chunks)
    chunked = chunks > 1 or double_buffer
    job = _party_ranks(party_ids)
    if job is not None:
        if int(party_ids[own_index]) != job.rank:
            raise ValueError(
                f"party {own_index} (rank {party_ids[own_index]}) is not addressable "
                f"from this process (rank {job.rank})"
            )
        if not session_id:
            raise ValueError("a session across processes needs a session_id (its group's key)")
        slots = [own_index]  # the rows this process holds
        dev = job.device if device is None else resolve_device(device)
    else:
        slots = list(range(n))
        dev = party_axis(n, device).device
    own_pos = slots.index(own_index)

    ring = None
    if checkpoint_every and checkpoint_every > 0 and session_id:
        # a quantized session retains QUANTIZED ring entries: the per-
        # entry device cost drops from width float32-bytes per row to
        # the wire footprint
        row_cost = dm.wire_bytes() if quant_mode != "none" else dm.width
        ring = _checkpoint_ring(
            session_id, own_index, party_ids,
            entry_bytes=len(slots) * (row_cost + 4), slots=slots,
        )
    ck_qz = None
    if ring is not None and quant_mode != "none":
        ck_qz = _make_ck_quant(dm)

    def _ck_payload(rows):
        """What enters the ring: the state itself, or (quantized session)
        its block-quantized twin — queued like the chain, no host sync."""
        if ck_qz is None:
            return rows
        q_t, e_t = ck_qz(rows)
        return _QuantCk(q_t, e_t, quant_mode, dm.quant_block, dm.width)

    if resume_from > 0:
        restored = _restore_state(
            session_id, own_index, resume_from, dm, resume_state, dev, slots,
        )
        if restored is None:
            raise LookupError(
                f"no checkpoint for session {session_id} step "
                f"{resume_from} reachable from party {own_index}"
            )
        x, ns = restored
    else:
        packed = [dm.pack(operands[i]) for i in slots]
        x = torch.from_numpy(np.stack([row for row, _ in packed])).to(dev)
        ns = torch.tensor([int(nn) for _, nn in packed], dtype=torch.int32, device=dev)

    def _check_abort():
        if should_abort is not None:
            why = should_abort()
            if why:
                raise SessionAborted(why)

    group = None
    if job is not None:
        if group_timeout_s is None:
            group_timeout_s = float(get_flag("mc_dispatch_session_deadline_ms")) / 1000.0 or 120.0
        group = _join_session_group(
            session_id, session_epoch, party_ids, job, max(1.0, group_timeout_s), should_abort
        )
        axis = DistributedPartyAxis(size=n, index=own_index, group=group, device=dev)
    else:
        axis = party_axis(n, dev)
    step_fn = _make_step(dm, axis)

    # the per-step watchdog: ``progress`` is (step index, last progress
    # instant, chunk index), advanced before every dispatch and before the
    # final fetch; a stall past the step deadline aborts the session
    # (abort_session flips every local registrant).  Steps are queued
    # without a host sync, so the final fetch is where the whole replayed
    # chain's device time is awaited: its allowance is one step deadline
    # PER replayed step.
    wd_stop = wd_thread = None
    progress = [resume_from, time.monotonic(), -1]
    # per-slice ack watermark: acked[j] = lowest step whose chunk-j ack
    # has NOT been observed yet; the fetch-phase abort reason names the
    # oldest unacked (step, chunk)
    acked = [resume_from] * chunks
    if step_deadline_ms and step_deadline_ms > 0 and session_id:
        wd_stop = threading.Event()
        budget_s = step_deadline_ms / 1000.0
        fetch_allow_s = budget_s * max(1, steps - resume_from)

        def _watch_steps(sid=session_id, ep=session_epoch):
            poll = min(0.01, budget_s / 4)
            while not wd_stop.wait(poll):
                allowed = budget_s if progress[0] < steps else fetch_allow_s
                if time.monotonic() - progress[1] > allowed:
                    if progress[0] < steps:
                        what = f"step {progress[0]}"
                        if progress[2] >= 0:
                            what += f" chunk {progress[2]}/{chunks}"
                    else:
                        what = "final fetch"
                        oldest = min(acked)
                        if chunked and oldest < steps:
                            what += (
                                f" (oldest unacked step {oldest} chunk "
                                f"{acked.index(oldest)}/{chunks})"
                            )
                    abort_session(
                        sid,
                        f"{what} exceeded the {step_deadline_ms:g}ms "
                        "step deadline",
                        epoch=ep,
                    )
                    return

        wd_thread = threading.Thread(
            target=_watch_steps, name="tbtorch-mc-step-watchdog", daemon=True
        )
        wd_thread.start()

    depth = int(get_flag("mc_dispatch_checkpoint_depth"))
    t0 = time.perf_counter()
    chunk_tally = 0  # sub-collectives dispatched (folded into bvars once)
    overlap_tally = 0  # dispatched while the same slice's predecessor flew
    # each slice's chunk spans still waiting for their ack observation,
    # and the open step's compute span (overlapped sessions only)
    pending_spans: List[list] = [[] for _ in range(chunks)]
    step_span = None
    try:
        if not chunked:
            for step_i in range(resume_from, steps):
                # an aborted session exits the chain HERE, between steps
                _check_abort()
                progress[0], progress[1] = step_i, time.monotonic()
                hook = _step_hook
                if hook is not None:
                    hook(step_i, own_index, 0)  # chaos-drill seam
                x, ns = step_fn(x, ns)  # chained: operands stay on-device
                completed = step_i + 1
                if ring is not None and completed % checkpoint_every == 0:
                    ring.put(completed, _ck_payload(x), ns, depth)
        else:
            # -- the overlap scheduler: chunked sub-collectives ---------
            concat_fn = None
            if chunks > 1:
                split_fn, concat_fn = _make_chunk_ops(dm.width, chunks)
                xs = list(split_fn(x))
            else:
                xs = [x]
            events = [None] * chunks  # each chunk's ack: after its last launch
            for step_i in range(resume_from, steps):
                step_span = _start_step_span(
                    service, method, step_i, steps, chunks, double_buffer, trace_id, parent_span_id,
                )
                for j in chunk_order:
                    # an abort lands BETWEEN sub-collectives, and the torn
                    # step never checkpoints
                    _check_abort()
                    progress[0], progress[2] = step_i, j
                    progress[1] = time.monotonic()
                    hook = _step_hook
                    if hook is not None:
                        hook(step_i, own_index, j)  # chaos-drill seam
                    if double_buffer and step_i > resume_from:
                        # xs[j] IS step k-1's chunk-j output: its ack
                        # reached → observed; not reached → this dispatch
                        # overlaps it, tallied.  Never blocks.
                        if _chunk_ready(events[j]):
                            acked[j] = step_i
                            _close_spans(pending_spans[j])
                        else:
                            overlap_tally += 1
                    # ns is not rethreaded through the chunks: the
                    # chunkable contract passes n through unchanged
                    xs[j], _ = step_fn(xs[j], ns)
                    events[j] = _record_event(dev)
                    chunk_tally += 1
                    csp = _start_chunk_span(
                        service, method, step_i, j, chunks, step_span, trace_id, parent_span_id,
                    )
                    if csp is not None:
                        pending_spans[j].append(csp)
                completed = step_i + 1
                if not double_buffer:
                    # serialized schedule: every chunk of this step
                    # observed complete before the next dispatches
                    for j in chunk_order:
                        progress[0], progress[2] = step_i, j
                        progress[1] = time.monotonic()
                        if events[j] is not None:
                            events[j].synchronize()
                        acked[j] = completed
                        _close_spans(pending_spans[j])
                if ring is not None and completed % checkpoint_every == 0:
                    # whole-step checkpoint: the chunks re-concat first
                    x_ck = concat_fn(*xs) if chunks > 1 else xs[0]
                    ring.put(completed, _ck_payload(x_ck), ns, depth)
                if step_span is not None:
                    rpcz.end_custom_span(step_span)
                    step_span = None
            x = concat_fn(*xs) if chunks > 1 else xs[0]
        # last look before the blocking fetch
        _check_abort()
        progress[0], progress[2] = steps, -1
        progress[1] = time.monotonic()
        own_row = x[own_pos].to("cpu", copy=True).numpy()
        own_n = int(ns[own_pos])
        # the fetch materialized the whole chain: every outstanding chunk
        # ack is implied — close the remaining spans at their ack instant
        for j in range(chunks):
            acked[j] = steps
            _close_spans(pending_spans[j])
    except PartyLost as e:
        # a peer left the session group mid-collective (its process died,
        # or it dropped the group on an abort): this party reports the
        # abort, it is not the one at fault
        raise SessionAborted(str(e)) from None
    finally:
        if group is not None:
            group.release()
        if wd_stop is not None:
            wd_stop.set()
            wd_thread.join()
        if chunk_tally:
            dispatch_chunks << chunk_tally
        if overlap_tally:
            dispatch_overlapped_chunks << overlap_tally
        # an abort mid-step leaves spans open: close them as errored so
        # the trace shows the torn step instead of losing it
        for j in range(chunks):
            _close_spans(pending_spans[j], error_code=int(ErrorCode.ESESSION))
        if step_span is not None:
            rpcz.end_custom_span(step_span, error_code=int(ErrorCode.ESESSION))
    elapsed = time.perf_counter() - t0
    dispatch_sessions << 1
    dispatch_steps << (steps - resume_from)
    dispatch_session_us << elapsed * 1e6
    _method_counter(service, method) << 1
    if quant_mode != "none":
        # the quantization dividend, tallied once per session: bytes the
        # wire did NOT carry vs the exact float32 row at this width
        dispatch_quantized_sessions << 1
        saved = (dm.width - dm.wire_bytes()) * n * (steps - resume_from)
        if saved > 0:
            dispatch_bytes_saved << saved
    return own_row, own_n, elapsed


def _restore_state(session_id, own_index, step, dm, resume_state, device, slots):
    """Rebuild the rows this process holds (``slots``) at one
    checkpointed step: a slot the local ring's entry holds takes that row
    (a survivor resuming in place, or a replaced label restored from the
    slot's old row), else the ``resume_state`` row shipped for it (a
    replacement's bootstrap). Returns (state ``[len(slots), width]``, n)
    on ``device``, or None when a slot is unrecoverable."""
    ring = _checkpoint_lookup(session_id, own_index) if session_id else None
    entry = ring.get(int(step)) if ring is not None else None
    payload, old_ns, old_slots = None, None, ()
    if entry is not None:
        payload, old_ns = entry
        old_slots = ring.slots
    state = resume_state or {}
    rows, ns = [], []
    for i in slots:
        if i in old_slots:
            src = old_slots.index(i)
            if isinstance(payload, _QuantCk):
                # quantized ring: dequantize on the host (exact,
                # power-of-two scales); the first replayed step
                # re-quantizes to the identical wire bytes
                row = torch.from_numpy(payload.shard_row(src))
            else:
                row = payload[src]
            rows.append(row.to(device))
            ns.append(int(old_ns[src]))
            continue
        if int(i) in state:
            row_bytes, nn = state[int(i)]
            try:
                row, n32 = dm.pack_state(row_bytes, nn)
            except ValueError:
                return None  # wrong-geometry reshard: unrecoverable slot
            rows.append(torch.from_numpy(row).to(device))
            ns.append(int(n32))
            continue
        return None
    return (
        torch.stack(rows),
        torch.tensor(ns, dtype=torch.int32, device=device),
    )


# -- rpcz spans (annotated with method identity) -------------------------------


def _start_session_span(service: str, method: str, fingerprint: str, party_ids: List[int],
                        own_index: int, steps: int, trace_id: int = 0, parent_span_id: int = 0,
                        resume_from: int = 0, extra: str = "", forced: bool = False):
    span = rpcz.start_custom_span(
        rpcz.SPAN_TYPE_COLLECTIVE, service, method,
        trace_id=trace_id, parent_span_id=parent_span_id, forced=forced,
    )
    if span is not None:
        note = (
            f"method={service}.{method} fingerprint={fingerprint} "
            f"steps={steps} index={own_index} parties={party_ids}"
        )
        if resume_from > 0:
            # a resumed chain: the span shows how much work the
            # checkpoint saved (only steps > resume_from re-ran)
            note += f" resume_from={resume_from}"
        if extra:
            # quantize= / link-order audit trail
            note += " " + extra
        span.annotate(note)
    return span


def _start_step_span(service, method, step_i, steps, chunks, double_buffer, trace_id,
                     parent_span_id):
    """One step's COMPUTE span in an overlapped session: covers the host
    dispatch window of the step's sub-collectives; its children are the
    chunk spans, and a chunk span of step k that closes inside step k+1's
    window is the trace-level proof of overlap."""
    span = rpcz.start_custom_span(
        rpcz.SPAN_TYPE_COLLECTIVE, service, method,
        trace_id=trace_id, parent_span_id=parent_span_id,
    )
    if span is not None:
        span.annotate(
            f"compute step={step_i}/{steps} chunks={chunks} "
            f"schedule={'double_buffer' if double_buffer else 'serialized'}"
        )
    return span


def _start_chunk_span(service, method, step_i, j, chunks, step_span, trace_id, parent_span_id):
    """One chunk sub-collective's span, nested inside its step's compute
    span (``chunk=<j>/<C>``); ended at the chunk's ACK observation, so its
    interval is dispatch→ack."""
    span = rpcz.start_custom_span(
        rpcz.SPAN_TYPE_COLLECTIVE, service, method,
        trace_id=step_span.trace_id if step_span is not None else trace_id,
        parent_span_id=step_span.span_id if step_span is not None else parent_span_id,
    )
    if span is not None:
        span.annotate(f"chunk={j}/{chunks} step={step_i}")
    return span


def _close_spans(spans: list, error_code: int = 0) -> None:
    """End-and-drain a slice's pending chunk spans (ack observed, or the
    session tore down) — draining keeps a second close idempotent."""
    while spans:
        rpcz.end_custom_span(spans.pop(0), error_code=error_code)


# -- server half ---------------------------------------------------------------


def _validate_proposal(req: dict):
    """Shared accept/run admission: bounds, then kernel identity, then
    the party ids against this process's job. Returns (party_ids,
    own_index, steps, dm, err) where err is (code, text) on rejection —
    the clean control-stream reject that keeps a divergent party out of
    lockstep."""
    from incubator_brpc_tpu_torch.parallel.quantized import QUANT_MODES

    try:
        party_ids = [int(i) for i in req["parties"]]
        own_index = int(req["index"])
        steps = int(req["steps"])
        width = int(req["width"])
        service = str(req["service"])
        method = str(req["method"])
        fingerprint = str(req["fingerprint"])
        quantize = str(req.get("quantize", "") or "none")
    except (ValueError, KeyError, TypeError) as e:
        return None, None, None, None, (
            ErrorCode.EREQUEST, f"bad dispatch proposal: {e}"
        )
    if not (
        0 < steps <= MAX_STEPS
        and 0 < width <= MAX_WIDTH
        and 1 < len(party_ids) <= MAX_PARTIES
        and 0 <= own_index < len(party_ids)
        and len(set(party_ids)) == len(party_ids)
    ):
        return None, None, None, None, (
            ErrorCode.EREQUEST, "dispatch proposal out of bounds"
        )
    if quantize not in QUANT_MODES:
        dispatch_rejects << 1
        return None, None, None, None, (
            ErrorCode.EREQUEST, f"unknown quantize mode {quantize!r}"
        )
    dm = resolve_method(service, method, width)
    if dm is None:
        dispatch_rejects << 1
        return None, None, None, None, (
            ErrorCode.ENOMETHOD,
            f"no device method {service}.{method} with width {width} "
            f"registered in this process",
        )
    dm = dm.quantized(quantize)
    if dm is None:
        # the session is quantized but this method registered no such
        # variant here — same class of divergence as a fingerprint
        # mismatch, same clean pre-lockstep reject
        dispatch_rejects << 1
        return None, None, None, None, (
            ErrorCode.EREQUEST,
            f"device method {service}.{method} has no {quantize} "
            f"quantized variant registered in this process",
        )
    ours = dm.fingerprint()
    if ours != fingerprint:
        # same name, different kernel: entering lockstep would run a
        # program the proposer never named — reject before any dispatch
        dispatch_rejects << 1
        return None, None, None, None, (
            ErrorCode.EREQUEST,
            f"device method fingerprint mismatch for {service}.{method}: "
            f"proposal {fingerprint} vs local {ours}",
        )
    try:
        _party_ranks(party_ids)
    except ValueError as e:
        return None, None, None, None, (ErrorCode.EREQUEST, str(e))
    return party_ids, own_index, steps, dm, None


def make_dispatch_handler(server):
    """Server half of ``_tpu_transport.collective_dispatch``: validate a
    session proposal against the local registry (accept phase — nothing
    runs), or bind the resolved kernel and run this party's side of the
    lockstep chain (run phase), answering with the final row; the
    control phases answer the abort broadcast (``abort``), the resume
    census (``resume_query``), the reshard (``fetch_shard``) and the ring
    release (``release``)."""

    runs = RunLimit(server.options.collective_max_concurrency)

    def collective_dispatch(cntl, request: bytes) -> bytes:
        try:
            req = json.loads(request.decode())
        except ValueError as e:
            cntl.set_failed(ErrorCode.EREQUEST, f"undecodable proposal: {e}")
            return b""
        phase = req.get("phase")
        if phase == "abort":
            # the abort broadcast: validated as little as possible — a
            # survivor must unwedge even when the rest of the proposal
            # state is unreachable or corrupt
            sid = str(req.get("session_id", ""))
            try:
                # epoch-scoped: a straggler abort from a superseded run
                # must not kill the session's resumed run
                abort_epoch = int(req["epoch"]) if "epoch" in req else None
            except (ValueError, TypeError):
                abort_epoch = None
            found = bool(sid) and abort_session(
                sid,
                str(req.get("reason", "")) or "aborted by proposer",
                epoch=abort_epoch,
            )
            return json.dumps({"aborted": found}).encode()
        if phase == "resume_query":
            # the resume barrier's census: every LOCAL party's checkpoint
            # watermark for this session — the proposer min-joins these
            # over the survivors into the resume point
            sid = str(req.get("session_id", ""))
            wm = checkpoint_watermarks(sid) if sid else {}
            return json.dumps(
                {"watermarks": {str(k): v for k, v in wm.items()}}
            ).encode()
        if phase == "fetch_shard":
            # reshard: materialize checkpointed rows for the requested
            # slots (the replacement party's bootstrap state)
            sid = str(req.get("session_id", ""))
            step = int(req.get("step", 0) or 0)
            slots = [int(s) for s in req.get("slots", ())]
            rows = checkpoint_fetch(sid, step, slots) if sid else {}
            return json.dumps(
                {"rows": {str(k): v for k, v in rows.items()}}
            ).encode()
        if phase == "release":
            sid = str(req.get("session_id", ""))
            return json.dumps(
                {"released": bool(sid) and release_checkpoints(sid)}
            ).encode()
        party_ids, own_index, steps, dm, err = _validate_proposal(req)
        if err is not None:
            cntl.set_failed(*err)
            return b""
        floor = int(get_flag("mc_dispatch_min_steps"))
        if phase != "accept" and steps < floor:
            # the accept ack raised our target to the floor; a run
            # proposal below it means the proposer did not fold this
            # party's target — reject rather than silently dispatch a
            # count the accept never agreed to
            dispatch_rejects << 1
            cntl.set_failed(
                ErrorCode.EREQUEST,
                f"run proposal steps {steps} below this party's accepted "
                f"floor {floor}",
            )
            return b""
        if phase == "accept":
            # Nothing is run or reserved; ``target`` lets this party RAISE
            # the step count (mc_dispatch_min_steps). The proposer folds
            # every target with max — the N-party join.
            target = min(max(steps, floor), MAX_STEPS)
            return json.dumps(
                {"accept": True, "index": own_index, "target": target}
            ).encode()
        if not runs.enter():
            cntl.set_failed(ErrorCode.ELIMIT, berror(ErrorCode.ELIMIT))
            return b""
        try:
            return _serve_run(cntl, server, req, party_ids, own_index, steps, dm)
        finally:
            runs.leave()

    return collective_dispatch


def _serve_run(cntl, server, req, party_ids, own_index, steps, dm) -> bytes:
    """The run phase of one party: its fields, the tombstone, the session's
    registration (its deadline, the proposer's connection as a death
    signal), its chain, its final row."""
    service, method = str(req["service"]), str(req["method"])
    try:
        operands = [base64.b64decode(op) for op in req.get("operands", [])]
        if len(operands) != len(party_ids):
            raise ValueError("one operand per party required")
        for op in operands:
            if len(op) > dm.width:
                raise ValueError(f"operand of {len(op)}B exceeds width {dm.width}")
    except (ValueError, TypeError) as e:
        cntl.set_failed(ErrorCode.EREQUEST, f"bad operands: {e}")
        return b""
    # fault plane: a session_id-carrying run registers here so the
    # abort broadcast, the party's own deadline watch, link-death
    # feedback, and the proposer's control socket dying can all
    # unwedge this party mid-chain with a clean ESESSION
    session_id = str(req.get("session_id", "")) or None
    # elastic plane: the proposer stamps the checkpoint cadence and
    # step deadline into the run proposal (cadence MUST be uniform
    # across parties or the min-join loses its "last common step"
    # meaning); absent fields fall back to this party's own flags
    try:
        run_epoch = int(req.get("epoch", 0) or 0)
        resume_from = int(req.get("resume_from", 0) or 0)
        # overlap fields: session-uniform — every party must dispatch
        # the same sub-collective sequence or the chunk collectives
        # cannot rendezvous
        chunks = _validate_chunks(dm, req.get("chunks", 1), service, method)
        chunk_order = _validate_chunk_order(req.get("chunk_order"), chunks)
        double_buffer = bool(req.get("double_buffer", False))
        if "checkpoint_every" in req:
            checkpoint_every = int(req["checkpoint_every"] or 0)
        else:
            checkpoint_every = int(get_flag("mc_dispatch_checkpoint_every"))
        if "step_deadline_ms" in req:
            step_deadline_ms = float(req["step_deadline_ms"] or 0)
        else:
            step_deadline_ms = float(get_flag("mc_dispatch_step_deadline_ms"))
        resume_state = {
            int(k): (base64.b64decode(v["row"]), int(v["n"]))
            for k, v in (req.get("resume_state") or {}).items()
        }
        if not (0 <= resume_from <= steps):
            raise ValueError(f"resume_from {resume_from} out of bounds")
        if resume_from > 0 and session_id is None:
            raise ValueError("resume_from requires a session_id")
    except (ValueError, TypeError, KeyError) as e:
        dispatch_rejects << 1
        cntl.set_failed(ErrorCode.EREQUEST, f"bad run fields: {e}")
        return b""
    if session_id is not None and run_epoch <= aborted_epoch(session_id):
        # the abort for this epoch already passed through here: a
        # stale (reordered or retried) run proposal must not start a
        # zombie chain no peer will ever join
        cntl.set_failed(
            ErrorCode.ESESSION,
            f"session aborted: run epoch {run_epoch} already "
            "tombstoned on this party",
        )
        return b""
    st = None
    sock_hook = None
    deadline_ms = float(req.get("deadline_ms", 0) or 0)
    if deadline_ms <= 0:
        deadline_ms = float(get_flag("mc_dispatch_session_deadline_ms"))
    if session_id is not None:
        deadline = (
            time.monotonic() + deadline_ms / 1000.0 if deadline_ms > 0 else 0.0
        )
        st = _register_session(
            session_id, party_ids, deadline, owner=server, epoch=run_epoch,
        )
        hooks = getattr(getattr(cntl, "_sock", None), "on_failed", None)
        if hooks is not None:
            # the proposer died with us mid-chain: its control
            # connection failing IS the death signal (socket feedback)
            def _proposer_died(_s, _sid=session_id, _ep=run_epoch):
                abort_session(
                    _sid, "proposer connection died mid-session", epoch=_ep,
                )

            hooks.append(_proposer_died)
            sock_hook = (hooks, _proposer_died)

    def _should_abort():
        if st is None:
            return None
        if st.abort_event.is_set():
            return st.abort_reason or "session aborted"
        if st.deadline and time.monotonic() > st.deadline:
            abort_session(
                st.session_id, "session deadline exceeded", epoch=st.epoch,
            )
            return "session deadline exceeded"
        return None

    quant_note = ""
    if getattr(dm, "quant_mode", "none") != "none":
        quant_note = f"quantize={dm.quant_mode}"
    if chunk_order != list(range(chunks)):
        # the proposer's topology-derived route, auditable per party
        quant_note = (quant_note + f" chunk_order={chunk_order}").strip()
    span = _start_session_span(
        service, method, dm.fingerprint(), party_ids, own_index, steps,
        trace_id=cntl.trace_id, parent_span_id=cntl.span_id,
        resume_from=resume_from, extra=quant_note,
        # the proposal rode in sampled (head-based): this party's session
        # span must not drop to a dry local bucket, or the fleet-wide trace
        # loses a whole party
        forced=bool(getattr(cntl.request_meta, "sampled", 0) if cntl.request_meta is not None else 0),
    )
    try:
        own_row, own_n, elapsed = run_dispatch_session(
            party_ids, own_index, dm, operands, steps,
            service=service, method=method, should_abort=_should_abort,
            session_id=session_id, resume_from=resume_from,
            resume_state=resume_state,
            checkpoint_every=checkpoint_every,
            step_deadline_ms=step_deadline_ms,
            session_epoch=run_epoch,
            chunks=chunks, double_buffer=double_buffer,
            chunk_order=chunk_order,
            # step/chunk spans nest inside the session span (or the
            # proposing RPC's trace when the session span was not sampled)
            trace_id=span.trace_id if span is not None else cntl.trace_id,
            parent_span_id=span.span_id if span is not None else cntl.span_id,
            device=server.device(),
            group_timeout_s=deadline_ms / 1000.0 if deadline_ms > 0 else None,
        )
    except SessionAborted as e:
        rpcz.end_custom_span(span, error_code=ErrorCode.ESESSION)
        cntl.set_failed(ErrorCode.ESESSION, f"session aborted: {e.reason}")
        return b""
    except LookupError as e:
        # a resume proposal for a step this party no longer retains
        # (evicted ring, wrong process): a clean control-stream
        # reject — the proposer falls back to a full restart
        dispatch_rejects << 1
        rpcz.end_custom_span(span, error_code=ErrorCode.EREQUEST)
        cntl.set_failed(ErrorCode.EREQUEST, f"cannot resume: {e}")
        return b""
    except Exception as e:
        dispatch_errors << 1
        rpcz.end_custom_span(span, error_code=ErrorCode.EINTERNAL)
        logger.exception("dispatch session failed")
        cntl.set_failed(ErrorCode.EINTERNAL, f"dispatch session: {e!r}")
        return b""
    finally:
        if sock_hook is not None:
            try:
                sock_hook[0].remove(sock_hook[1])
            except ValueError:
                pass
        if st is not None:
            _unregister_session(st)
    rpcz.end_custom_span(span)
    return json.dumps(
        {
            "result": base64.b64encode(dm.unpack(own_row, own_n)).decode(),
            "steps": steps,
            "resumed_from": resume_from,
            "elapsed_s": elapsed,
            "index": own_index,
        }
    ).encode()


# -- client half: the N-party session scheduler --------------------------------

# connectivity-class failures of a RUN rpc = the party is DEAD for this
# session (its chain will never converge); anything else is a reject.
# Both abort the session — only death feeds the re-propose path's
# survivor set.
_DEATH_CODES = frozenset(
    {
        ErrorCode.EFAILEDSOCKET, ErrorCode.EEOF, ErrorCode.ECLOSE,
        ErrorCode.EHOSTDOWN, ErrorCode.ERPCTIMEDOUT, ErrorCode.ELOGOFF,
        ErrorCode.ETIMEDOUT,
    }
)


def propose_dispatch(
    channels,
    party_ids: List[int],
    service: str,
    method: str,
    operands: List[bytes],
    steps: int = 1,
    proposer_index: Optional[int] = None,
    timeout_ms: float = 120000,
    session_deadline_ms: Optional[float] = None,
    session_id: Optional[str] = None,
    resume_from: int = 0,
    resume_state: Optional[Dict[int, Tuple[bytes, int]]] = None,
    resume_state_slots=None,
    checkpoint_every: Optional[int] = None,
    step_deadline_ms: Optional[float] = None,
    epoch: int = 0,
    chunks: int = 1,
    double_buffer: bool = False,
    quantize: str = "none",
    link_profile=None,
    chunk_order=None,
    device: DeviceLike = None,
) -> dict:
    """Schedule an N-party session of a registered device method.

    ``party_ids`` are the parties in order (labels in a single-controller
    process, job ranks across processes); ``operands[i]`` is party i's
    initial row. ``channels[j]`` is a host channel to the server playing
    the j-th REMOTE party index (every index except ``proposer_index``;
    with ``proposer_index=None`` the proposer is a pure scheduler and every
    party is remote — the ParallelChannel lowering's shape; else the
    proposer runs that party's chain itself, on ``device``). Returns
    ``{"results": [bytes per party], "final_steps": k, "elapsed_s":
    proposer's chain seconds or None, ...}``.

    ``chunks``/``double_buffer``/``chunk_order`` select the overlap
    schedule and ``quantize`` ("none"/"int8"/"int4") the method's variant,
    whose fingerprint the proposal stamps, as in
    :func:`run_dispatch_session`; the accept and run fan-outs go out
    slowest-measured-link first (``link_profile``, {party id: {"gbps",
    "rtt_us"}}, default this process's device links), and with
    ``chunks > 1`` the stamped ``chunk_order`` front-loads the slowest
    parties' slices.

    Three phases over the star:
    1. accept fan-out + barrier — every party resolves the (service,
       method) pair locally and fingerprint-checks it; any reject
       surfaces HERE, before lockstep. ``final = max(all targets)``.
    2. run fan-out (async — every party must be dispatching before any
       can finish) under a fault watcher, then the proposer's own chain
       if it participates.
    3. completion barrier — every response must echo ``final``.

    Fault semantics: the run phase registers a SESSION (random id +
    ``session_deadline_ms`` budget, default the RPC timeout) on every
    party. The watcher classifies a failed run RPC: connectivity failures
    (a dead party) and rejects both abort the session — a broadcast to
    every surviving party plus the local abort event — and
    :class:`SessionAborted` carries the dead and surviving index sets for
    the re-propose path (:func:`propose_with_recovery`); an ESESSION
    answer is a survivor reporting the abort and blames nobody."""
    n = len(party_ids)
    remote_indexes = [i for i in range(n) if i != proposer_index]
    if len(remote_indexes) != len(channels):
        raise ValueError("one channel per remote party required")
    if len(operands) != n:
        raise ValueError("one operand per party required")
    dm = resolve_method(service, method)
    if dm is None:
        raise LookupError(
            f"device method {service}.{method} not registered locally "
            f"(the proposer validates against its own registry too)"
        )
    quantize = (quantize or "none").strip() or "none"
    qdm = dm.quantized(quantize)
    if qdm is None:
        raise LookupError(
            f"device method {service}.{method} has no {quantize} "
            "quantized variant registered locally"
        )
    dm = qdm
    fingerprint = dm.fingerprint()
    for op in operands:
        if len(op) > dm.width:
            raise ValueError(f"operand of {len(op)}B exceeds method width {dm.width}")
    chunks = _validate_chunks(dm, chunks, service, method)
    # topology-aware route: fan out slowest-measured-link first, and
    # front-load the chunk slices that cover the slowest parties
    if link_profile is None:
        link_profile = _default_link_profile()
    party_order, auto_chunk_order, sched_note = schedule_session_order(
        party_ids, link_profile, chunks
    )
    # the audit trail of the session spans: the quantize mode and the
    # chosen link order with the profile it came from
    sched_extra = ((f"quantize={quantize} " if quantize != "none" else "") + sched_note).strip()
    if chunk_order is None:
        chunk_order = auto_chunk_order
    else:
        chunk_order = _validate_chunk_order(chunk_order, chunks)

    # session identity + deadline: what the fault plane keys on.  Every
    # party gets the SAME budget, measured from its own clock at proposal
    # arrival.  A caller-supplied session_id is a RESUME of that session:
    # the parties' checkpoint rings are keyed on it.
    if session_id is None:
        session_id = uuid.uuid4().hex
    sess_ms = (
        float(session_deadline_ms)
        if session_deadline_ms and session_deadline_ms > 0
        else float(get_flag("mc_dispatch_session_deadline_ms")) or float(timeout_ms)
    )
    ckpt_every = (
        int(checkpoint_every)
        if checkpoint_every is not None
        else int(get_flag("mc_dispatch_checkpoint_every"))
    )
    step_ms = (
        float(step_deadline_ms)
        if step_deadline_ms is not None
        else float(get_flag("mc_dispatch_step_deadline_ms"))
    )
    resume_from = int(resume_from or 0)
    if not (0 <= resume_from <= steps):
        raise ValueError(f"resume_from {resume_from} outside 0..{steps}")
    b64_operands = None

    def proposal(idx: int, nsteps: int, phase: str = "") -> bytes:
        nonlocal b64_operands
        d = {
            "parties": list(party_ids),
            "index": idx,
            "steps": nsteps,
            "width": dm.width,
            "service": service,
            "method": method,
            "fingerprint": fingerprint,
        }
        if quantize != "none":
            # session-uniform, validated at accept AND run: the
            # fingerprint above IS the quantized variant's
            d["quantize"] = quantize
        if phase:
            d["phase"] = phase
        else:
            # the FULL operand list: a party across processes places its
            # own, a single-controller party needs them all
            if b64_operands is None:
                b64_operands = [base64.b64encode(op).decode() for op in operands]
            d["operands"] = b64_operands
            d["session_id"] = session_id
            d["deadline_ms"] = sess_ms
            d["epoch"] = int(epoch)
            # elastic plane: the proposer owns the cadence (uniform
            # across parties) and the step watchdog; a resumed run names
            # the agreed restore point plus bootstrap rows for parties
            # without a ring (the replacement)
            d["checkpoint_every"] = ckpt_every
            d["step_deadline_ms"] = step_ms
            if chunks > 1:
                d["chunks"] = chunks
                if chunk_order != list(range(chunks)):
                    d["chunk_order"] = chunk_order
            if double_buffer:
                d["double_buffer"] = True
            if resume_from > 0:
                d["resume_from"] = resume_from
                # bootstrap rows ride only to the parties that need them
                # (resume_state_slots — the replacements; survivors
                # restore from their own rings)
                if resume_state and (
                    resume_state_slots is None or idx in resume_state_slots
                ):
                    d["resume_state"] = {
                        str(i): {
                            "row": base64.b64encode(bytes(row)).decode(),
                            "n": int(nn),
                        }
                        for i, (row, nn) in resume_state.items()
                    }
        return json.dumps(d).encode()

    # fleet-wide trace: the proposer's ambient trace context (the RPC
    # handler this proposal runs inside, if any) or a fresh trace id rides
    # EVERY control RPC of this session, so each party's handler span and
    # session/step/chunk spans join one cross-process trace. The sampled
    # bit propagates the head-based decision: a proposer with rpcz on
    # samples its sessions at the edge and every party honors that.
    amb_trace, amb_parent = rpcz.current_trace_context()
    session_trace = amb_trace or (rpcz._new_id() if rpcz.rpcz_enabled() else 0)
    session_sampled = 1 if session_trace else 0
    fleet_trace = (session_trace, amb_parent, session_sampled)

    def _call(ch, payload):
        return _control_call(ch, payload, timeout_ms, trace=fleet_trace)

    # fan-out order: slowest measured link FIRST; parties with no
    # telemetry keep mesh order at the tail.  The channel list itself
    # stays positional (callers index it by remote slot).
    fan = sorted(
        zip(channels, remote_indexes), key=lambda p: party_order.index(p[1]),
    )

    # Phase 1 — accept barrier + the monotone-max step-count join
    accepts = [_call(ch, proposal(idx, steps, phase="accept")) for ch, idx in fan]
    deadline = time.monotonic() + timeout_ms / 1000.0
    final = steps
    for cntl, ev in accepts:
        if not ev.wait(max(0.0, deadline - time.monotonic())):
            raise TimeoutError("dispatch peer never acknowledged proposal")
        if cntl.failed():
            raise RuntimeError(f"dispatch proposal rejected: {cntl.error_text}")
        ack = json.loads(cntl.response_payload.decode())
        final = max(final, int(ack.get("target", steps)))

    # Phase 2 — run fan-out (async: a sync proposal would deadlock — the
    # first party's collective blocks on parties never told to start),
    # in the same slowest-first order as the accept fan-out
    pending = [_call(ch, proposal(idx, final)) for ch, idx in fan]
    fan_indexes = [idx for _ch, idx in fan]
    session_deadline = time.monotonic() + sess_ms / 1000.0
    st = _register_session(session_id, party_ids, session_deadline, epoch=epoch)
    outcome = {"dead": [], "rejects": [], "reason": ""}
    watch_stop = threading.Event()
    broadcast_done = [False]

    def _broadcast_abort(reason: str, skip) -> None:
        """phase:"abort" to every party not already known dead (async,
        best-effort — each party's own deadline is the backstop)."""
        msg = json.dumps(
            {"phase": "abort", "session_id": session_id, "reason": reason,
             "epoch": int(epoch)}
        ).encode()
        for ch, idx in fan:
            if idx in skip:
                continue
            try:
                _call(ch, msg)
            except Exception:
                logger.exception("abort broadcast to party %d failed", idx)

    trigger_lock = threading.Lock()

    def _trigger_abort(reason: str) -> None:
        with trigger_lock:
            outcome["reason"] = outcome["reason"] or reason
            first = not broadcast_done[0]
            broadcast_done[0] = True
        if first:
            # one broadcast per session: later classifications add to the
            # outcome but the survivors were already told
            _broadcast_abort(reason, set(outcome["dead"]))
        abort_session(session_id, reason, epoch=epoch)

    def _watch() -> None:
        # classify every settled run RPC as it lands; on the FIRST death
        # or reject — or the session deadline — abort fabric-wide so the
        # survivors exit their chains instead of waiting on a party that
        # can never join.  After an abort the watcher KEEPS scanning
        # until every run RPC settles (or the deadline): an ESESSION
        # answer is a survivor reporting the abort, never the dead party,
        # which must still be identified for the re-propose path.
        seen = set()
        while not watch_stop.wait(0.01):
            done = True
            now = time.monotonic()
            for (cntl, ev), idx in zip(pending, fan_indexes):
                if not ev.is_set():
                    done = False
                    continue
                if idx in seen or not cntl.failed():
                    continue
                seen.add(idx)
                code = cntl.error_code
                if code == ErrorCode.ESESSION:
                    _trigger_abort(f"party {idx} reported abort: {cntl.error_text}")
                elif code in _DEATH_CODES:
                    outcome["dead"].append(idx)
                    _trigger_abort(f"party {idx} died mid-session: {cntl.error_text}")
                else:
                    outcome["rejects"].append((idx, cntl.error_text))
                    _trigger_abort(f"party {idx} rejected the run: {cntl.error_text}")
            if done:
                return
            if st.abort_event.is_set() and not broadcast_done[0]:
                # aborted from OUTSIDE the rpc plane (a link-death hook
                # here): the survivors still need the broadcast
                _trigger_abort(st.abort_reason or "session aborted")
            if now > session_deadline:
                _trigger_abort("session deadline exceeded")
                return

    watcher = threading.Thread(target=_watch, name="tbtorch-mc-session-watch", daemon=True)
    watcher.start()

    own_elapsed = None
    results: List[Optional[bytes]] = [None] * n
    party_elapsed: List[Optional[float]] = [None] * n  # each party's chain seconds
    abort_exc: Optional[SessionAborted] = None
    sched_span = None
    if proposer_index is None and sched_extra:
        # a pure scheduler leaves the audit span too (index=-1 marks the
        # scheduler role): the quantize mode and the chosen link order
        # stay traceable when the proposer runs no chain of its own
        sched_span = _start_session_span(
            service, method, fingerprint, party_ids, -1, final,
            trace_id=session_trace, parent_span_id=amb_parent,
            resume_from=resume_from, extra=sched_extra, forced=bool(session_sampled),
        )
    try:
        if proposer_index is not None:

            def _own_should_abort():
                if st.abort_event.is_set():
                    return st.abort_reason or "session aborted"
                if time.monotonic() > session_deadline:
                    abort_session(session_id, "session deadline exceeded", epoch=epoch)
                    return "session deadline exceeded"
                return None

            span = _start_session_span(
                service, method, fingerprint, party_ids, proposer_index, final,
                trace_id=session_trace, parent_span_id=amb_parent,
                resume_from=resume_from, extra=sched_extra, forced=bool(session_sampled),
            )
            try:
                own_row, own_n, own_elapsed = run_dispatch_session(
                    party_ids, proposer_index, dm, operands,
                    final, service=service, method=method,
                    should_abort=_own_should_abort,
                    session_id=session_id, resume_from=resume_from,
                    resume_state=resume_state,
                    checkpoint_every=ckpt_every, step_deadline_ms=step_ms,
                    session_epoch=epoch,
                    chunks=chunks, double_buffer=double_buffer,
                    chunk_order=chunk_order,
                    trace_id=span.trace_id if span is not None else session_trace,
                    parent_span_id=span.span_id if span is not None else amb_parent,
                    device=device,
                    group_timeout_s=sess_ms / 1000.0,
                )
            except SessionAborted as e:
                rpcz.end_custom_span(span, error_code=ErrorCode.ESESSION)
                abort_exc = e
                # across processes this chain can end first (a peer left
                # the session group): tell the other parties; the watcher
                # still names the dead one from its RPC
                _trigger_abort(e.reason)
            except Exception:
                dispatch_errors << 1
                rpcz.end_custom_span(span, error_code=ErrorCode.EINTERNAL)
                # our own chain failed: the peers' chains can never
                # converge either — take the whole session down cleanly
                _trigger_abort("proposer chain failed")
                raise
            else:
                rpcz.end_custom_span(span)
                results[proposer_index] = dm.unpack(own_row, own_n)
                party_elapsed[proposer_index] = own_elapsed

        # Phase 3 — completion barrier; the watcher exits once every run
        # RPC settled, or as soon as it aborted the session
        watcher.join()
        if st.abort_event.is_set() or abort_exc is not None:
            dead = sorted(set(outcome["dead"]))
            survivors = [i for i in range(n) if i not in set(dead)]
            reason = (
                outcome["reason"]
                or (abort_exc.reason if abort_exc is not None else "")
                or st.abort_reason
                or "session aborted"
            )
            raise SessionAborted(
                reason,
                dead_indexes=dead,
                survivor_indexes=survivors,
                rejects=outcome["rejects"],
                session_id=session_id,
                final_steps=final,
            )
        for (cntl, ev), idx in zip(pending, fan_indexes):
            if cntl.failed():  # defensive: the watcher classifies these
                raise RuntimeError(f"dispatch peer failed: {cntl.error_text}")
            resp = json.loads(cntl.response_payload.decode())
            # each party echoes the count it validated AND ran — a
            # mismatch means a corrupted or stale proposal reached it
            if int(resp.get("steps", -1)) != final:
                raise RuntimeError(
                    f"party {idx} dispatched {resp.get('steps')} steps, "
                    f"agreed final was {final} — close did not converge"
                )
            results[idx] = base64.b64decode(resp["result"])
            party_elapsed[idx] = resp.get("elapsed_s")
        # clean completion: nothing left to resume — release every
        # party's checkpoint ring (best-effort broadcast; the eviction
        # cap is the backstop for a proposer that dies before this)
        if ckpt_every > 0:
            release_checkpoints(session_id)
            msg = json.dumps({"phase": "release", "session_id": session_id}).encode()
            for ch in channels:
                try:
                    _call(ch, msg)
                except Exception:
                    logger.exception("checkpoint release broadcast failed")
    finally:
        watch_stop.set()
        watcher.join()
        _unregister_session(st)
        if sched_span is not None:
            rpcz.end_custom_span(
                sched_span,
                error_code=(
                    int(ErrorCode.ESESSION)
                    if (st.abort_event.is_set() or abort_exc is not None)
                    else 0
                ),
            )
    return {
        "results": results,
        "final_steps": final,
        "elapsed_s": own_elapsed,
        "party_elapsed_s": party_elapsed,
        "session_id": session_id,
        "resumed_from": resume_from if resume_from > 0 else None,
        "quantize": quantize,
        # the proposer-side wire accounting: bytes every party put on the
        # party axis across the REPLAYED steps
        "wire_bytes": dm.wire_bytes() * n * (final - resume_from),
        "link_order": party_order,
        "chunk_order": chunk_order,
    }


def _control_call(ch, payload: bytes, timeout_ms: float, trace=None):
    """One control-stream RPC of the session plane (the proposals, the
    abort broadcast and the resume barrier's traffic), on the host plane
    even over a device-link channel. ``trace`` is the proposer's
    ``(trace_id, parent_span_id, sampled)`` fleet-trace context: stamped on
    the controller so the proposal crosses the wire inside the proposer's
    trace and every party's spans join it. Returns (controller, done
    event)."""
    from incubator_brpc_tpu_torch.rpc.controller import Controller
    from incubator_brpc_tpu_torch.transport.device_link import HANDSHAKE_SERVICE

    cntl = Controller(timeout_ms=timeout_ms)
    cntl._force_host = True
    if trace is not None and trace[0]:
        cntl.trace_id = int(trace[0])
        cntl.parent_span_id = int(trace[1])
        cntl.trace_sampled = 1 if trace[2] else 0
    ev = threading.Event()
    ch.call_method(
        HANDSHAKE_SERVICE, DISPATCH_METHOD, payload, cntl=cntl,
        done=lambda c, _ev=ev: _ev.set(),
    )
    return cntl, ev


def _query_watermarks(session_id: str, survivor_pairs, timeout_ms: float) -> Dict[int, dict]:
    """The resume barrier's gather half: ask every surviving remote party
    for its checkpoint census (phase:"resume_query"), merged with the
    proposer-local census (a participating proposer — and, in-process,
    co-hosted parties — answer from the same registry).  A survivor that
    fails the query contributes nothing, which drags the min-join to 0 —
    the safe side."""
    msg = json.dumps({"phase": "resume_query", "session_id": session_id}).encode()
    calls = []
    for ch, idx in survivor_pairs:
        try:
            calls.append(_control_call(ch, msg, timeout_ms))
        except Exception:
            logger.exception("resume query to party %d failed", idx)
    merged: Dict[int, dict] = dict(checkpoint_watermarks(session_id))
    deadline = time.monotonic() + timeout_ms / 1000.0
    for cntl, ev in calls:
        if not ev.wait(max(0.0, deadline - time.monotonic())) or cntl.failed():
            continue
        try:
            ans = json.loads(cntl.response_payload.decode())
            for k, info in (ans.get("watermarks") or {}).items():
                slot = int(k)
                have = merged.get(slot)
                if have is None or int(info.get("watermark", 0)) > int(have.get("watermark", 0)):
                    merged[slot] = info
        except (ValueError, TypeError, AttributeError):
            continue
    return merged


def _fetch_state(
    session_id: str, step: int, slots: List[int], channels, timeout_ms: float, required=None,
) -> Optional[Dict[int, Tuple[bytes, int]]]:
    """Reshard: assemble session state at one checkpointed step from the
    survivors' rings (local first, then phase:"fetch_shard" over the rpc
    plane) — what bootstraps a replacement party.  Returns
    {slot: (full-width row bytes, n)} covering whatever was reachable,
    or None when a REQUIRED slot (default: all of ``slots``) is
    unrecoverable — the caller then falls back to a full restart.  Across
    processes each survivor serves only its own slot, so a dead party's
    row is reachable only where another ring holds it."""
    state: Dict[int, Tuple[bytes, int]] = dict(_checkpoint_rows(session_id, step, slots))
    for ch in channels:
        missing = [s for s in slots if s not in state]
        if not missing:
            break
        msg = json.dumps(
            {"phase": "fetch_shard", "session_id": session_id, "step": int(step),
             "slots": missing}
        ).encode()
        try:
            cntl, ev = _control_call(ch, msg, timeout_ms)
        except Exception:
            logger.exception("shard fetch failed")
            continue
        if not ev.wait(timeout_ms / 1000.0) or cntl.failed():
            continue
        try:
            rows = json.loads(cntl.response_payload.decode()).get("rows") or {}
            for k, v in rows.items():
                if int(k) not in state:
                    state[int(k)] = (base64.b64decode(v["row"]), int(v["n"]))
        except (ValueError, TypeError, KeyError, AttributeError):
            continue
    need = slots if required is None else required
    if any(s not in state for s in need):
        return None
    return state


def propose_with_recovery(
    channels,
    party_ids: List[int],
    service: str,
    method: str,
    operands: List[bytes],
    steps: int = 1,
    proposer_index: Optional[int] = None,
    timeout_ms: float = 120000,
    session_deadline_ms: Optional[float] = None,
    max_reproposals: int = 1,
    spares=None,
    checkpoint_every: Optional[int] = None,
    step_deadline_ms: Optional[float] = None,
    chunks: int = 1,
    double_buffer: bool = False,
    quantize: str = "none",
    link_profile=None,
    device: DeviceLike = None,
) -> dict:
    """:func:`propose_dispatch` with the elastic recovery path: a session
    that aborts on PARTY DEATH heals instead of restarting from nothing
    (up to ``max_reproposals`` times).  Two recovery modes, tried in
    order:

    1. **Resume with replacement** — when ``spares`` (a list of
       ``(channel, party id)`` standby parties) can fill every dead slot:
       the resume barrier min-joins the survivors' checkpoint watermarks
       into the last COMMON checkpointed step, the dead party's state is
       re-sharded out of the survivors' rings over the rpc plane, and the
       SAME session (same id, a new epoch) re-runs only the steps past the
       resume point — byte-identical to an undisturbed run.  A dead slot
       no reachable ring holds (across processes, where each ring holds
       its own row) falls back to a full restart over the healed set.
    2. **Shrink restart** — no spare: a fresh session from step 0 over
       the survivors only.

    Rejects and proposer death are not recoverable and re-raise.  The
    result dict gains ``dead_party_ids``, ``replaced_party_ids`` and
    ``resumed_from`` (None unless the winning run was a resume)."""
    chs = list(channels)
    pids = [int(p) for p in party_ids]
    ops = list(operands)
    pidx = proposer_index
    dropped: List[int] = []
    replaced: List[int] = []
    spare_pool = list(spares or ())
    session_id = uuid.uuid4().hex
    run_steps = steps
    resume_from = 0
    resume_state: Optional[Dict[int, Tuple[bytes, int]]] = None
    resumed = False
    for attempt in range(max_reproposals + 1):
        remote = [i for i in range(len(pids)) if i != pidx]
        try:
            out = propose_dispatch(
                chs, pids, service, method, ops, steps=run_steps,
                proposer_index=pidx, timeout_ms=timeout_ms,
                session_deadline_ms=session_deadline_ms,
                session_id=session_id, resume_from=resume_from,
                resume_state=resume_state,
                resume_state_slots=frozenset(
                    i for i in range(len(pids)) if pids[i] in set(replaced)
                ) or None,
                checkpoint_every=checkpoint_every,
                step_deadline_ms=step_deadline_ms,
                epoch=attempt,
                chunks=chunks, double_buffer=double_buffer,
                quantize=quantize, link_profile=link_profile, device=device,
            )
            out["dead_party_ids"] = dropped
            out["replaced_party_ids"] = replaced
            if resumed:
                dispatch_resumes << 1
            return out
        except SessionAborted as e:
            dead = set(e.dead_indexes)
            if (
                attempt == max_reproposals
                or not dead
                or e.rejects
                or (pidx is not None and pidx in dead)
            ):
                raise
            have_spares = len(spare_pool) >= len(dead)
            if not have_spares and len(pids) - len(dead) < 2:
                # a shrink below 2 parties is no session; replacement
                # does not shrink, so the width guard only gates mode 2
                raise
            run_steps = max(run_steps, e.final_steps or 0)
            dropped.extend(pids[i] for i in sorted(dead))
            if have_spares:
                # elastic heal: replacement + resume (mode 1)
                survivor_slots = [i for i in range(len(pids)) if i not in dead]
                surv_pairs = [(ch, idx) for ch, idx in zip(chs, remote) if idx not in dead]
                wms = _query_watermarks(session_id, surv_pairs, timeout_ms)
                point = resume_point({i: wms.get(i) for i in survivor_slots})
                for slot in sorted(dead):
                    sch, spid = spare_pool.pop(0)
                    replaced.append(int(spid))
                    pids[slot] = int(spid)
                    chs[remote.index(slot)] = sch
                state = None
                if point > 0:
                    # reshard for the REPLACEMENTS: gather every slot
                    # reachable at the resume point, but REQUIRE only the
                    # replaced slots — survivors restore their slots from
                    # their own rings, and the bootstrap rows ride only to
                    # the replacement parties (resume_state_slots above)
                    state = _fetch_state(
                        session_id, point, list(range(len(pids))),
                        [ch for ch, _i in surv_pairs], timeout_ms,
                        required=sorted(dead),
                    )
                    if state is None:
                        point = 0  # reshard incomplete: full restart
                resume_from = point
                resume_state = state
                resumed = True
                dispatch_replaced_parties << len(dead)
                logger.warning(
                    "resuming %s.%s session %s from step %d with %d "
                    "replacement(s) after: %s",
                    service, method, session_id, point, len(dead), e.reason,
                )
            else:
                # shrink restart (mode 2): new session over the
                # survivors; the old session's rings are released
                # best-effort (the eviction cap is the backstop)
                logger.warning(
                    "re-proposing %s.%s over %d survivor(s) after: %s",
                    service, method, len(pids) - len(dead), e.reason,
                )
                release_checkpoints(session_id)
                rel = json.dumps({"phase": "release", "session_id": session_id}).encode()
                keep = [i for i in range(len(pids)) if i not in dead]
                chs = [ch for ch, idx in zip(chs, remote) if idx not in dead]
                for ch in chs:
                    try:
                        _control_call(ch, rel, timeout_ms)
                    except Exception:
                        logger.exception("checkpoint release failed")
                ops = [ops[i] for i in keep]
                pids = [pids[i] for i in keep]
                if pidx is not None:
                    pidx = keep.index(pidx)
                session_id = uuid.uuid4().hex
                resume_from = 0
                resume_state = None
                resumed = False
    raise AssertionError("unreachable")


# -- the ParallelChannel lowering ----------------------------------------------

mc_lowered_dispatches = Adder(name="parallel_channel_mc_lowered")


def lower_parallel_call(
    channels,
    party_ids: List[int],
    service: str,
    method: str,
    requests: List[bytes],
    timeout_ms: float,
) -> List[bytes]:
    """One combo call lowered onto the method plane: the sub-links' server
    ranks form the party axis (channel order — the order a
    single-controller fused dispatch stacks, so merges are
    byte-identical), each party's operand is its sub-request, the proposer
    is a pure scheduler, and one 1-step session replaces the host fan-out.
    Returns per-sub response bytes in channel order. The call routes
    through :func:`propose_with_recovery`; a 1-step session has no
    checkpointed past and no spare pool, so an abort surfaces as
    :class:`SessionAborted` and the combo layer falls back to the host
    fan-out."""
    if not timeout_ms or timeout_ms <= 0:
        timeout_ms = 120000.0
    out = propose_with_recovery(
        channels, [int(p) for p in party_ids], service, method, requests,
        steps=1, proposer_index=None, timeout_ms=timeout_ms, max_reproposals=0,
    )
    mc_lowered_dispatches << 1
    return out["results"]
