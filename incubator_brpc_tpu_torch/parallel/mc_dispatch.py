"""Collective method plane — the session runner of
``incubator_brpc_tpu/parallel/mc_dispatch.py``, in its single-controller form.

A session runs K lockstep steps of a registered device method's kernel
over P parties, the operands staying on the device through the chain. The
JAX package runs it in two forms: one ``jax.distributed`` process per
party, or one process that addresses every party's device, where "one call
owns every shard and the session degenerates to the full computation".
This port runs the second form on one card: the state is one ``[P,
width]`` uint8 tensor (and ``n`` an int32 ``[P]``), party ``i``'s row is
row ``i``, and the kernel takes the party axis (``parallel/mesh.py``
:class:`PartyAxis`) where the JAX kernel names ``"par"``:

    kernel(data: uint8[P, width], n: int32[P], axis) -> (uint8[P, width], int32[P])

Party ids are labels of the rows. What a session offers is the JAX
function's: ``steps``, ``resume_from``/``resume_state`` and
``checkpoint_every`` (the checkpoint rings), the step watchdog
(``step_deadline_ms``), ``chunks``/``double_buffer``/``chunk_order`` (the
overlap scheduler: a chunk is a view of the state cut at a multiple of the
method's ``chunk_align``), ``quantize`` (the K2 variants of
``parallel/quantized.py``, whose rings hold the quantized state), and the
same counters. The chunk acks are CUDA events recorded after each chunk's
launch (always ready on the CPU); the serialized schedule's barrier is
their ``synchronize()``.

The topology-aware scheduler (``schedule_session_order``) orders parties
and chunks by the measured speed of this process's device links
(``transport/device_link.py`` ``link_profile()``).

Left for later slices: the RPC proposals and handlers
(``propose_dispatch``, ``make_dispatch_handler``, ``_validate_proposal``,
``propose_with_recovery``), which call the scheduler, ``lower_parallel_call``,
the rpcz spans, and the form with one party per ``torch.distributed`` rank.
"""

from __future__ import annotations

import base64
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from incubator_brpc_tpu_torch.bvar import Adder, LatencyRecorder, PassiveStatus
from incubator_brpc_tpu_torch.parallel import quantized as _quantized
from incubator_brpc_tpu_torch.parallel.mesh import PartyAxis, party_axis
from incubator_brpc_tpu_torch.rpc.device_method import lookup_device_method
from incubator_brpc_tpu_torch.utils.device import DeviceLike
from incubator_brpc_tpu_torch.utils.flags import get_flag
from incubator_brpc_tpu_torch.utils.status import ErrorCode

logger = logging.getLogger(__name__)

# chunked overlap sessions: a step's operand may split into at most this
# many independently-dispatched sub-collectives
MAX_CHUNKS = 64

# plane-level observability: sessions/steps/errors/rejects across every
# kernel, plus a latency summary; per-kernel counters are minted lazily
# below. errors, rejects, resumes and replaced_parties are bumped by the
# proposal path, which comes with the host plane.
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


# -- step-granular checkpoint rings --------------------------------------------
#
# With ``checkpoint_every`` set, each party retains a device-resident ring
# of its last ``mc_dispatch_checkpoint_depth`` completed-step states, keyed
# by (session_id, own party index).  An aborted session's rings survive the
# abort so a resume can start from the last COMMON checkpointed step and
# replay only the steps past it.  Rings are released on clean completion
# and capped by an oldest-session eviction.  Entries hold the session's
# tensors (every party's row; a step's kernel returns new tensors, so
# retaining them is free) and a CUDA event recorded after them: an entry
# counts toward the resume census only once the card has reached it.

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
    __slots__ = ("session_id", "own_index", "party_ids", "entries",
                 "entry_bytes")

    def __init__(self, session_id, own_index, party_ids, entry_bytes):
        self.session_id = session_id
        self.own_index = int(own_index)
        self.party_ids = tuple(party_ids)  # the labels of the payload's rows
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


def _checkpoint_ring(session_id, own_index, party_ids, entry_bytes):
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
                session_id, own_index, party_ids, entry_bytes
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
            if slot in out or not (0 <= slot < len(ring.party_ids)):
                continue
            # the wire format is always the FULL-WIDTH row: a quantized
            # ring dequantizes here (exact — power-of-two scales), so
            # the reshard protocol never forks on representation
            out[slot] = (_payload_row(x, slot).tobytes(), int(ns[slot]))
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


# -- the lockstep step ---------------------------------------------------------


def _make_step(dm, axis: PartyAxis):
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
    ``[P, width]`` -> (wire values, int8 exponents) of every row, one K2a
    launch.  Retaining them IS the checkpoint."""
    mode, block = dm.quant_mode, dm.quant_block

    def qz(x):
        return _quantized._tq_quantize(x.view(torch.float32), mode, block)

    return qz


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
    device: DeviceLike = None,
) -> Tuple[np.ndarray, int, float]:
    """Run a K-step session of ``dm``'s kernel over every party's row on
    one device (``cuda`` unless ``device="cpu"``); returns (party
    ``own_index``'s final row, its final n, elapsed seconds).  Operands
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
    in order); it never changes bytes."""
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
    axis = party_axis(n, device)
    dev = axis.device
    step_fn = _make_step(dm, axis)

    ring = None
    if checkpoint_every and checkpoint_every > 0 and session_id:
        # a quantized session retains QUANTIZED ring entries: the per-
        # entry device cost drops from width float32-bytes per row to
        # the wire footprint
        row_cost = dm.wire_bytes() if quant_mode != "none" else dm.width
        ring = _checkpoint_ring(
            session_id, own_index, party_ids, entry_bytes=n * (row_cost + 4),
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
            session_id, own_index, resume_from, party_ids, dm, resume_state, dev,
        )
        if restored is None:
            raise LookupError(
                f"no checkpoint for session {session_id} step "
                f"{resume_from} reachable from party {own_index}"
            )
        x, ns = restored
    else:
        packed = [dm.pack(op) for op in operands]
        x = torch.from_numpy(np.stack([row for row, _ in packed])).to(dev)
        ns = torch.tensor([int(nn) for _, nn in packed], dtype=torch.int32, device=dev)

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

    def _check_abort():
        if should_abort is not None:
            why = should_abort()
            if why:
                raise SessionAborted(why)

    depth = int(get_flag("mc_dispatch_checkpoint_depth"))
    t0 = time.perf_counter()
    chunk_tally = 0  # sub-collectives dispatched (folded into bvars once)
    overlap_tally = 0  # dispatched while the same slice's predecessor flew
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
                        else:
                            overlap_tally += 1
                    # ns is not rethreaded through the chunks: the
                    # chunkable contract passes n through unchanged
                    xs[j], _ = step_fn(xs[j], ns)
                    events[j] = _record_event(dev)
                    chunk_tally += 1
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
                if ring is not None and completed % checkpoint_every == 0:
                    # whole-step checkpoint: the chunks re-concat first
                    x_ck = concat_fn(*xs) if chunks > 1 else xs[0]
                    ring.put(completed, _ck_payload(x_ck), ns, depth)
            x = concat_fn(*xs) if chunks > 1 else xs[0]
        # last look before the blocking fetch
        _check_abort()
        progress[0], progress[2] = steps, -1
        progress[1] = time.monotonic()
        own_row = x[own_index].to("cpu", copy=True).numpy()
        own_n = int(ns[own_index])
        for j in range(chunks):
            acked[j] = steps
    finally:
        if wd_stop is not None:
            wd_stop.set()
            wd_thread.join()
        if chunk_tally:
            dispatch_chunks << chunk_tally
        if overlap_tally:
            dispatch_overlapped_chunks << overlap_tally
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


def _restore_state(
    session_id, own_index, step, party_ids, dm, resume_state, device
):
    """Rebuild the session state at one checkpointed step: slot i takes
    the row the local ring's entry holds under the label it had in that
    run (``ring.party_ids[i]``) — a survivor resuming in place, or a new
    label in the slot restored from the old one's row — else the
    ``resume_state`` row shipped for it (a replacement's bootstrap).
    Returns (state ``[P, width]``, n ``[P]``) on ``device``, or None when a
    slot is unrecoverable."""
    ring = _checkpoint_lookup(session_id, own_index) if session_id else None
    entry = ring.get(int(step)) if ring is not None else None
    payload, old_ns, old_pids = None, None, ()
    if entry is not None:
        payload, old_ns = entry
        old_pids = ring.party_ids
    state = resume_state or {}
    rows, ns = [], []
    for i in range(len(party_ids)):
        if i < len(old_pids):
            src = i  # the payload row labelled old_pids[i]
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
