"""Two-party device transport — the ``transport="tpu"`` data plane, the
counterpart of ``incubator_brpc_tpu/transport/device_link.py``.

The reference template is the RDMA endpoint pair (rdma/rdma_endpoint.h:
42-213): two Sockets handshake over their TCP connection ("RDMA" magic +
cookie, socket.cpp:1692-1704), then move the SAME wire frames through
queue-pair send/recv rings with a credit window (rdma_endpoint.h:105-123,
176-195), completions feeding the normal input path
(rdma_completion_queue.cpp:152). The port keeps the JAX package's design:

- **A link binds one device per party.** Each step exchanges both
  parties' outbound slots at once. The exchange is a copy with no compute,
  so it is done with ``torch`` copy ops, not a hand-written kernel. Its
  three forms (:meth:`DeviceLink._build_step`):

  - both parties on one device, ``host_loopback`` None (the default) or
    True: the **host swap**. The peer's bytes are already on this host and
    the consumer is this host's messenger, so side i is handed the other
    side's row with no device hop — the shared-device path of the JAX
    package on one TPU chip;
  - one device, ``host_loopback=False`` (the **forced device form**): both
    rows are gathered into one host tensor (pinned when the device is a
    card), copied to the device on the link's own CUDA stream, swapped
    there (``torch.flip`` over the party axis: the reference's
    ``slots[::-1]``), copied back into a fresh host tensor, and an event
    recorded after the copy completes the step through
    :class:`DeviceCompletionButex`. On ``device="cpu"`` the same code runs
    on CPU tensors;
  - two distinct devices: each row moves to the other party's device, as
    ``ppermute`` does, and back to the host. One card cannot run this
    form; it is untested on hardware.

- **Slots are the rings.** Each step carries one fixed-geometry uint32
  slot per direction (negotiated ``slot_words``) behind 8 header words
  (``TPUL`` magic, used bytes, seq, the 64-bit cumulative ack, flags); the
  link is a BYTE STREAM of tbus_std frames, packed head-to-tail into slots
  and re-cut by the receiver's InputMessenger. A step's output is a fresh
  host buffer: a delivered row is wrapped zero-copy into the receiver's
  IOBuf and stays alive until the last reference to it drops.
- **Handshake rides the host socket** (``_tpu_transport.handshake``): the
  client proposes a cookie, its device and the geometry as an ordinary RPC
  on the TCP socket; the server builds its half on a device of its own
  device list — ``torch.cuda.device_count()`` cards, or the one CPU device
  of a Server built with ``ServerOptions(device="cpu")`` — and answers.
- **Flow control**: writers park on a butex once the outbound backlog
  passes the window's byte budget (EOVERCROWDED past the timeout); the
  window counts undrained steps (``ack_mode="local"``) or the peer's
  cumulative-delivered count carried in the slot headers
  (``ack_mode="wire"``, the multi-controller information flow).

Each package has its own :data:`link_hub`, so a ``transport="tpu"`` call
from one package's Channel to the other package's Server finds no link;
only TCP interoperates across the two packages.

``controller="multi"`` routes the handshake to ``transport/mc_link.py``:
the link whose two halves live in two processes, lockstep over
``torch.distributed``; its ``DeviceSocket`` carries RPC frames as this
module's does.

A link that fails aborts the collective sessions of its parties
(``parallel/mc_dispatch.py`` ``abort_sessions_for_devices``, keyed by job
rank: a multi-controller link's two ranks; a link inside one process has
no ranks). Credentials ride the handshake's bootstrap channel and key the
link (``DeviceLinkMap.get_or_create(auth=)``): channels with different
credentials never share a link. Not here yet: TLS on links (``ssl_*``,
ROADMAP A10).
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import logging
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from incubator_brpc_tpu_torch.bvar import Adder, LatencyRecorder, PerSecond
from incubator_brpc_tpu_torch.runtime.butex import Butex
from incubator_brpc_tpu_torch.runtime.device_butex import DeviceCompletionButex
from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool
from incubator_brpc_tpu_torch.utils.device import resolve_device
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint
from incubator_brpc_tpu_torch.utils.status import ErrorCode

logger = logging.getLogger(__name__)

LINK_MAGIC = 0x5450554C  # "TPUL"
LINK_HEADER_WORDS = 8
# header words: 0 magic, 1 used_bytes, 2 seq, 3 ack_lo, 4 flags,
# 5 ack_hi (the delivered count is 64-bit on the wire: a wrapped 32-bit
# ack would wedge the wire-mode credit window), 6-7 reserved
F_DATA = 1
F_CLOSE = 2

HANDSHAKE_SERVICE = "_tpu_transport"
HANDSHAKE_METHOD = "handshake"

link_steps = Adder(name="device_link_steps")
link_bytes = Adder(name="device_link_bytes")
link_acks = Adder(name="device_link_ack_steps")  # wire-mode catch-up steps
link_errors = Adder(name="device_link_errors")  # fail() calls, all links
# send() attempts refused with EOVERCROWDED after a full window-stall wait
link_overcrowded = Adder(name="device_link_overcrowded")

_link_ids = itertools.count(1)  # per-link bvar namespace: device_link_<n>_*

# Every live link, for the quiesce at interpreter exit and in
# shutdown_links(): a teardown close frame dispatches one last exchange
# step on a worker fiber, and a process that exits (or stops the worker
# pool) while a step is in flight would tear the runtime down under it.
_all_links: "weakref.WeakSet" = weakref.WeakSet()
_links_lock = threading.Lock()


def _quiesce_links(timeout: float = 10.0) -> None:
    """Outwait in-flight drives and steps of every live link (bounded),
    then the completion watchers they submitted to."""
    deadline = time.monotonic() + timeout
    with _links_lock:
        links = list(_all_links)
    for link in links:
        while time.monotonic() < deadline:
            with link._lock:
                # a failed link's undelivered steps are never drained: its
                # watches settle below, with the watchers'
                idle = not link._driving and (link._inflight == 0 or link._closed)
            if idle:
                break
            time.sleep(0.01)
    from incubator_brpc_tpu_torch.runtime import device_butex as _db

    if _db._watchers is not None:
        _db._watchers.quiesce(timeout=max(0.1, deadline - time.monotonic()))


atexit.register(_quiesce_links)


def _device_id(dev: torch.device) -> int:
    """The device's index in its kind's list (the CPU is device 0)."""
    return dev.index if dev.index is not None else 0


class _Events:
    """Several CUDA events watched as one completion."""

    def __init__(self, events: List) -> None:
        self.events = events

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()


def _record_event(stream) -> Optional["torch.cuda.Event"]:
    if stream is None:
        return None
    event = torch.cuda.Event(blocking=True)
    event.record(stream)
    return event


class DeviceLink:
    """One established two-party link: the QP pair + CQ + window."""

    # the job ranks of the link's two parties (a multi-controller link's;
    # a link inside one process has none): whose sessions fail() aborts
    ranks: tuple = ()

    def __init__(
        self,
        devices: List,
        slot_words: int = 16384,
        window: int = 8,
        host_loopback: Optional[bool] = None,
        ack_mode: str = "local",
    ):
        """``devices``: one device per party (``torch.device`` or its
        name; ``None`` is the card).

        ``host_loopback``: when both parties share ONE device the exchange
        is a pure swap, and the default (None) takes the host swap; False
        forces the swap through the device (the forced device form, see
        the module docstring). A failing device step fails the link; it
        never falls back to the host swap.

        ``ack_mode``: how the credit window learns about drained steps.
        'local' (default) gates on this process's shared delivery counter
        — correct and cheapest when both parties live in one process.
        'wire' gates on the CUMULATIVE-DELIVERED count carried in received
        slot headers (words 3 and 5) — the information flow a
        multi-controller deployment has, where each host only observes its
        own deliveries: the RDMA endpoint's piggybacked imm-data acks, with
        catch-up steps dispatched when acks lag the window
        (rdma_endpoint.h:117-123,176-195)."""
        if slot_words < 64:
            raise ValueError("slot_words too small")
        if ack_mode not in ("local", "wire"):
            raise ValueError(f"unknown ack_mode {ack_mode!r}")
        self.devices = [resolve_device(d) for d in devices]  # [side0, side1]
        self.slot_words = slot_words
        self.window = window
        self.ack_mode = ack_mode
        self._peer_ack = 0  # wire mode: max delivered-count seen in rows
        self._acks_sent = 0  # wire mode: highest ack value put on the wire
        self._host_loopback = host_loopback
        self._slot_bytes = slot_words * 4
        self._lock = threading.Lock()
        self._out: List[deque] = [deque(), deque()]  # pending bytes per side
        self._out_nbytes = [0, 0]
        self._close_pending = [False, False]
        self._closed = False
        # a multi-controller half frozen by its close dance refuses new
        # sends (transport/mc_link.py)
        self._send_blocked = False
        self._seq = 0  # steps dispatched
        self._next_deliver = 0  # next seq to hand to the sockets
        self._inflight = 0  # dispatched, not yet drained
        self._reorder: Dict[int, object] = {}
        self._deliver_lock = threading.Lock()  # one in-order deliverer
        self._deliver_tid: Optional[int] = None  # thread inside _deliver
        self._driving = False
        self._wbutex = Butex(0)  # writers park here on backlog
        self._cq = DeviceCompletionButex()
        self.socks: List[Optional["DeviceSocket"]] = [None, None]
        self._pool = global_worker_pool()
        # -- per-link instrumentation: rtt per exchange step (dispatch ->
        # in-order delivery), flush = the staging gather into a slot, pump
        # = feeding delivered bytes into the messenger, bytes per second
        # each way. Retired (hidden from the registry) when the link dies.
        self.link_id = next(_link_ids)
        pfx = f"device_link_{self.link_id}"
        self._m_out_bytes = Adder()
        self._m_in_bytes = Adder()
        self._m_rtt = LatencyRecorder(name=f"{pfx}_step_rtt_us")
        self._m_flush = LatencyRecorder(name=f"{pfx}_flush_us")
        self._m_pump = LatencyRecorder(name=f"{pfx}_pump_us")
        self._m_out_rate = PerSecond(self._m_out_bytes, name=f"{pfx}_out_bytes_second")
        self._m_in_rate = PerSecond(self._m_in_bytes, name=f"{pfx}_in_bytes_second")
        self._metrics_retired = False
        self._step_ts: Dict[int, float] = {}  # seq -> dispatch perf_counter
        self._build_step()
        with _links_lock:
            _all_links.add(self)

    def _retire_metrics(self) -> None:
        """Drop this link's names from the expose registry (terminal).
        The aggregate device_link_* counters live on."""
        if self._metrics_retired:
            return
        self._metrics_retired = True
        for v in (
            self._m_rtt, self._m_flush, self._m_pump,
            self._m_out_rate, self._m_in_rate,
        ):
            try:
                v.hide()
            except Exception:
                pass

    def _maybe_retire_metrics(self) -> None:
        """Clean-close path: once every handshaken side's socket has left
        CONNECTED the link carries no more traffic — drop its names."""
        from incubator_brpc_tpu_torch.transport.sock import CONNECTED

        socks = [s for s in self.socks if s is not None]
        if socks and all(s.state != CONNECTED for s in socks):
            self._retire_metrics()

    # -- the exchange step ---------------------------------------------------

    def _build_step(self) -> None:
        self._width = LINK_HEADER_WORDS + self.slot_words
        same_device = len({str(d) for d in self.devices}) == 1
        if self._host_loopback is None:
            self._host_loopback = same_device
        self._pin = any(d.type == "cuda" for d in self.devices)
        self._streams: Dict[str, object] = {}
        if self._host_loopback:
            # shared-device geometry: pure host swap — no copy to the
            # device, no readback. All the link machinery above the step
            # (slot packing, seq/ack headers, window, in-order delivery)
            # still runs.
            self._step = None
            return
        for d in self.devices:
            if d.type == "cuda" and str(d) not in self._streams:
                self._streams[str(d)] = torch.cuda.Stream(device=d)
        self._step = self._swap_on_device if same_device else self._exchange_across_devices

    def _make_slots(self, rows: List[np.ndarray]) -> torch.Tensor:
        """Both parties' outbound slots in one host tensor ``[2, width]``
        (int32 bits of the uint32 words; pinned when a party is a card)."""
        slots = torch.empty((2, self._width), dtype=torch.int32, pin_memory=self._pin)
        host = slots.numpy()
        host[0] = rows[0].view(np.int32)
        host[1] = rows[1].view(np.int32)
        return slots

    def _swap_on_device(self, slots: torch.Tensor):
        """The forced device form on one device: copy both rows there on the
        link's stream, swap them (the reference's ``slots[::-1]``), copy the
        result back into a fresh host tensor. Returns (host tensor, event to
        watch or None on the CPU)."""
        dev = self.devices[0]
        stream = self._streams.get(str(dev))
        out = torch.empty_like(slots, pin_memory=self._pin)
        ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with ctx:
            on_dev = slots.to(dev, non_blocking=True)
            out.copy_(torch.flip(on_dev, dims=(0,)), non_blocking=True)
            event = _record_event(stream)
        return out, event

    def _exchange_across_devices(self, slots: torch.Tensor):
        """Two distinct devices: each party's row moves to its own device,
        then to the peer's (the ``ppermute`` hop), then to the host. One card
        cannot run this form."""
        out = torch.empty_like(slots, pin_memory=self._pin)
        events = []
        for side in (0, 1):
            src, dst = self.devices[1 - side], self.devices[side]
            stream = self._streams.get(str(dst))
            ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
            with ctx:
                moved = slots[1 - side].to(src, non_blocking=True).to(dst, non_blocking=True)
                out[side].copy_(moved, non_blocking=True)
                ev = _record_event(stream)
            if ev is not None:
                events.append(ev)
        return out, (_Events(events) if events else None)

    # -- send side -----------------------------------------------------------

    def attach(self, side: int, sock: "DeviceSocket") -> None:
        self.socks[side] = sock

    def send(self, side: int, data, timeout: Optional[float] = 10.0) -> int:
        """Queue bytes (bytes or IOBuf) for the peer. 0, or EOVERCROWDED
        when the backlog stays above the window's byte budget past
        ``timeout``. The in-order deliverer thread never parks here (a
        handler responding inline during delivery would deadlock the link
        waiting on itself) — its writes are admitted past the budget,
        bounded by one response per delivered request.

        An IOBuf is queued as zero-copy views of its blocks (kept alive by
        the IOBuf itself): the only host copy of outbound payload bytes is
        the gather into the slot."""
        if self._closed:
            return ErrorCode.EFAILEDSOCKET
        if isinstance(data, (bytes, bytearray, memoryview)):
            chunks = [[memoryview(data).cast("B"), data]]
        else:  # IOBuf: views stay valid while the IOBuf is referenced
            chunks = [[v, data] for v in data.views() if len(v)]
        n = sum(len(v) for v, _ in chunks)
        if n == 0:
            return 0
        budget = self.window * self._slot_bytes
        deadline = None
        while True:
            with self._lock:
                if self._closed or self._send_blocked:
                    return ErrorCode.EFAILEDSOCKET
                if (
                    self._out_nbytes[side] <= budget
                    or threading.get_ident() == self._deliver_tid
                ):
                    self._out[side].extend(chunks)
                    self._out_nbytes[side] += n
                    break
                seq = self._wbutex.load()
            # window stall: park until a step drains (credit released)
            if deadline is None:
                deadline = time.monotonic() + (timeout if timeout else 10.0)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                link_overcrowded << 1
                return ErrorCode.EOVERCROWDED
            self._wbutex.wait(seq, timeout=remaining)
        self._kick()
        return 0

    def close(self, side: int) -> None:
        with self._lock:
            if self._closed:
                return
            self._close_pending[side] = True
        self._kick()

    def _kick(self) -> None:
        with self._lock:
            if self._driving or self._closed:
                return
            self._driving = True
        self._pool.spawn(self._drive)

    # -- the drainer (single-drainer discipline, like Socket's KeepWrite) ----

    def _has_work(self) -> bool:
        return bool(
            self._out[0] or self._out[1]
            or self._close_pending[0] or self._close_pending[1]
        )

    def _window_full_locked(self) -> bool:
        """Credit check under the link lock. 'local': dispatched-but-
        undrained steps (this process sees both deliveries). 'wire': how
        far our seq runs ahead of the peer's CUMULATIVE-DELIVERED count as
        carried in received slot words 3 and 5."""
        if self.ack_mode == "wire":
            return self._seq - self._peer_ack >= self.window
        return self._inflight >= self.window

    def _drive(self) -> None:
        while True:
            ack_only = False
            with self._lock:
                if self._closed or not self._has_work():
                    self._driving = False
                    return
                if self._window_full_locked():
                    # wire mode: when the acks we have put on the wire lag
                    # our deliveries by nearly a full window, the peer may
                    # be blocked on US — dispatch ONE over-window catch-up
                    # step carrying the fresh cumulative ack (and any queued
                    # data; a pure ack frame would starve data at window=1).
                    # Acks are cumulative, so one catch-up step flushes the
                    # whole backlog; deliveries cap the lag at `window`, so
                    # the threshold is always reachable.
                    if (
                        self.ack_mode == "wire"
                        and self._next_deliver - self._acks_sent
                        >= max(1, self.window - 1)
                    ):
                        ack_only = True
                        need = None
                    else:
                        # both modes wait for DELIVERY progress: a delivery
                        # releases the local credit (and advances _peer_ack
                        # in wire mode) before _wbutex bumps. (Waiting on
                        # the completion count instead races the delivery
                        # that follows it, and stalls a step per timeout.)
                        need = self._wbutex.load()
                else:
                    need = None
                if need is None:
                    rows = [self._fill_slot_locked(s) for s in (0, 1)]
                    seq = self._seq
                    self._seq += 1
                    self._inflight += 1
                    self._step_ts[seq] = time.perf_counter()
            if need is not None:
                self._wbutex.wait(need, timeout=1.0)
                continue
            if ack_only:
                link_acks << 1
            if self._step is None:
                # host swap: deliver side i the peer's outbound row. Guarded
                # like the device path: a raising handler during the
                # synchronous delivery fails the link, never strands
                # _driving=True with the queue wedged.
                link_steps << 1
                try:
                    self._on_step_done(seq, ("host", [rows[1], rows[0]]), None)
                except Exception:
                    logger.exception("host-swap link delivery failed")
                    self.fail("host-swap delivery failed")
                    with self._lock:
                        self._driving = False
                    return
                continue
            try:
                slots = self._make_slots(rows)
                out, event = self._step(slots)
            except Exception:
                logger.exception("device link step dispatch failed")
                self.fail("link step dispatch failed")
                with self._lock:
                    self._driving = False
                return
            link_steps << 1
            # the watcher only settles the event: delivery runs handlers,
            # which may block, so it goes to a worker fiber (a watcher
            # parked in a handler could starve the completions it waits on)
            self._cq.watch(
                event,
                on_complete=lambda _work, error, _seq=seq, _out=out, _keep=slots: (
                    self._pool.spawn(self._on_step_done, _seq, _out, error)
                ),
            )

    def _fill_slot_locked(self, side: int) -> np.ndarray:
        """Pack queued views head-to-tail into one slot (byte stream: a
        frame may split across slots; the receiver's messenger re-cuts).
        ONE gather copy per byte — the staging write into the 'ring'.
        np.empty, not np.zeros: the receiver only reads ``used`` bytes;
        only the header words (and, when the row crosses a device, the
        unused tail) are written below."""
        t0 = time.perf_counter()
        row = np.empty(self._width, dtype=np.uint32)
        rb = row.view(np.uint8)
        used = 0
        q = self._out[side]
        cap = self._slot_bytes
        base = LINK_HEADER_WORDS * 4
        while q and used < cap:
            entry = q[0]
            view = entry[0]
            take = min(len(view), cap - used)
            rb[base + used : base + used + take] = np.frombuffer(
                view[:take], dtype=np.uint8
            )
            if take == len(view):
                q.popleft()  # keepalive dropped with the entry
            else:
                entry[0] = view[take:]
            used += take
        self._out_nbytes[side] -= used
        if self._step is not None and used < cap:
            # the whole row crosses the device on the device forms: an
            # uninitialized tail would ship this process's freed heap
            rb[base + used :] = 0
        flags = F_DATA if used else 0
        if not q and self._close_pending[side]:
            flags |= F_CLOSE
            self._close_pending[side] = False
        row[0] = LINK_MAGIC
        row[1] = used
        row[2] = self._seq & 0xFFFFFFFF
        row[5:LINK_HEADER_WORDS] = 0  # reserved words must not leak heap
        row[5] = (self._next_deliver >> 32) & 0xFFFFFFFF  # ack high word
        self._acks_sent = self._next_deliver  # words 3+5 carry this
        # words 3(+5) carry the cumulative delivered count on the wire.
        # ack_mode='local' gates the window on the shared in-process
        # counter and only WRITES these; ack_mode='wire' gates on the
        # values READ from received rows (_deliver).
        row[3] = self._next_deliver & 0xFFFFFFFF
        row[4] = flags
        if used:
            link_bytes << used
            self._m_out_bytes << used
        self._m_flush << (time.perf_counter() - t0) * 1e6
        return row

    # -- receive side --------------------------------------------------------

    def _on_step_done(self, seq: int, arrays, error) -> None:
        if error is not None:
            logger.error("device link step failed: %s", error)
            self.fail(f"link step failed: {error}")
            return
        with self._lock:
            self._reorder[seq] = arrays
        self._drain_ready()
        self._kick()

    def _drain_ready(self) -> None:
        """Deliver completed steps strictly in sequence. Completions may
        arrive out of order; _deliver_lock admits ONE deliverer at a time
        and the pop of _next_deliver happens under the link lock, so the
        byte stream can never interleave. The window credit (inflight) is
        released only after delivery — undrained outputs are the occupied
        ring."""
        while True:
            with self._deliver_lock:
                with self._lock:
                    arrays = self._reorder.pop(self._next_deliver, None)
                    if arrays is None:
                        return
                    dispatched_at = self._step_ts.pop(self._next_deliver, None)
                    self._next_deliver += 1
                self._deliver_tid = threading.get_ident()
                t0 = time.perf_counter()
                try:
                    self._deliver(arrays)
                finally:
                    self._deliver_tid = None
                    now = time.perf_counter()
                    self._m_pump << (now - t0) * 1e6
                    if dispatched_at is not None:
                        self._m_rtt << (now - dispatched_at) * 1e6
            with self._lock:
                self._inflight -= 1
            self._wbutex.add(1)
            self._wbutex.wake_all()

    def _rows_to_host(self, arrays) -> List[np.ndarray]:
        """The step's two output rows as host uint32 arrays: the host
        swap's rows as they are, a device form's host tensor viewed in
        place (each view keeps the tensor alive)."""
        if isinstance(arrays, tuple) and arrays[0] == "host":
            return arrays[1]
        host = arrays.numpy().view(np.uint32)
        return [host[0], host[1]]

    def _deliver(self, arrays) -> None:
        """One completed exchange: side i now holds the PEER's outbound
        slot — feed it into side i's socket."""
        rows = self._rows_to_host(arrays)
        for side in (0, 1):
            if not self._deliver_row(side, rows[side]):
                return

    def _deliver_row(self, side: int, row: np.ndarray) -> bool:
        """Feed one received slot into side ``side``'s socket. False when
        the row is not a link slot (the link is failed)."""
        if int(row[0]) != LINK_MAGIC:
            self.fail("bad link slot magic")
            return False
        used = int(row[1])
        flags = int(row[4])
        if self.ack_mode == "wire":
            # the peer's cumulative-delivered count rides words 3+5;
            # this is the ONLY credit signal in wire mode
            with self._lock:
                ack = int(row[3]) | (int(row[5]) << 32)
                if ack > self._peer_ack:
                    self._peer_ack = ack
        sock = self.socks[side]
        if used:
            self._m_in_bytes << used
        if used and sock is not None:
            # ZERO-copy delivery: the read IOBuf's block wraps the step
            # output's own buffer, which stays alive until the last
            # reference drops. Payload bytes materialize once, at the
            # parse boundary.
            base = LINK_HEADER_WORDS * 4
            view = memoryview(row.view(np.uint8))[base : base + used]
            sock._feed(view)
        if flags & F_CLOSE and sock is not None:
            sock.set_failed(ErrorCode.ECLOSE, "peer closed device link")
        return True

    def fail(self, reason: str) -> None:
        """Fail the link: drop the queues, abort the collective sessions
        of the link's ranks, wake the writers, fail both sockets with
        EFAILEDSOCKET."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for side in (0, 1):
                self._out[side].clear()
                self._out_nbytes[side] = 0
            self._step_ts.clear()
        link_errors << 1
        self._retire_metrics()
        if self.ranks:
            # party-death feedback for the collective fault plane: a
            # session between these ranks lost the link between them, so
            # every party exits with ESESSION instead of waiting it out
            try:
                from incubator_brpc_tpu_torch.parallel.mc_dispatch import (
                    abort_sessions_for_devices,
                )

                abort_sessions_for_devices(self.ranks, f"device link failed: {reason}")
            except Exception:
                logger.exception("link-death session abort failed")
        self._wbutex.add(1)
        self._wbutex.wake_all()
        for sock in self.socks:
            if sock is not None:
                sock.set_failed(ErrorCode.EFAILEDSOCKET, reason)

    @property
    def inflight_steps(self) -> int:
        with self._lock:
            return self._inflight

    def profile(self) -> dict:
        """Structured snapshot of this link's recorders (what the
        topology-aware session scheduler reads, parallel/mc_dispatch).
        ``gbps`` sums both directions' measured bytes/s; a fresh link reads
        0.0 until the 1 Hz bvar sampler has a window."""
        out_bps = float(self._m_out_rate.get_value() or 0.0)
        in_bps = float(self._m_in_rate.get_value() or 0.0)
        return {
            "link_id": int(self.link_id),
            "devices": [_device_id(d) for d in self.devices],
            "rtt_us": float(self._m_rtt.latency()),
            "rtt_p99_us": float(self._m_rtt.latency_percentile(0.99)),
            "steps": int(self._m_rtt.count()),
            "out_bytes_s": out_bps,
            "in_bytes_s": in_bps,
            "out_bytes": int(self._m_out_bytes.get_value()),
            "in_bytes": int(self._m_in_bytes.get_value()),
            "gbps": (out_bps + in_bps) / 1e9,
        }


class DeviceSocket:
    """Socket-shaped endpoint over one side of a DeviceLink: the messenger,
    channel and server paths treat it exactly like a TCP Socket (same duck
    surface), but ``write`` stages bytes onto the link and reads arrive
    from link completions — no fd anywhere."""

    def __init__(
        self,
        link: DeviceLink,
        side: int,
        messenger=None,
        user_message_handler=None,
        context: Optional[dict] = None,
        remote: Optional[EndPoint] = None,
    ):
        from incubator_brpc_tpu_torch.iobuf import IOBuf
        from incubator_brpc_tpu_torch.transport.sock import CONNECTED, _registry

        self.link = link
        self.side = side
        self.messenger = messenger
        self.user_message_handler = user_message_handler
        self.context: dict = dict(context) if context else {}
        dev = link.devices[1 - side]
        self.remote = remote or EndPoint(ip=f"{dev.type}://{_device_id(dev)}", port=0)
        self.state = CONNECTED
        self.error_code = 0
        self.error_text = ""
        self.preferred_protocol = None
        self.is_client = side == 0
        self.inline_read = False
        self.on_failed: List = []
        self.on_revived: List = []  # never fires: a dead link is re-handshaken, not revived
        self._read_buf = IOBuf()
        self._feed_lock = threading.Lock()
        self._recycled = False
        self.id = _registry.insert(self)
        link.attach(side, self)

    # -- write path ----------------------------------------------------------

    def write(self, data, on_error=None, timeout: Optional[float] = None) -> int:
        """Stage ``data`` (bytes or IOBuf, zero-copy) onto the link. A
        synchronous failure is reported ONCE, via the return code — the TCP
        Socket.write contract; ``on_error`` is accepted and never fired."""
        from incubator_brpc_tpu_torch.transport.sock import CONNECTED

        if self.state != CONNECTED:
            return ErrorCode.EFAILEDSOCKET
        return self.link.send(self.side, data, timeout=timeout)

    # -- read path (driven by link completions) ------------------------------

    def _feed(self, data) -> None:
        """Link delivery: append the byte-stream chunk and run the normal
        messenger cut loop. A memoryview of 4 KiB or more is wrapped
        zero-copy as an external block (its backing step-output buffer is
        kept alive until the last ref drops); smaller chunks are copied,
        where the external-block bookkeeping would cost more."""
        with self._feed_lock:  # per-socket reader serialization
            if isinstance(data, memoryview) and len(data) >= 4096:
                self._read_buf.append_external(data)
            else:
                self._read_buf.append(bytes(data))
            if self.messenger is not None and len(self._read_buf):
                self.messenger.process(self)

    # -- lifecycle -----------------------------------------------------------

    def set_failed(self, code: int = ErrorCode.EFAILEDSOCKET, reason: str = "") -> bool:
        from incubator_brpc_tpu_torch.transport.sock import CONNECTED, FAILED

        if self.state != CONNECTED:
            return False
        self.state = FAILED
        self.error_code = code
        self.error_text = reason
        if code != ErrorCode.ECLOSE:
            self.link.fail(reason)
        else:
            self.link.close(self.side)
        for cb in list(self.on_failed):
            try:
                cb(self)
            except Exception:
                logger.exception("device socket on_failed raised")
        self.link._maybe_retire_metrics()
        return True

    def recycle(self) -> None:
        from incubator_brpc_tpu_torch.transport.sock import RECYCLED, _registry

        if self._recycled:
            return  # idempotent: the link map and the server may both settle us
        self._recycled = True
        self.set_failed(ErrorCode.ECLOSE, "recycled")
        self.state = RECYCLED
        _registry.recycle(self.id)

    # sync fast path: a device socket has no fd to poll — callers join
    def try_read_ownership(self) -> bool:
        return False

    def kick_poller(self) -> None:
        pass

    def __repr__(self) -> str:
        return f"<DeviceSocket side={self.side} dev={self.link.devices[self.side]}>"


# -- rendezvous + handshake ---------------------------------------------------


class LinkHub:
    """Cookie rendezvous for link halves. Both parties live in one
    process, so the hub is process-global (the reference's analog is the
    rdmacm exchange), one per package.

    Un-taken cookies expire after ``ttl`` seconds (a client whose
    handshake RPC timed out never collects its link): expiry fails the
    link and recycles its server-side socket so nothing leaks."""

    def __init__(self, ttl: float = 60.0) -> None:
        self._lock = threading.Lock()
        self._links: Dict[str, tuple] = {}  # cookie -> (link, created_ts)
        self._ttl = ttl

    def _prune_locked(self) -> None:
        now = time.monotonic()
        for cookie in [c for c, (_, ts) in self._links.items() if now - ts > self._ttl]:
            link, _ = self._links.pop(cookie)
            link.fail("handshake abandoned (cookie expired)")
            for sock in link.socks:
                if sock is not None:
                    sock.recycle()

    def create(
        self, cookie: str, devices, slot_words: int, window: int,
        ack_mode: str = "local",
    ) -> DeviceLink:
        with self._lock:
            self._prune_locked()
            if cookie in self._links:
                raise ValueError("cookie already in use")
            link = DeviceLink(devices, slot_words=slot_words, window=window, ack_mode=ack_mode)
            self._links[cookie] = (link, time.monotonic())
            return link

    def take(self, cookie: str) -> Optional[DeviceLink]:
        with self._lock:
            self._prune_locked()
            entry = self._links.pop(cookie, None)
            return entry[0] if entry is not None else None


link_hub = LinkHub()
_cookie_counter = itertools.count(1)


class DeviceLinkMap:
    """Client-side dedup of established device links keyed by
    (endpoint, local device, geometry) — the SocketMap analog for the
    device plane (reference socket_map.h:35; rdma_endpoint.h:42-213 runs
    one QP per peer). Every Channel shares ONE link per peer+geometry; a
    dead link is recycled and re-handshaken on the next get, behind an
    exponential backoff after a failed handshake."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._links: Dict[tuple, "DeviceSocket"] = {}
        # per-key establishment locks; never deleted (deleting a lock
        # another thread holds would let two handshakes race on one key) —
        # bounded by the distinct peers this process ever contacts
        self._key_locks: Dict[tuple, threading.Lock] = {}
        # re-handshake backoff per key: (consecutive_failures,
        # next_allowed_monotonic). A dead peer must not be storm-redialed
        # by every caller that wants the link — failures double the wait
        # (device_link_backoff_initial_ms .. _max_ms), success clears it
        self._backoff: Dict[tuple, tuple] = {}
        self._cred_refs: Dict[tuple, object] = {}  # keep id()-keyed objects alive

    def _key_lock(self, key: tuple) -> threading.Lock:
        with self._lock:
            lk = self._key_locks.get(key)
            if lk is None:
                lk = self._key_locks[key] = threading.Lock()
            return lk

    def get_or_create(
        self,
        ep: EndPoint,
        device_index: int = 0,
        slot_words: int = 16384,
        window: int = 8,
        timeout_ms: float = 60000,
        ack_mode: str = "local",
        controller: str = "single",
        auth=None,
        ssl_context=None,
        ssl_server_hostname=None,
    ) -> "DeviceSocket":
        """The live link to ``ep`` for this geometry and these credentials,
        handshaking one when there is none. ``controller="multi"``
        handshakes the link whose halves live in two processes
        (``transport/mc_link.py``). ``auth`` is the calling channel's
        Authenticator: the handshake presents it (an auth-requiring server
        rejects a bare bootstrap), and it is part of the link identity —
        channels with different credentials never share a link (the
        reference keys SocketMap by {EndPoint, rdma, ssl, auth},
        socket_map.h:35). ``ssl_*`` are refused until ROADMAP A10."""
        from incubator_brpc_tpu_torch.rpc.controller import refuse_unported
        from incubator_brpc_tpu_torch.transport.sock import CONNECTED
        from incubator_brpc_tpu_torch.utils.flags import get_flag

        if controller not in ("single", "multi"):
            raise ValueError(f"unknown controller {controller!r}")
        for name, value, default, item in (
            ("ssl_context", ssl_context, None, "A10"),
            ("ssl_server_hostname", ssl_server_hostname, None, "A10"),
        ):
            if value != default:
                refuse_unported("DeviceLinkMap.get_or_create", name, value, item)
        ident = f"auth-{id(auth):x}" if auth is not None else ""
        key = (ep.ip, ep.port, device_index, slot_words, window, ack_mode, controller, ident)
        if auth is not None:
            # the key embeds an id(): retain the credential object for the
            # entry's lifetime, or a collected auth object's recycled
            # address would alias a DIFFERENT principal onto this link
            with self._lock:
                self._cred_refs[key] = auth
        # per-key lock: a thundering herd to one peer produces ONE
        # handshake, while links to OTHER peers establish concurrently
        with self._key_lock(key):
            with self._lock:
                ds = self._links.get(key)
            if ds is not None and ds.state == CONNECTED:
                return ds
            if ds is not None:
                ds.recycle()  # free the dead link's registry slot
                with self._lock:
                    self._links.pop(key, None)
            # exponential re-handshake backoff: while a recent attempt to
            # this peer failed, refuse at once instead of dialing
            with self._lock:
                bo = self._backoff.get(key)
            if bo is not None and time.monotonic() < bo[1]:
                raise ConnectionError(
                    f"device link to {ep.ip}:{ep.port} backing off after "
                    f"{bo[0]} failed handshake(s) "
                    f"({max(0.0, bo[1] - time.monotonic()) * 1e3:.0f} ms left)"
                )
            # The handshake rides a fresh host channel to the peer; the
            # client socket map dedupes the TCP connection, so the channel
            # object itself is throwaway.
            from incubator_brpc_tpu_torch.rpc.channel import Channel, ChannelOptions

            try:
                boot = Channel()
                if not boot.init(
                    EndPoint(ip=ep.ip, port=ep.port),
                    options=ChannelOptions(timeout_ms=timeout_ms, auth=auth),
                ):
                    raise ConnectionError(f"device-link bootstrap channel init failed for {ep}")
                if controller == "multi":
                    from incubator_brpc_tpu_torch.transport.mc_link import establish_mc_link

                    ds = establish_mc_link(
                        boot,
                        device_index=device_index,
                        slot_words=slot_words,
                        window=window,
                        timeout_ms=timeout_ms,
                    )
                else:
                    ds = establish_device_link(
                        boot,
                        device_index=device_index,
                        slot_words=slot_words,
                        window=window,
                        timeout_ms=timeout_ms,
                        ack_mode=ack_mode,
                    )
            except Exception:
                # failed handshake: arm/double the backoff window so the
                # next caller fails fast instead of re-storming the peer
                failures = (bo[0] if bo is not None else 0) + 1
                wait_ms = min(
                    int(get_flag("device_link_backoff_initial_ms")) * (2 ** (failures - 1)),
                    int(get_flag("device_link_backoff_max_ms")),
                )
                with self._lock:
                    self._backoff[key] = (failures, time.monotonic() + wait_ms / 1e3)
                raise
            with self._lock:
                self._backoff.pop(key, None)  # healthy again
                # opportunistic sweep: recycle dead entries so a long-lived
                # process contacting many peers does not accumulate them
                for k, old in [(k, v) for k, v in self._links.items() if v.state != CONNECTED]:
                    old.recycle()
                    del self._links[k]
                    if k != key:
                        self._cred_refs.pop(k, None)
                self._links[key] = ds
            return ds

    def live_links(self) -> List["DeviceSocket"]:
        from incubator_brpc_tpu_torch.transport.sock import CONNECTED

        with self._lock:
            return [ds for ds in self._links.values() if ds.state == CONNECTED]

    def recycle_all(self) -> None:
        """Close every link of the map (the client side's F_CLOSE rides
        the link to the server) and forget them and their backoffs."""
        with self._lock:
            links, self._links = list(self._links.values()), {}
            self._backoff.clear()
            self._cred_refs.clear()
        for ds in links:
            ds.recycle()

    def link_profile(self) -> Dict[int, dict]:
        """Per-PEER-device snapshot of the live star's measured link
        telemetry: {peer device index: DeviceLink.profile()}, what the
        topology-aware session scheduler reads. Two links to one peer
        device (distinct geometry keys) keep the faster-measured entry."""
        prof: Dict[int, dict] = {}
        for ds in self.live_links():
            link = ds.link
            pid = _device_id(link.devices[1 - ds.side])
            p = link.profile()
            have = prof.get(pid)
            if have is None or p["gbps"] > have["gbps"]:
                prof[pid] = p
        return prof


device_link_map = DeviceLinkMap()


def link_profile() -> Dict[int, dict]:
    """The process-global star's per-peer telemetry snapshot (see
    :meth:`DeviceLinkMap.link_profile`)."""
    return device_link_map.link_profile()


def shutdown_links(timeout: float = 10.0) -> None:
    """Close every client link of this process and wait (bounded) for
    the close frames and any in-flight steps to finish — before the worker
    pool they run on is stopped (``rpc.shutdown_host_plane``)."""
    device_link_map.recycle_all()
    _quiesce_links(timeout)


def _server_devices(server) -> List[torch.device]:
    """The devices a server's link halves may bind: the one CPU device of
    a Server built with ``ServerOptions(device="cpu")``, else every CUDA
    card PyTorch sees."""
    opt = server.options.device
    if opt is not None and torch.device(opt).type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_handshake_handler(server):
    """The server half of the handshake: an ordinary RPC handler on the
    host socket (the TCP-piggybacked magic+cookie of socket.cpp:1692-1704).
    Builds the link + the server-side DeviceSocket bound to this server's
    messenger and method map."""

    def handshake(cntl, request: bytes) -> bytes:
        try:
            req = json.loads(request.decode())
        except ValueError as e:
            cntl.set_failed(ErrorCode.EREQUEST, f"bad handshake: {e}")
            return b""
        if not isinstance(req, dict):
            cntl.set_failed(ErrorCode.EREQUEST, "bad handshake: not an object")
            return b""
        if req.get("controller") == "multi":
            # the peer's half lives in ANOTHER process; the half built here
            # runs lockstep with it over torch.distributed
            from incubator_brpc_tpu_torch.transport.mc_link import accept_mc_handshake

            return accept_mc_handshake(server, cntl, req)
        try:
            cookie = req["cookie"]
            client_dev = int(req["device"])
            slot_words = int(req.get("slot_words", 16384))
            window = int(req.get("window", 8))
            ack_mode = str(req.get("ack_mode", "local"))
        except (ValueError, KeyError, TypeError) as e:
            cntl.set_failed(ErrorCode.EREQUEST, f"bad handshake: {e}")
            return b""
        devices = _server_devices(server)
        if not devices:
            cntl.set_failed(ErrorCode.EREQUEST, "no device for a link: PyTorch sees no CUDA card")
            return b""
        server_dev = server.options.device_index
        if server_dev is None:
            # prefer a device different from the client's (a second card);
            # on one card both halves share it
            server_dev = (client_dev + 1) % len(devices)
        if not (0 <= client_dev < len(devices) and 0 <= server_dev < len(devices)):
            cntl.set_failed(ErrorCode.EREQUEST, "device index out of range")
            return b""
        try:
            link = link_hub.create(
                cookie,
                [devices[client_dev], devices[server_dev]],
                slot_words=slot_words,
                window=window,
                ack_mode=ack_mode,
            )
        except ValueError as e:
            cntl.set_failed(ErrorCode.EREQUEST, str(e))
            return b""
        ds = DeviceSocket(link, side=1, messenger=server._messenger, context={"server": server})
        server._device_socks.append(ds)

        def _forget(sock, _server=server):
            # a dead link must not accumulate on a long-running server:
            # drop it from the list and free its registry slot
            try:
                _server._device_socks.remove(sock)
            except ValueError:
                pass
            sock.recycle()

        ds.on_failed.append(_forget)
        return json.dumps(
            {
                "device": server_dev,
                "slot_words": slot_words,
                "window": window,
                # fingerprints of this server's device-kernel methods: a
                # fused dispatch lowers a call only when the peer
                # advertises the SAME kernel under that name (ROADMAP A3)
                "device_methods": {
                    full: dm.fingerprint() for full, dm in server._device_methods.items()
                },
            }
        ).encode()

    return handshake


def establish_device_link(
    channel,
    device_index: int = 0,
    slot_words: int = 16384,
    window: int = 8,
    timeout_ms: float = 60000,
    ack_mode: str = "local",
) -> DeviceSocket:
    """Client half: propose over the host socket, then attach side 0.
    ``channel`` must be an initialized single-server Channel whose normal
    (TCP) path carries the handshake RPC."""
    from incubator_brpc_tpu_torch.rpc import channel as channel_mod
    from incubator_brpc_tpu_torch.rpc.controller import Controller

    cookie = f"link-{next(_cookie_counter)}-{id(channel):x}"
    payload = json.dumps(
        {
            "cookie": cookie,
            "device": device_index,
            "slot_words": slot_words,
            "window": window,
            "ack_mode": ack_mode,
        }
    ).encode()
    cntl = channel._call_host(
        HANDSHAKE_SERVICE, HANDSHAKE_METHOD, payload, cntl=Controller(timeout_ms=timeout_ms)
    )
    if cntl.failed():
        raise ConnectionError(f"device handshake failed: {cntl.error_text}")
    link = link_hub.take(cookie)
    if link is None:
        raise ConnectionError("device handshake succeeded but link not found")
    try:
        advertised = json.loads(cntl.response_payload.decode()).get("device_methods", {})
    except (ValueError, AttributeError):
        advertised = {}
    ds = DeviceSocket(link, side=0, messenger=channel_mod._client_messenger)
    # the peer's device-kernel fingerprints gate the fused dispatch (A3)
    ds.device_methods = advertised
    return ds
