"""Multi-controller device links — the device plane across PROCESSES, the
counterpart of ``incubator_brpc_tpu/transport/mc_link.py``.

The single-controller ``DeviceLink`` (transport/device_link.py) holds both
halves of the QP in one process. The reference transport connects
*separate hosts*: the RDMA handshake crosses the TCP socket between two
machines and each side runs its own send/recv rings
(rdma/rdma_endpoint.h:42-213, per-host device init rdma_helper.cpp). Here:

- **One process per party.** Each process of a job
  (``utils/distributed.py``) owns ONE side of the link: its own device, its
  own outbound queue, its own DeviceSocket and messenger. A party is keyed
  by its RANK in the job, not by its device: on one card every process
  holds ``cuda:0``, so two halves on the same device are two parties as
  long as their ranks differ (the JAX package refuses the same global
  device, :433-440; the port refuses the same rank).
- **The data plane is lockstep.** Both processes run the SAME exchange the
  SAME number of times in the SAME order over the link's two-rank process
  group (``link_group``): one ``allgather`` of the two slot rows, where the
  JAX package dispatches a ``ppermute``; each side keeps the peer's row.
  This side's row lives on the process's device (a CUDA tensor on a card,
  moved by gloo through the host or by NCCL across cards). The group is
  joined on a thread of the link's own when the link is built (both halves
  must meet in the store, and the server half exists before the client
  half), and the first exchange waits for it.
- **The control plane rides the host socket.** How many exchange steps
  both sides agree to dispatch flows as tiny JSON messages on a streaming
  RPC (rpc/stream.py) opened by the same handshake RPC that proposes the
  link: the reference's rdmacm-over-TCP split (socket.cpp:1692-1704). Each
  side announces ``want`` = the step count its backlog needs; both run
  ``target = max(all wants)`` — a monotone join that needs no consensus
  round.
- **Credit: the collective IS the window.** Each side gates dispatch on
  its OWN undrained steps (``seq - delivered < window``): a receiver that
  stops draining stops dispatching, which stalls the peer's collectives at
  exactly ``window`` steps of pipeline. The cumulative-delivered count
  still rides slot words 3+5 (``peer_ack``) as the cross-host drain
  telemetry; a peer that delivers nothing for ``wedge_timeout`` seconds
  fails the link (the wedge timer). The drive waits on DELIVERY progress
  (the link's ``_wbutex``), as the single-controller drive does; the JAX
  package waits on completions, which race the delivery that follows them.
- **Completions have a thread of their own per link**
  (``tbtorch-mclink-N``): it waits on each step's collective in order and
  hands the peer's row (read back to the host) to a worker fiber for
  in-order delivery, so a step blocked on a slow peer never parks the
  shared completion watchers that device methods use.
- **Shutdown is a two-message dance.** Either side freezes its wants and
  sends ``close_req(target)``; the peer freezes, computes
  ``final = max(targets)`` and answers ``close_ack(final)``. Stream ordering
  makes ``final`` identical on both sides, so both dispatch exactly
  ``final`` steps and tear down — no half-joined collective.
- **Peer death fails fast.** A dead peer's host socket fails under the
  control stream, which fails the link with EFAILEDSOCKET; a collective
  blocked on the dead peer errors when gloo sees the connection close, and
  the group's timeout (never longer than ``wedge_timeout``) bounds it
  otherwise. ``fail`` also aborts the group where the backend has
  ``abort``.
"""

from __future__ import annotations

import itertools
import json
import logging
import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from incubator_brpc_tpu_torch.bvar import Adder
from incubator_brpc_tpu_torch.transport.device_link import (
    HANDSHAKE_METHOD,
    HANDSHAKE_SERVICE,
    LINK_HEADER_WORDS,
    DeviceLink,
    DeviceSocket,
    link_steps,
)
from incubator_brpc_tpu_torch.utils.status import ErrorCode

logger = logging.getLogger(__name__)

mc_ctrl_msgs = Adder(name="mc_link_control_msgs")
# waits for a delivery that made no progress (peer slow / not yet
# dispatching): each tick is one bounded 1 s retry before the wedge timer
mc_stall_retries = Adder(name="mc_link_stall_retries")
mc_wedge_failures = Adder(name="mc_link_wedge_failures")

_group_keys = itertools.count(1)
_STOP = object()  # completion-thread sentinel


class MultiControllerLink(DeviceLink):
    """One side of a two-process device link (see module docstring).

    ``own_side``: 0 = client (the handshake proposer), 1 = server.
    ``devices``: the two parties' devices in link order [client, server];
    only ``devices[own_side]`` is this process's. ``ranks``: the two
    parties' job ranks in the same order. ``make_group(timeout)``: builds
    the link's two-rank process group (this process at ``own_side``) whose
    collectives time out after ``timeout`` s, e.g. over
    ``utils.distributed.link_group``; it is called once, on the link's join
    thread, with ``wedge_timeout``. ``control_send``: ships one small dict
    to the peer's ``on_control`` (the streaming-RPC control plane).
    """

    def __init__(
        self,
        own_side: int,
        devices: List,
        ranks: List[int],
        make_group: Callable[[float], object],
        slot_words: int = 16384,
        window: int = 8,
        control_send: Optional[Callable[[dict], None]] = None,
        wedge_timeout: float = 120.0,
    ):
        if len(ranks) != 2 or ranks[0] == ranks[1]:
            raise ValueError(f"a multi-controller link needs two distinct ranks, got {ranks}")
        self.own_side = own_side
        self.ranks = [int(r) for r in ranks]
        self._control_send_fn = control_send
        self._target = 0  # steps both sides agreed to dispatch
        self._final_target: Optional[int] = None  # set by the close dance
        self._frozen = False  # close dance started: wants stop growing
        self._finished = False
        self._ctrl_close: Optional[Callable[[], None]] = None
        self.wedge_timeout = wedge_timeout
        self._group = None
        self._group_error: Optional[BaseException] = None
        self._group_ready = threading.Event()
        self._completions: "queue.Queue" = queue.Queue()
        # exchange telemetry: host time per exchange (dispatch to the
        # peer's row on the host), their count, and the device of the last
        # row this side handed to the collective
        self.exchanges = 0
        self.exchange_s = 0.0
        self.row_device: Optional[torch.device] = None
        # the base class builds the step over this process's device only:
        # the peer's device is not addressable from here
        super().__init__(
            [devices[own_side]] * 2, slot_words=slot_words, window=window,
            host_loopback=False, ack_mode="wire",
        )
        own = self.devices[0]
        self.devices = [torch.device(d) for d in devices]
        self.devices[own_side] = own
        threading.Thread(
            target=self._join_group, args=(make_group,),
            name=f"tbtorch-mclink-{self.link_id}-join", daemon=True,
        ).start()
        threading.Thread(
            target=self._complete_loop,
            name=f"tbtorch-mclink-{self.link_id}", daemon=True,
        ).start()

    # -- the exchange ----------------------------------------------------------

    def _build_step(self) -> None:
        self._width = LINK_HEADER_WORDS + self.slot_words
        self._host_loopback = False
        dev = self.devices[0]  # this process's device (both entries, see __init__)
        self._streams = {str(dev): torch.cuda.Stream(device=dev)} if dev.type == "cuda" else {}
        self._step = self._exchange

    def _join_group(self, make_group) -> None:
        try:
            self._group = make_group(self.wedge_timeout)
        except Exception as e:  # noqa: BLE001 — a failed join fails the link
            logger.exception("mc link group join failed")
            self._group_error = e
        self._group_ready.set()

    def _make_local_slots(self, row: np.ndarray) -> torch.Tensor:
        """This side's outbound row on the process's device (through a
        pinned host buffer on the link's stream when it is a card)."""
        dev = self.devices[self.own_side]
        host = torch.from_numpy(row.view(np.int32))
        if dev.type != "cuda":
            return host
        with torch.cuda.stream(self._streams[str(dev)]):
            return host.pin_memory().to(dev, non_blocking=True)

    def _exchange(self, row: np.ndarray):
        """One lockstep step: an ``allgather`` of both parties' rows over
        the link's group (the JAX package's ``ppermute``). Returns the
        collective's handle and the gathered rows."""
        local = self._make_local_slots(row)
        dev = local.device
        if dev.type == "cuda":
            # gloo (which stages CUDA rows through the host itself) and
            # NCCL run on their own streams: the row's copy must land first
            torch.cuda.current_stream(dev).wait_stream(self._streams[str(dev)])
        outs = [torch.empty_like(local) for _ in range(2)]
        work = self._group.allgather([outs], [local])
        self.row_device = dev
        return work, outs, local

    def _peer_row_to_host(self, outs) -> np.ndarray:
        peer = outs[1 - self.own_side]
        if peer.device.type != "cuda":
            return peer.numpy().view(np.uint32)
        stream = self._streams[str(peer.device)]
        stream.wait_stream(torch.cuda.current_stream(peer.device))
        host = torch.empty(peer.shape, dtype=peer.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            host.copy_(peer, non_blocking=True)
        stream.synchronize()
        return host.numpy().view(np.uint32)

    def _complete_loop(self) -> None:
        """Wait on each dispatched step in order; hand the peer's row to a
        worker fiber for in-order delivery. Ends at the sentinel."""
        while True:
            item = self._completions.get()
            if item is _STOP:
                return
            seq, work, outs, _local, t0 = item  # _local: the sent row, alive until done
            try:
                work.wait()
                row = self._peer_row_to_host(outs)
            except Exception as e:  # noqa: BLE001 — a failed step fails the link
                self._pool.spawn(self._on_step_done, seq, None, e)
                continue
            self.exchanges += 1
            self.exchange_s += time.perf_counter() - t0
            self._pool.spawn(self._on_step_done, seq, row, None)

    def _deliver(self, arrays) -> None:
        """The peer's row, delivered to this side's socket."""
        self._deliver_row(self.own_side, arrays)

    # -- control plane -------------------------------------------------------

    def _send_ctrl(self, msg: dict) -> None:
        fn = self._control_send_fn
        if fn is None:
            return
        try:
            fn(msg)
            mc_ctrl_msgs << 1
        except Exception:
            logger.exception("mc link control send failed")
            self.fail("control plane send failed")

    def _need_locked(self) -> int:
        """Steps this side's queued bytes (and a pending close) need."""
        need = (self._out_nbytes[self.own_side] + self._slot_bytes - 1) // self._slot_bytes
        if self._close_pending[self.own_side]:
            need = max(need, 1)
        return need

    def on_control(self, msg: dict) -> None:
        """Peer control message (runs on the control stream's consumer
        fiber — ordered, one at a time)."""
        op = msg.get("op")
        if op == "want":
            with self._lock:
                if not self._frozen and not self._closed:
                    self._target = max(self._target, int(msg["n"]))
            self._kick()
        elif op == "close_req":
            with self._lock:
                self._frozen = True
                self._send_blocked = True  # refuse post-freeze queues
                # our own backlog queued before this freeze still needs
                # steps — fold it into the final count (a send() that
                # returned 0 must reach the wire; the peer learns the
                # raised final from the close_ack)
                final = max(self._target, int(msg["target"]), self._seq + self._need_locked())
                self._target = final
                self._final_target = final
            self._send_ctrl({"op": "close_ack", "target": final})
            self._kick()
        elif op == "close_ack":
            with self._lock:
                final = int(msg["target"])
                self._target = max(self._target, final)
                self._final_target = final
            self._kick()
        else:
            logger.warning("mc link: unknown control op %r", op)

    def _propagate_want(self) -> None:
        """After queuing bytes: if the backlog needs steps beyond the
        current target, raise it locally and announce to the peer. The
        target only ever grows (monotone max both sides converge on)."""
        with self._lock:
            if self._closed or self._frozen:
                return
            want = self._seq + self._need_locked()
            if want <= self._target:
                return
            self._target = want
        self._send_ctrl({"op": "want", "n": want})
        self._kick()

    # -- send / close --------------------------------------------------------

    def send(self, side: int, data, timeout: Optional[float] = 10.0) -> int:
        if side != self.own_side:
            raise ValueError("a multi-controller link sends only from its own side")
        rc = super().send(side, data, timeout=timeout)
        if rc == 0:
            self._propagate_want()
        return rc

    def close(self, side: int) -> None:
        with self._lock:
            if self._closed or self._frozen:
                return
            self._close_pending[self.own_side] = True
            self._frozen = True
            self._send_blocked = True  # refuse post-freeze queues
            self._target = max(self._target, self._seq + self._need_locked())
            t = self._target
        self._send_ctrl({"op": "close_req", "target": t})
        self._kick()

    # -- the lockstep drive loop --------------------------------------------

    def _drive(self) -> None:
        stall_since: Optional[float] = None
        while True:
            with self._lock:
                if self._closed:
                    self._driving = False
                    return
                finish = (
                    self._final_target is not None
                    and self._seq >= self._final_target
                    and self._inflight == 0
                )
                if finish:
                    self._driving = False
                else:
                    if self._seq >= self._target:
                        # nothing agreed to dispatch; on_control/send kick
                        # the drive again when the target grows
                        self._driving = False
                        return
                    if self._inflight >= self.window:
                        # own-delivery credit: wait for a delivery
                        need = self._wbutex.load()
                        delivered = self._next_deliver
                    else:
                        need = None
                        row = self._fill_slot_locked(self.own_side)
                        seq = self._seq
                        self._seq += 1
                        self._inflight += 1
                        self._step_ts[seq] = time.perf_counter()
            if finish:
                self._finish_close()
                return
            if need is not None:
                self._wbutex.wait(need, timeout=1.0)
                with self._lock:
                    progressed = self._next_deliver != delivered
                if progressed:
                    stall_since = None
                    continue
                # no delivery progress: the peer may have stopped
                # dispatching (died mid-burst). The backend errors a
                # half-joined collective when it sees the peer go; this
                # timer bounds the wait even if it blocks silently.
                mc_stall_retries << 1
                now = time.monotonic()
                if stall_since is None:
                    stall_since = now
                elif now - stall_since > self.wedge_timeout:
                    mc_wedge_failures << 1
                    self.fail("device plane wedged (peer not dispatching)")
                    with self._lock:
                        self._driving = False
                    return
                continue
            stall_since = None
            try:
                if not self._group_ready.wait(self.wedge_timeout):
                    raise TimeoutError("link group not joined within the wedge timeout")
                if self._group_error is not None:
                    raise self._group_error
                t0 = time.perf_counter()
                work, outs, local = self._exchange(row)
            except Exception:
                logger.exception("mc link step dispatch failed")
                self.fail("link step dispatch failed")
                with self._lock:
                    self._driving = False
                return
            link_steps << 1
            self._completions.put((seq, work, outs, local, t0))

    def _finish_close(self) -> None:
        """Both sides dispatched exactly ``final_target`` steps and every
        delivery drained: the link is done. Quiet teardown — no fail()
        cascade into the peer (it finishes its own count)."""
        with self._lock:
            if self._finished or self._closed:
                return
            self._finished = True
            self._closed = True
        self._retire_metrics()  # clean close never reaches fail()
        sock = self.socks[self.own_side]
        if sock is not None:
            sock.set_failed(ErrorCode.ECLOSE, "device link closed")
        self._wbutex.add(1)
        self._wbutex.wake_all()
        self._close_ctrl()
        self._completions.put(_STOP)

    def fail(self, reason: str) -> None:
        with self._lock:
            was_closed = self._closed
        super().fail(reason)
        if was_closed:
            return
        # a dead link must not leave its control stream (and this link,
        # captured by the stream handler) attached to the shared TCP
        # connection forever
        self._close_ctrl()
        group = self._group
        abort = getattr(group, "abort", None)
        if abort is not None:
            try:
                abort()
            except Exception:  # noqa: BLE001 — best effort on a dead link
                logger.exception("mc link group abort raised")
        self._completions.put(_STOP)

    def _close_ctrl(self) -> None:
        fn, self._ctrl_close = self._ctrl_close, None
        if fn is not None:
            try:
                fn()
            except Exception:
                logger.exception("mc link control stream close raised")

    @property
    def peer_ack(self) -> int:
        """Cumulative frames the peer reported delivered (slot words 3+5) —
        the cross-host drain telemetry."""
        with self._lock:
            return self._peer_ack

    def parties(self) -> List[tuple]:
        """The two parties as (rank, device) pairs, in link order."""
        return [(self.ranks[i], str(self.devices[i])) for i in (0, 1)]


# -- control stream plumbing ---------------------------------------------------


class _ControlHandler:
    """StreamHandler for the link's control plane. Messages are one JSON
    dict per stream message; they run on the stream's ordered consumer
    fiber, which is exactly the delivery order the close dance needs."""

    def __init__(self) -> None:
        self.link: Optional[MultiControllerLink] = None

    def on_received_messages(self, stream, messages: List[bytes]) -> None:
        link = self.link
        if link is None:
            return
        for m in messages:
            try:
                msg = json.loads(m.decode())
            except ValueError:
                logger.warning("mc link: undecodable control message")
                continue
            link.on_control(msg)

    def on_closed(self, stream) -> None:
        link = self.link
        if link is None:
            return
        # a clean shutdown closes the stream after the final step; only an
        # unexpected close (peer died) fails the link
        if link._final_target is None and not link._closed:
            link.fail("control stream closed by peer")

    def on_failed(self, stream, error_code: int, reason: str) -> None:
        link = self.link
        if link is not None and not link._closed:
            link.fail(f"control stream failed: {reason}")


def _stream_sender(stream) -> Callable[[dict], None]:
    def send(msg: dict) -> None:
        rc = stream.write(json.dumps(msg).encode(), timeout=10.0)
        if rc != 0:
            raise ConnectionError(f"control stream write failed: {rc}")

    return send


def _group_maker(key: str, ranks: List[int], backend: str):
    from incubator_brpc_tpu_torch.utils.distributed import link_group

    return lambda timeout: link_group(key, ranks, backend, timeout)


# -- establishment -------------------------------------------------------------


def accept_mc_handshake(server, cntl, req: dict) -> bytes:
    """Server half, called from the ``_tpu_transport.handshake`` handler
    when the proposal carries ``controller='multi'``. Accepts the control
    stream riding the same RPC, builds this process's link half over its
    own device, and answers with its rank and device so the client builds
    the same pair."""
    from incubator_brpc_tpu_torch.rpc.stream import StreamOptions, stream_accept
    from incubator_brpc_tpu_torch.utils.distributed import current_job

    handler = _ControlHandler()
    ctrl = stream_accept(cntl, StreamOptions(handler=handler))
    if ctrl is None:
        cntl.set_failed(ErrorCode.EREQUEST, "multi-controller handshake needs a control stream")
        return b""
    job = current_job()
    if job is None:
        cntl.set_failed(
            ErrorCode.EREQUEST,
            "this process is in no job: a multi-controller link needs "
            "utils.distributed.init_job",
        )
        return b""
    try:
        client_rank = int(req["client_rank"])
        client_dev = str(req["client_device"])
        backend = str(req["backend"])
        key = str(req["group"])
        slot_words = int(req.get("slot_words", 16384))
        window = int(req.get("window", 8))
    except (KeyError, ValueError, TypeError) as e:
        cntl.set_failed(ErrorCode.EREQUEST, f"bad mc handshake: {e}")
        return b""
    if client_rank == job.rank:
        cntl.set_failed(
            ErrorCode.EREQUEST,
            "client and server proposed the same rank — a multi-controller "
            "link needs one rank per process",
        )
        return b""
    if backend != job.backend:
        cntl.set_failed(
            ErrorCode.EREQUEST,
            f"backend {backend!r} proposed, this process's job runs {job.backend!r}",
        )
        return b""
    ranks = [client_rank, job.rank]
    link = MultiControllerLink(
        own_side=1,
        devices=[client_dev, job.device],
        ranks=ranks,
        make_group=_group_maker(key, ranks, backend),
        slot_words=slot_words,
        window=window,
        control_send=_stream_sender(ctrl),
    )
    link._ctrl_close = ctrl.close
    handler.link = link
    ds = DeviceSocket(link, side=1, messenger=server._messenger, context={"server": server})
    # fingerprint consumption is symmetric: the client's advertised device
    # methods land on the server-side socket too
    ds.device_methods = dict(req.get("device_methods") or {})
    server._device_socks.append(ds)

    def _forget(sock, _server=server):
        try:
            _server._device_socks.remove(sock)
        except ValueError:
            pass
        sock.recycle()

    ds.on_failed.append(_forget)
    return json.dumps(
        {
            "rank": job.rank,
            "device": str(job.device),
            "slot_words": slot_words,
            "window": window,
            "device_methods": {
                full: dm.fingerprint() for full, dm in server._device_methods.items()
            },
        }
    ).encode()


def establish_mc_link(
    channel,
    device_index: int = 0,
    slot_words: int = 16384,
    window: int = 8,
    timeout_ms: float = 60000,
) -> DeviceSocket:
    """Client half: open the control stream, propose over the host socket,
    build side 0 over this process's device and the agreed pair. The
    returned DeviceSocket rides RPC frames over the lockstep exchange.

    ``device_index`` keeps the JAX package's place (an index into the
    process's local devices); a port process owns one device, its job's,
    and the link binds that one."""
    from incubator_brpc_tpu_torch.rpc import channel as channel_mod
    from incubator_brpc_tpu_torch.rpc.controller import Controller
    from incubator_brpc_tpu_torch.rpc.device_method import registry_fingerprints
    from incubator_brpc_tpu_torch.rpc.stream import StreamOptions, stream_create
    from incubator_brpc_tpu_torch.utils.distributed import current_job

    job = current_job()
    if job is None:
        raise ConnectionError(
            "this process is in no job: a multi-controller link needs "
            "utils.distributed.init_job"
        )
    key = f"mc-link/{job.rank}/{next(_group_keys)}"
    handler = _ControlHandler()
    ctrl = stream_create(StreamOptions(handler=handler))
    payload = json.dumps(
        {
            "controller": "multi",
            "cookie": "",
            "client_rank": job.rank,
            "client_device": str(job.device),
            "backend": job.backend,
            "group": key,
            "slot_words": slot_words,
            "window": window,
            "device_methods": registry_fingerprints(),
        }
    ).encode()
    cntl = Controller(timeout_ms=timeout_ms)
    cntl._force_host = True
    cntl = channel.call_method(
        HANDSHAKE_SERVICE, HANDSHAKE_METHOD, payload, cntl=cntl, request_stream=ctrl
    )
    if cntl.failed():
        ctrl.close()
        raise ConnectionError(f"multi-controller handshake failed: {cntl.error_text}")
    try:
        resp = json.loads(cntl.response_payload.decode())
        ranks = [job.rank, int(resp["rank"])]
        link = MultiControllerLink(
            own_side=0,
            devices=[job.device, str(resp["device"])],
            ranks=ranks,
            make_group=_group_maker(key, ranks, job.backend),
            slot_words=int(resp.get("slot_words", slot_words)),
            window=int(resp.get("window", window)),
            control_send=_stream_sender(ctrl),
        )
    except Exception:
        # the server already built its half: closing the control stream
        # is what tells it to fail that half instead of wedging
        ctrl.close()
        raise
    link._ctrl_close = ctrl.close
    handler.link = link
    ds = DeviceSocket(link, side=0, messenger=channel_mod._client_messenger)
    ds.device_methods = resp.get("device_methods", {})
    return ds
