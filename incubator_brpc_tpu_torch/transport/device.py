"""Device transport — ``DeviceEndpoint``, the counterpart of
``incubator_brpc_tpu/transport/device.py`` (reference analog:
src/brpc/rdma/rdma_endpoint.h:42-213, a per-connection QP with send/recv
rings and credit-window flow control, and rdma_completion_queue delivery).

- Requests are framed into uint32 device rows on the card (kernel K1a,
  ``ops/kernels.frame_rows``) and the whole server hot path — parse,
  verify, dispatch, handle, respond — runs there (``models/tensor_echo``);
  only the response crosses back.
- The credit window bounds in-flight dispatches (``window_size``, like
  _local_window_capacity, rdma_endpoint.h:176-195): callers park on a
  butex when the window is full, completions release credits.
- Concurrent calls of the same bucket stack into one ``[B, bucket]``
  dispatch (``max_batch``), with B padded to a power of two.
- Payloads are padded to power-of-two buckets of 64 to 2^24 words.
- Each endpoint owns one CUDA stream. A dispatch stages its rows in pinned
  host memory, copies them to the card without blocking, launches, copies
  the response into a pinned host buffer without blocking, and records a
  ``torch.cuda.Event``; the completion queue (``DeviceCompletionButex``)
  watches the event and settles the calls. The staging buffers stay
  referenced until that event has fired.

``call_bytes`` adapts the host byte world: payloads are padded into the
bucket and responses trimmed to the request's length (handlers are
shape-preserving). ``server_handler`` gives an ordinary RPC handler,
``(cntl, request_bytes) -> bytes``, for a Server's method map.
"""

from __future__ import annotations

import threading
import time as _time
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from incubator_brpc_tpu_torch.bvar import Adder, LatencyRecorder
from incubator_brpc_tpu_torch.models.tensor_echo import TensorEchoService
from incubator_brpc_tpu_torch.ops import framing, kernels
from incubator_brpc_tpu_torch.runtime.butex import ETIMEDOUT, Butex
from incubator_brpc_tpu_torch.runtime.device_butex import DeviceCompletionButex
from incubator_brpc_tpu_torch.utils.device import DeviceLike, resolve_device
from incubator_brpc_tpu_torch.utils.status import ErrorCode

MIN_BUCKET_WORDS = 64
MAX_BUCKET_WORDS = 1 << 24  # 64 MiB of uint32

_metrics = None
_metrics_lock = threading.Lock()


def _device_metrics() -> Tuple[Adder, LatencyRecorder]:
    """The process-wide ``device_transport_calls`` / ``_latency`` bvars,
    made with the first endpoint (their window starts a sampler thread)."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            _metrics = (
                Adder(name="device_transport_calls"),
                LatencyRecorder(name="device_transport_latency"),
            )
    return _metrics


def _bucket_words(n: int) -> int:
    b = MIN_BUCKET_WORDS
    while b < n:
        b <<= 1
    if b > MAX_BUCKET_WORDS:
        raise ValueError(f"payload of {n} words exceeds max bucket")
    return b


def _pow2_at_least(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


class _PendingCall:
    __slots__ = ("ready", "response_words", "error_code", "error", "_t0")

    def __init__(self):
        self.ready = Butex(0)
        self.response_words: Optional[np.ndarray] = None
        self.error_code = 0
        self.error: Optional[BaseException] = None
        self._t0 = 0.0

    def settle(self) -> None:
        self.ready.add(1)
        self.ready.wake_all()

    def wait(self, timeout: Optional[float]) -> bool:
        while self.ready.load() == 0:
            if self.ready.wait(0, timeout=timeout) == ETIMEDOUT:
                return False
        return True


class DeviceEndpoint:
    """One device-resident service behind a credit window."""

    def __init__(
        self,
        service: Optional[TensorEchoService] = None,
        device: DeviceLike = None,
        window_size: int = 8,
        max_batch: int = 16,
    ):
        self.device = resolve_device(device)
        self.service = service or TensorEchoService()
        self.window_size = window_size
        # At most window_size calls hold credits at once, so a larger
        # batch ceiling could never form.
        self.max_batch = max(1, min(max_batch, window_size))
        self._credits = Butex(window_size)
        self._cq = DeviceCompletionButex()
        self._queue = deque()  # (bucket, mid, cid_lo, words, pending)
        self._qlock = threading.Lock()
        self._draining = False
        self._threads: list = []  # drainer and submit threads, joined by close()
        self._threads_lock = threading.Lock()
        self._calls, self._latency = _device_metrics()
        self._stream = (
            torch.cuda.Stream(device=self.device) if self.device.type == "cuda" else None
        )

    # -- credit window (rdma_endpoint.h:176-195) ----------------------------

    def _acquire_credit(self, timeout: Optional[float]) -> bool:
        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            c = self._credits.load()
            if c > 0 and self._credits.compare_exchange(c, c - 1):
                return True
            if c > 0:
                continue  # CAS race: retry
            remaining = None
            if deadline is not None:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
            self._credits.wait(0, timeout=remaining)

    def _release_credit(self) -> None:
        self._credits.add(1)
        self._credits.wake(1)  # one credit frees one waiter, no herd

    @property
    def inflight(self) -> int:
        return self.window_size - self._credits.load()

    # -- call paths ---------------------------------------------------------

    def call_words(
        self,
        payload_words: np.ndarray,
        method_id: int = 0,
        correlation_id: int = 1,
        timeout: Optional[float] = 10.0,
    ) -> _PendingCall:
        """Async: queue -> frame on the card -> fused step -> completion.
        Returns a _PendingCall the caller can wait on; the credit is held
        until the response settles (the per-WR ack discipline)."""
        pending = _PendingCall()
        if not self._acquire_credit(timeout):
            pending.error_code = ErrorCode.EOVERCROWDED
            pending.settle()
            return pending
        self._calls << 1
        pending._t0 = _time.monotonic()
        # a copy, so the caller may reuse its buffer; cast to uint32 words
        # when staged
        words = np.array(payload_words).reshape(-1)
        try:
            bucket = _bucket_words(max(1, words.shape[0]))
        except ValueError:
            # oversized payload: the credit MUST come back (a leak here
            # shrinks the window forever) and the caller gets the settled-
            # pending contract, not a raw exception
            self._release_credit()
            pending.error_code = ErrorCode.EREQUEST
            pending.settle()
            return pending
        entry = (
            bucket,
            int(method_id) & 0xFFFFFFFF,
            int(correlation_id) & 0xFFFFFFFF,
            words,
            pending,
        )
        with self._qlock:
            self._queue.append(entry)
            if self._draining:
                return pending  # the live drainer will pick it up
            self._draining = True
        # a DEDICATED thread, not a worker-pool fiber: handler fibers block
        # waiting on these dispatches, so a saturated pool could strand the
        # drainer behind the very callers it must unblock
        self._spawn(self._drain, "tbtorch-dev-batch")
        return pending

    def _spawn(self, target, name: str, args=()) -> None:
        t = threading.Thread(target=target, args=args, name=name, daemon=True)
        with self._threads_lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
            t.start()

    def close(self, timeout: Optional[float] = 30.0) -> bool:
        """Wait until every call has settled, then join the endpoint's
        drainer and submit threads. The endpoint stays usable (a later call
        starts a drainer again). False if they did not finish in time."""
        deadline = None if timeout is None else _time.monotonic() + timeout

        def left() -> Optional[float]:
            return None if deadline is None else max(0.0, deadline - _time.monotonic())

        while self.inflight or self._queue:
            if left() == 0.0:
                return False
            _time.sleep(0.001)
        with self._threads_lock:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(left())
        return not any(t.is_alive() for t in threads)

    # -- the batching drainer (single drainer) -------------------------------

    def _drain(self) -> None:
        while True:
            with self._qlock:
                if not self._queue:
                    self._draining = False
                    return
                # group the head run of SAME-BUCKET entries
                bucket = self._queue[0][0]
                batch = []
                while (
                    self._queue
                    and self._queue[0][0] == bucket
                    and len(batch) < self.max_batch
                ):
                    batch.append(self._queue.popleft())
                more = bool(self._queue)
            if more:
                # staggered arrivals: submit THIS batch on its own thread so
                # the next batch's staging overlaps it
                self._spawn(self._dispatch_batch, "tbtorch-dev-batch-tx", (bucket, batch))
            else:
                self._dispatch_batch(bucket, batch)

    def _staging(self, shape) -> torch.Tensor:
        pinned = self.device.type == "cuda"
        return torch.empty(shape, dtype=torch.uint32, pin_memory=pinned)

    def _launch(self, rows: torch.Tensor, meta: torch.Tensor):
        """Stage, frame (K1a) and step one batch. ``rows`` ``[B, bucket]``
        and ``meta`` ``[2, B]`` (cid_lo, mid) are host tensors. Returns
        (work to watch, host response rows, buffers to keep alive)."""
        if self.device.type == "cpu":
            framed = kernels.frame_rows(rows, meta[0], meta[1])
            response = self.service.step_rows(framed)
            return response, response, ()
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            rows_d = rows.to(self.device, non_blocking=True)
            meta_d = meta.to(self.device, non_blocking=True)
            framed = kernels.frame_rows(rows_d, meta_d[0], meta_d[1])
            response = self.service.step_rows(framed)
            host = torch.empty(response.shape, dtype=torch.uint32, pin_memory=True)
            host.copy_(response, non_blocking=True)
            done = torch.cuda.Event(blocking=True)
            done.record(self._stream)
        return done, host, (rows, meta)

    def _stage(self, bucket: int, batch: list):
        bpad = _pow2_at_least(len(batch))
        rows = self._staging((bpad, bucket))
        meta = self._staging((2, bpad))
        rows_np, meta_np = rows.numpy(), meta.numpy()
        meta_np[:] = 0
        for i, (_, mid, cid, words, _p) in enumerate(batch):
            n = words.shape[0]
            rows_np[i, :n] = words
            rows_np[i, n:] = 0
            meta_np[0, i] = cid
            meta_np[1, i] = mid
        # pad rows are zero frames whose (flagged) response rows are ignored
        rows_np[len(batch):] = 0
        return rows, meta

    def _dispatch_batch(self, bucket: int, batch: list) -> None:
        try:
            rows, meta = self._stage(bucket, batch)
            work, host, keep = self._launch(rows, meta)
        except Exception as e:  # noqa: BLE001 — dispatch failed: settle the whole batch
            for *_, pending in batch:
                pending.error = e
                pending.error_code = ErrorCode.EINTERNAL
                self._release_credit()
                pending.settle()
            return

        def on_complete(_work, error, _batch=batch, _host=host, _keep=keep):
            try:
                host_np = None if error is not None else _host.numpy()
            except Exception as e:  # noqa: BLE001 — fetch failed
                error, host_np = e, None
            for i, (*_, words, pending) in enumerate(_batch):
                try:
                    if error is not None:
                        pending.error = error
                        pending.error_code = ErrorCode.EINTERNAL
                    else:
                        _, payload, err = _parse_response(host_np[i])
                        pending.error_code = int(err)
                        pending.response_words = payload[: words.shape[0]]
                    self._latency << (_time.monotonic() - pending._t0) * 1e6
                except Exception as e:  # noqa: BLE001 — parse failed
                    pending.error = e
                    pending.error_code = ErrorCode.EINTERNAL
                    pending.response_words = None
                finally:
                    self._release_credit()
                    pending.settle()

        self._cq.watch(work, on_complete=on_complete)

    def call_bytes(
        self,
        payload: bytes,
        method_id: int = 0,
        correlation_id: int = 1,
        timeout: Optional[float] = 10.0,
    ) -> Tuple[int, bytes]:
        """Sync byte adapter: pad to words, run, trim the response to the
        request's byte length (handlers are shape-preserving)."""
        nbytes = len(payload)
        pad = (-nbytes) % 4
        words = np.frombuffer(payload + b"\x00" * pad, dtype=np.uint32)
        # ONE deadline budget across credit-wait + completion-wait
        deadline = None if timeout is None else _time.monotonic() + timeout
        pending = self.call_words(
            words, method_id=method_id, correlation_id=correlation_id, timeout=timeout
        )
        remaining = None
        if deadline is not None:
            remaining = max(0.0, deadline - _time.monotonic())
        if not pending.wait(remaining):
            return ErrorCode.ERPCTIMEDOUT, b""
        if pending.error_code:
            return pending.error_code, b""
        return 0, pending.response_words.tobytes()[:nbytes]

    def warm(self, payload_bytes: int) -> None:
        """Prepare every (batch, bucket) geometry this payload size can hit
        — single + each power-of-two batch up to max_batch: builds the
        kernels on first use, fills the pinned-memory cache with staging
        buffers of each shape, and runs each geometry once. Nothing is
        compiled per geometry; this keeps first-use costs out of a timed
        or latency-sensitive workload."""
        n_words = max(1, (payload_bytes + 3) // 4)
        bucket = _bucket_words(n_words)
        if self.device.type == "cuda":
            kernels.build()
        b = 1
        while b <= self.max_batch:
            rows = self._staging((b, bucket))
            meta = self._staging((2, b))
            rows.numpy()[:] = 0
            meta.numpy()[:] = 0
            work, _, _ = self._launch(rows, meta)
            if self.device.type == "cuda":
                work.synchronize()
            b <<= 1

    # -- host-plane integration --------------------------------------------

    def server_handler(self, method_id: int = 0, timeout: float = 60.0):
        """An ordinary Server handler, ``(cntl, request_bytes) -> bytes``,
        that delegates to this endpoint: the request payload goes to the
        card, the fused step runs, the response comes back. ``timeout``
        budgets credit-wait + queued-batch dispatch + completion."""

        def handler(cntl, request: bytes) -> bytes:
            code, out = self.call_bytes(
                request,
                method_id=method_id,
                correlation_id=cntl.call_id or 1,
                timeout=timeout,
            )
            if code:
                cntl.set_failed(code, f"device call failed ({code})")
                return b""
            return out

        return handler


def _parse_response(host_frame: np.ndarray):
    """Host-side parse of a response row (the 8-word header of
    ops/framing.py, read with numpy — no second device round trip).
    Word 7 is the error code on responses."""
    header = host_frame[: framing.HEADER_WORDS]
    payload = host_frame[framing.HEADER_WORDS :]
    return header, payload, header[7]
