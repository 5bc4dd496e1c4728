"""rpc_dump — sampled request capture to disk (reference
src/brpc/rpc_dump.{h,cpp}: RpcDumpContext sampled via the bvar collector
speed limiter; files are replayed by tools/rpc_replay).

Captured requests are written as ordinary tbus_std frames, so a dump file
is just a byte-stream of the same wire format — rpc_replay cuts frames
with try_parse_frame and re-issues them through a Channel, and rpc_view
prints them. Sampling is a per-second token budget
(``rpc_dump_max_requests_per_second``), the collector-speed-limiter role.

Enabled by the reloadable ``rpc_dump`` flag; the server samples each
admitted request before running the handler (the reference hooks the same
spot in ProcessRpcRequest).

The port's copy of the JAX package's ``rpc/dump.py``: a dump file written
by either package reads back through either ``load_dump_file``, and is
replayed by ``python -m incubator_brpc_tpu_torch.tools.rpc_replay`` and
printed by ``python -m incubator_brpc_tpu_torch.tools.rpc_view``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from incubator_brpc_tpu_torch.protocol.tbus_std import Meta, pack_frame
from incubator_brpc_tpu_torch.utils.flags import define_flag, get_flag

define_flag("rpc_dump", False, "sample requests to disk for replay", lambda v: True)
define_flag(
    "rpc_dump_dir",
    "./rpc_dump",
    "directory for dump files",
    lambda v: bool(v),
)
define_flag(
    "rpc_dump_max_requests_per_second",
    100,
    "sampling budget per second",
    lambda v: v > 0,
)
define_flag(
    "rpc_dump_max_requests_in_one_file",
    1000,
    "rotate dump file after this many requests",
    lambda v: v > 0,
)


class RpcDumper:
    def __init__(self, directory: Optional[str] = None):
        self._dir = directory
        self._lock = threading.Lock()
        self._file = None
        self._in_file = 0
        self._file_seq = 0
        self._window_start = 0.0
        self._window_count = 0
        self.sampled_total = 0

    def _admit(self) -> bool:
        budget = int(get_flag("rpc_dump_max_requests_per_second"))
        now = time.monotonic()
        if now - self._window_start >= 1.0:
            self._window_start = now
            self._window_count = 0
        if self._window_count >= budget:
            return False
        self._window_count += 1
        return True

    def _rotate(self) -> None:
        directory = self._dir or str(get_flag("rpc_dump_dir"))
        os.makedirs(directory, exist_ok=True)
        if self._file is not None:
            self._file.close()
        path = os.path.join(
            directory, f"requests.{os.getpid()}.{self._file_seq:04d}"
        )
        self._file_seq += 1
        self._file = open(path, "ab")
        self._in_file = 0

    def sample(self, meta: Meta, payload: bytes, attachment: bytes = b"") -> bool:
        """Capture one request if the budget allows. Never raises — dump
        failures must not fail the RPC being sampled."""
        # lock-free fast path: once this second's budget is spent, skip
        # without touching the lock (dirty read — at worst one extra
        # contender per window edge). Keeps the hot path from serializing
        # on the dump lock when sampling is saturated.
        if (
            self._window_count >= int(get_flag("rpc_dump_max_requests_per_second"))
            and time.monotonic() - self._window_start < 1.0
        ):
            return False
        try:
            with self._lock:
                if not self._admit():
                    return False
                max_per_file = int(get_flag("rpc_dump_max_requests_in_one_file"))
                if self._file is None or self._in_file >= max_per_file:
                    self._rotate()
                frame = pack_frame(meta, payload, 0, attachment=attachment)
                self._file.write(frame)
                self._file.flush()
                self._in_file += 1
                self.sampled_total += 1
            return True
        except OSError:
            return False

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


_global_dumper: Optional[RpcDumper] = None
_dumper_lock = threading.Lock()


def global_dumper() -> RpcDumper:
    global _global_dumper
    with _dumper_lock:
        if _global_dumper is None:
            _global_dumper = RpcDumper()
        return _global_dumper


def reset_global_dumper() -> None:
    """Close and drop the process dumper (tests; rotation picks up a
    changed rpc_dump_dir this way too)."""
    global _global_dumper
    with _dumper_lock:
        if _global_dumper is not None:
            _global_dumper.close()
            _global_dumper = None


def maybe_dump_request(meta: Meta, payload: bytes, attachment: bytes = b"") -> None:
    """The server-side hook (ProcessRpcRequest's sampling site). The caller
    passes the DECOMPRESSED payload, so compress is cleared here (after the
    flag check — the off path must stay allocation-free) to keep dumped
    frames self-consistent for replay."""
    if get_flag("rpc_dump"):
        import dataclasses

        global_dumper().sample(
            dataclasses.replace(meta, compress=""), payload, attachment
        )


def load_dump_file(path: str):
    """Yield (meta, payload, attachment) tuples from a dump file (the
    rpc_replay reader, tools/rpc_replay/rpc_replay.cpp)."""
    from incubator_brpc_tpu_torch.protocol.tbus_std import try_parse_frame

    with open(path, "rb") as f:
        buf = memoryview(f.read())  # zero-copy slicing: O(file) not O(file^2)
    off = 0
    while off < len(buf):
        frame, consumed = try_parse_frame(buf[off:])
        if frame is None:
            break
        off += consumed
        yield frame.meta, frame.payload, frame.attachment
