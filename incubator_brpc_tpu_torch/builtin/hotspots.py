"""Hotspots — on-demand sampling CPU profiler + contention dump
(reference src/brpc/builtin/hotspots_service.cpp: /hotspots/cpu via
gperftools sampling, /hotspots/contention via the bthread mutex
collector).

The CPU profiler here samples ``sys._current_frames()`` at a fixed rate
for a bounded window — a wall-clock stack sampler over every thread in
the process (fibers run on pool threads, so fiber work is attributed to
its code naturally). Results aggregate identical stacks and sort by
sample count; leaf-function totals give the flat view.

The port's copy of the JAX package's ``builtin/hotspots.py``: the CPU
sampler, the contention profile of ``runtime/mutex.py`` and the heap
profile over ``tracemalloc``, in text and folded renderings.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import Counter
from typing import Dict, List, Tuple

_profile_lock = threading.Lock()  # one profiling run at a time
# monotonic deadline of the run currently holding _profile_lock (0 = no
# run): lets a refused caller compute an honest Retry-After instead of
# guessing — read without the lock (a torn read only skews the hint)
_profile_until = 0.0


class ProfileInProgress(RuntimeError):
    """Another sampling run holds ``_profile_lock``; ``retry_after_s``
    estimates when it finishes (the HTTP side turns this into a 503 +
    Retry-After instead of surfacing a raw error)."""

    def __init__(self, retry_after_s: float) -> None:
        self.retry_after_s = max(1.0, retry_after_s)
        super().__init__(
            "another profiling run is in progress "
            f"(retry in ~{self.retry_after_s:.0f}s)"
        )


def sample_cpu(seconds: float = 1.0, hz: int = 100) -> Dict[str, object]:
    """Sample all threads' stacks for ``seconds`` at ``hz``. Returns
    {samples, stacks: [(count, stack_text)], flat: [(count, leaf)]}.
    One run at a time: a concurrent caller gets :class:`ProfileInProgress`
    (with a retry estimate) immediately — the lock is never waited on, so
    an HTTP scrape can't pile threads up behind a long window."""
    global _profile_until
    if not _profile_lock.acquire(blocking=False):
        raise ProfileInProgress(_profile_until - time.monotonic())
    try:
        _profile_until = time.monotonic() + max(0.01, seconds)
        me = threading.get_ident()
        interval = 1.0 / max(1, hz)
        stacks: Counter = Counter()
        flat: Counter = Counter()
        deadline = time.monotonic() + max(0.01, seconds)
        nsamples = 0
        while time.monotonic() < deadline:
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                stack = traceback.extract_stack(frame, limit=24)
                if not stack:
                    continue
                key = "\n".join(
                    f"  {f.filename}:{f.lineno} {f.name}" for f in stack
                )
                stacks[key] += 1
                leaf = stack[-1]
                flat[f"{leaf.filename}:{leaf.lineno} {leaf.name}"] += 1
                nsamples += 1
            time.sleep(interval)
        return {
            "samples": nsamples,
            "stacks": stacks.most_common(),
            "flat": flat.most_common(),
        }
    finally:
        _profile_until = 0.0
        _profile_lock.release()


def render_cpu_text(result: Dict[str, object], top: int = 30) -> str:
    lines = [f"samples: {result['samples']}", "", "--- flat (leaf) ---"]
    for leaf, count in list(result["flat"])[:top]:
        lines.append(f"{count:8d}  {leaf}")
    lines.append("")
    lines.append("--- stacks ---")
    for stack, count in list(result["stacks"])[:top]:
        lines.append(f"{count:8d} samples:")
        lines.append(stack)
        lines.append("")
    return "\n".join(lines)


def render_cpu_folded(result: Dict[str, object]) -> str:
    """pprof/flamegraph folded-stack text: one line per unique stack,
    root;...;leaf count — the interchange format go-pprof tooling and
    flamegraph.pl consume (the reference's hotspots_service renders
    through the bundled pprof.pl into the same family)."""
    lines = []
    for stack, count in result["stacks"]:
        frames = []
        for row in stack.splitlines():
            row = row.strip()
            # "  file:line name" -> "name file:line"
            loc, _, name = row.partition(" ")
            frames.append(f"{name} {loc}" if name else row)
        lines.append(f"{';'.join(frames)} {count}")
    return "\n".join(lines) + ("\n" if lines else "")


def render_contention_folded(top: int = 1000) -> str:
    """Contention profile in the same folded format; the sample weight is
    total wait microseconds (pprof's contention convention of delay-
    weighted samples, mutex.cpp:145's '--- contention' family)."""
    from incubator_brpc_tpu_torch.runtime.mutex import contention_profile

    lines = []
    for stack, count, wait_us in contention_profile()[:top]:
        frames = []
        for row in stack.strip().splitlines():
            row = row.strip()
            loc, _, name = row.partition(" ")
            frames.append(f"{name} {loc}" if name else row)
        if frames:
            lines.append(f"{';'.join(frames)} {int(wait_us)}")
    return "\n".join(lines) + ("\n" if lines else "")


def render_contention_text(top: int = 30) -> str:
    from incubator_brpc_tpu_torch.runtime.mutex import (
        contended_acquires,
        contention_profile,
        contention_wait,
    )

    rows: List[Tuple[str, int, float]] = contention_profile()
    lines = [
        f"contended acquires: {contended_acquires.get_value()}",
        f"wait stats: {contention_wait.get_value()}",
        "",
        "--- by call site (total wait us) ---",
    ]
    for stack, count, wait_us in rows[:top]:
        lines.append(f"{wait_us:12.0f}us over {count} acquisitions at:")
        lines.append(stack.rstrip())
        lines.append("")
    return "\n".join(lines)


# -- heap profile (reference /hotspots/heap + /hotspots/growth via
#    MallocExtension, details/tcmalloc_extension.cpp; here tracemalloc is
#    the allocator hook: start it once, snapshot on demand) ------------------

def heap_profiling_active() -> bool:
    import tracemalloc

    return tracemalloc.is_tracing()


def start_heap_profiling(nframes: int = 16) -> None:
    """Begin tracking allocations (a few % overhead while on — the same
    tradeoff as running with tcmalloc's sampling heap profiler)."""
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start(nframes)


def stop_heap_profiling() -> None:
    import tracemalloc

    if tracemalloc.is_tracing():
        tracemalloc.stop()


def render_heap_text(top: int = 30) -> str:
    """Live-bytes by allocation site (the /hotspots/heap view)."""
    import tracemalloc

    if not tracemalloc.is_tracing():
        return (
            "heap profiling is off - POST/GET /hotspots/heap?start=1 to "
            "begin tracking, then fetch this page again\n"
        )
    snap = tracemalloc.take_snapshot()
    total = sum(st.size for st in snap.statistics("filename"))
    lines = [f"tracked live bytes: {total}", "", "--- by allocation site ---"]
    for st in snap.statistics("lineno")[:top]:
        frame = st.traceback[-1]
        lines.append(
            f"{st.size:12d} B over {st.count:8d} blocks  "
            f"{frame.filename}:{frame.lineno}"
        )
    return "\n".join(lines) + "\n"


def render_heap_folded(top: int = 1000) -> str:
    """Folded stacks weighted by live bytes (pprof inuse_space family)."""
    import tracemalloc

    if not tracemalloc.is_tracing():
        return ""
    snap = tracemalloc.take_snapshot()
    lines = []
    for st in snap.statistics("traceback")[:top]:
        frames = [
            f"{f.filename}:{f.lineno}" for f in st.traceback
        ]  # root-first
        if frames:
            lines.append(f"{';'.join(frames)} {st.size}")
    return "\n".join(lines) + ("\n" if lines else "")
