"""High fan-in on the port's host plane against the JAX package's:
tests/test_high_concurrency.py's 2 cases, each run on both packages
through the ``pkg`` fixture, and phase 3o of ``chip_smoke.py`` rehearsed
on the CPU.

- 10,000 RPCs in flight at once through one ``Channel``, answered 0.5 s
  later from a timer by ``cntl.set_async()`` handlers: the pileup rides
  the existing threads;
- 600 calls into a handler that parks its worker on a butex for 150 ms:
  the pool grows only to ``fiber_concurrency_max`` and the rest queue.

The 90 s drain limits and the thread-growth margins are the reference's
(``growth < 40``, ``peak < cap + 80``). Both packages run in one process
here, and each keeps its global worker pool alive after its case, so the
blocking case counts threads from its own baseline (``peak - baseline <
cap + 80``, the reference's bound with the other package's idle pool in
the baseline) and holds the package's own pool workers to the cap.
Servers of the port run on
``device="cpu"``. Tolerance: none, everything here is bytes and counts."""

from __future__ import annotations

import threading
import time
import types

import pytest

import incubator_brpc_tpu.rpc as jax_rpc
from incubator_brpc_tpu.runtime.butex import Butex as JaxButex
from incubator_brpc_tpu.runtime.timer_thread import global_timer_thread as jax_timer
from incubator_brpc_tpu.transport.socket_map import global_socket_map as jax_socket_map
from incubator_brpc_tpu.utils.flags import get_flag as jax_get_flag
import incubator_brpc_tpu_torch.rpc as port_rpc
from incubator_brpc_tpu_torch.runtime.butex import Butex as PortButex
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import global_timer_thread as port_timer
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.utils.flags import get_flag as port_get_flag

N_ASYNC = 10000

PKGS = {
    "jax": types.SimpleNamespace(name="jax", rpc=jax_rpc, Butex=JaxButex, timer=jax_timer,
                                 get_flag=jax_get_flag, server_kw={}, worker="tbrpc-worker-"),
    "torch": types.SimpleNamespace(name="torch", rpc=port_rpc, Butex=PortButex, timer=port_timer,
                                   get_flag=port_get_flag, server_kw={"device": "cpu"},
                                   worker="tbtorch-worker-"),
}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    # no JAX client socket left redialing a stopped server's port, where a
    # later test's server may listen (ROADMAP C11)
    jax_socket_map().recycle_all()
    port_rpc.shutdown_host_plane()
    assert shutdown_watchers(timeout=60)
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


def _serve(pkg, service, method, handler):
    server = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
    server.add_service(service, {method: handler})
    assert server.start(0)
    ch = pkg.rpc.Channel()
    assert ch.init(f"127.0.0.1:{server.port}", options=pkg.rpc.ChannelOptions(timeout_ms=120000))
    return server, ch


def test_10k_outstanding_async_rpcs(pkg):
    timer = pkg.timer()

    def slow_echo(cntl, req: bytes):
        cntl.set_async()
        timer.schedule(lambda: cntl.send_response(b"r:" + req), delay=0.5)
        return None

    server, ch = _serve(pkg, "Bulk", "Echo", slow_echo)
    baseline_threads = threading.active_count()
    done_count = [0]
    failures = []
    all_done = threading.Event()
    lock = threading.Lock()

    def make_done(i):
        def done(cntl):
            with lock:
                if cntl.failed():
                    failures.append((i, cntl.error_code, cntl.error_text))
                elif cntl.response_payload != b"r:%06d" % i:
                    failures.append((i, -1, "payload mismatch"))
                done_count[0] += 1
                if done_count[0] == N_ASYNC:
                    all_done.set()

        return done

    try:
        t0 = time.monotonic()
        peak_threads = 0
        for i in range(N_ASYNC):
            ch.call_method("Bulk", "Echo", b"%06d" % i,
                           cntl=pkg.rpc.Controller(timeout_ms=120000), done=make_done(i))
            if i % 500 == 0:
                peak_threads = max(peak_threads, threading.active_count())
        while not all_done.wait(timeout=0.2):
            peak_threads = max(peak_threads, threading.active_count())
            assert time.monotonic() - t0 < 90, f"only {done_count[0]}/{N_ASYNC} done"
        assert not failures, f"{len(failures)} failed, first: {failures[:3]}"
        assert done_count[0] == N_ASYNC
        growth = peak_threads - baseline_threads
        assert growth < 40, (
            f"thread growth {growth} (baseline {baseline_threads}, peak {peak_threads})"
        )
    finally:
        server.stop()
        server.join(timeout=10)


def test_blocking_handlers_bounded_by_pool_cap(pkg):
    cap = int(pkg.get_flag("fiber_concurrency_max"))
    n = 600

    def parked_echo(cntl, req: bytes) -> bytes:
        b = pkg.Butex(0)
        b.wait(0, timeout=0.15)  # parks THIS worker (counts as blocked)
        return b"p:" + req

    server, ch = _serve(pkg, "Parked", "Echo", parked_echo)
    baseline_threads = threading.active_count()
    done_count = [0]
    failures = []
    all_done = threading.Event()
    lock = threading.Lock()

    def make_done(i):
        def done(cntl):
            with lock:
                if cntl.failed():
                    failures.append((i, cntl.error_text))
                elif cntl.response_payload != b"p:%04d" % i:
                    failures.append((i, "payload mismatch"))
                done_count[0] += 1
                if done_count[0] == n:
                    all_done.set()

        return done

    try:
        t0 = time.monotonic()
        peak_threads = peak_workers = 0
        for i in range(n):
            ch.call_method("Parked", "Echo", b"%04d" % i,
                           cntl=pkg.rpc.Controller(timeout_ms=120000), done=make_done(i))
        while not all_done.wait(timeout=0.2):
            peak_threads = max(peak_threads, threading.active_count())
            peak_workers = max(peak_workers, sum(
                t.name.startswith(pkg.worker) for t in threading.enumerate()))
            assert time.monotonic() - t0 < 90, f"only {done_count[0]}/{n} done"
        assert not failures, f"{len(failures)} failed, first: {failures[:3]}"
        growth = peak_threads - baseline_threads
        assert growth < cap + 80, (
            f"growth {growth} threads (baseline {baseline_threads}) vs cap {cap}")
        assert peak_workers <= cap, f"{peak_workers} pool workers vs cap {cap}"
    finally:
        server.stop()
        server.join(timeout=10)


def test_chip_smoke_phase_3o_on_the_cpu():
    """Phase 3o at a small scale on the CPU: every response bitwise, the
    thread bounds held (no card, so no launch is counted and no idle share
    is measured)."""
    import torch

    import chip_smoke
    from incubator_brpc_tpu_torch.ops import kernels

    out, k1 = chip_smoke.fanin_phase(torch, kernels, device="cpu", scale=0.05)
    assert out["calls"] == chip_smoke.FANIN_CALLS // 20
    assert out["growth"] < out["cap"] + chip_smoke.FANIN_MARGIN
    assert out["peak_workers"] <= out["cap"]
    assert out["drain_s"] > 0 and out["calls_per_s"] > 0
    assert out["device_us"] is None and out["idle_pct"] is None
    assert k1 == dict.fromkeys(chip_smoke.K1, 0)
