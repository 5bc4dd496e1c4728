"""The port's profilers, fiber mutex and logging (ROADMAP A12:
``builtin/hotspots.py``, ``runtime/mutex.py``, ``utils/logging.py``) on the
CPU, held against the JAX package's.

- ``tests/test_keys_hotspots.py``'s ``TestHotspots`` and
  ``TestRpczPersistence`` on both packages (``pkg``): the CPU sampler
  catches a busy thread, one run at a time, the ``/hotspots`` and
  ``/hotspots/contention`` pages, spans persisted to ``rpcz.jsonl``;
- ``tests/test_native_containers.py``'s ``TestFiberMutex``,
  ``TestFiberCond`` and ``TestCountdownEvent`` on both;
- ``tests/test_logging.py`` on both, each package's sink owning its own
  package logger (``incubator_brpc_tpu`` and ``incubator_brpc_tpu_torch``);
- beyond the oracle: ``/hotspots/contention`` after a contended
  ``FiberMutex`` loop names the loop's call site (text and folded), the
  folded CPU profile names the busy function, and the heap profile is
  switched on and off through its page.

The sampler walks ``sys._current_frames()``, so the rendered stacks differ
between the packages in file names and threads: the tests compare what
the oracle asserts (frames, counts, the retry-after), never whole text.
Tolerance: none; wall-clock waits carry their own bounds, as the oracles'."""

import json
import logging
import threading
import time

import pytest

from tests.test_torch_observability import (  # noqa: F401  (fixtures)
    channel,
    fetch,
    nothing_outlives_the_test,
    pkg,
    server,
    tuned,
)


def burn(stop):
    while not stop.is_set():
        sum(i * i for i in range(1000))


# -- tests/test_keys_hotspots.py TestHotspots -----------------------------------------


def test_cpu_sampler_catches_a_busy_thread(pkg):
    stop = threading.Event()
    t = threading.Thread(target=burn, args=(stop,), name="burner")
    t.start()
    try:
        result = pkg.hotspots.sample_cpu(seconds=0.3, hz=200)
    finally:
        stop.set()
        t.join()
    assert result["samples"] > 10
    assert "burn" in pkg.hotspots.render_cpu_text(result)
    # folded stacks: "root;...;leaf count", each frame "name file:line"
    assert any(";burn " in line for line in pkg.hotspots.render_cpu_folded(result).splitlines())


def test_single_run_at_a_time(pkg):
    t = threading.Thread(target=lambda: pkg.hotspots.sample_cpu(seconds=0.3))
    t.start()
    time.sleep(0.05)
    with pytest.raises(RuntimeError):
        pkg.hotspots.sample_cpu(seconds=0.1)
    t.join()


def test_portal_pages(pkg):
    s = server(pkg, {"h": {"m": lambda c, r: r}})
    status, _, body = fetch(pkg, s, "/hotspots?seconds=0.2")
    assert status == 200 and b"samples:" in body
    status, _, body = fetch(pkg, s, "/hotspots/contention")
    assert status == 200 and b"contended acquires" in body


# -- TestRpczPersistence ------------------------------------------------------------------


def test_spans_persist_and_survive_ring_eviction(pkg, tuned, tmp_path):
    tuned("enable_rpcz", True)
    tuned("rpcz_database_dir", str(tmp_path))
    try:
        srv = server(pkg, {"persist": {"echo": lambda cntl, req: req}})
        ch = channel(pkg, srv)
        for _ in range(3):
            assert ch.call_method("persist", "echo", b"traced").ok()
        srv.stop()
        srv.join(timeout=10)
        db = tmp_path / "rpcz.jsonl"
        assert db.exists()
        rows = [json.loads(ln) for ln in db.read_text().splitlines()]
        mine = [r for r in rows if r["service"] == "persist"]
        assert len(mine) >= 3
        assert any(r["type"] == "server" for r in mine)
        assert all(r["latency_us"] >= 0 for r in mine)
    finally:
        pkg.rpcz.span_store.close_db()
        pkg.rpcz.span_store.clear()


# -- tests/test_native_containers.py TestFiberMutex, TestFiberCond, TestCountdownEvent ----


def test_mutual_exclusion(pkg):
    m = pkg.runtime.FiberMutex()
    counter = [0]

    def worker():
        for _ in range(500):
            with m:
                v = counter[0]
                counter[0] = v + 1

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counter[0] == 4000


def test_try_acquire_and_timeout(pkg):
    m = pkg.runtime.FiberMutex()
    assert m.try_acquire()
    assert not m.try_acquire()
    t0 = time.monotonic()
    assert not m.acquire(timeout=0.1)
    assert 0.05 < time.monotonic() - t0 < 2.0
    m.release()
    assert m.acquire(timeout=0.1)
    m.release()


def test_contention_is_profiled(pkg):
    pkg.runtime.reset_contention_profile()
    m = pkg.runtime.FiberMutex()

    def holder():
        with m:
            time.sleep(0.05)

    t = threading.Thread(target=holder)
    t.start()
    time.sleep(0.01)
    with m:
        pass
    t.join()
    rows = pkg.runtime.contention_profile()
    assert rows, "contended acquire not sampled"
    assert sum(us for _, _, us in rows) > 10_000


def test_notify_one_wakes_waiter(pkg):
    m = pkg.runtime.FiberMutex()
    cond = pkg.runtime.FiberCond()
    ready = []

    def waiter():
        with m:
            while not ready:
                cond.wait(m)
            ready.append("seen")

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with m:
        ready.append(True)
    cond.notify_one()
    t.join(timeout=5)
    assert not t.is_alive()
    assert "seen" in ready


def test_cond_wait_timeout(pkg):
    m = pkg.runtime.FiberMutex()
    cond = pkg.runtime.FiberCond()
    with m:
        assert cond.wait(m, timeout=0.1) is False
    assert not m.locked


def test_signals_release_waiters(pkg):
    ev = pkg.runtime.CountdownEvent(3)
    done = threading.Event()

    def waiter():
        ev.wait()
        done.set()

    t = threading.Thread(target=waiter)
    t.start()
    ev.signal()
    ev.signal()
    assert not done.wait(timeout=0.1)
    ev.signal()
    assert done.wait(timeout=5)
    t.join()


def test_countdown_wait_timeout(pkg):
    ev = pkg.runtime.CountdownEvent(1)
    assert ev.wait(timeout=0.05) is False
    ev.signal()
    assert ev.wait(timeout=1)


def contended_loop(m, rounds=20):
    """Two threads taking one FiberMutex in turns, each holding it 2 ms."""
    def worker():
        for _ in range(rounds):
            with m:
                time.sleep(0.002)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def test_contention_page_names_the_call_site(pkg):
    pkg.runtime.reset_contention_profile()
    before = pkg.runtime.mutex.contended_acquires.get_value()
    contended_loop(pkg.runtime.FiberMutex())
    assert pkg.runtime.mutex.contended_acquires.get_value() > before
    s = server(pkg, {"h": {"m": lambda c, r: r}})
    status, _, body = fetch(pkg, s, "/hotspots/contention")
    assert status == 200
    text = body.decode()
    assert "us over " in text and "in worker" in text and "test_torch_hotspots_logging.py" in text
    status, _, folded = fetch(pkg, s, "/pprof/contention")
    assert status == 200
    assert any("in worker" in line and "test_torch_hotspots_logging.py" in line
               for line in folded.decode().splitlines())


def test_heap_profile_switches_through_its_page(pkg):
    s = server(pkg, {"h": {"m": lambda c, r: r}})
    was_on = pkg.hotspots.heap_profiling_active()
    try:
        assert fetch(pkg, s, "/hotspots/heap?start=1")[::2] == (200, b"heap profiling started\n")
        assert pkg.hotspots.heap_profiling_active()
        status, _, body = fetch(pkg, s, "/hotspots/heap")
        assert status == 200 and body.startswith(b"tracked live bytes: ")
        assert fetch(pkg, s, "/hotspots/heap?stop=1")[::2] == (200, b"heap profiling stopped\n")
        assert not pkg.hotspots.heap_profiling_active()
        assert fetch(pkg, s, "/hotspots/heap")[2].startswith(b"heap profiling is off")
    finally:
        if was_on:
            pkg.hotspots.start_heap_profiling()


# -- tests/test_logging.py ------------------------------------------------------------------


def sink(pkg, consume=True):
    """A LogSink of ``pkg`` that keeps every record it is handed."""

    class CapturingSink(pkg.logging.LogSink):
        def __init__(self):
            self.records = []

        def on_log_message(self, record):
            self.records.append(record)
            return consume

    return CapturingSink()


def test_sink_sees_framework_records(pkg):
    s = sink(pkg)
    old = pkg.logging.set_log_sink(s)
    try:
        logging.getLogger(pkg.root_logger + ".test").warning("hello %s", "sink")
    finally:
        pkg.logging.set_log_sink(old)
    assert any(r.getMessage() == "hello sink" for r in s.records)


def test_sink_swap_returns_old_and_restores(pkg):
    a, b = sink(pkg), sink(pkg)
    old0 = pkg.logging.set_log_sink(a)
    try:
        assert pkg.logging.set_log_sink(b) is a
        logging.getLogger(pkg.root_logger + ".test").error("to-b")
        assert any(r.getMessage() == "to-b" for r in b.records)
        assert not any(r.getMessage() == "to-b" for r in a.records)
    finally:
        pkg.logging.set_log_sink(old0)


def test_propagation_disabled_while_sink_active(pkg):
    root = logging.getLogger(pkg.root_logger)
    assert root.propagate is True
    old = pkg.logging.set_log_sink(sink(pkg))
    try:
        assert root.propagate is False
    finally:
        pkg.logging.set_log_sink(old)
    assert root.propagate is True


def test_sink_sees_info_and_debug(pkg):
    s = sink(pkg)
    old = pkg.logging.set_log_sink(s)
    try:
        logging.getLogger(pkg.root_logger + ".lvl").info("info-rec")
        logging.getLogger(pkg.root_logger + ".lvl").debug("debug-rec")
    finally:
        pkg.logging.set_log_sink(old)
    msgs = [r.getMessage() for r in s.records]
    assert "info-rec" in msgs and "debug-rec" in msgs


def test_level_counters_advance(pkg):
    before = pkg.logging.log_counts[logging.WARNING].get_value()
    logging.getLogger(pkg.root_logger + ".counting").warning("count me")
    assert pkg.logging.log_counts[logging.WARNING].get_value() == before + 1


def test_log_every_n_and_first_n(pkg):
    logger = logging.getLogger(pkg.root_logger + ".rl")
    old = pkg.logging.set_log_sink(sink(pkg))
    try:
        emitted = [pkg.logging.log_every_n(logger, logging.INFO, 3, "n") for _ in range(9)]
        assert emitted == [True, False, False] * 3
        emitted = [pkg.logging.log_first_n(logger, logging.INFO, 2, "f") for _ in range(5)]
        assert emitted == [True, True, False, False, False]
    finally:
        pkg.logging.set_log_sink(old)


def test_log_every_second(pkg):
    logger = logging.getLogger(pkg.root_logger + ".rl2")
    emitted = [pkg.logging.log_every_second(logger, logging.INFO, "s") for _ in range(3)]
    assert emitted == [True, False, False]


def test_each_sink_owns_its_own_package():
    """The port's sink sees the port's records and not the JAX package's,
    and the reverse: the two package loggers are siblings."""
    from tests.test_torch_observability import PKGS

    sinks = {name: sink(p) for name, p in PKGS.items()}
    olds = {name: p.logging.set_log_sink(sinks[name]) for name, p in PKGS.items()}
    try:
        for name, p in PKGS.items():
            logging.getLogger(p.root_logger + ".own").warning(f"from-{name}")
    finally:
        for name, p in PKGS.items():
            p.logging.set_log_sink(olds[name])
    for name in PKGS:
        assert [r.getMessage() for r in sinks[name].records] == [f"from-{name}"]


def test_log_counts_are_bvars_on_the_vars_page(pkg):
    s = server(pkg, {"h": {"m": lambda c, r: r}})
    text = fetch(pkg, s, "/vars?prefix=logging_")[2].decode()
    for level in ("debug", "info", "warning", "error", "fatal"):
        assert f"logging_{level}_count : " in text
