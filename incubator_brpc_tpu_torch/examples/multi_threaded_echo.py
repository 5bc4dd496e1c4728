"""multi_threaded_echo — N client threads hammering one server, qps per
thread count (reference example/multi_threaded_echo_c++: -thread_num
sync callers sharing one Channel).

Scaling caveat, measured honestly: on a single-core host (the bench
machine: host_cpus=1) the sweep CANNOT rise with threads — every thread
shares the same core, so the curve documents per-call overhead, not
scaling. On a multi-core host the same sweep shows the shared-Channel
fan-out (one socket, FIFO correlation, MPSC write queue) scaling until
the reactor or the GIL saturates.
"""

import os
import threading
import time

from incubator_brpc_tpu_torch.rpc import Channel, ChannelOptions, Controller, Server

DURATION_S = 0.5


def sweep(port: int, nthreads: int) -> float:
    ch = Channel()
    assert ch.init(f"127.0.0.1:{port}", options=ChannelOptions(timeout_ms=10000))
    stop = time.monotonic() + DURATION_S
    counts = [0] * nthreads

    def worker(i: int) -> None:
        while time.monotonic() < stop:
            cntl = ch.call_method(
                "Echo", "Echo", b"ping", cntl=Controller(timeout_ms=10000)
            )
            assert cntl.ok(), cntl.error_text
            counts[i] += 1

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(nthreads)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sum(counts) / (time.monotonic() - t0)


def main() -> None:
    server = Server()
    server.add_service("Echo", {"Echo": lambda cntl, req: req})
    assert server.start(0)
    ncpu = os.cpu_count() or 1
    print(f"multi-threaded echo sweep (host_cpus={ncpu}, "
          f"{DURATION_S}s per point, one shared Channel):")
    results = {}
    for n in (1, 2, 4):
        qps = sweep(server.port, n)
        results[n] = qps
        print(f"  threads={n}: {qps:,.0f} qps")
    if ncpu == 1:
        print("  note: 1-core host — a flat curve is the EXPECTED result "
              "(threads share the core); per-call overhead is the signal")
    server.stop()
    server.join(timeout=10)
    assert all(q > 0 for q in results.values())
    print("sweep ok")


if __name__ == "__main__":
    main()
