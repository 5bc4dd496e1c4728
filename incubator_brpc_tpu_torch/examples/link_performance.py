"""link_performance — the RDMA parity harness retargeted at device links
(reference example/rdma_performance/client.cpp:30-40: echo with a tunable
attachment size, qps + latency printout, a --use flag flipping the
transport). BASELINE config #5's shape.

Run (self-contained: starts its own server):
    python -m incubator_brpc_tpu_torch.examples.link_performance                      # device links
    python -m incubator_brpc_tpu_torch.examples.link_performance --transport tcp      # host sockets
    python -m incubator_brpc_tpu_torch.examples.link_performance --attachment-kb 32 --threads 4
    python -m incubator_brpc_tpu_torch.examples.link_performance --device cpu  # links on the CPU

The port's copy of the JAX package's ``examples/link_performance.py``; the
server's links live on the card unless ``--device cpu``.
"""

import argparse
import threading
import time

from incubator_brpc_tpu_torch.bvar import LatencyRecorder
from incubator_brpc_tpu_torch.rpc import (
    Channel,
    ChannelOptions,
    Controller,
    Server,
    ServerOptions,
)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--transport", choices=("tpu", "tcp"), default="tpu",
                   help="the use_rdma flip: device links vs host sockets")
    p.add_argument("--attachment-kb", type=int, default=4,
                   help="echoed attachment size in KiB (attachment_size)")
    p.add_argument("--threads", type=int, default=2, help="caller threads")
    p.add_argument("--seconds", type=float, default=3.0, help="test_seconds")
    p.add_argument("--device", default=None,
                   help="the server's device: the card by default, 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    def echo(cntl, req):
        cntl.response_attachment = cntl.request_attachment  # echo_attachment
        return req

    server = Server(ServerOptions(usercode_inline=True, device=args.device))
    server.add_service("perf", {"echo": echo})
    assert server.start(0)

    ch = Channel()
    assert ch.init(
        f"127.0.0.1:{server.port}",
        options=ChannelOptions(
            transport=args.transport,
            timeout_ms=120000,
            link_slot_words=64 * 1024,
        ),
    )
    attachment = b"a" * (args.attachment_kb << 10)
    warm = ch.call_method(
        "perf", "echo", b"warm", attachment=attachment,
        cntl=Controller(timeout_ms=120000),
    )
    assert warm.ok(), warm.error_text

    latency = LatencyRecorder(name=None)
    stop_at = time.monotonic() + args.seconds
    totals = {"calls": 0, "bytes": 0, "fail": 0}
    lock = threading.Lock()

    def worker():
        calls = fail = nbytes = 0
        while time.monotonic() < stop_at:
            t0 = time.perf_counter()
            c = ch.call_method(
                "perf", "echo", b"ping", attachment=attachment,
                cntl=Controller(timeout_ms=120000),
            )
            if c.ok():
                calls += 1
                nbytes += 2 * len(attachment)  # echoed both ways
                latency << (time.perf_counter() - t0) * 1e6
            else:
                fail += 1
        with lock:
            totals["calls"] += calls
            totals["bytes"] += nbytes
            totals["fail"] += fail

    threads = [threading.Thread(target=worker) for _ in range(args.threads)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    print(
        f"transport={args.transport} attachment={args.attachment_kb}KiB "
        f"threads={args.threads}: {totals['calls'] / wall:.0f} qps, "
        f"{totals['bytes'] / wall / 1e9:.3f} GB/s, "
        f"p50={latency.latency_percentile(0.5):.0f}us "
        f"p99={latency.latency_percentile(0.99):.0f}us "
        f"fail={totals['fail']}"
    )
    server.stop()
    server.join(timeout=10)


if __name__ == "__main__":
    main()
