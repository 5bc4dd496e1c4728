"""asynchronous_echo — async on both ends (reference
example/asynchronous_echo_c++: the client's done-closure runs on
completion instead of blocking; the server's handler finishes later via
the done guard).

Demo: the server parks each request on a timer (no handler thread held,
cntl.set_async + send_response); the client launches a burst of async
calls and collects completions — total wall time ~one response delay,
not burst x delay.
"""

import threading
import time

from incubator_brpc_tpu_torch.rpc import Channel, Controller, Server
from incubator_brpc_tpu_torch.runtime.timer_thread import global_timer_thread

N = 32
DELAY_S = 0.3


def main() -> None:
    timer = global_timer_thread()
    server = Server()

    def echo_later(cntl, request: bytes):
        # async server side: the handler returns immediately; the response
        # goes out from the timer callback (the reference's done-guard
        # released after a bthread_usleep)
        cntl.set_async()
        timer.schedule(
            lambda: cntl.send_response(b"late:" + request), delay=DELAY_S
        )
        return None

    server.add_service("Echo", {"Echo": echo_later})
    assert server.start(0)

    ch = Channel()
    assert ch.init(f"127.0.0.1:{server.port}")

    done = threading.Event()
    results = []
    lock = threading.Lock()

    def on_done(cntl):
        with lock:
            results.append(cntl.ok())
            if len(results) == N:
                done.set()

    t0 = time.monotonic()
    for i in range(N):
        ch.call_method(
            "Echo", "Echo", b"m%02d" % i,
            cntl=Controller(timeout_ms=10000), done=on_done,
        )
    launched = time.monotonic() - t0
    assert done.wait(10)
    total = time.monotonic() - t0
    assert all(results)
    print(
        f"{N} async calls: launched in {launched*1e3:.0f} ms, all done in "
        f"{total*1e3:.0f} ms (server delay {DELAY_S*1e3:.0f} ms each — "
        f"overlapped, not {N * DELAY_S:.1f} s serial)"
    )
    assert total < N * DELAY_S / 4, "async calls did not overlap"
    server.stop()
    server.join(timeout=10)
    print("asynchronous echo demo ok")


if __name__ == "__main__":
    main()
