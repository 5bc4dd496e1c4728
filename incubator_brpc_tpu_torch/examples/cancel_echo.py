"""cancel_echo — cancel an in-flight RPC from another thread (reference
example/cancel_c++: brpc::StartCancel(call_id) fails the call with
ECANCELED; the done callback still runs exactly once).

Demo: a slow server (0.8 s handler), an async call cancelled after 50 ms
— the caller gets ECANCELED in ~50 ms, not at the handler's pace — then a
second call left alone completes normally on the same channel.
"""

import threading
import time

from incubator_brpc_tpu_torch.rpc import Channel, Controller, Server
from incubator_brpc_tpu_torch.utils.status import ErrorCode


def main() -> None:
    server = Server()

    def slow_echo(cntl, request: bytes) -> bytes:
        time.sleep(0.8)
        return b"late:" + request

    server.add_service("Echo", {"Echo": slow_echo})
    assert server.start(0)

    ch = Channel()
    assert ch.init(f"127.0.0.1:{server.port}")

    done = threading.Event()
    out = {}

    def on_done(cntl):
        out["code"] = cntl.error_code
        out["elapsed_ms"] = (time.monotonic() - t0) * 1e3
        done.set()

    t0 = time.monotonic()
    cntl = Controller(timeout_ms=10000)
    ch.call_method("Echo", "Echo", b"doomed", cntl=cntl, done=on_done)
    time.sleep(0.05)
    cntl.start_cancel()  # any thread may cancel by the call's id
    assert done.wait(5)
    assert out["code"] == ErrorCode.ECANCELED, out
    print(
        f"cancelled call returned ECANCELED after {out['elapsed_ms']:.0f} ms "
        f"(handler runs 800 ms)"
    )

    c2 = ch.call_method("Echo", "Echo", b"patient", cntl=Controller(timeout_ms=10000))
    assert c2.ok(), c2.error_text
    print(f"uncancelled call completed: {c2.response_payload.decode()}")

    server.stop()
    server.join(timeout=10)
    print("cancel demo ok")


if __name__ == "__main__":
    main()
