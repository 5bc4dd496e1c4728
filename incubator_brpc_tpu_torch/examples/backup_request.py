"""backup_request — straggler mitigation (reference
example/backup_request_c++): a duplicate request fires at backup_request_ms;
the faster replica wins. Run: python -m incubator_brpc_tpu_torch.examples.backup_request
"""

import time

from incubator_brpc_tpu_torch.rpc import Channel, ChannelOptions, Server


def main() -> None:
    slow, fast = Server(), Server()

    def slow_echo(cntl, req):
        time.sleep(1.0)
        return b"slow:" + req

    slow.add_service("EchoService", {"Echo": slow_echo})
    fast.add_service("EchoService", {"Echo": lambda c, req: b"fast:" + req})
    assert slow.start(0) and fast.start(0)

    ch = Channel()
    # list naming + rr: the first attempt may land on the slow replica; the
    # backup fires at 100ms and the retry excludes the slow socket
    assert ch.init(
        f"list://127.0.0.1:{slow.port},127.0.0.1:{fast.port}",
        "rr",
        options=ChannelOptions(timeout_ms=5000, backup_request_ms=100),
    )
    t0 = time.monotonic()
    cntl = ch.call_method("EchoService", "Echo", b"hurry")
    dt = (time.monotonic() - t0) * 1e3
    assert cntl.ok(), cntl.error_text
    print(f"winner: {cntl.response_payload!r} after {dt:.0f}ms "
          f"(slow replica would have taken 1000ms)")
    slow.stop()
    fast.stop()


if __name__ == "__main__":
    main()
