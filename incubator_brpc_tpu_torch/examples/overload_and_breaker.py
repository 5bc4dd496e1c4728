"""overload_and_breaker — the robustness layer end to end (reference
policy/auto_concurrency_limiter.cpp + circuit_breaker.cpp): a 3-backend
cluster behind a round-robin channel; one backend browns out under
injected faults (deterministic FaultInjector, 50% of its dispatches
fail), the per-node circuit breaker isolates it within its short error
window, client goodput recovers to clean, and when the fault clears the
node revives half-open and takes traffic again. The same run shows a
server shedding an overload flood with ELIMIT under
``max_concurrency="auto"``.

Run:  python -m incubator_brpc_tpu_torch.examples.overload_and_breaker
"""

import threading
import time

from incubator_brpc_tpu_torch.rpc import (
    Channel,
    ChannelOptions,
    FaultInjector,
    Server,
    ServerOptions,
)
from incubator_brpc_tpu_torch.utils.flags import set_flag_unchecked
from incubator_brpc_tpu_torch.utils.status import ErrorCode


def start_backend(tag: str, fault_injector=None) -> Server:
    server = Server(ServerOptions(fault_injector=fault_injector))
    server.add_service(
        "EchoService", {"Echo": lambda cntl, req, t=tag: t.encode() + b":" + req}
    )
    assert server.start(0)
    return server


def error_rate(ch: Channel, n: int) -> float:
    fails = sum(
        1 for _ in range(n)
        if ch.call_method("EchoService", "Echo", b"ping").failed()
    )
    return fails / n


def breaker_demo() -> None:
    # small windows so the demo converges in seconds, not minutes
    set_flag_unchecked("circuit_breaker_short_window_size", 30)
    set_flag_unchecked("circuit_breaker_min_isolation_duration_ms", 500)
    set_flag_unchecked("fault_injection", True)

    healthy = [start_backend("s0"), start_backend("s1")]
    # s2 browns out: every 2nd dispatch fails (counter-based, not random)
    brown = start_backend("s2", FaultInjector(error_rate=0.5))
    backends = healthy + [brown]
    url = "list://" + ",".join(f"127.0.0.1:{s.port}" for s in backends)
    ch = Channel()
    assert ch.init(url, "rr", options=ChannelOptions(max_retry=0, timeout_ms=4000))

    rate = error_rate(ch, 30)
    print(f"brownout: error rate with s2 at 50% injected faults = {rate:.0%}")

    # the breaker trips inside its short window and takes s2 out
    deadline = time.monotonic() + 10
    while not ch._lb.isolated_servers() and time.monotonic() < deadline:
        ch.call_method("EchoService", "Echo", b"ping")
    iso = ch._lb.isolated_servers()
    assert iso and iso[0].port == brown.port, iso
    print(f"breaker isolated 127.0.0.1:{brown.port} "
          f"(state={ch._lb.breaker_states()[f'127.0.0.1:{brown.port}']['state']})")

    rate = error_rate(ch, 30)
    print(f"recovered: error rate with s2 isolated = {rate:.0%}")
    assert rate < 0.02

    # fault clears -> the node revives (half-open) and serves again
    brown.fault_injector = None
    deadline = time.monotonic() + 10
    while ch._lb.isolated_servers() and time.monotonic() < deadline:
        ch.call_method("EchoService", "Echo", b"ping")
        time.sleep(0.05)
    assert not ch._lb.isolated_servers()
    tags = set()
    for _ in range(9):
        c = ch.call_method("EchoService", "Echo", b"ping")
        assert c.ok(), c.error_text
        tags.add(c.response_payload.split(b":")[0].decode())
    print(f"revived: traffic reaches {sorted(tags)} again, zero errors")

    ch._lb.stop()
    for s in backends:
        s.stop()


def auto_limiter_demo() -> None:
    set_flag_unchecked("auto_cl_initial_max_concurrency", 2)
    srv = Server(ServerOptions(max_concurrency="auto"))
    gate = threading.Event()
    srv.add_service(
        "SlowService", {"Work": lambda cntl, req: (gate.wait(3), b"done")[1]}
    )
    assert srv.start(0)
    ch = Channel()
    assert ch.init(
        f"127.0.0.1:{srv.port}",
        options=ChannelOptions(max_retry=0, timeout_ms=5000),
    )
    codes = []

    def caller():
        codes.append(ch.call_method("SlowService", "Work", b"").error_code)

    threads = [threading.Thread(target=caller) for _ in range(6)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    gate.set()
    for t in threads:
        t.join()
    shed = sum(1 for c in codes if c == ErrorCode.ELIMIT)
    print(
        f"auto limiter: 6 concurrent vs adaptive limit "
        f"{srv.max_concurrency} -> {shed} shed with ELIMIT, "
        f"{codes.count(0)} served"
    )
    assert shed > 0
    srv.stop()
    srv.join(5)


def main() -> None:
    try:
        breaker_demo()
        auto_limiter_demo()
    finally:
        # the demo knobs are process-global flags: restore the defaults so
        # an in-process harness (tests/test_torch_examples.py) is unaffected
        set_flag_unchecked("fault_injection", False)
        set_flag_unchecked("circuit_breaker_short_window_size", 1500)
        set_flag_unchecked("circuit_breaker_min_isolation_duration_ms", 100)
        set_flag_unchecked("auto_cl_initial_max_concurrency", 40)
    print("overload_and_breaker: OK")


if __name__ == "__main__":
    main()
