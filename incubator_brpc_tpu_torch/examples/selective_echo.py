"""selective_echo — cross-cluster failover through a SelectiveChannel
(reference example/selective_echo_c++: sub-channels are schedulable units
inside an embedded load balancer; a degraded cluster loses traffic, a
dead one leaves rotation until it revives).

Demo: two "clusters" (each a sub-channel). Traffic balances; cluster B
is killed mid-stream — after the health threshold its sub-channel leaves
the candidate set (calls stop even ATTEMPTING it); B comes back on the
same port and the backed-off revive probe restores it to rotation.
"""

import time
from collections import Counter

from incubator_brpc_tpu_torch.rpc import Channel, Controller, SelectiveChannel, Server


def start_cluster(name: bytes, port: int = 0) -> Server:
    server = Server()
    server.add_service("Echo", {"Echo": lambda cntl, req: name + b":" + req})
    assert server.start(port)
    return server


def drive(sc, n: int) -> Counter:
    hits: Counter = Counter()
    for _ in range(n):
        cntl = sc.call_method("Echo", "Echo", b"q", cntl=Controller(timeout_ms=5000))
        hits[cntl.response_payload.split(b":")[0] if cntl.ok() else b"FAIL"] += 1
    return hits


def main() -> None:
    a = start_cluster(b"clusterA")
    b = start_cluster(b"clusterB")
    b_port = b.port

    sc = SelectiveChannel(
        max_retry=2, lb_name="rr",
        health_check_fails=2, health_check_interval_s=0.5,
    )
    for srv in (a, b):
        ch = Channel()
        assert ch.init(f"127.0.0.1:{srv.port}")
        sc.add_channel(ch)

    print(f"both clusters up: {dict(drive(sc, 10))}")

    b.stop()
    b.join(timeout=5)
    hits = drive(sc, 10)
    print(f"clusterB down:    {dict(hits)}  (no failures — retries + health gate)")
    assert hits[b"FAIL"] == 0 and hits[b"clusterA"] == 10
    health = {h["index"]: h["down"] for h in sc.health()}
    print(f"health view:      {health}")
    assert health[1] is True

    b2 = start_cluster(b"clusterB", b_port)  # same endpoint revives
    time.sleep(1.2)  # past the backed-off revive window
    hits = drive(sc, 12)
    print(f"clusterB revived: {dict(hits)}")
    assert hits[b"clusterB"] > 0, "revive probe never restored traffic"

    for srv in (a, b2):
        srv.stop()
        srv.join(timeout=5)
    print("selective failover demo ok")


if __name__ == "__main__":
    main()
