"""dynamic_partition_echo — two partition schemes behind one naming file,
traffic weighted by live capacity (reference example/
dynamic_partition_echo_c++: servers tagged "N/3" and "N/4" coexist while a
fleet re-partitions; DynamicPartitionChannel routes each call to ONE
scheme — probability ∝ replicas/partitions — then fans out across that
scheme's partitions).

Demo: start a 2-partition generation, drive traffic; bring up a
3-partition generation in the SAME naming file (a rolling re-partition),
drive more traffic and watch calls land on both schemes; retire the old
generation and see every call take the new one.
"""

import tempfile
import time
from collections import Counter

from incubator_brpc_tpu_torch.rpc import (
    ChannelOptions,
    Controller,
    DynamicPartitionChannel,
    Server,
)


def start_partition_server(index: int, count: int) -> Server:
    server = Server()

    def get(cntl, request: bytes) -> bytes:
        return f"{index}/{count}:".encode() + request

    server.add_service("Echo", {"Get": get})
    assert server.start(0)
    return server


def scheme_of(payload: bytes) -> int:
    """A response like b'0/2:x1/2:x' came from the 2-partition scheme."""
    return int(payload.split(b":", 1)[0].split(b"/")[1])


def drive(ch, n: int) -> Counter:
    hits: Counter = Counter()
    for i in range(n):
        cntl = ch.call_method(
            "Echo", "Get", b"q", cntl=Controller(timeout_ms=10000)
        )
        assert cntl.ok(), cntl.error_text
        hits[scheme_of(cntl.response_payload)] += 1
    return hits


def main() -> None:
    gen2 = [start_partition_server(i, 2) for i in range(2)]
    naming = tempfile.NamedTemporaryFile("w", suffix=".servers", delete=False)

    def publish(servers_with_schemes) -> None:
        lines = [
            f"127.0.0.1:{srv.port} {i}/{cnt}"
            for srv, i, cnt in servers_with_schemes
        ]
        with open(naming.name, "w") as f:
            f.write("\n".join(lines) + "\n")

    publish([(s, i, 2) for i, s in enumerate(gen2)])
    ch = DynamicPartitionChannel()
    assert ch.init(
        f"file://{naming.name}", options=ChannelOptions(timeout_ms=10000)
    )
    time.sleep(1.5)  # let the naming thread poll the file (1 Hz)

    print("phase 1 — only the 2-partition generation:")
    print(f"  scheme hits: {dict(drive(ch, 20))}")

    # rolling re-partition: the 3-partition generation joins the SAME file
    gen3 = [start_partition_server(i, 3) for i in range(3)]
    publish(
        [(s, i, 2) for i, s in enumerate(gen2)]
        + [(s, i, 3) for i, s in enumerate(gen3)]
    )
    time.sleep(1.5)
    print("phase 2 — both generations live (traffic splits by capacity):")
    hits = drive(ch, 60)
    print(f"  scheme hits: {dict(hits)}")
    assert set(hits) == {2, 3}, "both schemes should take traffic"

    # retire the old generation
    publish([(s, i, 3) for i, s in enumerate(gen3)])
    time.sleep(1.5)
    print("phase 3 — old generation retired:")
    hits = drive(ch, 20)
    print(f"  scheme hits: {dict(hits)}")
    assert set(hits) == {3}, "retired scheme still taking traffic"

    ch.stop()
    for s in gen2 + gen3:
        s.stop()
        s.join(timeout=5)
    print("dynamic re-partition demo ok")


if __name__ == "__main__":
    main()
