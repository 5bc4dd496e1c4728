"""partition_echo — sharded service behind one naming entry (reference
example/partition_echo_c++ + dynamic_partition_echo_c++): servers publish
"N/M" partition tags; a PartitionChannel fans a call across all partitions;
a DynamicPartitionChannel weights traffic across coexisting schemes.
Run: python -m incubator_brpc_tpu_torch.examples.partition_echo
     python -m incubator_brpc_tpu_torch.examples.partition_echo --device cpu

The port's copy of the JAX package's ``examples/partition_echo.py``: its
device half runs on the card, or on the CPU with ``--device cpu``.
"""

import argparse

from incubator_brpc_tpu_torch.rpc import (
    ChannelOptions,
    Controller,
    DynamicPartitionChannel,
    PartitionChannel,
    Server,
    ServerOptions,
)


def shard_server(i: int) -> Server:
    s = Server()
    s.add_service(
        "EchoService", {"Echo": (lambda c, req, _i=i: b"[shard%d]%s" % (_i, req))}
    )
    assert s.start(0)
    return s


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="the device half's device: the card by default, 'cpu' to run on the CPU")
    device = p.parse_args(argv).device

    shards = [shard_server(i) for i in range(3)]
    url = "list://" + ",".join(
        f"127.0.0.1:{s.port} {i}/3" for i, s in enumerate(shards)
    )

    pc = PartitionChannel()
    assert pc.init(url, partition_count=3)
    cntl = pc.call_method("EchoService", "Echo", b"sharded")
    assert cntl.ok(), cntl.error_text
    print("partitioned response:", cntl.response_payload)
    pc.stop()

    # dynamic: a /3 scheme and a /1 scheme coexist mid-repartition
    extra = shard_server(99)
    url2 = url + f",127.0.0.1:{extra.port} 0/1"
    dpc = DynamicPartitionChannel()
    assert dpc.init(url2)
    seen = set()
    for _ in range(12):
        c = dpc.call_method("EchoService", "Echo", b"x")
        assert c.ok(), c.error_text
        seen.add(c.response_payload)
    print("dynamic schemes answered:", sorted(seen))
    dpc.stop()
    for s in shards + [extra]:
        s.stop()
        s.join(timeout=10)

    # -- the same partitioned call over DEVICE LINKS: the client holds a
    # star of links through the DeviceLinkMap (the SocketMap analog;
    # SURVEY §2.5's sharded parameter-server shape). On one card (or the
    # CPU) every shard's link half shares the device ------------------------
    dshards = []
    for i in range(3):
        s = Server(ServerOptions(usercode_inline=True, device=device))
        s.add_service(
            "EchoService", {"Echo": (lambda c, req, _i=i: b"[dev%d]%s" % (_i, req))}
        )
        assert s.start(0)
        dshards.append(s)
    try:
        durl = "list://" + ",".join(
            f"127.0.0.1:{s.port} {i}/3" for i, s in enumerate(dshards)
        )
        dpc2 = PartitionChannel()
        assert dpc2.init(
            durl,
            partition_count=3,
            options=ChannelOptions(transport="tpu", timeout_ms=60000),
        )
        # sub-calls inherit the PARENT controller's budget: give the first
        # call room for 3 link handshakes
        cntl = dpc2.call_method(
            "EchoService", "Echo", b"over-ici", cntl=Controller(timeout_ms=60000)
        )
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"[dev0]over-ici[dev1]over-ici[dev2]over-ici"
        peers = sorted(
            str(sub[0]._device_sock.link.devices[1]) for sub in dpc2._subs
        )
        print(f"device-fabric response: {cntl.response_payload!r}")
        print(f"star fabric peers: {peers}")
        dpc2.stop()
    finally:
        for s in dshards:
            s.stop()
            s.join(timeout=10)

if __name__ == "__main__":
    main()
