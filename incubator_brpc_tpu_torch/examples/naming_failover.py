"""naming_failover — naming + LB + health-driven failover (reference
example/dynamic_partition_echo_c++'s naming shape + the ExcludedServers /
health-check machinery): three servers behind a list:// naming target and
an rr balancer; one dies mid-traffic and calls keep succeeding on the
survivors without a failed request reaching the user.

Run:  python -m incubator_brpc_tpu_torch.examples.naming_failover
"""


from incubator_brpc_tpu_torch.rpc import Channel, ChannelOptions, Server


def start_server(tag: str) -> Server:
    server = Server()
    server.add_service(
        "EchoService", {"Echo": lambda cntl, req, t=tag: t.encode() + b":" + req}
    )
    assert server.start(0)
    return server


def main() -> None:
    servers = [start_server(f"s{i}") for i in range(3)]
    url = "list://" + ",".join(f"127.0.0.1:{s.port}" for s in servers)
    ch = Channel()
    assert ch.init(url, "rr", options=ChannelOptions(timeout_ms=5000))

    hits = set()
    for _ in range(6):
        cntl = ch.call_method("EchoService", "Echo", b"ping")
        assert cntl.ok(), cntl.error_text
        hits.add(cntl.response_payload.split(b":")[0].decode())
    print(f"round-robin reached: {sorted(hits)}")

    victim = servers.pop()
    victim.stop()
    print("killed one server mid-traffic")

    survivors = set()
    for _ in range(12):
        cntl = ch.call_method("EchoService", "Echo", b"ping")
        assert cntl.ok(), f"call failed after server death: {cntl.error_text}"
        survivors.add(cntl.response_payload.split(b":")[0].decode())
    print(f"all calls kept succeeding; traffic now on: {sorted(survivors)}")

    for s in servers:
        s.stop()


if __name__ == "__main__":
    main()
