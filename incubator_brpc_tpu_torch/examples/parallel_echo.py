"""parallel_echo — scatter/gather over a ParallelChannel (reference
example/parallel_echo_c++): one call fans out to N sub-channels, responses
merge in channel order. The second half makes the same call over device
links to three device-method servers. Where the servers' devices are
distinct, the reference fuses the fan-out into one collective dispatch;
on one card every link shares the device, so the host fan-out answers
(``fused=False``; the single-controller fused dispatch is ROADMAP A3c).

Run: python -m incubator_brpc_tpu_torch.examples.parallel_echo
     python -m incubator_brpc_tpu_torch.examples.parallel_echo --device cpu

The port's copy of the JAX package's ``examples/parallel_echo.py``: the
device half runs on the card, or on the CPU with ``--device cpu``.
"""

import argparse

from incubator_brpc_tpu_torch.rpc import (
    Channel,
    ChannelOptions,
    ParallelChannel,
    Server,
    ServerOptions,
    device_method,
)


def add_one(data, n, axis):  # the device kernel every partition serves
    return data + 1, n  # uint8 rows: wraps at 256 as the JAX kernel does


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="the device half's device: the card by default, 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    servers = []
    for i in range(3):
        s = Server()
        s.add_service(
            "EchoService", {"Echo": (lambda c, req, _i=i: b"[replica%d]%s" % (_i, req))}
        )
        assert s.start(0)
        servers.append(s)

    pc = ParallelChannel()  # default fail_limit: succeeds unless ALL fail
    for s in servers:
        ch = Channel()
        assert ch.init(f"127.0.0.1:{s.port}")
        pc.add_channel(ch)

    cntl = pc.call_method("EchoService", "Echo", b"fanout")
    assert cntl.ok(), cntl.error_text
    print(f"merged response: {cntl.response_payload!r}")
    for s in servers:
        s.stop()
        s.join(timeout=10)

    # -- the device half: three device-method servers over device links ----
    dservers = []
    for i in range(3):
        # no device_index: each server binds a card other than the client's where
        # there is one, and on one card (or the CPU) all share it
        s = Server(ServerOptions(usercode_inline=True, device=args.device))
        s.add_service("dsvc", {"inc": device_method(add_one, width=256)})
        assert s.start(0)
        dservers.append(s)
    try:
        fused = ParallelChannel()
        for s in dservers:
            ch = Channel()
            assert ch.init(
                f"127.0.0.1:{s.port}",
                options=ChannelOptions(transport="tpu", timeout_ms=60000),
            )
            fused.add_channel(ch)
        cntl = fused.call_method("dsvc", "inc", b"\x01\x02\x03")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"\x02\x03\x04" * 3
        is_fused = getattr(cntl, "collective_fused", False)
        devices = sorted({str(sub[0]._device_sock.link.devices[1]) for sub in fused._subs})
        print(
            f"fused={is_fused} merged={cntl.response_payload!r}  "
            + ("(one collective dispatch, not 3 RPCs)" if is_fused else
               f"(3 RPCs of the host fan-out: the links share {', '.join(devices)}; "
               "the fused dispatch over distinct devices is ROADMAP A3c)")
        )
    finally:
        for s in dservers:
            s.stop()
            s.join(timeout=10)


if __name__ == "__main__":
    main()
