"""multi_protocol — ONE server port answering five wire protocols
(reference example/multi_threaded_echo_c++ + the per-connection protocol
scan, global.cpp:364-525): tbus_std, baidu_std ("PRPC"), hulu_pbrpc,
sofa_pbrpc, and the HTTP gateway, all multiplexed by the registry scan.

Run:  python -m incubator_brpc_tpu_torch.examples.multi_protocol [--device cpu]

The port's copy of the JAX package's ``examples/multi_protocol.py``. The
server's device (``ServerOptions(device=)``, for device links) is the card
unless ``--device cpu``.
"""

import argparse
import urllib.request

from incubator_brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, ServerOptions


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="the server's device: the card by default, 'cpu' to run on the CPU")
    device = p.parse_args(argv).device
    server = Server(ServerOptions(usercode_inline=True, device=device))
    server.add_service("EchoService", {"Echo": lambda cntl, req: req})
    assert server.start(0)
    port = server.port
    print(f"one port, many protocols: 127.0.0.1:{port}")

    for proto in ("tbus_std", "baidu_std", "hulu_pbrpc", "sofa_pbrpc"):
        ch = Channel()
        assert ch.init(f"127.0.0.1:{port}", options=ChannelOptions(protocol=proto))
        cntl = ch.call_method("EchoService", "Echo", proto.encode())
        assert cntl.ok(), cntl.error_text
        print(f"  {proto:12s} -> {cntl.response_payload.decode()}")

    # the same port serves the HTTP portal + gateway
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=10).read()
    print(f"  http         -> GET /health = {body.decode().strip()!r}")
    server.stop()
    server.join(timeout=10)


if __name__ == "__main__":
    main()
