"""nshead_extension — a custom protocol built on the nshead framing, the
reference's example/nshead_extension_c++ (+ nshead_pb_extension_c++)
analog: the server registers ONE NsheadService-style handler that speaks
its own body format (here a tiny "OP arg" text protocol), multiplexed on
the same port as every other wire protocol by the registry scan; the
client is a plain socket speaking nshead frames.

Run:  python -m incubator_brpc_tpu_torch.examples.nshead_extension [--device cpu]

The port's copy of the JAX package's ``examples/nshead_extension.py``. The
server's device (``ServerOptions(device=)``, for device links) is the card
unless ``--device cpu``.
"""

import argparse
import socket

from incubator_brpc_tpu_torch.protocol import nshead
from incubator_brpc_tpu_torch.rpc import Channel, Server, ServerOptions


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="the server's device: the card by default, 'cpu' to run on the CPU")
    device = p.parse_args(argv).device

    # the extension protocol: body = b"<op> <payload>"; the handler picks
    # the op, and head fields (id/log_id) echo back in the response frame
    def extension_service(cntl, head: dict, body: bytes) -> bytes:
        op, _, arg = body.partition(b" ")
        if op == b"REV":
            return arg[::-1]
        if op == b"UPPER":
            return arg.upper()
        cntl.set_failed(1003, f"unknown nshead op {op!r}")
        return b""

    server = Server(ServerOptions(usercode_inline=True, nshead_service=extension_service,
                                  device=device))
    server.add_service("EchoService", {"Echo": lambda cntl, req: req})
    assert server.start(0)
    print(f"nshead extension server on 127.0.0.1:{server.port}")

    def nshead_call(body: bytes, id=7, log_id=99) -> bytes:
        with socket.create_connection(("127.0.0.1", server.port), 5) as c:
            c.sendall(nshead.pack_frame(body, id=id, log_id=log_id))
            buf = b""
            while True:
                chunk = c.recv(4096)
                assert chunk, "server closed mid-frame"
                buf += chunk
                frame, consumed = nshead.try_parse_frame(buf)
                if frame is not None:
                    # the response head echoes the request identity
                    assert frame.head["id"] == id
                    assert frame.head["log_id"] == log_id
                    return frame.payload

    print(f"  REV hello   -> {nshead_call(b'REV hello').decode()}")
    print(f"  UPPER brpc  -> {nshead_call(b'UPPER brpc').decode()}")

    # the SAME port still answers the modern protocols (registry scan)
    ch = Channel()
    assert ch.init(f"127.0.0.1:{server.port}")
    cntl = ch.call_method("EchoService", "Echo", b"still multiplexed")
    assert cntl.ok(), cntl.error_text
    print(f"  tbus_std    -> {cntl.response_payload.decode()}")
    server.stop()
    server.join(timeout=10)


if __name__ == "__main__":
    main()
