"""echo — the canonical client/server pair (reference example/echo_c++:
EchoService::Echo returns the request, client prints the round trip).

Run server:  python -m incubator_brpc_tpu_torch.examples.echo server [port]
Run client:  python -m incubator_brpc_tpu_torch.examples.echo client <port> [message]
Or demo both in one process:  python -m incubator_brpc_tpu_torch.examples.echo demo
Flip the transport (same service, frames over the device plane — the
reference's use_rdma flip):  python -m incubator_brpc_tpu_torch.examples.echo demo tpu

The server's device links live on the card; ``--device cpu`` (anywhere in
the arguments) puts them on the CPU. The port's copy of the JAX package's
``examples/echo.py``.
"""

import sys

from incubator_brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, ServerOptions


def make_server(port: int = 0, device=None) -> Server:
    server = Server(ServerOptions(device=device))

    def echo(cntl, request: bytes) -> bytes:
        # attachment flows back untouched, like the reference example
        cntl.response_attachment = cntl.request_attachment
        return request

    server.add_service("EchoService", {"Echo": echo})
    assert server.start(port)
    print(f"EchoServer listening on {server.listen_endpoint} "
          f"(portal: http://127.0.0.1:{server.port}/status)")
    return server


def run_client(port: int, message: str = "hello world", transport: str = "tcp") -> None:
    ch = Channel()
    opts = ChannelOptions(transport=transport, timeout_ms=60000)
    assert ch.init(f"127.0.0.1:{port}", options=opts)
    cntl = ch.call_method(
        "EchoService", "Echo", message.encode(), attachment=b"piggyback"
    )
    if cntl.failed():
        raise SystemExit(f"RPC failed: {cntl.error_text}")
    via = ""
    if transport == "tpu" and ch._device_sock is not None:
        via = f" via device link {[str(d) for d in ch._device_sock.link.devices]}"
    print(f"response={cntl.response_payload!r} "
          f"attachment={cntl.response_attachment!r} "
          f"latency={cntl.latency_us:.0f}us{via}")


def split_device(argv):
    """(argv without ``--device DEV``, DEV or None)."""
    argv = list(argv)
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
        return argv, device
    return argv, None


def main(argv=None) -> None:
    argv, device = split_device(sys.argv[1:] if argv is None else argv)
    mode = argv[0] if argv else "demo"
    if mode == "server":
        server = make_server(int(argv[1]) if len(argv) > 1 else 8000, device)
        try:
            import time

            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            server.stop()
    elif mode == "client":
        run_client(int(argv[1]), *(argv[2:3] or []))
    else:
        transport = argv[1] if len(argv) > 1 else "tcp"
        server = make_server(0, device)
        try:
            run_client(server.port, transport=transport)
        finally:
            server.stop()
            server.join(timeout=10)


if __name__ == "__main__":
    main()
