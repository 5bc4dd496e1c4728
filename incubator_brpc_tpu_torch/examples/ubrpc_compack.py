"""ubrpc_compack — ubrpc (nshead + mcpack-packed body) end to end, the
reference's example/echo_c++_ubrpc_compack analog: a legacy ubrpc client
calls a modern server through the UbrpcServiceAdaptor, request params and
result travel as mcpack maps (the compack role — this build's bridge
speaks mcpack2, the same tagged binary family), and errors propagate in
the ubrpc result envelope.

Run:  python -m incubator_brpc_tpu_torch.examples.ubrpc_compack [--device cpu]

The port's copy of the JAX package's ``examples/ubrpc_compack.py``. The
server's device (``ServerOptions(device=)``, for device links) is the card
unless ``--device cpu``.
"""

import argparse

from incubator_brpc_tpu_torch.protocol import legacy_pbrpc as lp
from incubator_brpc_tpu_torch.protocol import mcpack
from incubator_brpc_tpu_torch.rpc import Channel, ChannelOptions, Controller, Server, ServerOptions


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="the server's device: the card by default, 'cpu' to run on the CPU")
    device = p.parse_args(argv).device

    # the adaptor routes nshead+mcpack frames to ordinary (cntl, bytes)
    # handlers; params arrive as the mcpack body
    def add(cntl, req: bytes) -> bytes:
        params = mcpack.loads(req)
        return mcpack.dumps({"sum": params["a"] + params["b"]})

    def div(cntl, req: bytes) -> bytes:
        params = mcpack.loads(req)
        if params["b"] == 0:
            cntl.set_failed(1008, "division by zero")
            return b""
        return mcpack.dumps({"quot": params["a"] // params["b"]})

    server = Server(ServerOptions(usercode_inline=True, nshead_service=lp.UbrpcServiceAdaptor,
                                  device=device))
    server.add_service("calc", {"add": add, "div": div})
    assert server.start(0)
    print(f"ubrpc (mcpack2) server on 127.0.0.1:{server.port}")

    ch = Channel()
    assert ch.init(f"127.0.0.1:{server.port}",
                   options=ChannelOptions(protocol="ubrpc_mcpack2", timeout_ms=5000))
    cntl = ch.call_method("calc", "add", mcpack.dumps({"a": 19, "b": 23}),
                          cntl=Controller(timeout_ms=5000))
    assert cntl.ok(), cntl.error_text
    print(f"  calc.add(19, 23)  -> {mcpack.loads(cntl.response_payload)}")

    cntl = ch.call_method("calc", "div", mcpack.dumps({"a": 144, "b": 12}),
                          cntl=Controller(timeout_ms=5000))
    assert cntl.ok(), cntl.error_text
    print(f"  calc.div(144, 12) -> {mcpack.loads(cntl.response_payload)}")

    # errors ride the ubrpc result envelope back to the caller
    cntl = ch.call_method("calc", "div", mcpack.dumps({"a": 1, "b": 0}),
                          cntl=Controller(timeout_ms=5000))
    assert cntl.failed()
    print(f"  calc.div(1, 0)    -> error {cntl.error_code}: {cntl.error_text}")
    server.stop()
    server.join(timeout=10)


if __name__ == "__main__":
    main()
