"""tensor_echo_tpu — the transport=tpu flagship pair (the analog of
reference example/rdma_performance): an RPC server whose echo method runs
on the card as the port's framing kernels (frame, verify, echo step: parse
→ verify → dispatch → respond in device memory), fronted by the ordinary
RPC plane. The port's copy of the JAX package's
``examples/tensor_echo_tpu.py``; the name is kept so that a reader finds
its counterpart.

Run: python -m incubator_brpc_tpu_torch.examples.tensor_echo_tpu
     python -m incubator_brpc_tpu_torch.examples.tensor_echo_tpu --device cpu
"""

import argparse

import numpy as np

from incubator_brpc_tpu_torch.rpc import Channel, Controller, Server, ServerOptions
from incubator_brpc_tpu_torch.transport.device import DeviceEndpoint


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="the endpoint's device: the card by default, 'cpu' to run on the CPU")
    args = p.parse_args(argv)

    ep = DeviceEndpoint(window_size=8, device=args.device)
    print("device:", ep.device, "window:", ep.window_size)

    server = Server(ServerOptions(device=args.device))
    server.add_service("TensorEcho", {"Echo": ep.server_handler()})
    assert server.start(0)
    try:
        ch = Channel()
        assert ch.init(f"127.0.0.1:{server.port}")
        # generous timeout: the first call builds the kernels
        cntl = ch.call_method(
            "TensorEcho", "Echo", b"over the PCIe and back",
            cntl=Controller(timeout_ms=120000),
        )
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"over the PCIe and back"
        print("echoed via HBM:", cntl.response_payload)

        # direct endpoint path (no RPC hop), pipelined through the window
        pendings = [
            ep.call_words(np.full(64, i, dtype=np.uint32), correlation_id=i + 1)
            for i in range(8)
        ]
        for i, p_ in enumerate(pendings):
            assert p_.wait(60) and p_.error_code == 0
            assert np.array_equal(p_.response_words, np.full(64, i, dtype=np.uint32))
        print("pipelined 8 calls through the credit window, all ok")
    finally:
        server.stop()
        server.join(timeout=10)
        assert ep.close(timeout=60), "the endpoint did not settle its calls"


if __name__ == "__main__":
    main()
