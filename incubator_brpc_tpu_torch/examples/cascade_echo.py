"""cascade_echo — a handler that is itself an RPC client (reference
example/cascade_echo_c++: server A's Echo calls server B's Echo before
answering; exercises user-code re-entrancy into the client stack from a
worker fiber, with the deadline budget shared down the chain).

Demo: client -> frontend -> backend; the frontend's handler issues a
nested sync RPC and annotates the reply; a three-deep chain then shows
depth-limited recursion (the reference example's --depth flag).
"""


from incubator_brpc_tpu_torch.rpc import Channel, Controller, Server


def start_backend() -> Server:
    server = Server()
    server.add_service("Echo", {"Echo": lambda cntl, req: b"backend(" + req + b")"})
    assert server.start(0)
    return server


def start_frontend(backend_port: int) -> Server:
    downstream = Channel()
    assert downstream.init(f"127.0.0.1:{backend_port}")
    server = Server()

    def echo(cntl, request: bytes) -> bytes:
        # nested sync RPC from inside a handler fiber; give the child the
        # remaining budget, not a fresh one (the reference passes the
        # parent's deadline down)
        sub = downstream.call_method(
            "Echo", "Echo", request, cntl=Controller(timeout_ms=5000)
        )
        if sub.failed():
            cntl.set_failed(sub.error_code, f"downstream: {sub.error_text}")
            return b""
        return b"frontend(" + sub.response_payload + b")"

    server.add_service("Echo", {"Echo": echo})
    assert server.start(0)
    return server


def start_recursive(depth_port_holder) -> Server:
    """One server whose handler calls ITSELF until depth runs out (the
    --depth recursion of the reference example)."""
    server = Server()
    selfchan = Channel()

    def echo(cntl, request: bytes) -> bytes:
        depth = int(request)
        if depth <= 0:
            return b"bottom"
        sub = selfchan.call_method(
            "Recur", "Echo", b"%d" % (depth - 1),
            cntl=Controller(timeout_ms=5000),
        )
        if sub.failed():
            cntl.set_failed(sub.error_code, sub.error_text)
            return b""
        return b"d%d->" % depth + sub.response_payload

    server.add_service("Recur", {"Echo": echo})
    assert server.start(0)
    assert selfchan.init(f"127.0.0.1:{server.port}")
    return server


def main() -> None:
    backend = start_backend()
    frontend = start_frontend(backend.port)
    ch = Channel()
    assert ch.init(f"127.0.0.1:{frontend.port}")
    cntl = ch.call_method("Echo", "Echo", b"hi", cntl=Controller(timeout_ms=10000))
    assert cntl.ok(), cntl.error_text
    assert cntl.response_payload == b"frontend(backend(hi))"
    print(f"two-hop cascade: {cntl.response_payload.decode()}")

    recur = start_recursive(None)
    rch = Channel()
    assert rch.init(f"127.0.0.1:{recur.port}")
    c = rch.call_method("Recur", "Echo", b"4", cntl=Controller(timeout_ms=10000))
    assert c.ok(), c.error_text
    assert c.response_payload == b"d4->d3->d2->d1->bottom"
    print(f"self-cascade depth 4: {c.response_payload.decode()}")

    for s in (frontend, backend, recur):
        s.stop()
        s.join(timeout=10)
    print("cascade demo ok")


if __name__ == "__main__":
    main()
