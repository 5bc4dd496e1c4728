"""streaming_echo — bidirectional stream with credit-window flow control
(reference example/streaming_echo_c++): the client opens a stream on an
RPC, pushes messages, the server echoes them back on its half.
Run: python -m incubator_brpc_tpu_torch.examples.streaming_echo
"""

import threading
import time

from incubator_brpc_tpu_torch.rpc import (
    Channel,
    Server,
    StreamHandler,
    StreamOptions,
    stream_accept,
    stream_create,
)


def main() -> None:
    server = Server()
    server_streams = {}

    class ServerSide(StreamHandler):
        def on_received_messages(self, stream, messages):
            for m in messages:
                stream.write(b"echo:" + m)  # push back on our half

        def on_closed(self, stream):
            print("[server] stream closed")

    def open_stream(cntl, request):
        s = stream_accept(cntl, StreamOptions(handler=ServerSide()))
        server_streams[s.id] = s
        return b"stream accepted"

    server.add_service("StreamService", {"Open": open_stream})
    assert server.start(0)

    got, done = [], threading.Event()

    class ClientSide(StreamHandler):
        def on_received_messages(self, stream, messages):
            got.extend(messages)
            if len(got) >= 5:
                done.set()

    ch = Channel()
    assert ch.init(f"127.0.0.1:{server.port}")
    s = stream_create(StreamOptions(handler=ClientSide(), max_buf_size=1 << 20))
    cntl = ch.call_method("StreamService", "Open", b"", request_stream=s)
    assert cntl.ok(), cntl.error_text
    assert s.wait_connected(5)

    for i in range(5):
        assert s.write(b"msg-%d" % i) == 0
        time.sleep(0.02)
    assert done.wait(5)
    print("[client] received:", got)
    s.close()
    server.stop()


if __name__ == "__main__":
    main()
