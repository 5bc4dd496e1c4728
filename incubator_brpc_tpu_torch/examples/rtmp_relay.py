"""rtmp_relay — media relay + FLV dump (reference example/rtmp_c++ and
the rtmp.cpp publish/play machinery): a publisher pushes metadata and
AV frames, a player joins and receives the relay, and the server tees
the stream into an in-memory FLV file.

Run:  python -m incubator_brpc_tpu_torch.examples.rtmp_relay

The port's copy of the JAX package's ``examples/rtmp_relay.py``. The relay
is host code: the server touches no device.
"""

import io
import threading
import time

from incubator_brpc_tpu_torch.protocol import amf0, flv, rtmp
from incubator_brpc_tpu_torch.rpc import Server, ServerOptions


def main() -> None:
    sinks = {}

    def sink_factory(name):
        sinks[name] = io.BytesIO()
        return sinks[name]

    server = Server(
        ServerOptions(
            usercode_inline=True,
            rtmp_service=flv.FlvDumpService(sink_factory),
        )
    )
    server.add_service("svc", {"echo": lambda cntl, req: req})
    assert server.start(0)
    print(f"RTMP relay on rtmp://127.0.0.1:{server.port}/live")

    received = []
    got = threading.Event()

    def on_media(msg):
        received.append(msg)
        if len(received) >= 3:
            got.set()

    publisher = rtmp.RtmpClient("127.0.0.1", server.port)
    pub_stream = publisher.create_stream()
    assert pub_stream.publish("studio")

    player = rtmp.RtmpClient("127.0.0.1", server.port)
    play_stream = player.create_stream()
    assert play_stream.play("studio", on_media=on_media)

    pub_stream.send_metadata({"width": 1280.0, "height": 720.0})
    pub_stream.send_audio(0, b"\xaf\x00" + b"aac-config")
    pub_stream.send_video(0, b"\x17\x00" + b"avc-config")
    assert got.wait(10), "player received nothing"
    print(f"player received {len(received)} relayed messages")

    # snapshot the dump BEFORE closing: the service closes its sink when
    # the publisher's stream ends
    deadline = time.monotonic() + 10
    flv_bytes = b""
    while time.monotonic() < deadline:
        flv_bytes = sinks["studio"].getvalue()
        if len(list(flv.FlvReader(flv_bytes))) >= 3:
            break
        time.sleep(0.05)
    publisher.close()
    player.close()
    tags = list(flv.FlvReader(flv_bytes))
    kinds = {t: 0 for t, _, _ in tags}
    for t, _, _ in tags:
        kinds[t] += 1
    script = next(d for t, _, d in tags if t == flv.TAG_SCRIPT)
    _, meta = amf0.decode_all(script)
    print(f"server dumped {len(tags)} FLV tags {kinds}; "
          f"onMetaData width={meta['width']:.0f}")
    server.stop()
    server.join(timeout=10)


if __name__ == "__main__":
    main()
