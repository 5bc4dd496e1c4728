"""The FLV muxer and demuxer (``protocol/flv.py``) of the port on the CPU,
held against the JAX package's:

- ``tests/test_flv.py``'s 11 cases on both packages (the header and tag
  fixtures, the 24-bit size bound, round trips, the incremental feed, the
  timestamp extension byte, corrupt signatures and tag sizes, the RTMP
  message tee, and ``FlvDumpService`` on a live server: the dump of a
  published stream, a player's close leaving the publisher's dump whole);
- the bytes: seeded tag sequences written by both packages' ``FlvWriter``
  are the same files, and each package's ``FlvReader`` reads either file
  alike at every split point of the input (corrupt files refused alike).

The port's servers run on ``ServerOptions(device="cpu")``. After each test
the port's host plane is shut down and no ``tbtorch-*`` thread is left.
Tolerance: none; every comparison is of bytes, integers or strings."""

from __future__ import annotations

import io
import struct
import threading
import time
import types

import numpy as np
import pytest

import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu_torch.rpc as port_rpc
from incubator_brpc_tpu.protocol import amf0 as jax_amf0
from incubator_brpc_tpu.protocol import flv as jax_flv
from incubator_brpc_tpu.protocol import rtmp as jax_rtmp
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu_torch.protocol import amf0 as port_amf0
from incubator_brpc_tpu_torch.protocol import flv as port_flv
from incubator_brpc_tpu_torch.protocol import rtmp as port_rtmp
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread

PKGS = {
    "jax": types.SimpleNamespace(name="jax", rpc=jax_rpc, amf0=jax_amf0, flv=jax_flv,
                                 rtmp=jax_rtmp, ParseError=jax_tbus.ParseError, server_kw={}),
    "torch": types.SimpleNamespace(name="torch", rpc=port_rpc, amf0=port_amf0, flv=port_flv,
                                   rtmp=port_rtmp, ParseError=port_tbus.ParseError,
                                   server_kw={"device": "cpu"}),
}

_OPEN = []  # servers the test started, stopped at teardown


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    while _OPEN:
        srv = _OPEN.pop()
        srv.stop()
        srv.join(timeout=10)
    port_rpc.shutdown_host_plane()
    assert shutdown_watchers(timeout=60)
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


def dump_server(pkg, sink_factory):
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(
        usercode_inline=True, rtmp_service=pkg.flv.FlvDumpService(sink_factory),
        **pkg.server_kw))
    srv.add_service("svc", {"echo": lambda cntl, req: req})
    assert srv.start(0)
    _OPEN.append(srv)
    return srv


# -- tests/test_flv.py on both packages ------------------------------------------


class TestWire:
    def test_header_fixture(self, pkg):
        flv = pkg.flv
        # "FLV" 0x01 flags u32be(9) — audio+video = 0x05
        assert flv.pack_header() == b"FLV\x01\x05\x00\x00\x00\x09"
        assert flv.pack_header(audio=False) == b"FLV\x01\x01\x00\x00\x00\x09"

    def test_tag_fixture(self, pkg):
        flv = pkg.flv
        # audio tag, ts=0x12345678 (extension byte carries bits 24-31)
        tag = flv.pack_tag(flv.TAG_AUDIO, 0x12345678, b"AB")
        assert tag[0] == 8
        assert tag[1:4] == b"\x00\x00\x02"            # size 2
        assert tag[4:7] == b"\x34\x56\x78"            # ts low 24
        assert tag[7] == 0x12                          # ts ext
        assert tag[8:11] == b"\x00\x00\x00"            # stream id
        assert tag[11:13] == b"AB"
        assert tag[13:17] == struct.pack(">I", 13)     # prev tag size

    def test_oversized_tag_rejected(self, pkg):
        with pytest.raises(ValueError):
            pkg.flv.pack_tag(pkg.flv.TAG_VIDEO, 0, b"\x00" * (0xFFFFFF + 1))


class TestRoundTrip:
    def test_write_read(self, pkg):
        flv = pkg.flv
        out = io.BytesIO()
        w = flv.FlvWriter(out)
        meta = pkg.amf0.encode_all("onMetaData", {"duration": 0.0})
        w.write_script(0, meta)
        w.write_audio(10, b"\xaf\x01AAA")
        w.write_video(20, b"\x17\x01VVV")
        r = flv.FlvReader(out.getvalue())
        tags = list(r)
        assert [t[0] for t in tags] == [
            flv.TAG_SCRIPT, flv.TAG_AUDIO, flv.TAG_VIDEO
        ]
        assert tags[1] == (flv.TAG_AUDIO, 10, b"\xaf\x01AAA")
        assert tags[2] == (flv.TAG_VIDEO, 20, b"\x17\x01VVV")
        assert pkg.amf0.decode_all(tags[0][2])[0] == "onMetaData"

    def test_incremental_feed(self, pkg):
        flv = pkg.flv
        out = io.BytesIO()
        w = flv.FlvWriter(out)
        w.write_audio(1, b"x" * 100)
        w.write_video(2, b"y" * 200)
        wire = out.getvalue()
        r = flv.FlvReader()
        got = []
        for i in range(0, len(wire), 7):
            r.feed(wire[i : i + 7])
            got.extend(iter(r))
        assert [(t, ts, len(d)) for t, ts, d in got] == [
            (flv.TAG_AUDIO, 1, 100), (flv.TAG_VIDEO, 2, 200)
        ]

    def test_extended_timestamp_roundtrip(self, pkg):
        flv = pkg.flv
        out = io.BytesIO()
        w = flv.FlvWriter(out)
        w.write_video(0x7FABCDEF, b"v")
        tags = list(flv.FlvReader(out.getvalue()))
        assert tags[0][1] == 0x7FABCDEF

    def test_bad_signature_raises(self, pkg):
        r = pkg.flv.FlvReader(b"NOT-AN-FLV-FILE-AT-ALL")
        with pytest.raises(pkg.ParseError):
            r.next_tag()

    def test_corrupt_prev_tag_size_raises(self, pkg):
        flv = pkg.flv
        out = io.BytesIO()
        w = flv.FlvWriter(out)
        w.write_audio(0, b"a")
        wire = bytearray(out.getvalue())
        wire[-1] ^= 0xFF  # corrupt the trailing previous_tag_size
        r = flv.FlvReader(bytes(wire))
        with pytest.raises(pkg.ParseError):
            r.next_tag()

    def test_rtmp_message_tee(self, pkg):
        flv, rtmp = pkg.flv, pkg.rtmp
        out = io.BytesIO()
        w = flv.FlvWriter(out)
        assert w.write_message(
            rtmp.RtmpMessage(rtmp.MSG_AUDIO, 5, 1, b"aud")
        )
        assert not w.write_message(
            rtmp.RtmpMessage(rtmp.MSG_COMMAND_AMF0, 0, 0, b"cmd")
        )
        tags = list(flv.FlvReader(out.getvalue()))
        assert tags == [(flv.TAG_AUDIO, 5, b"aud")]


class TestRtmpDumpIntegration:
    def test_player_close_does_not_destroy_publisher_dump(self, pkg):
        flv, rtmp = pkg.flv, pkg.rtmp
        # a subscriber leaving must not pop the publisher's writer (the
        # dump would restart with a second FLV header mid-stream)
        sinks = []

        def sink_factory(name):
            sinks.append(io.BytesIO())
            return sinks[-1]

        srv = dump_server(pkg, sink_factory)
        pub = rtmp.RtmpClient("127.0.0.1", srv.port)
        ps = pub.create_stream()
        assert ps.publish("cam2")
        ps.send_audio(0, b"\xaf\x01a1")

        sub = rtmp.RtmpClient("127.0.0.1", srv.port)
        ss = sub.create_stream()
        assert ss.play("cam2")
        ss.close()  # deleteStream from the PLAYER
        sub.close()
        time.sleep(0.3)  # let the server process the player's close

        ps.send_audio(40, b"\xaf\x01a2")  # publisher keeps going
        deadline = time.monotonic() + 10
        tags = []
        while time.monotonic() < deadline:
            if sinks and not sinks[0].closed:
                tags = list(flv.FlvReader(sinks[0].getvalue()))
                if len(tags) >= 2:
                    break
            time.sleep(0.05)
        assert len(sinks) == 1, "dump restarted into a second sink"
        assert [d for t, ts, d in tags if t == flv.TAG_AUDIO] == [
            b"\xaf\x01a1", b"\xaf\x01a2"
        ]
        pub.close()

    def test_published_stream_dumps_to_flv(self, pkg):
        flv, rtmp = pkg.flv, pkg.rtmp
        sinks = {}

        def sink_factory(name):
            sinks[name] = io.BytesIO()
            return sinks[name]

        srv = dump_server(pkg, sink_factory)
        pub = rtmp.RtmpClient("127.0.0.1", srv.port)
        ps = pub.create_stream()
        assert ps.publish("cam1")
        ps.send_metadata({"width": 320.0})
        ps.send_audio(0, b"\xaf\x00HDR")
        ps.send_video(40, b"\x17\x01FRM")
        deadline = time.monotonic() + 10
        kinds: list = []
        tags: list = []
        while time.monotonic() < deadline:
            buf = sinks.get("cam1")
            if buf is not None:
                tags = list(flv.FlvReader(buf.getvalue()))
                kinds = [t for t, _, _ in tags]
                if {flv.TAG_SCRIPT, flv.TAG_AUDIO, flv.TAG_VIDEO} <= set(
                    kinds
                ):
                    break
            time.sleep(0.05)
        pub.close()
        assert flv.TAG_SCRIPT in kinds
        assert flv.TAG_AUDIO in kinds and flv.TAG_VIDEO in kinds
        script = next(d for t, _, d in tags if t == flv.TAG_SCRIPT)
        name, meta = pkg.amf0.decode_all(script)
        assert name == "onMetaData" and meta["width"] == 320.0


# -- the bytes -------------------------------------------------------------------


TAG = {"script": jax_flv.TAG_SCRIPT, "audio": jax_flv.TAG_AUDIO, "video": jax_flv.TAG_VIDEO}


def seeded_tags(seed, n=40):
    """(kind, timestamp, data) of a seeded tag sequence: script data, audio
    and video of up to 3000 B, timestamps over the 24-bit boundary."""
    rng = np.random.default_rng(seed)
    out = [("script", 0, jax_amf0.encode_all("onMetaData", {"width": 640.0, "fps": 30.0}))]
    for i in range(n):
        kind = ("audio", "video")[int(rng.integers(0, 2))]
        ts = int(rng.integers(0, 1 << 32)) if i % 5 == 4 else 33 * i
        data = rng.integers(0, 256, int(rng.integers(0, 3000)), dtype=np.uint8).tobytes()
        out.append((kind, ts, data))
    return out


def write(flv, tags, audio=True, video=True):
    out = io.BytesIO()
    w = flv.FlvWriter(out, audio=audio, video=video)
    for kind, ts, data in tags:
        getattr(w, f"write_{kind}")(ts, data)
    return out.getvalue()


def read_split(flv, err, data, split):
    """The tags ``flv``'s reader gives for ``data`` fed in two parts split
    at ``split`` (tags after each feed), or where it refuses the input."""
    r = flv.FlvReader()
    got = []
    try:
        for part in (data[:split], data[split:]):
            r.feed(part)
            got.append(list(r))
    except err as e:
        got.append(("refused", str(e)))
    return got, r.flags


def test_flv_files_identical_across_packages():
    """Seeded tag sequences written through both packages' ``FlvWriter``
    (each header flag combination; ``write_message`` for the RTMP tee) are
    the same files, and the ``FlvDumpService`` writer's script tag too."""
    for seed, (audio, video) in enumerate(((True, True), (True, False), (False, True))):
        tags = seeded_tags(seed)
        data = write(jax_flv, tags, audio, video)
        assert write(port_flv, tags, audio, video) == data
        want = [(TAG[k], ts & 0xFFFFFFFF, d) for k, ts, d in tags]
        assert list(port_flv.FlvReader(data)) == list(jax_flv.FlvReader(data)) == want
    msgs = [(t, ts, 1, d) for t, ts, d in ((8, 5, b"a"), (20, 0, b"cmd"), (9, 7, b"v"),
                                           (18, 0, b"s"), (4, 0, b"ctl"))]
    outs = []
    for flv, rtmp in ((jax_flv, jax_rtmp), (port_flv, port_rtmp)):
        out = io.BytesIO()
        w = flv.FlvWriter(out)
        wrote = [w.write_message(rtmp.RtmpMessage(*m)) for m in msgs]
        outs.append((wrote, out.getvalue()))
    assert outs[0] == outs[1] and outs[0][0] == [True, False, True, True, False]


def test_flv_readers_agree_at_every_split_point():
    """A file of six tags, and the same file with a corrupt tag type, a
    corrupt previous_tag_size and a data offset past the header, fed to
    each package's reader in two parts split at every byte: the same tags
    after each feed, the same flags, the same refusals."""
    tags = [("script", 0, b"\x02\x00\x0aonMetaData"), ("audio", 0, b"\xaf\x00\x12\x10"),
            ("video", 0, b"\x17\x00avcC"), ("video", 0x1000001, b"\x17\x01" + b"k" * 90),
            ("audio", 23, b"\xaf\x01" + b"a" * 20), ("video", 33, b"\x27\x01" + b"p" * 40)]
    good = write(jax_flv, tags)
    assert write(port_flv, tags) == good
    bad_type = bytearray(good)
    bad_type[13] = 7
    bad_prev = bytearray(good)
    bad_prev[-1] ^= 1
    offset = bytearray(good[:5]) + struct.pack(">I", 12) + b"\x00\x00\x00" + good[9:]
    for data in (good, bytes(bad_type), bytes(bad_prev), bytes(offset)):
        for split in range(len(data) + 1):
            want = read_split(jax_flv, jax_tbus.ParseError, data, split)
            assert read_split(port_flv, port_tbus.ParseError, data, split) == want, split
    assert read_split(jax_flv, jax_tbus.ParseError, good, 0)[0][1] == [
        (TAG[k], ts, d) for k, ts, d in tags]
