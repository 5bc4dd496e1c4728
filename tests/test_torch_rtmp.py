"""RTMP and AMF0 (``protocol/rtmp.py``, ``protocol/amf0.py``) of the port on
the CPU, held against the JAX package's:

- ``tests/test_rtmp.py``'s 23 cases on both packages (AMF0 fixtures and
  refusals, the chunk layer's header compression, size negotiation,
  interleaving and memory bounds, the handshake, publish, play, the relay,
  the late joiner's cached headers, a refused connect and a second
  publisher, rtmp beside tbus_std on one port);
- the bytes: seeded nested AMF0 values encode alike and decode alike
  (truncations refused alike), ``chunk_message`` over csids 2-65599,
  extended timestamps and chunk sizes 128-65536, and the control and
  command packers give the same bytes in both packages, and each
  package's ``ChunkReader`` reads the other's wire alike at every split
  point;
- interop over TCP both ways: each package's ``RtmpClient`` publishes to
  the other package's server while a player of the other package plays,
  the relay bitwise;
- the registry: both packages register rtmp, gated on ``rtmp_service``,
  between thrift and the legacy family;
- the native plane: an RTMP publisher and player on a ``native_plane=True``
  server are handed to the Python plane (one handoff a connection) and
  relayed there, the C++ dispatch counting none of it;
- ``chip_smoke.py``'s phase 3n at a small scale on the CPU.

The port's servers run on ``ServerOptions(device="cpu")``. After each test
the port's host plane is shut down and no ``tbtorch-*`` thread is left (the
port's ``RtmpClient.close()`` joins its reader). Tolerance: none; every
comparison is of bytes, integers or strings."""

from __future__ import annotations

import struct
import threading
import time
import types

import numpy as np
import pytest

import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu_torch.rpc as port_rpc
from incubator_brpc_tpu.protocol import amf0 as jax_amf0
from incubator_brpc_tpu.protocol import registry as jax_registry
from incubator_brpc_tpu.protocol import rtmp as jax_rtmp
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu_torch.protocol import amf0 as port_amf0
from incubator_brpc_tpu_torch.protocol import registry as port_registry
from incubator_brpc_tpu_torch.protocol import rtmp as port_rtmp
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread

PKGS = {
    "jax": types.SimpleNamespace(name="jax", rpc=jax_rpc, amf0=jax_amf0, rtmp=jax_rtmp,
                                 ParseError=jax_tbus.ParseError, server_kw={}),
    "torch": types.SimpleNamespace(name="torch", rpc=port_rpc, amf0=port_amf0, rtmp=port_rtmp,
                                   ParseError=port_tbus.ParseError,
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


def server(pkg, **opts):
    """A started server of ``pkg`` with a tbus_std echo (stopped at
    teardown)."""
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**opts, **pkg.server_kw))
    srv.add_service("svc", {"echo": lambda cntl, req: req})
    assert srv.start(0)
    _OPEN.append(srv)
    return srv


# -- tests/test_rtmp.py on both packages ---------------------------------------


class TestAmf0:
    def test_fixture_bytes(self, pkg):
        amf0 = pkg.amf0
        # spec-worked bytes: number 5.0, string "foo", object {k:"v"}
        assert amf0.encode_value(5.0) == b"\x00" + struct.pack(">d", 5.0)
        assert amf0.encode_value("foo") == b"\x02\x00\x03foo"
        assert (
            amf0.encode_value({"k": "v"})
            == b"\x03\x00\x01k\x02\x00\x01v\x00\x00\x09"
        )

    def test_roundtrip(self, pkg):
        amf0 = pkg.amf0
        values = [
            "connect",
            1.0,
            {"app": "live", "nested": {"a": 1.0}, "arr": [1.0, "x", None]},
            None,
            True,
            amf0.Undefined,
        ]
        data = amf0.encode_all(*values)
        assert amf0.decode_all(data) == values

    def test_long_string(self, pkg):
        amf0 = pkg.amf0
        s = "y" * 70000
        data = amf0.encode_value(s)
        assert data[0] == amf0.LONG_STRING
        v, off = amf0.decode_value(memoryview(data), 0)
        assert v == s and off == len(data)

    def test_ecma_array_decodes_as_dict(self, pkg):
        # ECMA array: marker 0x08, count, then key/value pairs + end marker
        body = (
            b"\x08\x00\x00\x00\x01"
            + b"\x00\x01n" + b"\x00" + struct.pack(">d", 7.0)
            + b"\x00\x00\x09"
        )
        v, _ = pkg.amf0.decode_value(memoryview(body), 0)
        assert v == {"n": 7.0}

    def test_truncations_raise(self, pkg):
        data = pkg.amf0.encode_all("hello", {"k": 1.0})
        for cut in (1, 3, len(data) - 1):
            with pytest.raises(pkg.ParseError):
                pkg.amf0.decode_all(data[:cut])


class TestChunkLayer:
    def test_roundtrip_single(self, pkg):
        rtmp = pkg.rtmp
        payload = b"m" * 300
        wire = rtmp.chunk_message(3, rtmp.MSG_VIDEO, 5, 1234, payload, 128)
        reader = rtmp.ChunkReader()
        msgs, consumed = reader.feed(wire)
        assert consumed == len(wire)
        assert len(msgs) == 1
        m = msgs[0]
        assert (m.type_id, m.msg_stream_id, m.timestamp) == (rtmp.MSG_VIDEO, 5, 1234)
        assert m.payload == payload

    def test_incremental_feed(self, pkg):
        rtmp = pkg.rtmp
        payload = bytes(range(256)) * 4
        wire = rtmp.chunk_message(9, rtmp.MSG_AUDIO, 2, 77, payload, 128)
        reader = rtmp.ChunkReader()
        got = []
        off = 0
        for i in range(0, len(wire), 7):  # drip-feed 7 bytes at a time
            chunk = wire[off : i + 7]
            msgs, used = reader.feed(chunk)
            off += used
            got.extend(msgs)
        msgs, used = reader.feed(wire[off:])
        got.extend(msgs)
        assert len(got) == 1 and got[0].payload == payload

    def test_extended_timestamp(self, pkg):
        rtmp = pkg.rtmp
        payload = b"x" * 200
        ts = 0x1234567
        wire = rtmp.chunk_message(4, rtmp.MSG_VIDEO, 1, ts, payload, 128)
        msgs, _ = rtmp.ChunkReader().feed(wire)
        assert msgs[0].timestamp == ts and msgs[0].payload == payload

    def test_large_csid_encoding(self, pkg):
        rtmp = pkg.rtmp
        for csid in (63, 64, 319, 320, 1000):
            wire = rtmp.chunk_message(csid, rtmp.MSG_AUDIO, 1, 0, b"pp", 128)
            msgs, consumed = rtmp.ChunkReader().feed(wire)
            assert consumed == len(wire) and msgs[0].payload == b"pp"

    def test_interleaved_chunk_streams(self, pkg):
        rtmp = pkg.rtmp
        # two messages chunked at 64B interleave their chunks on the wire:
        # the reader keeps per-csid assembly state
        a = rtmp.chunk_message(3, rtmp.MSG_AUDIO, 1, 10, b"A" * 150, 64)
        b = rtmp.chunk_message(4, rtmp.MSG_VIDEO, 1, 20, b"B" * 150, 64)

        def split(wire, csid):
            # re-split one message's wire into its chunks (fmt0 first)
            reader_chunks = []
            off = 0
            first = True
            while off < len(wire):
                hdr = 12 if first else 1
                take = hdr + min(64, len(wire) - off - hdr)
                reader_chunks.append(wire[off : off + take])
                off += take
                first = False
            return reader_chunks

        ca, cb = split(a, 3), split(b, 4)
        wire = b"".join(x for pair in zip(ca, cb) for x in pair)
        reader = rtmp.ChunkReader()
        reader.chunk_size = 64  # negotiated: matches the writer above
        msgs, consumed = reader.feed(wire)
        assert consumed == len(wire)
        payloads = {m.payload[:1]: m.payload for m in msgs}
        assert payloads == {b"A": b"A" * 150, b"B": b"B" * 150}

    def test_delta_headers_idempotent_across_short_reads(self, pkg):
        rtmp = pkg.rtmp
        # fmt1 delta header whose payload straddles a read boundary: the
        # re-parse after the short read must NOT re-apply the delta
        reader = rtmp.ChunkReader()
        first = rtmp.chunk_message(3, rtmp.MSG_AUDIO, 1, 1000, b"a" * 10, 128)
        msgs, used = reader.feed(first)
        assert used == len(first) and msgs[0].timestamp == 1000
        # hand-build a fmt1 continuation: +40 ms delta, 10-byte payload
        hdr = bytes([0x43]) + b"\x00\x00\x28" + b"\x00\x00\x0a" + bytes(
            [rtmp.MSG_AUDIO]
        )
        wire = hdr + b"b" * 10
        # drip: header only (payload short) → retry with the full chunk
        msgs, used = reader.feed(wire[: len(hdr) + 3])
        assert msgs == [] and used == 0
        msgs, used = reader.feed(wire)
        assert used == len(wire)
        assert msgs[0].timestamp == 1040  # 1000 + 40, applied exactly once

    def test_compressed_header_without_fmt0_rejected(self, pkg):
        # a 0xC3 flood (fmt3 on a virgin csid) must be a parse error, not
        # an amplification of zero-length fabricated messages
        with pytest.raises(pkg.ParseError):
            pkg.rtmp.ChunkReader().feed(b"\xc3" * 16)

    def test_timestamp_wraps_mod_2_32(self, pkg):
        rtmp = pkg.rtmp
        # a >49.7-day stream wraps its 32-bit clock; accumulation must
        # wrap too or the relay-side packer dies on struct.pack('>I')
        reader = rtmp.ChunkReader()
        first = rtmp.chunk_message(3, rtmp.MSG_AUDIO, 1, 0xFFFFFFF0, b"x", 128)
        msgs, _ = reader.feed(first)
        assert msgs[0].timestamp == 0xFFFFFFF0
        hdr = bytes([0x43]) + b"\x00\x00\x20" + b"\x00\x00\x01" + bytes(
            [rtmp.MSG_AUDIO]
        )
        msgs, used = reader.feed(hdr + b"y")  # +0x20 past the wrap
        assert used == len(hdr) + 1
        assert msgs[0].timestamp == 0x10
        # and the packer accepts the wrapped value end-to-end
        rtmp.chunk_message(3, rtmp.MSG_AUDIO, 1, msgs[0].timestamp, b"y", 128)

    def test_assembly_memory_bounded(self, pkg):
        rtmp = pkg.rtmp
        # partial assembly across many chunk streams must hit a hard cap,
        # not pin unbounded RAM
        reader = rtmp.ChunkReader()
        reader.chunk_size = 1 << 20
        reader.max_message = 4 * (1 << 20)
        wire = bytearray()
        for i in range(6):  # 6 x 1 MiB partials of declared-4MiB messages
            csid = 3 + i
            wire += rtmp.chunk_message(
                csid, rtmp.MSG_VIDEO, 1, 0, b"z" * (4 << 20), 1 << 20
            )[: 12 + (1 << 20)]  # fmt0 header + first chunk only
        with pytest.raises(pkg.ParseError):
            reader.feed(bytes(wire))

    def test_too_many_chunk_streams_rejected(self, pkg):
        rtmp = pkg.rtmp
        reader = rtmp.ChunkReader()
        wire = bytearray()
        for i in range(rtmp.ChunkReader.MAX_STREAMS + 1):
            wire += rtmp.chunk_message(64 + i, rtmp.MSG_AUDIO, 1, 0, b"a", 128)
        with pytest.raises(pkg.ParseError):
            reader.feed(bytes(wire))

    def test_set_chunk_size_respected(self, pkg):
        rtmp = pkg.rtmp
        reader = rtmp.ChunkReader()
        reader.chunk_size = 4096
        payload = b"z" * 3000
        wire = rtmp.chunk_message(5, rtmp.MSG_VIDEO, 1, 0, payload, 4096)
        msgs, consumed = reader.feed(wire)
        assert consumed == len(wire) and msgs[0].payload == payload


def service_class(rtmp):
    class _Service(rtmp.RtmpService):
        def __init__(self):
            self.events = []
            self.audio_frames = []

        def on_connect(self, conn, info):
            self.events.append(("connect", info.get("app")))
            return info.get("app") != "forbidden"

        def on_publish(self, stream):
            self.events.append(("publish", stream.name))
            return True

        def on_play(self, stream):
            self.events.append(("play", stream.name))
            return True

        def on_audio(self, stream, ts, payload):
            self.audio_frames.append((ts, payload))

    return _Service


@pytest.fixture
def rtmp_server(pkg):
    service = service_class(pkg.rtmp)()
    srv = server(pkg, usercode_inline=True, rtmp_service=service)
    return srv, service


class TestEndToEnd:
    def test_connect_and_create_stream(self, pkg, rtmp_server):
        srv, service = rtmp_server
        client = pkg.rtmp.RtmpClient("127.0.0.1", srv.port, app="live")
        stream = client.create_stream()
        assert stream.msid >= 1
        assert ("connect", "live") in service.events
        client.close()

    def test_connect_rejected(self, pkg, rtmp_server):
        srv, _ = rtmp_server
        with pytest.raises((TimeoutError, ConnectionError)):
            pkg.rtmp.RtmpClient("127.0.0.1", srv.port, app="forbidden", timeout=2)

    def test_publish_play_relay(self, pkg, rtmp_server):
        rtmp = pkg.rtmp
        srv, service = rtmp_server
        pub = rtmp.RtmpClient("127.0.0.1", srv.port)
        pub_stream = pub.create_stream()
        assert pub_stream.publish("room1")

        received = []
        got_enough = threading.Event()

        def on_media(msg):
            received.append((msg.type_id, msg.timestamp, msg.payload))
            if len(received) >= 4:
                got_enough.set()

        sub = rtmp.RtmpClient("127.0.0.1", srv.port)
        sub_stream = sub.create_stream()
        assert sub_stream.play("room1", on_media=on_media)

        pub_stream.send_metadata({"width": 640.0, "height": 480.0})
        pub_stream.send_audio(100, b"\xaf\x01AUDIO")
        pub_stream.send_video(110, b"\x17\x01VIDEO")
        pub_stream.send_audio(120, b"\xaf\x01MORE")
        assert got_enough.wait(5), f"only got {received}"

        kinds = [k for k, _, _ in received]
        assert rtmp.MSG_DATA_AMF0 in kinds
        assert rtmp.MSG_AUDIO in kinds and rtmp.MSG_VIDEO in kinds
        audio = [(ts, p) for k, ts, p in received if k == rtmp.MSG_AUDIO]
        assert (100, b"\xaf\x01AUDIO") in audio
        # service media hook observed the publisher's frames too
        assert (100, b"\xaf\x01AUDIO") in service.audio_frames
        pub.close()
        sub.close()

    def test_late_joiner_gets_cached_headers(self, pkg, rtmp_server):
        rtmp = pkg.rtmp
        srv, _ = rtmp_server
        pub = rtmp.RtmpClient("127.0.0.1", srv.port)
        ps = pub.create_stream()
        assert ps.publish("vod")
        ps.send_metadata({"fps": 30.0})
        ps.send_audio(0, b"\xaf\x00SEQ")   # AAC sequence header
        ps.send_video(0, b"\x17\x00SPS")   # AVC sequence header
        ps.send_video(40, b"\x27\x01FRAME")
        time.sleep(0.3)  # let the server cache before the late join

        received = []
        headers_seen = threading.Event()

        def on_media(msg):
            received.append((msg.type_id, msg.payload))
            if len(received) >= 3:
                headers_seen.set()

        sub = rtmp.RtmpClient("127.0.0.1", srv.port)
        ss = sub.create_stream()
        assert ss.play("vod", on_media=on_media)
        assert headers_seen.wait(5), f"late joiner got {received}"
        payloads = [p for _, p in received]
        assert b"\xaf\x00SEQ" in payloads  # cached AAC header replayed
        assert b"\x17\x00SPS" in payloads  # cached AVC header replayed
        pub.close()
        sub.close()

    def test_double_publish_refused(self, pkg, rtmp_server):
        rtmp = pkg.rtmp
        srv, _ = rtmp_server
        a = rtmp.RtmpClient("127.0.0.1", srv.port)
        sa = a.create_stream()
        assert sa.publish("solo")
        b = rtmp.RtmpClient("127.0.0.1", srv.port)
        sb = b.create_stream()
        sb.name = "solo"
        b._send_command(sb.msid, "publish", 0.0, None, "solo", "live")
        assert sb.wait_status("NetStream.Publish.BadName", timeout=5)
        a.close()
        b.close()

    def test_rtmp_and_tbus_share_the_port(self, pkg, rtmp_server):
        srv, _ = rtmp_server
        client = pkg.rtmp.RtmpClient("127.0.0.1", srv.port)
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{srv.port}")
        c = ch.call_method("svc", "echo", b"both-worlds")
        assert c.ok() and c.response_payload == b"both-worlds"
        client.close()

    def test_no_service_kills_rtmp_conn(self, pkg):
        srv = server(pkg, usercode_inline=True)
        with pytest.raises((TimeoutError, ConnectionError, OSError)):
            pkg.rtmp.RtmpClient("127.0.0.1", srv.port, timeout=2)


# -- the bytes -------------------------------------------------------------------


def seeded_value(rng, depth=0):
    """A seeded AMF0-encodable value, nested at most four deep."""
    kinds = ["num", "int", "bool", "str", "none", "undef"]
    if depth < 4:
        kinds += ["dict", "list"]
    kind = kinds[int(rng.integers(0, len(kinds)))]
    if kind == "num":
        return float(rng.normal() * 10.0 ** int(rng.integers(-3, 8)))
    if kind == "int":
        return int(rng.integers(-(1 << 40), 1 << 40))
    if kind == "bool":
        return bool(rng.integers(0, 2))
    if kind == "str":
        alphabet = "abcXYZ09 _-é€✓"
        return "".join(alphabet[int(i)] for i in rng.integers(0, len(alphabet),
                                                             int(rng.integers(0, 24))))
    if kind == "none":
        return None
    if kind == "undef":
        return "undefined"  # mapped to each package's Undefined by amf0_value
    if kind == "dict":
        return {f"k{int(rng.integers(0, 1000))}": seeded_value(rng, depth + 1)
                for _ in range(int(rng.integers(0, 5)))}
    return [seeded_value(rng, depth + 1) for _ in range(int(rng.integers(0, 5)))]


def amf0_value(amf0, v):
    """``v`` with the string "undefined" standing for ``amf0.Undefined``."""
    if v == "undefined":
        return amf0.Undefined
    if isinstance(v, dict):
        return {k: amf0_value(amf0, x) for k, x in v.items()}
    if isinstance(v, list):
        return [amf0_value(amf0, x) for x in v]
    return v


def plain_value(amf0, v):
    """The inverse of ``amf0_value``: a value both packages compare alike."""
    if v is amf0.Undefined:
        return "undefined"
    if isinstance(v, dict):
        return {k: plain_value(amf0, x) for k, x in v.items()}
    if isinstance(v, list):
        return [plain_value(amf0, x) for x in v]
    return v


def decoded(amf0, err, data):
    try:
        return [plain_value(amf0, v) for v in amf0.decode_all(data)]
    except err:
        return "refused"


def test_amf0_bytes_identical_across_packages():
    """Seeded nested values (numbers, booleans, strings of every width,
    null, undefined, objects, strict arrays; a long string) encode to the
    same bytes in both packages, each decodes the other's bytes alike, and
    every truncation of a command is refused or read alike."""
    rng = np.random.default_rng(29)
    for _ in range(60):
        values = [seeded_value(rng) for _ in range(int(rng.integers(1, 5)))]
        wire = jax_amf0.encode_all(*[amf0_value(jax_amf0, v) for v in values])
        assert port_amf0.encode_all(*[amf0_value(port_amf0, v) for v in values]) == wire
        want = decoded(jax_amf0, jax_tbus.ParseError, wire)
        assert decoded(port_amf0, port_tbus.ParseError, wire) == want
        for cut in sorted({int(c) for c in rng.integers(0, len(wire), 6)}):
            assert (decoded(port_amf0, port_tbus.ParseError, wire[:cut])
                    == decoded(jax_amf0, jax_tbus.ParseError, wire[:cut]))
    long = "z" * 70001 + "€"
    assert port_amf0.encode_value(long) == jax_amf0.encode_value(long)
    # hand-built markers the encoders never write: ECMA array, date, and an
    # unsupported reference marker
    for body in (b"\x08\x00\x00\x00\x02\x00\x01a\x00" + struct.pack(">d", 1.5)
                 + b"\x00\x01b\x05\x00\x00\x09",
                 b"\x0b" + struct.pack(">d", 1.6e12) + b"\x00\x00",
                 b"\x07\x00\x01", b"\x0a\xff\xff\xff\xff"):
        assert (decoded(port_amf0, port_tbus.ParseError, body)
                == decoded(jax_amf0, jax_tbus.ParseError, body))


CSIDS = (2, 3, 63, 64, 65, 318, 319, 320, 321, 1000, 65599)
CHUNK_SIZES = (128, 129, 4096, 60000, 65536)
TIMESTAMPS = (0, 1, 0xFFFFFE, 0xFFFFFF, 0x1000000, 0xFFFFFFFF, 1 << 32)


def seeded_messages(seed=29, n=60):
    """(csid, type_id, msid, timestamp, payload, chunk size) of seeded
    messages over the boundary csids, timestamps and chunk sizes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        csid = CSIDS[i % len(CSIDS)] if i < 2 * len(CSIDS) else int(rng.integers(2, 65600))
        size = CHUNK_SIZES[i % len(CHUNK_SIZES)]
        ts = TIMESTAMPS[i % len(TIMESTAMPS)] if i % 2 else int(rng.integers(0, 1 << 32))
        n_bytes = (0, 1, size - 1, size, size + 1, int(rng.integers(0, 3 * size)))[i % 6]
        payload = rng.integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
        type_id = (8, 9, 18, 20)[i % 4]
        out.append((csid, type_id, int(rng.integers(0, 1 << 32)), ts, payload, size))
    return out


def read_all(rtmp, wire, chunk_size, split=None):
    """Every message ``rtmp``'s ChunkReader cuts off ``wire`` fed whole, or
    in two feeds split at ``split``; with the bytes each feed consumed."""
    reader = rtmp.ChunkReader()
    reader.chunk_size = chunk_size
    feeds = [wire] if split is None else [wire[:split], None]
    msgs, used = [], []
    off = 0
    for part in feeds:
        got, n = reader.feed(wire[off:] if part is None else part)
        off += n
        used.append(n)
        msgs += [(m.type_id, m.timestamp, m.msg_stream_id, m.payload) for m in got]
    return msgs, used


def test_chunk_messages_identical_across_packages():
    """``chunk_message`` gives the same bytes in both packages over csids
    2-65599 (one-, two- and three-byte basic headers), extended timestamps
    and chunk sizes 128-65536, and each package's reader cuts the other's
    wire into the same messages."""
    for csid, type_id, msid, ts, payload, size in seeded_messages():
        wire = jax_rtmp.chunk_message(csid, type_id, msid, ts, payload, size)
        assert port_rtmp.chunk_message(csid, type_id, msid, ts, payload, size) == wire
        want = read_all(jax_rtmp, wire, size)
        assert read_all(port_rtmp, wire, size) == want
        assert want == ([(type_id, ts & 0xFFFFFFFF, msid, payload)], [len(wire)])


def test_chunk_readers_agree_at_every_split_point():
    """A burst of five messages on three chunk streams (a fmt0 each, fmt3
    continuations, an extended timestamp), split at every byte: both
    packages' readers cut the same messages and consume the same bytes at
    each feed, and the whole burst always comes out."""
    msgs = [(3, 20, 0, 0, b"c" * 40), (6, 9, 1, 0x1000001, bytes(range(256)) * 2),
            (6, 8, 1, 33, b"a" * 7), (4, 18, 1, 5, b"m" * 129), (6, 9, 1, 66, b"v" * 300)]
    wire = b"".join(jax_rtmp.chunk_message(*m, 128) for m in msgs)
    assert wire == b"".join(port_rtmp.chunk_message(*m, 128) for m in msgs)
    for split in range(len(wire) + 1):
        want = read_all(jax_rtmp, wire, 128, split)
        assert read_all(port_rtmp, wire, 128, split) == want, split
        assert sum(want[1]) == len(wire) and len(want[0]) == len(msgs)


def test_control_and_command_packers_identical():
    """The control packers, command packers and the server's status and
    metadata helpers give the same bytes in both packages."""
    for size in (1, 128, 4096, 0x7FFFFFFF, 0xFFFFFFFF):
        for name in ("pack_set_chunk_size", "pack_window_ack_size", "pack_ack",
                     "pack_stream_begin"):
            value = size if name != "pack_window_ack_size" else size & 0xFFFFFFFF
            assert getattr(port_rtmp, name)(value) == getattr(jax_rtmp, name)(value)
        assert port_rtmp.pack_set_peer_bandwidth(size, 1) == jax_rtmp.pack_set_peer_bandwidth(size, 1)
    cmds = [(0, "connect", 1.0, {"app": "live", "tcUrl": "rtmp://h:1/live"}),
            (1, "publish", 0.0, None, "cam", "live"),
            (1, "onStatus", 0.0, None, jax_rtmp._status_info("NetStream.Publish.BadName", "x")),
            (0, "_result", 2.0, None, 1.0)]
    for cmd in cmds:
        for chunk in (128, 4096):
            assert (port_rtmp.pack_command(*cmd, chunk_size=chunk)
                    == jax_rtmp.pack_command(*cmd, chunk_size=chunk))
    for code in ("NetStream.Publish.Start", "NetStream.Play.Failed",
                 "NetConnection.Connect.Rejected", "NetStream.Publish.BadName"):
        assert port_rtmp._status_info(code) == jax_rtmp._status_info(code)
    meta = jax_amf0.encode_all("@setDataFrame", "onMetaData", {"fps": 30.0})
    assert (port_rtmp._normalize_metadata(meta, port_amf0.decode_all(meta))
            == jax_rtmp._normalize_metadata(meta, jax_amf0.decode_all(meta)))
    for payload in (b"", b"\x17", b"\x17\x00", b"\x27\x01", b"\xaf\x00", b"\xaf\x01", b"\x2f\x00"):
        assert port_rtmp._is_avc_header(payload) == jax_rtmp._is_avc_header(payload)
        assert port_rtmp._is_aac_header(payload) == jax_rtmp._is_aac_header(payload)


# -- interop over TCP both ways ------------------------------------------------


def seeded_media(seed, n=24):
    """(kind, ts, payload) of a seeded stream: metadata, the AAC and AVC
    sequence headers, then audio and video frames of up to 20 KB."""
    rng = np.random.default_rng(seed)
    out = [("meta", 0, {"width": 1280.0, "height": 720.0, "fps": 30.0}),
           ("audio", 0, b"\xaf\x00\x12\x10"), ("video", 0, b"\x17\x00" + b"\x00" * 3 + b"avcC")]
    for i in range(n):
        body = rng.integers(0, 256, int(rng.integers(1, 20000)), dtype=np.uint8).tobytes()
        if i % 3 == 2:
            out.append(("audio", 33 * i, b"\xaf\x01" + body[:384]))
        else:
            out.append(("video", 33 * i, (b"\x17\x01" if i == 0 else b"\x27\x01") + body))
    return out


def relay(pub_pkg, play_pkg, port, name, media):
    """Publish ``media`` with ``pub_pkg``'s client while ``play_pkg``'s
    client plays ``name``; returns what the player received."""
    got, done = [], threading.Event()

    def on_media(msg):
        got.append((msg.type_id, msg.timestamp, msg.payload))
        if len(got) == len(media):
            done.set()

    player = play_pkg.rtmp.RtmpClient("127.0.0.1", port)
    pub = pub_pkg.rtmp.RtmpClient("127.0.0.1", port)
    try:
        assert player.create_stream().play(name, on_media=on_media)
        ps = pub.create_stream()
        assert ps.publish(name)
        for kind, ts, payload in media:
            if kind == "meta":
                ps.send_metadata(payload, ts)
            else:
                getattr(ps, f"send_{kind}")(ts, payload)
        assert done.wait(20), f"{len(got)} of {len(media)} relayed"
    finally:
        pub.close()
        player.close()
    return got


def expected_relay(rtmp, amf0, media):
    """What a player that joined before the publish receives: every
    message as sent, metadata in its ``@setDataFrame`` form."""
    out = []
    for kind, ts, payload in media:
        if kind == "meta":
            out.append((rtmp.MSG_DATA_AMF0, ts,
                        amf0.encode_all("@setDataFrame", "onMetaData", payload)))
        else:
            out.append((rtmp.MSG_AUDIO if kind == "audio" else rtmp.MSG_VIDEO, ts, payload))
    return out


@pytest.mark.parametrize("client,srv_pkg", [("torch", "jax"), ("jax", "torch")],
                         ids=["port-client-jax-server", "jax-client-port-server"])
def test_interop_both_ways(client, srv_pkg):
    """Each package's client publishes to the other package's server while
    the server's package plays, and the other way round: every message
    relayed bitwise, in order, with its timestamp."""
    cp, sp = PKGS[client], PKGS[srv_pkg]
    srv = server(sp, rtmp_service=sp.rtmp.RtmpService())
    for seed, (pub, play) in enumerate(((cp, sp), (sp, cp))):
        media = seeded_media(seed)
        got = relay(pub, play, srv.port, f"s{seed}", media)
        assert got == expected_relay(jax_rtmp, jax_amf0, media)


# -- the registry ------------------------------------------------------------------


def test_registry_order_is_the_jax_packages():
    """rtmp between thrift and the legacy family, gated on its option,
    packing neither requests nor responses, cutting its connection's bytes
    itself: as the JAX package registers it."""
    jax_names = [p.name for p in jax_registry.protocol_registry.ordered()]
    port_names = [p.name for p in port_registry.protocol_registry.ordered()]
    assert port_names == jax_names
    i = port_names.index("thrift")
    assert port_names[i + 1:i + 3] == ["rtmp", "hulu_pbrpc"]
    row = port_registry.protocol_registry.get("rtmp")
    jrow = jax_registry.protocol_registry.get("rtmp")
    for field in ("enabled_for", "process_request", "parse_conn", "parse_header"):
        assert (getattr(row, field) is None) == (getattr(jrow, field) is None) is False
    assert row.pack_request is None and row.pack_response is None
    assert jrow.pack_request is None and jrow.pack_response is None


# -- the native plane ----------------------------------------------------------------


def test_native_plane_hands_rtmp_off(pkg):
    """A publisher and a player on a native-plane server are each handed
    to the Python plane (C0 and the start of C1 are neither tbus_std's nor
    baidu_std's magic) and relayed there; the C++ dispatch counts none of
    it."""
    srv = server(pkg, native_plane=True, rtmp_service=pkg.rtmp.RtmpService())
    plane = srv._native_plane
    assert plane is not None
    before = plane.stats()
    media = seeded_media(7, n=12)
    assert relay(pkg, pkg, srv.port, "native", media) == expected_relay(jax_rtmp, jax_amf0, media)
    after = plane.stats()
    assert after["native_reqs"] == before["native_reqs"]
    assert after["handoffs"] - before["handoffs"] == 2


# -- chip_smoke.py's phase 3n on the CPU ---------------------------------------


def test_chip_smoke_phase_3n_on_the_cpu():
    """Phase 3n's parts (a)-(c) at a small scale on the CPU: every device
    answer bitwise ``expected(words, 3)``, every relayed message bitwise in
    order at every player, the late joiners' cached headers, the FLV dumps
    read back as published, the neighbour's tbus_std echoes, the native
    plane's two handoffs, the TS output's packets and CRCs, a rejected
    connect and a second publisher refused, and no launch counted (no
    card). Its counts are of calls, frames and bytes, never of time."""
    import torch

    import chip_smoke
    from incubator_brpc_tpu_torch.ops import kernels

    out, k1 = chip_smoke.rtmp_phase(torch, kernels, device="cpu", scale=0.1)
    assert set(k1) == set("ab")
    assert all(row == {"frame_rows": 0, "verify_rows": 0, "echo_step_rows": 0}
               for row in k1.values())
    a = out["a"]
    frames = chip_smoke.rtmp_frames(0.1)
    # every video payload, the AVC sequence header included, is computed on
    assert a["device_calls"] == a["device_right"] == chip_smoke.RTMP_STREAMS * (frames + 1)
    assert a["players"] == 2 * chip_smoke.RTMP_STREAMS
    assert a["players_right"] == a["players"] and a["late_headers_right"] == chip_smoke.RTMP_STREAMS
    assert a["dumps_right"] == chip_smoke.RTMP_STREAMS
    assert a["neighbour"]["calls_right"] == a["neighbour"]["calls"] > 0
    assert a["neighbour"]["alone_right"] == a["neighbour"]["alone_calls"] > 0
    b = out["b"]
    assert b["frames"] == chip_smoke.rtmp_frames(0.1, chip_smoke.RTMP_NATIVE_FRAMES)
    assert b["relayed_right"] and b["device_right"] == b["device_calls"] == b["frames"] + 1
    assert b["handoffs"] == 2 and b["native_reqs_moved"] == 0
    c = out["c"]
    assert c["ts_streams_right"] == chip_smoke.RTMP_STREAMS and c["ts_packets"] > 0
    assert c["connect_rejected"] == ["_error", "closed"]
    assert c["second_publish"] == "NetStream.Publish.BadName"
