"""The MPEG-TS muxer (``protocol/mpegts.py``) of the port on the CPU, held
against the JAX package's:

- ``tests/test_mpegts.py``'s 10 cases on both packages (the MPEG-2 CRC
  check value, PAT and PMT, packet alignment and sync, continuity
  counters, SPS/PPS on keyframes in Annex-B form, PTS/DTS from the
  composition offset, the ADTS header, sequence headers emitting nothing,
  unaligned input refused, the FLV to TS pipe);
- the bytes: ``crc32_mpeg``, the PSI sections and PES packets of seeded
  inputs, and the transport streams ``TsWriter`` makes of seeded AVC and
  AAC tag sequences (with and without video or audio, B-frame offsets,
  sequence headers that change mid-stream) are identical in both packages,
  and ``demux_packets`` splits them alike.

Host code only: no server, no device. Tolerance: none; every comparison is
of bytes, integers or strings."""

from __future__ import annotations

import io
import struct
import types

import numpy as np
import pytest

from incubator_brpc_tpu.protocol import flv as jax_flv
from incubator_brpc_tpu.protocol import mpegts as jax_ts
from incubator_brpc_tpu_torch.protocol import flv as port_flv
from incubator_brpc_tpu_torch.protocol import mpegts as port_ts

PKGS = {
    "jax": types.SimpleNamespace(name="jax", ts=jax_ts, flv=jax_flv),
    "torch": types.SimpleNamespace(name="torch", ts=port_ts, flv=port_flv),
}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


def _avc_seq_header(sps=b"\x67\x64\x00\x1e", pps=b"\x68\xee\x3c\x80"):
    """FLV video tag: keyframe+AVC, packet type 0, cts 0, then the
    AVCDecoderConfigurationRecord with one SPS and one PPS."""
    record = (
        b"\x01" + sps[1:4] + b"\xff"
        + bytes([0xE0 | 1]) + struct.pack(">H", len(sps)) + sps
        + bytes([1]) + struct.pack(">H", len(pps)) + pps
    )
    return b"\x17\x00\x00\x00\x00" + record


def _avc_frame(key: bool, nal: bytes, cts: int = 0):
    first = 0x17 if key else 0x27
    return bytes([first, 1]) + cts.to_bytes(3, "big") + struct.pack(
        ">I", len(nal)
    ) + nal


def _aac_seq_header(asc=b"\x12\x10"):  # AAC-LC 44.1kHz stereo
    return b"\xaf\x00" + asc


def _aac_frame(raw: bytes):
    return b"\xaf\x01" + raw


# -- tests/test_mpegts.py on both packages ---------------------------------------


class TestPsi:
    def test_crc32_mpeg_vector(self, pkg):
        # classic check value for "123456789" under CRC-32/MPEG-2
        assert pkg.ts.crc32_mpeg(b"123456789") == 0x0376E6E7

    def test_pat_pmt_structure(self, pkg):
        ts = pkg.ts
        pat = ts.build_pat()
        assert pat[0] == 0x00  # table id
        assert ts.crc32_mpeg(pat[:-4]) == struct.unpack(">I", pat[-4:])[0]
        # the single program maps to the PMT pid
        program, pmt = struct.unpack_from(">HH", pat, 8)
        assert program == 1 and (pmt & 0x1FFF) == ts.PID_PMT

        pmt_sec = ts.build_pmt()
        assert pmt_sec[0] == 0x02
        assert ts.crc32_mpeg(pmt_sec[:-4]) == struct.unpack(
            ">I", pmt_sec[-4:]
        )[0]
        assert bytes([ts.STREAM_TYPE_H264]) in pmt_sec
        assert bytes([ts.STREAM_TYPE_AAC]) in pmt_sec


def mux(ts, writes, **kw):
    out = io.BytesIO()
    w = ts.TsWriter(out, **kw)
    for kind, ts_ms, payload in writes:
        (w.write_video if kind == "v" else w.write_audio)(ts_ms, payload)
    return out.getvalue()


class TestMux:
    def test_packets_aligned_and_synced(self, pkg):
        ts = pkg.ts
        data = mux(ts, [
            ("v", 0, _avc_seq_header()),
            ("a", 0, _aac_seq_header()),
            ("v", 0, _avc_frame(True, b"\x65" + b"k" * 1000)),
            ("a", 23, _aac_frame(b"q" * 300)),
            ("v", 40, _avc_frame(False, b"\x41" + b"p" * 5000)),
        ])
        assert len(data) % ts.TS_PACKET == 0
        pkts = ts.demux_packets(data)
        # first two packets are PAT then PMT
        assert pkts[0][0] == ts.PID_PAT and pkts[0][1]
        assert pkts[1][0] == ts.PID_PMT and pkts[1][1]
        pids = {p for p, _, _, _ in pkts}
        assert ts.PID_VIDEO in pids and ts.PID_AUDIO in pids

    def test_continuity_counters_increment(self, pkg):
        ts = pkg.ts
        data = mux(ts, [
            ("v", 0, _avc_seq_header()),
            ("v", 0, _avc_frame(True, b"\x65" + b"x" * 2000)),
            ("v", 40, _avc_frame(False, b"\x41" + b"y" * 2000)),
        ])
        ccs = [
            cc for pid, _, cc, _ in ts.demux_packets(data)
            if pid == ts.PID_VIDEO
        ]
        for a, b in zip(ccs, ccs[1:]):
            assert b == (a + 1) & 0x0F

    def test_keyframe_gets_sps_pps_annexb(self, pkg):
        ts = pkg.ts
        sps, pps = b"\x67\x64\x00\x1e", b"\x68\xee\x3c\x80"
        data = mux(ts, [
            ("v", 0, _avc_seq_header(sps, pps)),
            ("v", 0, _avc_frame(True, b"\x65FRAME")),
        ])
        es = b"".join(
            body for pid, _, _, body in ts.demux_packets(data)
            if pid == ts.PID_VIDEO
        )
        assert b"\x00\x00\x00\x01" + sps in es
        assert b"\x00\x00\x00\x01" + pps in es
        assert b"\x00\x00\x00\x01\x65FRAME" in es
        assert b"\x00\x00\x00\x01\x09" in es  # access unit delimiter

    def test_pes_pts_dts_from_cts(self, pkg):
        ts = pkg.ts
        data = mux(ts, [
            ("v", 0, _avc_seq_header()),
            ("v", 100, _avc_frame(True, b"\x65z", cts=40)),
        ])
        es = b"".join(
            body for pid, _, _, body in ts.demux_packets(data)
            if pid == ts.PID_VIDEO
        )
        assert es[:4] == b"\x00\x00\x01\xe0"
        flags, hlen = es[7], es[8]
        assert flags & 0xC0 == 0xC0  # PTS+DTS (cts != 0)

        def read_ts(b):
            return (
                ((b[0] >> 1) & 0x7) << 30
                | b[1] << 22 | ((b[2] >> 1) & 0x7F) << 15
                | b[3] << 7 | (b[4] >> 1) & 0x7F
            )

        pts = read_ts(es[9:14])
        dts = read_ts(es[14:19])
        assert dts == 100 * 90
        assert pts == (100 + 40) * 90

    def test_aac_adts_header(self, pkg):
        ts = pkg.ts
        data = mux(ts, [
            ("a", 0, _aac_seq_header(b"\x12\x10")),
            ("a", 0, _aac_frame(b"RAWAAC")),
        ])
        es = b"".join(
            body for pid, _, _, body in ts.demux_packets(data)
            if pid == ts.PID_AUDIO
        )
        # skip the PES header to the ADTS syncword
        i = es.find(b"\xff\xf1")
        assert i >= 0
        adts = es[i : i + 7]
        frame_len = ((adts[3] & 0x3) << 11) | (adts[4] << 3) | (adts[5] >> 5)
        assert frame_len == 7 + len(b"RAWAAC")
        assert es.endswith(b"RAWAAC")

    def test_sequence_headers_emit_no_packets(self, pkg):
        out = io.BytesIO()
        w = pkg.ts.TsWriter(out)
        w.write_video(0, _avc_seq_header())
        w.write_audio(0, _aac_seq_header())
        assert out.getvalue() == b""  # PSI waits for the first real frame

    def test_demux_rejects_unaligned(self, pkg):
        with pytest.raises(ValueError):
            pkg.ts.demux_packets(b"\x47" * 100)


class TestFlvToTsPipe:
    def test_flv_tags_feed_the_ts_writer(self, pkg):
        """The same payload bytes flow FLV→TS (the rtmp→flv→hls path the
        reference serves)."""
        flv, ts = pkg.flv, pkg.ts

        fout = io.BytesIO()
        fw = flv.FlvWriter(fout)
        fw.write_video(0, _avc_seq_header())
        fw.write_audio(0, _aac_seq_header())
        fw.write_video(0, _avc_frame(True, b"\x65KEY"))
        fw.write_audio(23, _aac_frame(b"AUD"))

        tout = io.BytesIO()
        tw = ts.TsWriter(tout)
        for tag, ts_ms, payload in flv.FlvReader(fout.getvalue()):
            if tag == flv.TAG_VIDEO:
                tw.write_video(ts_ms, payload)
            elif tag == flv.TAG_AUDIO:
                tw.write_audio(ts_ms, payload)
        pkts = ts.demux_packets(tout.getvalue())
        assert {p for p, _, _, _ in pkts} >= {
            ts.PID_PAT, ts.PID_PMT, ts.PID_VIDEO, ts.PID_AUDIO
        }


# -- the bytes -------------------------------------------------------------------


def seeded_writes(seed, n=60):
    """(kind, ms, payload) of a seeded AVC + AAC stream: sequence headers
    (a second pair mid-stream, two SPS), keyframes and P-frames of several
    length-prefixed NAL units with composition offsets (negative too), a
    truncated NAL length, AAC frames, an end-of-sequence tag, MP3 audio."""
    rng = np.random.default_rng(seed)

    def blob(hi):
        return rng.integers(0, 256, int(rng.integers(1, hi)), dtype=np.uint8).tobytes()

    out = [("v", 0, _avc_seq_header()), ("a", 0, _aac_seq_header(b"\x13\x90"))]
    for i in range(n):
        ms = 33 * i + int(rng.integers(0, 3))
        if i == n // 2:
            record = (b"\x01\x64\x00\x1f\xff\xe2" + struct.pack(">H", 4) + b"\x67\x64\x00\x1f"
                      + struct.pack(">H", 3) + b"\x67\x01\x02" + b"\x01"
                      + struct.pack(">H", 4) + b"\x68\xee\x3c\x81")
            out.append(("v", ms, b"\x17\x00\x00\x00\x00" + record))
            out.append(("a", ms, _aac_seq_header(b"\x11\x88")))
        key = i % 15 == 0
        nals = b"".join(struct.pack(">I", len(nal)) + nal
                        for nal in [bytes([0x65 if key else 0x41]) + blob(3000)
                                    for _ in range(int(rng.integers(1, 4)))])
        cts = int(rng.integers(-66, 100))
        frame = bytes([0x17 if key else 0x27, 1]) + cts.to_bytes(3, "big", signed=True) + nals
        if i == 7:
            frame += struct.pack(">I", 1 << 20)  # a NAL length past the tag
        out.append(("v", ms, frame))
        out.append(("a", ms + 11, _aac_frame(blob(700))))
        if i == 9:
            out.append(("v", ms, b"\x17\x02\x00\x00\x00"))  # end of sequence
            out.append(("a", ms, b"\x2f\x01mp3"))  # MP3: no TS mapping here
    return out


@pytest.mark.parametrize("has_video,has_audio", [(True, True), (True, False), (False, True)])
def test_ts_streams_identical_across_packages(has_video, has_audio):
    """The transport streams both packages' ``TsWriter`` make of the same
    seeded tags are the same bytes, and ``demux_packets`` splits them alike
    into whole packets whose PAT/PMT CRCs hold and whose continuity
    counters run in sequence per PID."""
    writes = [w for w in seeded_writes(int(has_video) * 2 + int(has_audio))
              if (w[0] == "v" and has_video) or (w[0] == "a" and has_audio)]
    data = mux(jax_ts, writes, has_video=has_video, has_audio=has_audio)
    assert mux(port_ts, writes, has_video=has_video, has_audio=has_audio) == data
    assert len(data) % port_ts.TS_PACKET == 0 and data
    pkts = port_ts.demux_packets(data)
    assert pkts == jax_ts.demux_packets(data)
    last = {}
    for pid, pusi, cc, body in pkts:
        if pid in last:
            assert cc == (last[pid] + 1) & 0x0F
        last[pid] = cc
        if pid in (port_ts.PID_PAT, port_ts.PID_PMT):
            length = ((body[2] & 0x0F) << 8) | body[3]
            section = body[1:4 + length]
            assert port_ts.crc32_mpeg(section[:-4]) == struct.unpack(">I", section[-4:])[0]


def test_psi_pes_and_crc_identical_across_packages():
    """``crc32_mpeg`` over seeded blobs, PAT and PMT sections for each
    stream layout, and PES packets of seeded elementary streams (audio and
    video ids, PTS alone or with a DTS, timestamps past 33 bits, video past
    the 16-bit length) are the same bytes in both packages; an audio PES
    past the 16-bit length, which must carry its length, is refused by
    both (``struct.error``)."""

    def pes(ts, *args):
        try:
            return ts.build_pes(*args)
        except struct.error:
            return "refused"

    rng = np.random.default_rng(41)
    for _ in range(20):
        blob = rng.integers(0, 256, int(rng.integers(0, 400)), dtype=np.uint8).tobytes()
        assert port_ts.crc32_mpeg(blob) == jax_ts.crc32_mpeg(blob)
    for pmt_pid, program in ((port_ts.PID_PMT, 1), (0x0042, 7)):
        assert port_ts.build_pat(pmt_pid, program) == jax_ts.build_pat(pmt_pid, program)
    for video, audio in ((0x100, 0x101), (None, 0x101), (0x100, None), (None, None)):
        assert port_ts.build_pmt(video, audio) == jax_ts.build_pmt(video, audio)
    for sid in (0xE0, 0xC0):
        for size in (0, 188, 70000):
            es = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            pts = int(rng.integers(0, 1 << 34))
            for dts in (None, pts, pts - 3600):
                want = pes(jax_ts, sid, pts, dts, es)
                assert pes(port_ts, sid, pts, dts, es) == want
                assert (want == "refused") == (sid == 0xC0 and size == 70000)
