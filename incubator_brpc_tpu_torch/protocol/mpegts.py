"""MPEG-TS muxer — the HLS leg of the media stack (reference
src/brpc/ts.{h,cpp}: TsWriter packs RTMP audio/video messages into
ISO 13818-1 transport streams; this module keeps the same role with the
same stream types: H.264 video 0x1B on PID 256, AAC audio 0x0F on
PID 257, PAT on PID 0, PMT on PID 4096).

Payload conversion matches the reference's rtmp→ts path:
- FLV/RTMP video tags carry AVCC (length-prefixed NAL units; tag [0]
  frame/codec, [1] packet type, [2:5] cts). The muxer converts the AVC
  sequence header (SPS/PPS from the AVCDecoderConfigurationRecord) and
  each frame's NALs to Annex-B start-code form, prepending SPS/PPS on
  keyframes and an AUD per access unit.
- FLV/RTMP audio tags carry raw AAC (tag [0] codec/rate, [1] packet
  type) plus an AudioSpecificConfig sequence header. Each raw frame gets
  an ADTS header derived from that config.

PSI tables carry the MPEG-2 CRC32 (polynomial 0x04C11DB7, init ~0).
Every output chunk is a whole number of 188-byte sync-aligned packets —
the property HLS segmenters depend on.

The port's copy of the JAX package's ``protocol/mpegts.py``: the same
transport streams byte for byte.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List, Optional

TS_PACKET = 188
SYNC = 0x47

PID_PAT = 0x0000
PID_PMT = 0x1000
PID_VIDEO = 0x0100
PID_AUDIO = 0x0101

STREAM_TYPE_H264 = 0x1B  # TsStreamVideoH264 (ts.h)
STREAM_TYPE_AAC = 0x0F   # TsStreamAudioAAC

_SID_VIDEO = 0xE0  # PES stream ids
_SID_AUDIO = 0xC0


def crc32_mpeg(data: bytes) -> int:
    """MPEG-2/PSI CRC32: poly 0x04C11DB7, init 0xFFFFFFFF, no reflection,
    no final xor (the reference embeds the same table-driven variant)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7 if crc & 0x80000000 else crc << 1)
            crc &= 0xFFFFFFFF
    return crc


def _psi_packet(pid: int, table: bytes, cc: int) -> bytes:
    """One TS packet holding a PSI section (pointer_field = 0)."""
    header = bytes([
        SYNC,
        0x40 | ((pid >> 8) & 0x1F),  # payload_unit_start
        pid & 0xFF,
        0x10 | (cc & 0x0F),          # payload only
    ])
    payload = b"\x00" + table        # pointer field
    pad = TS_PACKET - len(header) - len(payload)
    return header + payload + b"\xff" * pad


def build_pat(pmt_pid: int = PID_PMT, program: int = 1) -> bytes:
    """Program Association Table section (CreateAsPAT, ts.h:193)."""
    body = struct.pack(
        ">HBBB", 1, 0xC1, 0x00, 0x00  # tsid, version/current, sec, last
    ) + struct.pack(">HH", program, 0xE000 | pmt_pid)
    section = bytes([0x00]) + struct.pack(
        ">H", 0xB000 | (len(body) + 4)
    ) + body
    return section + struct.pack(">I", crc32_mpeg(section))


def build_pmt(
    video_pid: Optional[int] = PID_VIDEO,
    audio_pid: Optional[int] = PID_AUDIO,
    program: int = 1,
) -> bytes:
    """Program Map Table (CreateAsPMT, ts.h:194): declares the elementary
    streams; PCR rides the video PID (or audio when video-less)."""
    pcr_pid = video_pid if video_pid is not None else (audio_pid or 0x1FFF)
    body = struct.pack(
        ">HBBB", program, 0xC1, 0x00, 0x00
    ) + struct.pack(">HH", 0xE000 | pcr_pid, 0xF000)
    for pid, stype in (
        (video_pid, STREAM_TYPE_H264),
        (audio_pid, STREAM_TYPE_AAC),
    ):
        if pid is not None:
            body += bytes([stype]) + struct.pack(
                ">HH", 0xE000 | pid, 0xF000
            )
    section = bytes([0x02]) + struct.pack(
        ">H", 0xB000 | (len(body) + 4)
    ) + body
    return section + struct.pack(">I", crc32_mpeg(section))


def _pts_field(marker: int, pts: int) -> bytes:
    pts &= (1 << 33) - 1
    return bytes([
        (marker << 4) | (((pts >> 30) & 0x7) << 1) | 1,
        (pts >> 22) & 0xFF,
        (((pts >> 15) & 0x7F) << 1) | 1,
        (pts >> 7) & 0xFF,
        ((pts & 0x7F) << 1) | 1,
    ])


def build_pes(stream_id: int, pts: int, dts: Optional[int], es: bytes) -> bytes:
    """PES packet (ts.cpp's TsMessage→PES path): PTS always, DTS when it
    differs (B-frame reorder via composition-time offsets)."""
    if dts is None or dts == pts:
        flags, hlen = 0x80, 5
        header_data = _pts_field(0x2, pts)
    else:
        flags, hlen = 0xC0, 10
        header_data = _pts_field(0x3, pts) + _pts_field(0x1, dts)
    body = bytes([0x80, flags, hlen]) + header_data + es
    # video PES may use length 0 (unbounded); audio must carry the length
    length = 0 if stream_id == _SID_VIDEO and len(body) > 0xFFFF else len(body)
    return b"\x00\x00\x01" + bytes([stream_id]) + struct.pack(
        ">H", length
    ) + body


class TsWriter:
    """Mux RTMP/FLV-shaped audio/video payloads into 188-byte TS packets
    (reference TsWriter ts.h; write PAT+PMT once, then PES-packetize)."""

    def __init__(self, out: BinaryIO, has_video: bool = True,
                 has_audio: bool = True):
        self._out = out
        self._has_video = has_video
        self._has_audio = has_audio
        self._cc = {PID_PAT: 0, PID_PMT: 0, PID_VIDEO: 0, PID_AUDIO: 0}
        self._wrote_psi = False
        # decoder config captured from the sequence headers
        self._sps: List[bytes] = []
        self._pps: List[bytes] = []
        self._asc: Optional[bytes] = None  # AudioSpecificConfig

    # -- PSI ---------------------------------------------------------------

    def _ensure_psi(self) -> None:
        if self._wrote_psi:
            return
        self._wrote_psi = True
        vp = PID_VIDEO if self._has_video else None
        ap = PID_AUDIO if self._has_audio else None
        self._out.write(_psi_packet(PID_PAT, build_pat(), self._bump(PID_PAT)))
        self._out.write(
            _psi_packet(PID_PMT, build_pmt(vp, ap), self._bump(PID_PMT))
        )

    def _bump(self, pid: int) -> int:
        cc = self._cc[pid]
        self._cc[pid] = (cc + 1) & 0x0F
        return cc

    # -- TS packetization --------------------------------------------------

    def _emit(self, pid: int, pes: bytes, pcr: Optional[int]) -> None:
        """Split one PES packet across TS packets; first packet carries
        payload_unit_start (+ PCR in its adaptation field when given)."""
        first = True
        off = 0
        while first or off < len(pes):
            room = TS_PACKET - 4
            adaptation = b""
            if first and pcr is not None:
                base = pcr & ((1 << 33) - 1)
                adaptation = bytes([7, 0x10]) + bytes([
                    (base >> 25) & 0xFF,
                    (base >> 17) & 0xFF,
                    (base >> 9) & 0xFF,
                    (base >> 1) & 0xFF,
                    ((base & 1) << 7) | 0x7E,
                    0,
                ])
                room -= len(adaptation)  # includes its own length byte
            chunk = pes[off : off + room]
            off += len(chunk)
            if len(chunk) < room:
                # stuff through the adaptation field (ISO 13818-1 2.4.3.5)
                stuff = room - len(chunk)
                if adaptation:
                    adaptation = bytes([adaptation[0] + stuff]) + \
                        adaptation[1:] + b"\xff" * stuff
                elif stuff == 1:
                    adaptation = bytes([0])
                else:
                    adaptation = bytes([stuff - 1, 0x00]) + b"\xff" * (
                        stuff - 2
                    )
            flags = 0x30 if adaptation else 0x10
            header = bytes([
                SYNC,
                (0x40 if first else 0x00) | ((pid >> 8) & 0x1F),
                pid & 0xFF,
                flags | self._bump(pid),
            ])
            pkt = header + adaptation + chunk
            assert len(pkt) == TS_PACKET, len(pkt)
            self._out.write(pkt)
            first = False

    # -- AVC (video) -------------------------------------------------------

    def _parse_avc_config(self, record: bytes) -> None:
        """SPS/PPS out of the AVCDecoderConfigurationRecord (ISO 14496-15;
        the reference's avc_demux_sps_pps)."""
        if len(record) < 7:
            return
        n_sps = record[5] & 0x1F
        off = 6
        self._sps = []
        for _ in range(n_sps):
            if off + 2 > len(record):
                return
            n = struct.unpack_from(">H", record, off)[0]
            off += 2
            self._sps.append(bytes(record[off : off + n]))
            off += n
        if off >= len(record):
            return
        n_pps = record[off]
        off += 1
        self._pps = []
        for _ in range(n_pps):
            if off + 2 > len(record):
                return
            n = struct.unpack_from(">H", record, off)[0]
            off += 2
            self._pps.append(bytes(record[off : off + n]))
            off += n

    def write_video(self, timestamp_ms: int, payload: bytes) -> None:
        """One RTMP/FLV video tag. Sequence headers are absorbed into
        decoder state; frames emit Annex-B PES with AUD (+SPS/PPS on
        keyframes), PTS = dts + composition offset."""
        if len(payload) < 5:
            return
        frame_type = payload[0] >> 4
        packet_type = payload[1]
        cts = int.from_bytes(payload[2:5], "big", signed=True)
        if packet_type == 0:  # AVC sequence header
            self._parse_avc_config(payload[5:])
            return
        if packet_type != 1:
            return  # end-of-sequence
        self._ensure_psi()
        es = bytearray(b"\x00\x00\x00\x01\x09\xf0")  # access unit delimiter
        if frame_type == 1:  # keyframe: prepend parameter sets
            for ps in self._sps + self._pps:
                es += b"\x00\x00\x00\x01" + ps
        off = 5
        data = memoryview(payload)
        while off + 4 <= len(payload):  # AVCC -> Annex B
            (n,) = struct.unpack_from(">I", data, off)
            off += 4
            if n <= 0 or off + n > len(payload):
                break
            es += b"\x00\x00\x00\x01" + bytes(data[off : off + n])
            off += n
        dts = timestamp_ms * 90  # 90 kHz clock
        pts = (timestamp_ms + max(0, cts)) * 90
        self._emit(
            PID_VIDEO, build_pes(_SID_VIDEO, pts, dts, bytes(es)), pcr=dts
        )

    # -- AAC (audio) -------------------------------------------------------

    def write_audio(self, timestamp_ms: int, payload: bytes) -> None:
        """One RTMP/FLV audio tag (AAC): sequence header captures the
        AudioSpecificConfig; raw frames get ADTS headers."""
        if len(payload) < 2:
            return
        if (payload[0] >> 4) != 10:
            return  # only AAC has a TS mapping here
        if payload[1] == 0:  # AAC sequence header
            self._asc = bytes(payload[2:])
            return
        raw = payload[2:]
        if not raw:
            return
        self._ensure_psi()
        es = self._adts(raw)
        pts = timestamp_ms * 90
        pcr = None if self._has_video else pts
        self._emit(PID_AUDIO, build_pes(_SID_AUDIO, pts, None, es), pcr=pcr)

    def _adts(self, raw: bytes) -> bytes:
        """ADTS header from the captured AudioSpecificConfig
        (aac_mux_adts in the reference's path)."""
        profile, rate_idx, channels = 1, 4, 2  # AAC-LC 44.1k stereo default
        if self._asc and len(self._asc) >= 2:
            profile = max(1, (self._asc[0] >> 3)) - 1
            rate_idx = ((self._asc[0] & 0x7) << 1) | (self._asc[1] >> 7)
            channels = (self._asc[1] >> 3) & 0x0F
        frame_len = len(raw) + 7
        hdr = bytes([
            0xFF,
            0xF1,  # MPEG-4, no CRC
            ((profile & 0x3) << 6) | ((rate_idx & 0xF) << 2)
            | ((channels >> 2) & 0x1),
            ((channels & 0x3) << 6) | ((frame_len >> 11) & 0x3),
            (frame_len >> 3) & 0xFF,
            ((frame_len & 0x7) << 5) | 0x1F,
            0xFC,
        ])
        return hdr + raw


def demux_packets(data: bytes):
    """Split a TS byte stream into (pid, payload_unit_start, cc, payload)
    tuples — the test-side inverse (enough structure to verify muxing;
    the reference ships no demuxer either)."""
    if len(data) % TS_PACKET:
        raise ValueError("not packet-aligned")
    out = []
    for off in range(0, len(data), TS_PACKET):
        pkt = data[off : off + TS_PACKET]
        if pkt[0] != SYNC:
            raise ValueError(f"lost sync at {off}")
        pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
        pusi = bool(pkt[1] & 0x40)
        afc = (pkt[3] >> 4) & 0x3
        cc = pkt[3] & 0x0F
        body = pkt[4:]
        if afc & 0x2:  # adaptation field present
            alen = body[0]
            body = body[1 + alen :]
        if not afc & 0x1:
            body = b""
        out.append((pid, pusi, cc, bytes(body)))
    return out
