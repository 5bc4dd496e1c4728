"""FLV container muxing/demuxing over the RTMP message types (reference
src/brpc/rtmp.h:388-440 FlvWriter/FlvReader; the tag layout follows the
Adobe FLV spec both implement).

Wire layout:
    header   "FLV" | version=1 | flags (0x04 audio | 0x01 video) | u32be 9
    then     u32be previous_tag_size (0 for the first)
    tag      type(1B: 8 audio / 9 video / 18 script) | u24be data_size |
             u24be timestamp | u8 timestamp_ext (bits 24-31) |
             u24be stream_id (always 0) | data
    then     u32be previous_tag_size = 11 + data_size   (repeats)

The RTMP relay and this muxer share message shapes: an RTMP AUDIO/VIDEO/
DATA_AMF0 message maps 1:1 onto an FLV tag (rtmp.cpp converts the same
way), so ``FlvDumpService`` can tee any published stream into a .flv.

The port's copy of the JAX package's ``protocol/flv.py``, over the port's
``rtmp`` and ``amf0``: the same files both ways.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator, Optional, Tuple

from incubator_brpc_tpu_torch.protocol import rtmp as rtmp_mod
from incubator_brpc_tpu_torch.protocol.tbus_std import ParseError

SIGNATURE = b"FLV"
VERSION = 1
FLAG_AUDIO = 0x04
FLAG_VIDEO = 0x01
HEADER_BYTES = 9

TAG_AUDIO = 8
TAG_VIDEO = 9
TAG_SCRIPT = 18
_TAG_TYPES = (TAG_AUDIO, TAG_VIDEO, TAG_SCRIPT)

# RTMP message type <-> FLV tag type (identical numbering by design:
# MSG_AUDIO=8, MSG_VIDEO=9, MSG_DATA_AMF0=18)
_MSG_TO_TAG = {
    rtmp_mod.MSG_AUDIO: TAG_AUDIO,
    rtmp_mod.MSG_VIDEO: TAG_VIDEO,
    rtmp_mod.MSG_DATA_AMF0: TAG_SCRIPT,
}


def pack_header(audio: bool = True, video: bool = True) -> bytes:
    flags = (FLAG_AUDIO if audio else 0) | (FLAG_VIDEO if video else 0)
    return SIGNATURE + bytes([VERSION, flags]) + struct.pack(">I", HEADER_BYTES)


def pack_tag(tag_type: int, timestamp: int, data: bytes) -> bytes:
    """One tag + its trailing previous_tag_size word."""
    if tag_type not in _TAG_TYPES:
        raise ValueError(f"not an FLV tag type: {tag_type}")
    if len(data) > 0xFFFFFF:
        raise ValueError(f"FLV tag data of {len(data)} B exceeds 24-bit size")
    timestamp &= 0xFFFFFFFF
    head = bytes([tag_type])
    head += struct.pack(">I", len(data))[1:]          # u24 data size
    head += struct.pack(">I", timestamp & 0xFFFFFF)[1:]  # u24 ts low
    head += bytes([(timestamp >> 24) & 0xFF])         # ts extension
    head += b"\x00\x00\x00"                           # stream id
    return head + data + struct.pack(">I", 11 + len(data))


class FlvWriter:
    """Append FLV tags into a file-like object (reference FlvWriter
    rtmp.h:388: same write-header-once-then-tags discipline)."""

    def __init__(self, out: BinaryIO, audio: bool = True, video: bool = True):
        self._out = out
        self._audio = audio
        self._video = video
        self._wrote_header = False

    def _ensure_header(self) -> None:
        if not self._wrote_header:
            self._out.write(pack_header(self._audio, self._video))
            self._out.write(struct.pack(">I", 0))  # first previous_tag_size
            self._wrote_header = True

    def write_audio(self, timestamp: int, payload: bytes) -> None:
        self._ensure_header()
        self._out.write(pack_tag(TAG_AUDIO, timestamp, payload))

    def write_video(self, timestamp: int, payload: bytes) -> None:
        self._ensure_header()
        self._out.write(pack_tag(TAG_VIDEO, timestamp, payload))

    def write_script(self, timestamp: int, payload: bytes) -> None:
        """AMF0-encoded script data ('onMetaData' and friends)."""
        self._ensure_header()
        self._out.write(pack_tag(TAG_SCRIPT, timestamp, payload))

    def write_message(self, msg: "rtmp_mod.RtmpMessage") -> bool:
        """Tee an RTMP media message; returns False for non-media types."""
        tag = _MSG_TO_TAG.get(msg.type_id)
        if tag is None:
            return False
        self._ensure_header()
        self._out.write(pack_tag(tag, msg.timestamp, msg.payload))
        return True


class FlvReader:
    """Incremental FLV demuxer over a bytes-like feed (reference FlvReader
    rtmp.h:407: EAGAIN-style 'need more data' peeking)."""

    def __init__(self, data: bytes = b""):
        self._buf = bytearray(data)
        self._header_read = False
        self.flags = 0

    def feed(self, data: bytes) -> None:
        self._buf += data

    def _try_header(self) -> bool:
        if self._header_read:
            return True
        if len(self._buf) < HEADER_BYTES + 4:
            return False
        if bytes(self._buf[:3]) != SIGNATURE:
            raise ParseError("not an FLV stream")
        if self._buf[3] != VERSION:
            raise ParseError(f"unsupported FLV version {self._buf[3]}")
        (offset,) = struct.unpack_from(">I", self._buf, 5)
        if offset < HEADER_BYTES:
            raise ParseError("FLV data offset shorter than the header")
        if len(self._buf) < offset + 4:
            return False
        self.flags = self._buf[4]
        del self._buf[: offset + 4]  # header + first previous_tag_size
        self._header_read = True
        return True

    def next_tag(self) -> Optional[Tuple[int, int, bytes]]:
        """(tag_type, timestamp, data) or None when more bytes are needed."""
        if not self._try_header():
            return None
        if len(self._buf) < 11:
            return None
        tag_type = self._buf[0]
        if tag_type not in _TAG_TYPES:
            raise ParseError(f"corrupt FLV tag type {tag_type}")
        size = (self._buf[1] << 16) | (self._buf[2] << 8) | self._buf[3]
        ts = (self._buf[4] << 16) | (self._buf[5] << 8) | self._buf[6]
        ts |= self._buf[7] << 24
        total = 11 + size + 4  # tag + previous_tag_size
        if len(self._buf) < total:
            return None
        data = bytes(self._buf[11 : 11 + size])
        (prev,) = struct.unpack_from(">I", self._buf, 11 + size)
        if prev != 11 + size:
            raise ParseError(
                f"FLV previous_tag_size {prev} != {11 + size}"
            )
        del self._buf[:total]
        return tag_type, ts, data

    def __iter__(self) -> Iterator[Tuple[int, int, bytes]]:
        while True:
            tag = self.next_tag()
            if tag is None:
                return
            yield tag


class FlvDumpService(rtmp_mod.RtmpService):
    """RtmpService that tees every published stream into an FLV sink:
    ``sink_factory(stream_name) -> BinaryIO``. Subclass or wrap to add
    relay behavior on top (the hub relay runs regardless — this service
    only OBSERVES, like the reference's rtmp.cpp FLV dump path)."""

    def __init__(self, sink_factory):
        self._sink_factory = sink_factory
        self._writers = {}

    def _writer(self, stream) -> FlvWriter:
        w = self._writers.get(stream.name)
        if w is None:
            w = self._writers[stream.name] = FlvWriter(
                self._sink_factory(stream.name)
            )
        return w

    def on_meta_data(self, stream, data) -> None:
        from incubator_brpc_tpu_torch.protocol import amf0

        # the hook delivers the decoded AMF command list (possibly
        # ['@setDataFrame', 'onMetaData', {...}]): keep the metadata object
        meta = None
        if isinstance(data, dict):
            meta = data
        elif isinstance(data, list):
            for v in reversed(data):
                if isinstance(v, dict):
                    meta = v
                    break
        if meta is None:
            return
        self._writer(stream).write_script(
            0, amf0.encode_all("onMetaData", meta)
        )

    def on_audio(self, stream, ts: int, payload: bytes) -> None:
        self._writer(stream).write_audio(ts, payload)

    def on_video(self, stream, ts: int, payload: bytes) -> None:
        self._writer(stream).write_video(ts, payload)

    def on_close_stream(self, stream) -> None:
        # writers belong to the PUBLISHER of a name: a player closing its
        # subscription to the same name must not destroy the live dump
        if not stream.publishing:
            return
        w = self._writers.pop(stream.name, None)
        if w is not None:
            # the sink was created by our factory, so its lifetime ends
            # here (file-backed factories would otherwise leak one fd per
            # recorded stream)
            out = w._out
            close = getattr(out, "close", None)
            if close is not None:
                close()
