"""RTMP — the media-streaming protocol that demonstrates the Protocol
stack's extension ceiling (reference src/brpc/rtmp.{h,cpp} 2,869 LoC +
policy/rtmp_protocol.cpp 3,676 LoC; byte layouts per the public RTMP
spec, which that code also follows).

Kept design points:
- the C0/C1/C2 handshake piggybacks on the ordinary accepted socket and
  the protocol joins the shared-port scan (first byte 0x03 is the magic),
  gated to servers that registered an ``RtmpService``
  (ServerOptions.rtmp_service — reference server.h rtmp_service);
- chunk-stream framing is STATEFUL per connection (negotiated chunk
  sizes, per-csid header compression): the connection's reader state
  lives on the socket and the messenger consults the protocol's
  ``parse_conn`` hook — the Socket::parsing_context design the reference
  uses for exactly this (socket.h reset_parsing_context; mongo shares it);
- NetConnection/NetStream command machines: connect → createStream →
  publish/play with _result/onStatus AMF0 replies
  (policy/rtmp_protocol.cpp's command dispatch);
- the in-server relay: published streams are a named hub; players attach
  and receive metadata + AVC/AAC sequence headers cached for late joiners
  then live frames — the RtmpRetryingClientStream/monitoring examples'
  server-side counterpart.

Host-plane only: media bytes are opaque payloads here (the TPU story for
tensors rides the device transport; RTMP exists to prove the protocol
registry can carry a full stateful media protocol, as in the reference).

The port's copy of the JAX package's ``protocol/rtmp.py``, byte for byte
on the wire. Its frames carry what the port's messenger reads off every
frame it cuts (``arrival_ts``, ``is_stream``, ``is_response``). On a
``native_plane=True`` server an RTMP connection is handed to the Python
plane (its first four bytes, C0 and the start of C1, are neither
tbus_std's nor baidu_std's magic) and served here. The client's reader
thread is named ``tbtorch-rtmp-reader`` and ``RtmpClient.close()`` joins it.
"""

from __future__ import annotations

import logging
import os
import socket as pysocket
import struct
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch.protocol import amf0
from incubator_brpc_tpu_torch.protocol.registry import Protocol, protocol_registry
from incubator_brpc_tpu_torch.protocol.tbus_std import ParseError

logger = logging.getLogger(__name__)

HANDSHAKE_SIZE = 1536
VERSION = 3

# message type ids (public spec; reference rtmp_protocol.h:47-61)
MSG_SET_CHUNK_SIZE = 1
MSG_ABORT = 2
MSG_ACK = 3
MSG_USER_CONTROL = 4
MSG_WINDOW_ACK_SIZE = 5
MSG_SET_PEER_BANDWIDTH = 6
MSG_AUDIO = 8
MSG_VIDEO = 9
MSG_DATA_AMF0 = 18
MSG_COMMAND_AMF0 = 20

DEFAULT_CHUNK_SIZE = 128
OUT_CHUNK_SIZE = 4096
WINDOW_ACK_SIZE = 2500000

# control messages ride chunk stream 2 / msid 0; commands ride csid 3
CSID_CONTROL = 2
CSID_COMMAND = 3
CSID_MEDIA = 6


class RtmpMessage:
    __slots__ = ("type_id", "timestamp", "msg_stream_id", "payload",
                 "process_inline", "arrival_ts")  # arrival_ts: stamped at cut

    # the messenger's routing surface: always a request
    is_response = False
    is_stream = False

    def __init__(self, type_id: int, timestamp: int, msg_stream_id: int,
                 payload: bytes):
        self.type_id = type_id
        self.timestamp = timestamp
        self.msg_stream_id = msg_stream_id
        self.payload = payload
        self.process_inline = True  # stateful + ordered: reader fiber only
        self.arrival_ts = None


# ---------------------------------------------------------------------------
# chunk writer
# ---------------------------------------------------------------------------


def chunk_message(
    csid: int,
    type_id: int,
    msg_stream_id: int,
    timestamp: int,
    payload: bytes,
    chunk_size: int = OUT_CHUNK_SIZE,
) -> bytes:
    """One message → fmt0 chunk + fmt3 continuations (always full headers
    per message: simple, always-legal encoding; readers handle any fmt)."""
    out = bytearray()
    timestamp &= 0xFFFFFFFF  # 32-bit wrapping clock (spec §5.3.1.3)
    ext = timestamp >= 0xFFFFFF
    ts_field = 0xFFFFFF if ext else timestamp
    if csid < 64:
        basic0, basic3 = bytes([csid]), bytes([0xC0 | csid])
    elif csid < 320:
        basic0 = bytes([0, csid - 64])
        basic3 = bytes([0xC0, csid - 64])
    else:
        v = csid - 64
        basic0 = bytes([1, v & 0xFF, v >> 8])
        basic3 = bytes([0xC1, v & 0xFF, v >> 8])
    out += basic0
    out += struct.pack(">I", ts_field)[1:]  # 3 bytes BE
    out += struct.pack(">I", len(payload))[1:]
    out += bytes([type_id])
    out += struct.pack("<I", msg_stream_id)  # the one little-endian field
    if ext:
        out += struct.pack(">I", timestamp)
    off = 0
    first = True
    while first or off < len(payload):
        if not first:
            out += basic3
            if ext:
                out += struct.pack(">I", timestamp)
        first = False
        n = min(chunk_size, len(payload) - off)
        out += payload[off : off + n]
        off += n
    return bytes(out)


# ---------------------------------------------------------------------------
# chunk reader (per-connection state)
# ---------------------------------------------------------------------------


class _CsState:
    __slots__ = ("timestamp", "ts_delta", "length", "type_id",
                 "msg_stream_id", "ext_ts", "acc", "primed")

    def __init__(self):
        self.timestamp = 0
        self.ts_delta = 0
        self.length = 0
        self.type_id = 0
        self.msg_stream_id = 0
        self.ext_ts = False
        self.acc = bytearray()
        # a fmt0 header must arrive before any compressed (fmt1/2/3)
        # header may reference it — otherwise a desynced or hostile
        # byte stream fabricates messages out of zeroed state
        self.primed = False


class ChunkReader:
    """Incremental chunk-stream parser. ``feed`` consumes as much of
    ``data`` as forms complete chunks and returns (messages, consumed)."""

    # a hostile peer must not pin unbounded memory through the stateful
    # cut (which bypasses the messenger's max_body_size gate): bound the
    # per-message size, the number of live chunk streams, and the TOTAL
    # bytes sitting in partial assembly across all of them
    MAX_MESSAGE = 64 * 1024 * 1024
    MAX_STREAMS = 1024

    def __init__(self):
        self.chunk_size = DEFAULT_CHUNK_SIZE
        self.max_message = self.MAX_MESSAGE
        self._cs: Dict[int, _CsState] = {}
        self._assembling = 0  # bytes across all partial st.acc buffers

    def feed(
        self, data: bytes, max_msgs: Optional[int] = None
    ) -> Tuple[List[RtmpMessage], int]:
        """Parse complete chunks off ``data``. With ``max_msgs`` the cut
        stops once that many messages completed — unconsumed bytes stay
        with the caller (the one-frame-per-call contract parse_conn needs
        so dispatch order matches wire order)."""
        msgs: List[RtmpMessage] = []
        mv = memoryview(data)
        off = 0
        while max_msgs is None or len(msgs) < max_msgs:
            used = self._one_chunk(mv, off, msgs)
            if used == 0:
                break
            off += used
        return msgs, off

    def _one_chunk(self, mv: memoryview, off: int, out: List[RtmpMessage]) -> int:
        n = len(mv)
        start = off
        if off >= n:
            return 0
        b0 = mv[off]
        fmt = b0 >> 6
        csid = b0 & 0x3F
        off += 1
        if csid == 0:
            if off >= n:
                return 0
            csid = 64 + mv[off]
            off += 1
        elif csid == 1:
            if off + 2 > n:
                return 0
            csid = 64 + mv[off] + (mv[off + 1] << 8)
            off += 2
        st = self._cs.get(csid)
        if st is None:
            if len(self._cs) >= self.MAX_STREAMS:
                raise ParseError(
                    f"rtmp peer opened more than {self.MAX_STREAMS} "
                    "chunk streams"
                )
            st = self._cs[csid] = _CsState()
        if fmt != 0 and not st.primed:
            raise ParseError(
                f"rtmp fmt{fmt} chunk on csid {csid} with no prior fmt0"
            )
        # Parse the header into locals FIRST: state must not mutate until
        # the whole chunk (header AND payload) is known available, or the
        # retry after a short read re-applies timestamp deltas.
        new_len, new_type, new_msid = st.length, st.type_id, st.msg_stream_id
        new_ts, new_delta, new_ext = st.timestamp, st.ts_delta, st.ext_ts
        fresh = fmt != 3
        if fmt == 0:
            if off + 11 > n:
                return 0
            ts = (mv[off] << 16) | (mv[off + 1] << 8) | mv[off + 2]
            new_len = (mv[off + 3] << 16) | (mv[off + 4] << 8) | mv[off + 5]
            new_type = mv[off + 6]
            new_msid = struct.unpack_from("<I", mv, off + 7)[0]
            off += 11
            new_ext = ts == 0xFFFFFF
            if new_ext:
                if off + 4 > n:
                    return 0
                ts = struct.unpack_from(">I", mv, off)[0]
                off += 4
            new_ts, new_delta = ts, 0
        elif fmt == 1:
            if off + 7 > n:
                return 0
            delta = (mv[off] << 16) | (mv[off + 1] << 8) | mv[off + 2]
            new_len = (mv[off + 3] << 16) | (mv[off + 4] << 8) | mv[off + 5]
            new_type = mv[off + 6]
            off += 7
            new_ext = delta == 0xFFFFFF
            if new_ext:
                if off + 4 > n:
                    return 0
                delta = struct.unpack_from(">I", mv, off)[0]
                off += 4
            new_delta = delta
            new_ts = st.timestamp + delta
        elif fmt == 2:
            if off + 3 > n:
                return 0
            delta = (mv[off] << 16) | (mv[off + 1] << 8) | mv[off + 2]
            off += 3
            new_ext = delta == 0xFFFFFF
            if new_ext:
                if off + 4 > n:
                    return 0
                delta = struct.unpack_from(">I", mv, off)[0]
                off += 4
            new_delta = delta
            new_ts = st.timestamp + delta
        else:  # fmt 3: continuation (or repeat of the previous header)
            if st.ext_ts:
                if off + 4 > n:
                    return 0
                off += 4  # writers repeat the extended ts on continuations
            if not st.acc and st.length:
                # a fresh fmt3 message: repeat everything incl. delta
                fresh = True
                new_ts = st.timestamp + st.ts_delta
        if new_len > self.max_message:
            raise ParseError(f"rtmp message of {new_len} B rejected")
        already = 0 if fresh else len(st.acc)
        want = min(self.chunk_size, new_len - already)
        if off + want > n:
            return 0
        dropped = len(st.acc) if fresh else 0
        if self._assembling - dropped + want > self.max_message:
            raise ParseError(
                f"rtmp partial-assembly memory over {self.max_message} B"
            )
        # whole chunk available: commit header state, then the payload
        st.length, st.type_id, st.msg_stream_id = new_len, new_type, new_msid
        # RTMP timestamps are 32-bit and wrap (spec §5.3.1.3); without the
        # mask a >49.7-day stream overflows struct.pack('>I') on relay
        st.timestamp, st.ts_delta, st.ext_ts = (
            new_ts & 0xFFFFFFFF, new_delta, new_ext,
        )
        st.primed = True
        if fresh and st.acc:
            self._assembling -= len(st.acc)
            st.acc = bytearray()
        st.acc += bytes(mv[off : off + want])
        self._assembling += want
        off += want
        if len(st.acc) >= st.length:
            self._assembling -= len(st.acc)
            out.append(
                RtmpMessage(st.type_id, st.timestamp, st.msg_stream_id,
                            bytes(st.acc))
            )
            st.acc = bytearray()
        return off - start


# ---------------------------------------------------------------------------
# control / command packers
# ---------------------------------------------------------------------------


def _ctrl(type_id: int, payload: bytes) -> bytes:
    return chunk_message(CSID_CONTROL, type_id, 0, 0, payload)


def pack_set_chunk_size(size: int) -> bytes:
    return _ctrl(MSG_SET_CHUNK_SIZE, struct.pack(">I", size & 0x7FFFFFFF))


def pack_window_ack_size(size: int) -> bytes:
    return _ctrl(MSG_WINDOW_ACK_SIZE, struct.pack(">I", size))


def pack_set_peer_bandwidth(size: int, limit_type: int = 2) -> bytes:
    return _ctrl(MSG_SET_PEER_BANDWIDTH, struct.pack(">IB", size, limit_type))


def pack_ack(received: int) -> bytes:
    return _ctrl(MSG_ACK, struct.pack(">I", received & 0xFFFFFFFF))


def pack_stream_begin(msid: int) -> bytes:
    return _ctrl(MSG_USER_CONTROL, struct.pack(">HI", 0, msid))


def pack_command(msid: int, *values: Any, chunk_size: int = OUT_CHUNK_SIZE) -> bytes:
    return chunk_message(
        CSID_COMMAND, MSG_COMMAND_AMF0, msid, 0, amf0.encode_all(*values),
        chunk_size,
    )


def _status_info(code: str, description: str = "") -> Dict[str, Any]:
    return {
        "level": "error" if ".Failed" in code or ".BadName" in code else "status",
        "code": code,
        "description": description or code,
    }


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------


class RtmpService:
    """Subclass and register via ``ServerOptions(rtmp_service=...)``.
    Returning False from on_connect/on_publish/on_play refuses the
    operation with the protocol's error status. Media callbacks observe
    relayed frames (the relay itself is built in)."""

    def on_connect(self, conn: "RtmpServerConnection", info: dict) -> bool:
        return True

    def on_publish(self, stream: "RtmpServerStream") -> bool:
        return True

    def on_play(self, stream: "RtmpServerStream") -> bool:
        return True

    def on_meta_data(self, stream: "RtmpServerStream", data: Any) -> None:
        pass

    def on_audio(self, stream: "RtmpServerStream", ts: int, payload: bytes) -> None:
        pass

    def on_video(self, stream: "RtmpServerStream", ts: int, payload: bytes) -> None:
        pass

    def on_close_stream(self, stream: "RtmpServerStream") -> None:
        pass


class _HubEntry:
    __slots__ = ("publisher", "subscribers", "metadata", "avc_header",
                 "aac_header")

    def __init__(self):
        self.publisher: Optional["RtmpServerStream"] = None
        self.subscribers: List["RtmpServerStream"] = []
        self.metadata: Optional[bytes] = None  # raw @setDataFrame payload
        self.avc_header: Optional[bytes] = None
        self.aac_header: Optional[bytes] = None


# guards the lazy creation of a server's hub: two connections racing the
# first RTMP operation must not each install their own dict/lock pair
_hub_init_lock = threading.Lock()


def _hub(server) -> Dict[str, _HubEntry]:
    hub = getattr(server, "_rtmp_hub", None)
    if hub is None:
        with _hub_init_lock:
            hub = getattr(server, "_rtmp_hub", None)
            if hub is None:
                server._rtmp_hub_lock = threading.Lock()
                hub = server._rtmp_hub = {}
    return hub


class RtmpServerStream:
    """One NetStream on a server connection (publisher or player)."""

    def __init__(self, conn: "RtmpServerConnection", msid: int, name: str,
                 publishing: bool):
        self.conn = conn
        self.msid = msid
        self.name = name
        self.publishing = publishing

    def send_media(self, type_id: int, ts: int, payload: bytes) -> None:
        self.conn.send_message(CSID_MEDIA, type_id, self.msid, ts, payload)

    def __repr__(self):
        role = "publish" if self.publishing else "play"
        return f"<RtmpServerStream {role} {self.name!r} msid={self.msid}>"


class RtmpServerConnection:
    """Per-connection protocol driver: chunk reader state, command
    dispatch, stream table, relay membership."""

    def __init__(self, sock, server, service: RtmpService):
        self.sock = sock
        self.server = server
        self.service = service
        self.reader = ChunkReader()
        self.await_c2 = True
        self.out_chunk_size = OUT_CHUNK_SIZE
        self.streams: Dict[int, RtmpServerStream] = {}
        self._next_msid = 1
        self.connect_info: dict = {}
        # messages already cut from a copied window but not yet handed to
        # the messenger (parse_conn returns one frame per call)
        self.pending: Deque[RtmpMessage] = deque()
        self._in_bytes = 0
        self._acked = 0
        self._peer_window = 0
        # a bound-method hook on the connection this driver wraps: hook
        # and owner share the connection's lifetime
        sock.on_failed.append(self._on_socket_failed)

    # -- outbound ----------------------------------------------------------

    def send_raw(self, data: bytes) -> None:
        self.sock.write(data)

    def send_message(self, csid: int, type_id: int, msid: int, ts: int,
                     payload: bytes) -> None:
        self.send_raw(
            chunk_message(csid, type_id, msid, ts, payload,
                          self.out_chunk_size)
        )

    def send_command(self, msid: int, *values: Any) -> None:
        self.send_raw(pack_command(msid, *values,
                                   chunk_size=self.out_chunk_size))

    def send_status(self, msid: int, tid: float, code: str,
                    description: str = "") -> None:
        self.send_command(
            msid, "onStatus", tid, None, _status_info(code, description)
        )

    # -- inbound -----------------------------------------------------------

    def on_bytes(self, n: int) -> None:
        self._in_bytes += n
        if (
            self._peer_window
            and self._in_bytes - self._acked >= self._peer_window
        ):
            self._acked = self._in_bytes
            self.send_raw(pack_ack(self._in_bytes))

    def on_message(self, msg: RtmpMessage) -> None:
        t = msg.type_id
        if t == MSG_SET_CHUNK_SIZE:
            if len(msg.payload) >= 4:
                size = struct.unpack_from(">I", msg.payload)[0] & 0x7FFFFFFF
                if size:
                    # clamp: a hostile peer must not force unbounded
                    # single-chunk assembly windows
                    self.reader.chunk_size = min(size, 1 << 24)
        elif t == MSG_WINDOW_ACK_SIZE:
            if len(msg.payload) >= 4:
                self._peer_window = struct.unpack_from(">I", msg.payload)[0]
        elif t == MSG_COMMAND_AMF0:
            self._on_command(msg)
        elif t in (MSG_AUDIO, MSG_VIDEO, MSG_DATA_AMF0):
            self._on_media(msg)
        # ACK / ABORT / USER_CONTROL / bandwidth: nothing to do server-side

    def _on_command(self, msg: RtmpMessage) -> None:
        try:
            values = amf0.decode_all(msg.payload)
        except ParseError as e:
            logger.warning("rtmp command undecodable: %s", e)
            return
        if not values or not isinstance(values[0], str):
            return
        name = values[0]
        tid = values[1] if len(values) > 1 else 0.0
        args = values[2:]
        if name == "connect":
            info = args[0] if args and isinstance(args[0], dict) else {}
            self.connect_info = info
            if not self.service.on_connect(self, info):
                self.send_command(
                    0, "_error", tid, None,
                    _status_info("NetConnection.Connect.Rejected"),
                )
                # let the _error flush before failing the socket (an
                # immediate set_failed drops the queued reply on EAGAIN)
                from incubator_brpc_tpu_torch.transport.sock import when_drained

                when_drained(
                    self.sock,
                    lambda s: s.set_failed(reason="rtmp connect rejected"),
                )
                return
            self.send_raw(pack_window_ack_size(WINDOW_ACK_SIZE))
            self.send_raw(pack_set_peer_bandwidth(WINDOW_ACK_SIZE))
            self.send_raw(pack_set_chunk_size(self.out_chunk_size))
            self.send_command(
                0,
                "_result",
                tid,
                {"fmsVer": "TBRPC/1,0", "capabilities": 31.0},
                {
                    "level": "status",
                    "code": "NetConnection.Connect.Success",
                    "description": "Connection succeeded.",
                },
            )
        elif name == "createStream":
            msid = self._next_msid
            self._next_msid += 1
            self.send_command(0, "_result", tid, None, float(msid))
        elif name == "publish":
            stream_name = args[1] if len(args) > 1 else ""
            self._start_publish(msg.msg_stream_id, str(stream_name), tid)
        elif name == "play":
            stream_name = args[1] if len(args) > 1 else ""
            self._start_play(msg.msg_stream_id, str(stream_name), tid)
        elif name in ("deleteStream", "closeStream"):
            msid = int(args[1]) if name == "deleteStream" and len(args) > 1 \
                else msg.msg_stream_id
            self._close_stream(msid)
        # other commands (FCPublish, getStreamLength...) need no reply

    def _start_publish(self, msid: int, name: str, tid: float) -> None:
        if not name:
            self.send_status(msid, 0.0, "NetStream.Publish.BadName", "empty")
            return
        stream = RtmpServerStream(self, msid, name, publishing=True)
        hub = _hub(self.server)
        with self.server._rtmp_hub_lock:
            entry = hub.setdefault(name, _HubEntry())
            busy = entry.publisher is not None
            if not busy:
                entry.publisher = stream
        if busy:
            # the entry pre-existed (a live publisher owns it), so no
            # idle-drop is needed — and _drop_if_idle re-takes the hub
            # lock, so it must never run under it
            self.send_status(
                msid, 0.0, "NetStream.Publish.BadName", "already publishing"
            )
            return
        if not self.service.on_publish(stream):
            with self.server._rtmp_hub_lock:
                entry.publisher = None
            self._drop_if_idle(name)
            self.send_status(msid, 0.0, "NetStream.Publish.BadName", "refused")
            return
        self.streams[msid] = stream
        self.send_status(msid, 0.0, "NetStream.Publish.Start", name)

    def _start_play(self, msid: int, name: str, tid: float) -> None:
        stream = RtmpServerStream(self, msid, name, publishing=False)
        if not self.service.on_play(stream):
            self.send_status(msid, 0.0, "NetStream.Play.Failed", "refused")
            return
        hub = _hub(self.server)
        with self.server._rtmp_hub_lock:
            entry = hub.setdefault(name, _HubEntry())
            entry.subscribers.append(stream)
            cached = (entry.metadata, entry.aac_header, entry.avc_header)
        self.streams[msid] = stream
        self.send_raw(pack_stream_begin(msid))
        self.send_status(msid, 0.0, "NetStream.Play.Start", name)
        meta, aac, avc = cached
        if meta is not None:
            stream.send_media(MSG_DATA_AMF0, 0, meta)
        if aac is not None:
            stream.send_media(MSG_AUDIO, 0, aac)
        if avc is not None:
            stream.send_media(MSG_VIDEO, 0, avc)

    def _on_media(self, msg: RtmpMessage) -> None:
        stream = self.streams.get(msg.msg_stream_id)
        if stream is None or not stream.publishing:
            return
        meta_values = None
        if msg.type_id == MSG_DATA_AMF0:
            try:
                meta_values = amf0.decode_all(msg.payload)
            except ParseError:
                meta_values = None
        hub = _hub(self.server)
        with self.server._rtmp_hub_lock:
            entry = hub.get(stream.name)
            if entry is None:
                return
            if msg.type_id == MSG_DATA_AMF0:
                entry.metadata = _normalize_metadata(msg.payload, meta_values)
            elif msg.type_id == MSG_AUDIO and _is_aac_header(msg.payload):
                entry.aac_header = msg.payload
            elif msg.type_id == MSG_VIDEO and _is_avc_header(msg.payload):
                entry.avc_header = msg.payload
            targets = list(entry.subscribers)
        if msg.type_id == MSG_DATA_AMF0:
            if meta_values is not None:
                self.service.on_meta_data(stream, meta_values)
        elif msg.type_id == MSG_AUDIO:
            self.service.on_audio(stream, msg.timestamp, msg.payload)
        else:
            self.service.on_video(stream, msg.timestamp, msg.payload)
        for sub in targets:
            try:
                sub.send_media(msg.type_id, msg.timestamp, msg.payload)
            except Exception:
                logger.exception("rtmp relay to %r failed", sub)

    def _drop_if_idle(self, name: str) -> None:
        """Remove a hub entry nobody uses — a refused publish must not let
        attacker-chosen names accumulate."""
        hub = _hub(self.server)
        with self.server._rtmp_hub_lock:
            entry = hub.get(name)
            if entry is not None and entry.publisher is None and not entry.subscribers:
                hub.pop(name, None)

    def _close_stream(self, msid: int) -> None:
        stream = self.streams.pop(msid, None)
        if stream is None:
            return
        hub = _hub(self.server)
        with self.server._rtmp_hub_lock:
            entry = hub.get(stream.name)
            if entry is not None:
                if entry.publisher is stream:
                    entry.publisher = None
                elif stream in entry.subscribers:
                    entry.subscribers.remove(stream)
                if entry.publisher is None and not entry.subscribers:
                    hub.pop(stream.name, None)
        try:
            self.service.on_close_stream(stream)
        except Exception:
            logger.exception("on_close_stream raised")

    def _on_socket_failed(self, sock) -> None:
        for msid in list(self.streams):
            self._close_stream(msid)


# ---------------------------------------------------------------------------
# protocol entry (shared-port scan + stateful cut)
# ---------------------------------------------------------------------------


class _HandshakeFrame:
    __slots__ = ("c1", "process_inline", "arrival_ts")  # arrival_ts: stamped at cut

    is_response = False
    is_stream = False

    def __init__(self, c1: bytes):
        self.c1 = c1
        self.process_inline = True
        self.arrival_ts = None


def parse_header(header: bytes) -> Optional[int]:
    if len(header) >= 1 and header[0] != VERSION:
        raise ParseError("not rtmp")
    return 1 + HANDSHAKE_SIZE  # C0 + C1


def try_parse_frame(buf: bytes) -> Tuple[Optional[_HandshakeFrame], int]:
    if len(buf) < 1 + HANDSHAKE_SIZE:
        return None, 0
    if buf[0] != VERSION:
        raise ParseError("not rtmp")
    return _HandshakeFrame(bytes(buf[1 : 1 + HANDSHAKE_SIZE])), 1 + HANDSHAKE_SIZE


def _process_request(sock, frame) -> None:
    server = sock.context.get("server")
    service = (
        getattr(server.options, "rtmp_service", None)
        if server is not None
        else None
    )
    if isinstance(frame, _HandshakeFrame):
        if service is None:
            sock.set_failed(reason="rtmp without rtmp_service")
            return
        conn = RtmpServerConnection(sock, server, service)
        sock.context["rtmp"] = conn
        # S0 + S1 (fresh time+random) + S2 (echo of C1)
        s1 = struct.pack(">II", int(time.monotonic()), 0) + os.urandom(
            HANDSHAKE_SIZE - 8
        )
        sock.write(bytes([VERSION]) + s1 + frame.c1)
        sock.preferred_protocol = RTMP  # parse_conn owns the bytes from here
        return
    conn: Optional[RtmpServerConnection] = sock.context.get("rtmp")
    if conn is None:
        logger.warning("rtmp message on %r with no connection state", sock)
        return
    conn.on_message(frame)


def parse_conn(sock, buf, max_total: Optional[int] = None):
    """Stateful cut: C2 then chunks. Returns (frame|None, consumed); the
    messenger keeps calling while bytes are consumed."""
    conn: Optional[RtmpServerConnection] = sock.context.get("rtmp")
    if conn is None:
        # the scan marked us preferred off the first bytes, but C0+C1 split
        # across bursts: finish cutting the handshake here
        if len(buf) < 1 + HANDSHAKE_SIZE:
            return None, 0
        raw = buf.to_bytes(1 + HANDSHAKE_SIZE)
        if raw[0] != VERSION:
            raise ParseError("not rtmp")
        buf.popn(1 + HANDSHAKE_SIZE)
        return _HandshakeFrame(raw[1:]), 1 + HANDSHAKE_SIZE
    if conn.await_c2:
        if len(buf) < HANDSHAKE_SIZE:
            return None, 0
        buf.popn(HANDSHAKE_SIZE)
        conn.await_c2 = False
        conn.on_bytes(HANDSHAKE_SIZE)
        return None, HANDSHAKE_SIZE
    # messages cut on a previous call drain first — no buffer touch at all
    if conn.pending:
        return conn.pending.popleft(), 0
    # bounded window, copied ONCE and drained completely: copying the
    # chain per one-message feed would re-copy the same leading bytes
    # once per message under a small-message burst. The window always
    # covers at least one full chunk (+headers), so every call either
    # completes a message or consumes chunks into assembly state —
    # guaranteed progress, linear total copying.
    window = max(64 * 1024, conn.reader.chunk_size + 64)
    raw = memoryview(buf.to_bytes(min(len(buf), window)))
    total = 0
    while True:
        msgs, used = conn.reader.feed(raw[total:], max_msgs=1)
        total += used
        if not msgs:
            break
        msg = msgs[0]
        if msg.type_id == MSG_SET_CHUNK_SIZE:
            # framing state must change BEFORE the next cut — applying it
            # at dispatch time would misparse any larger message sharing
            # this read burst
            conn.on_message(msg)
            continue
        conn.pending.append(msg)
    if total:
        buf.popn(total)
        conn.on_bytes(total)
    if conn.pending:
        return conn.pending.popleft(), total
    return None, total


def _enabled_for(sock) -> bool:
    server = sock.context.get("server")
    return (
        server is not None
        and getattr(server.options, "rtmp_service", None) is not None
    )


RTMP = Protocol(
    name="rtmp",
    parse=try_parse_frame,
    parse_header=parse_header,
    process_request=_process_request,
    parse_conn=parse_conn,
    enabled_for=_enabled_for,
)

if "rtmp" not in protocol_registry:
    protocol_registry.register(RTMP)


def _normalize_metadata(payload: bytes, values) -> bytes:
    """Cache '@setDataFrame' payloads as the 'onMetaData' form players
    expect (strip the publisher-side wrapper). ``values`` is the already-
    decoded AMF0 list (or None if undecodable)."""
    if values and values[0] == "@setDataFrame":
        return amf0.encode_all(*values[1:])
    return payload


def _is_avc_header(payload: bytes) -> bool:
    return (
        len(payload) >= 2 and (payload[0] & 0x0F) == 7 and payload[1] == 0
    )


def _is_aac_header(payload: bytes) -> bool:
    return len(payload) >= 2 and (payload[0] >> 4) == 10 and payload[1] == 0


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class RtmpClientStream:
    """A created NetStream on the client: publish or play."""

    def __init__(self, client: "RtmpClient", msid: int):
        self.client = client
        self.msid = msid
        self.name = ""
        self.on_media: Optional[Callable[[RtmpMessage], None]] = None
        self.statuses: List[dict] = []
        self._status_cv = threading.Condition()

    def _on_status(self, info: dict) -> None:
        with self._status_cv:
            self.statuses.append(info)
            self._status_cv.notify_all()

    def wait_status(self, code: str, timeout: float = 5.0) -> bool:
        deadline = time.monotonic() + timeout
        with self._status_cv:
            while True:
                if any(s.get("code") == code for s in self.statuses):
                    return True
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._status_cv.wait(left)

    def publish(self, name: str, timeout: float = 5.0) -> bool:
        self.name = name
        self.client._send_command(self.msid, "publish", 0.0, None, name, "live")
        return self.wait_status("NetStream.Publish.Start", timeout)

    def play(self, name: str, on_media=None, timeout: float = 5.0) -> bool:
        self.name = name
        self.on_media = on_media
        self.client._send_command(self.msid, "play", 0.0, None, name)
        return self.wait_status("NetStream.Play.Start", timeout)

    def send_metadata(self, data: dict, ts: int = 0) -> None:
        payload = amf0.encode_all("@setDataFrame", "onMetaData", data)
        self.client._send_media(self.msid, MSG_DATA_AMF0, ts, payload)

    def send_audio(self, ts: int, payload: bytes) -> None:
        self.client._send_media(self.msid, MSG_AUDIO, ts, payload)

    def send_video(self, ts: int, payload: bytes) -> None:
        self.client._send_media(self.msid, MSG_VIDEO, ts, payload)

    def close(self) -> None:
        self.client._send_command(0, "deleteStream", 0.0, None, float(self.msid))


class RtmpClient:
    """Minimal full-duplex RTMP client over a plain socket with a reader
    thread (the reference's RtmpClientStream family; examples/rtmp_press).
    The thread is named ``tbtorch-rtmp-reader``; ``close()`` joins it."""

    def __init__(self, host: str, port: int, app: str = "live",
                 timeout: float = 5.0):
        self._sock = pysocket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(pysocket.IPPROTO_TCP, pysocket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()
        self._reader = ChunkReader()
        self._out_chunk_size = OUT_CHUNK_SIZE
        self._results: Dict[float, Any] = {}
        self._results_cv = threading.Condition()
        self._streams: Dict[int, RtmpClientStream] = {}
        self._next_tid = 1.0
        self._closed = False
        self._rthread = None
        try:
            self._handshake(timeout)
            self._rthread = threading.Thread(
                target=self._read_loop, name="tbtorch-rtmp-reader", daemon=True
            )
            self._rthread.start()
            self._send_raw(pack_set_chunk_size(self._out_chunk_size))
            tid = self._alloc_tid()
            self._send_command(
                0, "connect", tid,
                {"app": app, "tcUrl": f"rtmp://{host}:{port}/{app}"},
            )
            result = self._wait_result(tid, timeout)
            if result is None:
                raise TimeoutError("rtmp connect timed out")
            ok, info = result
            if not ok:
                raise ConnectionError(f"rtmp connect rejected: {info}")
        except BaseException:
            # a failed connect must not strand the fd + reader thread
            self.close()
            raise

    # -- plumbing ----------------------------------------------------------

    def _handshake(self, timeout: float) -> None:
        c1 = struct.pack(">II", 0, 0) + os.urandom(HANDSHAKE_SIZE - 8)
        self._sock.sendall(bytes([VERSION]) + c1)
        need = 1 + 2 * HANDSHAKE_SIZE  # S0 S1 S2
        got = b""
        while len(got) < need:
            chunk = self._sock.recv(need - len(got))
            if not chunk:
                raise ConnectionError("rtmp handshake: peer closed")
            got += chunk
        if got[0] != VERSION:
            raise ConnectionError("rtmp handshake: bad version")
        s1 = got[1 : 1 + HANDSHAKE_SIZE]
        self._sock.sendall(s1)  # C2 echoes S1

    def _send_raw(self, data: bytes) -> None:
        with self._wlock:
            self._sock.sendall(data)

    def _send_command(self, msid: int, *values: Any) -> None:
        self._send_raw(
            pack_command(msid, *values, chunk_size=self._out_chunk_size)
        )

    def _send_media(self, msid: int, type_id: int, ts: int, payload: bytes) -> None:
        self._send_raw(
            chunk_message(CSID_MEDIA, type_id, msid, ts, payload,
                          self._out_chunk_size)
        )

    def _alloc_tid(self) -> float:
        tid = self._next_tid
        self._next_tid += 1.0
        return tid

    def _wait_result(self, tid: float, timeout: float):
        deadline = time.monotonic() + timeout
        with self._results_cv:
            while tid not in self._results:
                left = deadline - time.monotonic()
                if left <= 0 or self._closed:
                    return None
                self._results_cv.wait(left)
            return self._results.pop(tid)

    def _read_loop(self) -> None:
        buf = bytearray()
        try:
            while not self._closed:
                data = self._sock.recv(65536)
                if not data:
                    break
                buf += data
                # one message per feed: a SET_CHUNK_SIZE must take effect
                # before the bytes behind it are framed. The feed consumes
                # through a zero-copy view at a moving offset; the residual
                # tail is compacted once per recv, not once per message.
                off = 0
                while True:
                    msgs, used = self._reader.feed(
                        memoryview(buf)[off:], max_msgs=1
                    )
                    off += used
                    if not msgs:
                        break
                    self._on_message(msgs[0])
                if off:
                    del buf[:off]
        except (OSError, ParseError):
            pass
        finally:
            self._closed = True
            with self._results_cv:
                self._results_cv.notify_all()

    def _on_message(self, msg: RtmpMessage) -> None:
        t = msg.type_id
        if t == MSG_SET_CHUNK_SIZE and len(msg.payload) >= 4:
            size = struct.unpack_from(">I", msg.payload)[0] & 0x7FFFFFFF
            if size:
                self._reader.chunk_size = size
        elif t == MSG_COMMAND_AMF0:
            try:
                values = amf0.decode_all(msg.payload)
            except ParseError:
                return
            if not values:
                return
            name = values[0]
            if name in ("_result", "_error"):
                tid = values[1] if len(values) > 1 else 0.0
                with self._results_cv:
                    self._results[tid] = (name == "_result", values[2:])
                    self._results_cv.notify_all()
            elif name == "onStatus":
                info = values[3] if len(values) > 3 else {}
                stream = self._streams.get(msg.msg_stream_id)
                if stream is not None and isinstance(info, dict):
                    stream._on_status(info)
        elif t in (MSG_AUDIO, MSG_VIDEO, MSG_DATA_AMF0):
            stream = self._streams.get(msg.msg_stream_id)
            if stream is not None and stream.on_media is not None:
                try:
                    stream.on_media(msg)
                except Exception:
                    logger.exception("on_media callback raised")

    # -- public ------------------------------------------------------------

    def create_stream(self, timeout: float = 5.0) -> RtmpClientStream:
        tid = self._alloc_tid()
        self._send_command(0, "createStream", tid, None)
        result = self._wait_result(tid, timeout)
        if result is None:
            raise TimeoutError("createStream timed out")
        ok, values = result
        if not ok or not values:
            raise ConnectionError(f"createStream refused: {values}")
        msid = int(values[-1])
        stream = RtmpClientStream(self, msid)
        self._streams[msid] = stream
        return stream

    def close(self) -> None:
        self._closed = True
        try:
            # shutdown wakes the reader's recv; close alone does not
            self._sock.shutdown(pysocket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        t = self._rthread
        if t is not None and t is not threading.current_thread():
            t.join(10.0)
