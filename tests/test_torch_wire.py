"""The port's wire layer against the JAX package's, byte for byte: tbus_std
frames (packed by each side, parsed by the other, with and without the
body-checksum bit), CRC32C, the four codecs (gzip, zlib, zlib1, snappy),
and the port's IOBuf on the cases of tests/test_iobuf.py
``TestIOBufSemantics``. Inputs come from numpy seeds; every comparison is
bitwise (no tolerance)."""

import errno
import os
import socket

import numpy as np
import pytest

from incubator_brpc_tpu import native as jax_native
from incubator_brpc_tpu.protocol import compress as jax_compress
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu.utils.flags import set_flag_unchecked as jax_set_flag
from incubator_brpc_tpu_torch.iobuf import IOBuf
from incubator_brpc_tpu_torch.protocol import compress as port_compress
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.utils.crc32c import crc32c
from incubator_brpc_tpu_torch.utils.flags import set_flag_unchecked as port_set_flag


def _bytes(rng, n):
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


def _meta_kwargs(rng):
    return dict(
        service=f"svc{int(rng.integers(0, 100))}",
        method=f"m{int(rng.integers(0, 100))}",
        compress=["", "gzip", "snappy"][int(rng.integers(0, 3))],
        timeout_ms=int(rng.integers(0, 5000)),
        log_id=int(rng.integers(0, 1 << 40)),
        error_text=["", "deliberate"][int(rng.integers(0, 2))],
        extra={"k": int(rng.integers(0, 9))} if rng.integers(0, 2) else {},
    )


FRAME_CASES = [
    # (seed, has meta, payload bytes, attachment bytes, flags, error code)
    (0, True, 0, 0, 0, 0),
    (1, True, 11, 0, 0, 0),
    (2, True, 256, 7, 0, 0),
    (3, False, 4096, 0, port_tbus.FLAG_RESPONSE, 0),
    (4, True, 32 * 1024, 1000, port_tbus.FLAG_RESPONSE, 1002),
    (5, False, 0, 0, port_tbus.FLAG_RESPONSE, 2001),
    (6, True, 65, 3, port_tbus.FLAG_BODY_CRC, 0),
]


@pytest.fixture(params=[False, True], ids=["meta-crc", "body-crc"])
def body_crc(request):
    """The ``tbus_body_crc`` flag, set alike in both packages."""
    jax_set_flag("tbus_body_crc", request.param)
    port_set_flag("tbus_body_crc", request.param)
    yield request.param
    jax_set_flag("tbus_body_crc", False)
    port_set_flag("tbus_body_crc", False)


def _frame_inputs(seed, has_meta, n_payload, n_att, flags, err):
    rng = np.random.default_rng(seed)
    kw = _meta_kwargs(rng) if has_meta else None
    payload = _bytes(rng, n_payload)
    attachment = _bytes(rng, n_att)
    cid = int(rng.integers(0, 1 << 63))
    return kw, payload, attachment, cid, flags, err


@pytest.mark.parametrize("case", FRAME_CASES)
def test_pack_frame_is_bitwise_the_jax_packages(case, body_crc):
    kw, payload, attachment, cid, flags, err = _frame_inputs(*case)
    want = jax_tbus.pack_frame(
        jax_tbus.Meta(**kw) if kw is not None else None,
        payload, cid, flags=flags, error_code=err, attachment=attachment,
    )
    got = port_tbus.pack_frame(
        port_tbus.Meta(**kw) if kw is not None else None,
        payload, cid, flags=flags, error_code=err, attachment=attachment,
    )
    assert got == want
    iob = port_tbus.pack_frame_iobuf(
        port_tbus.Meta(**kw) if kw is not None else None,
        payload, cid, flags=flags, error_code=err, attachment=attachment,
    )
    assert iob.to_bytes() == want
    hdr_flags = int.from_bytes(got[8:12], "little")
    assert bool(hdr_flags & port_tbus.FLAG_BODY_CRC) == (body_crc or bool(flags & port_tbus.FLAG_BODY_CRC))


def _same_frame(a, b):
    assert (a.correlation_id, a.flags, a.error_code) == (b.correlation_id, b.flags, b.error_code)
    assert a.payload == b.payload and a.attachment == b.attachment
    assert a.meta.to_bytes() == b.meta.to_bytes()


@pytest.mark.parametrize("case", FRAME_CASES)
def test_each_side_parses_the_others_frames(case, body_crc):
    kw, payload, attachment, cid, flags, err = _frame_inputs(*case)
    jax_wire = jax_tbus.pack_frame(
        jax_tbus.Meta(**kw) if kw is not None else None,
        payload, cid, flags=flags, error_code=err, attachment=attachment,
    )
    port_wire = port_tbus.pack_frame(
        port_tbus.Meta(**kw) if kw is not None else None,
        payload, cid, flags=flags, error_code=err, attachment=attachment,
    )
    tail = b"\x00\x01"  # bytes of a next frame stay unconsumed
    p_of_j, n1 = port_tbus.try_parse_frame(jax_wire + tail)
    j_of_p, n2 = jax_tbus.try_parse_frame(port_wire + tail)
    j_of_j, _ = jax_tbus.try_parse_frame(jax_wire)
    assert n1 == n2 == len(jax_wire)
    assert port_tbus.parse_header(jax_wire[:32]) == jax_tbus.parse_header(port_wire[:32]) == n1
    _same_frame(p_of_j, j_of_j)
    _same_frame(j_of_p, j_of_j)
    assert p_of_j.payload == payload and p_of_j.attachment == attachment
    # a partial frame asks for more bytes on both sides
    assert port_tbus.try_parse_frame(jax_wire[:-1]) == (None, 0)


def test_both_sides_refuse_the_same_corruption():
    wire = bytearray(port_tbus.pack_frame(port_tbus.Meta(service="a", method="b"), b"xy", 9))
    wire[40] ^= 0x20  # inside the meta: the crc no longer matches
    with pytest.raises(port_tbus.ParseError, match="crc mismatch"):
        port_tbus.try_parse_frame(bytes(wire))
    with pytest.raises(jax_tbus.ParseError, match="crc mismatch"):
        jax_tbus.try_parse_frame(bytes(wire))
    with pytest.raises(port_tbus.ParseError, match="bad magic"):
        port_tbus.parse_header(b"XXXXXXXX")


@pytest.mark.parametrize("seed", range(6))
def test_crc32c_equals_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 7, 64, 1000, int(rng.integers(1, 70_000))):
        data = _bytes(rng, n)
        s = int(rng.integers(0, 1 << 32))
        assert crc32c(data) == jax_native.crc32c(data)
        assert crc32c(data, s) == jax_native.crc32c(data, s)
    # chaining: the crc of a concatenation continues from the first part's
    a, b = _bytes(rng, 300), _bytes(rng, 500)
    assert crc32c(b, crc32c(a)) == crc32c(a + b) == jax_native.crc32c(a + b)


def test_crc32c_known_value():
    assert crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def _codec_inputs(seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 16, size=4000, dtype=np.uint32)
    return [
        b"",
        b"a",
        b"abc",
        _bytes(rng, 1000),  # incompressible
        b"Z" * 50_000,
        words.tobytes(),  # small alphabet, long matches
        bytes(range(256)) * 300,
        _bytes(rng, 70_000) + b"\x00" * 70_000,  # past snappy's 64 KiB window
    ]


@pytest.mark.parametrize("codec", ["gzip", "zlib", "zlib1", "snappy"])
@pytest.mark.parametrize("seed", [0, 1])
def test_codecs_agree_byte_for_byte(codec, seed):
    for data in _codec_inputs(seed):
        packed = port_compress.compress(codec, data)
        assert packed == jax_compress.compress(codec, data), (codec, len(data))
        assert port_compress.decompress(codec, packed) == data
        assert jax_compress.decompress(codec, packed) == data


def test_codecs_refuse_alike():
    with pytest.raises(ValueError, match="unknown compression codec"):
        port_compress.compress("lz4", b"x")
    bomb = port_compress.compress("zlib", b"\x00" * 100_000)
    port_set_flag("max_decompress_bytes", 1000)
    try:
        with pytest.raises(ValueError, match="max_decompress_bytes"):
            port_compress.decompress("zlib", bomb)
        with pytest.raises(ValueError, match="max_decompress_bytes"):
            port_compress.decompress("snappy", port_compress.compress("snappy", b"\x00" * 5000))
    finally:
        port_set_flag("max_decompress_bytes", 256 * 1024 * 1024)


# -- the port's IOBuf on the cases of tests/test_iobuf.py TestIOBufSemantics --


class TestIOBufSemantics:
    def test_append_roundtrip(self):
        b = IOBuf()
        b.append(b"hello ")
        b.append(b"world")
        assert len(b) == 11
        assert b.to_bytes() == b"hello world"

    def test_large_append_spans_blocks(self):
        b = IOBuf()
        data = os.urandom(50_000)
        b.append(data)
        assert len(b) == len(data)
        assert b.to_bytes() == data

    def test_cutn_moves_bytes(self):
        b = IOBuf()
        b.append(b"abcdefghij")
        head = b.cutn(4)
        assert head.to_bytes() == b"abcd"
        assert b.to_bytes() == b"efghij"
        assert len(b) == 6

    def test_cut_more_than_size(self):
        b = IOBuf()
        b.append(b"xy")
        out = b.cutn(10)
        assert out.to_bytes() == b"xy"
        assert len(b) == 0

    def test_share_bumps_refcount_no_copy(self):
        a = IOBuf()
        a.append(b"shared-bytes")
        c = IOBuf()
        c.append_iobuf(a)
        assert c.to_bytes() == b"shared-bytes"
        assert a.to_bytes() == b"shared-bytes"
        assert a.block_shared_count(0) == 2
        c.clear()
        assert a.block_shared_count(0) == 1

    def test_partial_cut_shares_block(self):
        a = IOBuf()
        a.append(b"0123456789")
        head = a.cutn(3)
        assert head.block_shared_count(0) == 2
        assert a.block_shared_count(0) == 2
        assert head.to_bytes() == b"012"
        assert a.to_bytes() == b"3456789"

    def test_popn(self):
        b = IOBuf()
        b.append(b"0123456789")
        assert b.popn(4) == 4
        assert b.to_bytes() == b"456789"
        assert b.popn(100) == 6
        assert len(b) == 0

    def test_copy_to_with_pos(self):
        b = IOBuf()
        b.append(b"0123")
        b.append(b"4567")
        assert b.to_bytes(4, pos=2) == b"2345"
        assert len(b) == 8  # non-consuming

    def test_external_release_after_last_ref(self):
        released = []
        buf = bytearray(b"external-payload")
        a = IOBuf()
        a.append_external(buf, release_cb=lambda o: released.append(o))
        c = IOBuf()
        c.append_iobuf(a)
        a.clear()
        assert released == []  # c still holds a ref
        c.clear()
        assert len(released) == 1
        assert released[0] is buf

    def test_external_zero_copy_read(self):
        buf = bytearray(b"zcview")
        a = IOBuf()
        a.append_external(buf)
        assert a.to_bytes() == b"zcview"
        assert b"".join(bytes(v) for v in a.views()) == b"zcview"
        a.clear()

    def test_views_concat_equals_bytes(self):
        b = IOBuf()
        b.append(b"abc")
        b.append(os.urandom(20_000))
        total = b.to_bytes()
        assert b"".join(bytes(v) for v in b.views()) == total

    def test_append_after_cut_does_not_corrupt_shared_tail(self):
        a = IOBuf()
        a.append(b"AAAA")
        c = IOBuf()
        c.append_iobuf(a)
        a.append(b"BBBB")
        assert c.to_bytes() == b"AAAA"
        assert a.to_bytes() == b"AAAABBBB"

    def test_fd_roundtrip(self):
        s1, s2 = socket.socketpair()
        try:
            out = IOBuf()
            payload = os.urandom(100_000)
            out.append(payload)
            received = IOBuf()
            while len(out) > 0:
                nw = out.cut_into_fd(s1.fileno())
                assert nw > 0
                while True:
                    nr = received.append_from_fd(s2.fileno(), 1 << 20)
                    if nr <= 0 or len(received) >= len(payload) - len(out):
                        break
            while len(received) < len(payload):
                nr = received.append_from_fd(s2.fileno(), 1 << 20)
                assert nr > 0
            assert received.to_bytes() == payload
        finally:
            s1.close()
            s2.close()

    def test_fd_eagain(self):
        s1, s2 = socket.socketpair()
        try:
            s2.setblocking(False)
            got = IOBuf()
            rc = got.append_from_fd(s2.fileno())
            assert rc == -errno.EAGAIN or rc == -errno.EWOULDBLOCK
        finally:
            s1.close()
            s2.close()
