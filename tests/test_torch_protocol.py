"""tbus_std conformance of the port against the JAX package: the 12 cases of
tests/test_protocol.py, each run on both packages through the ``pkg``
fixture (the reference suite's shape, test/brpc_baidu_rpc_protocol_unittest:
parse and pack handlers called directly on hand-built buffers).

``tests/test_torch_wire.py`` already holds the two packages' frames
bitwise equal and their refusals of corrupt frames alike; these cases pin
the semantic contract each package keeps on its own: the resumable parse,
the per-frame attachment size, the meta's elided defaults, 64-bit
correlation ids, the response flag, and the native IOBuf cut against the
bytes path. Tolerance: none, everything here is bytes."""

import types
from dataclasses import replace

import pytest

import incubator_brpc_tpu.iobuf as jax_iobuf
import incubator_brpc_tpu.native as jax_native
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu.utils import flags as jax_flags
import incubator_brpc_tpu_torch.iobuf as port_iobuf
import incubator_brpc_tpu_torch.native as port_native
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.utils import flags as port_flags

PKGS = {
    "jax": types.SimpleNamespace(name="jax", tbus=jax_tbus, flags=jax_flags,
                                 IOBuf=jax_iobuf.IOBuf, native=jax_native),
    "torch": types.SimpleNamespace(name="torch", tbus=port_tbus, flags=port_flags,
                                   IOBuf=port_iobuf.IOBuf, native=port_native),
}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


def test_roundtrip_basic(pkg):
    t = pkg.tbus
    meta = t.Meta(service="Echo", method="echo", log_id=7)
    wire = t.pack_frame(meta, b"hello", correlation_id=42)
    frame, consumed = t.try_parse_frame(wire)
    assert consumed == len(wire)
    assert frame.payload == b"hello"
    assert frame.attachment == b""
    assert frame.correlation_id == 42
    assert frame.meta.service == "Echo"
    assert frame.meta.method == "echo"
    assert frame.meta.log_id == 7
    assert not frame.is_response


def test_roundtrip_attachment(pkg):
    t = pkg.tbus
    wire = t.pack_frame(t.Meta(service="S", method="m"), b"payload", correlation_id=1,
                        attachment=b"ATTACH")
    frame, _ = t.try_parse_frame(wire)
    assert frame.payload == b"payload"
    assert frame.attachment == b"ATTACH"


def test_pack_does_not_mutate_caller_meta(pkg):
    t = pkg.tbus
    meta = t.Meta(service="S", method="m")
    t.pack_frame(meta, b"p", correlation_id=1, attachment=b"1234")
    assert meta.attachment_size == 0


def test_attachment_size_is_authoritative_per_frame(pkg):
    # a reused Meta whose attachment_size a previous frame set must not
    # carve a phantom attachment out of a frame without one
    t = pkg.tbus
    stale = t.Meta(service="S", method="m", attachment_size=4)
    wire = t.pack_frame(stale, b"payload!", correlation_id=2, attachment=b"")
    frame, _ = t.try_parse_frame(wire)
    assert frame.payload == b"payload!"
    assert frame.attachment == b""


def test_attachment_without_meta_rejected(pkg):
    with pytest.raises(ValueError):
        pkg.tbus.pack_frame(None, b"p", correlation_id=1, attachment=b"x")


def test_resumable_parse_contract(pkg):
    # (None, 0) on short reads at every split point: the InputMessenger
    # CutInputMessage contract (reference input_messenger.cpp:60-129)
    t = pkg.tbus
    wire = t.pack_frame(t.Meta(service="S", method="m"), b"x" * 100, correlation_id=3)
    for cut in (0, 1, t.HEADER_BYTES - 1, t.HEADER_BYTES, len(wire) - 1):
        frame, consumed = t.try_parse_frame(wire[:cut])
        assert frame is None and consumed == 0
    frame, consumed = t.try_parse_frame(wire + b"tail")
    assert frame is not None and consumed == len(wire)


def test_bad_magic_and_crc_raise(pkg):
    t = pkg.tbus
    meta = t.Meta(service="S", method="m")
    with pytest.raises(t.ParseError):
        t.try_parse_frame(b"\x00" * t.HEADER_BYTES)
    # the crc always covers the meta (routing info)
    wire = bytearray(t.pack_frame(meta, b"abc", correlation_id=4))
    wire[t.HEADER_BYTES + 2] ^= 0xFF
    with pytest.raises(t.ParseError):
        t.try_parse_frame(bytes(wire))
    # the payload only under tbus_body_crc
    pkg.flags.set_flag("tbus_body_crc", True)
    try:
        wire = bytearray(t.pack_frame(meta, b"abc", correlation_id=4))
        wire[-1] ^= 0xFF
        with pytest.raises(t.ParseError):
            t.try_parse_frame(bytes(wire))
    finally:
        pkg.flags.set_flag("tbus_body_crc", False)


def test_parse_frame_iobuf_matches_bytes_path(pkg):
    t = pkg.tbus
    assert pkg.native.NATIVE_AVAILABLE, "the host runtime did not build"
    meta = t.Meta(service="S", method="m", log_id=9)
    wire = t.pack_frame(meta, b"pay" * 1000, correlation_id=(7 << 32) | 5,
                        attachment=b"att" * 10)
    ref, ref_consumed = t.try_parse_frame(wire)
    buf = pkg.IOBuf()
    # split across appends so the native cut walks several blocks
    buf.append(wire[:10])
    buf.append(wire[10:200])
    buf.append(wire[200:])
    buf.append(b"nextframe-prefix")
    frame, consumed = t.parse_frame_iobuf(buf)
    assert consumed == ref_consumed
    assert frame.meta.service == "S" and frame.meta.log_id == 9
    assert frame.payload == ref.payload
    assert frame.attachment == ref.attachment
    assert frame.correlation_id == (7 << 32) | 5
    assert len(buf) == len(b"nextframe-prefix")  # only the frame consumed


def test_parse_frame_iobuf_incomplete_and_corrupt(pkg):
    t = pkg.tbus
    assert pkg.native.NATIVE_AVAILABLE, "the host runtime did not build"
    wire = t.pack_frame(t.Meta(service="S", method="m"), b"xyz", correlation_id=1)
    for cut in (1, t.HEADER_BYTES - 1, t.HEADER_BYTES, len(wire) - 1):
        buf = pkg.IOBuf()
        buf.append(wire[:cut])
        assert t.parse_frame_iobuf(buf) == (None, 0)
        assert len(buf) == cut  # nothing consumed on incomplete
    corrupt = bytearray(wire)
    corrupt[t.HEADER_BYTES + 1] ^= 0xFF  # a meta byte: always crc-covered
    buf = pkg.IOBuf()
    buf.append(bytes(corrupt))
    with pytest.raises(t.ParseError):
        t.parse_frame_iobuf(buf)
    buf = pkg.IOBuf()
    buf.append(b"\x00" * t.HEADER_BYTES)
    with pytest.raises(t.ParseError):
        t.parse_frame_iobuf(buf)


def test_response_flag_and_error_code(pkg):
    t = pkg.tbus
    wire = t.pack_frame(t.Meta(error_text="boom"), b"", correlation_id=5,
                        flags=t.FLAG_RESPONSE, error_code=2001)
    frame, _ = t.try_parse_frame(wire)
    assert frame.is_response
    assert frame.error_code == 2001
    assert frame.meta.error_text == "boom"


def test_64bit_correlation_id(pkg):
    t = pkg.tbus
    cid = (123 << 32) | 456
    frame, _ = t.try_parse_frame(t.pack_frame(t.Meta(), b"", correlation_id=cid))
    assert frame.correlation_id == cid


def test_meta_roundtrip_defaults_elided(pkg):
    Meta = pkg.tbus.Meta
    m = Meta(service="S", method="m", extra={"k": 1})
    m2 = Meta.from_bytes(m.to_bytes())
    assert replace(m2, extra={}) == replace(m, extra={})
    assert m2.extra == {"k": 1}
    assert Meta.from_bytes(Meta().to_bytes()) == Meta()
