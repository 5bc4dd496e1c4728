"""Compression codec registry (reference src/brpc/compress.{h,cpp}; handlers
registered in global.cpp:342-354 for COMPRESS_TYPE_{GZIP,ZLIB,SNAPPY}).

Codecs are named strings carried in Meta.compress; both sides look the name
up here. A name always identifies exactly one algorithm.

Two disciplines this registry enforces for the whole stack:

- **Determinism + byte-identity with the JAX package.**  gzip pins
  ``mtime=0`` (a wall-clock mtime would make even two compressions of the
  same bytes differ), and "snappy" is the portable block-format encoder
  in protocol/snappy_codec.py, whose greedy parse the JAX package's C++
  and Python encoders both make — NOT python-snappy, whose C encoder
  makes different (legal) parse choices.

- **A decompressed-size ceiling on every codec** (``max_decompress_bytes``
  flag): a 100-byte bomb must not expand unbounded into server memory.
  gzip/zlib decompress through a bounded decompressobj loop; snappy
  rejects on its length preamble before any expansion.

The port's copy of the JAX package's ``protocol/compress.py``: snappy
runs through the native codec seam (``tb_codec_compress`` /
``tb_codec_decompress`` of the port's host runtime, the table its native
server plane runs) when the library loaded, and through its plain version
``protocol/snappy_codec.py`` otherwise; both make the same parse choices.
"""

from __future__ import annotations

import zlib as _zlib
from typing import Callable, Dict, Tuple

from incubator_brpc_tpu_torch.protocol import snappy_codec as _snappy

_codecs: Dict[str, Tuple[Callable[[bytes], bytes], Callable[[bytes], bytes]]] = {}


def register_codec(
    name: str,
    compress: Callable[[bytes], bytes],
    decompress: Callable[[bytes], bytes],
) -> None:
    if name in _codecs:
        raise ValueError(f"codec {name!r} already registered")
    _codecs[name] = (compress, decompress)


def has_codec(name: str) -> bool:
    return name in _codecs


def compress(name: str, data: bytes) -> bytes:
    if not name:
        return data
    try:
        c, _ = _codecs[name]
    except KeyError:
        raise ValueError(f"unknown compression codec {name!r}") from None
    return c(data)


def decompress(name: str, data: bytes) -> bytes:
    if not name:
        return data
    try:
        _, d = _codecs[name]
    except KeyError:
        raise ValueError(f"unknown compression codec {name!r}") from None
    return d(data)


def max_decompress_bytes() -> int:
    """The decompress ceiling (0 = unlimited), read per call so tests and
    operators can retune it at runtime."""
    from incubator_brpc_tpu_torch.utils.flags import get_flag

    return int(get_flag("max_decompress_bytes"))


def _bounded_inflate(data: bytes, wbits: int) -> bytes:
    """zlib-family decompress that never expands past the ceiling: the
    decompressobj is fed with max_length so output growth stops AT the
    bound instead of after the allocation.  One member, no trailing
    garbage (the JAX package's native plane applies the same rules)."""
    limit = max_decompress_bytes()
    obj = _zlib.decompressobj(wbits)
    out = bytearray()
    chunk = data
    while True:
        budget = (limit - len(out) + 1) if limit else 0
        out += obj.decompress(chunk, budget) if limit else obj.decompress(chunk)
        if limit and len(out) > limit:
            raise ValueError(
                f"decompressed size exceeds max_decompress_bytes ({limit})"
            )
        if obj.eof:
            if obj.unused_data:
                raise ValueError("trailing garbage after compressed stream")
            return bytes(out)
        chunk = obj.unconsumed_tail
        if not chunk:
            raise ValueError("truncated compressed stream")


# deterministic gzip container: fixed header (mtime=0, XFL=0, OS=255 —
# the bytes CPython's gzip.compress(data, 6, mtime=0) emits), raw deflate
# level 6, CRC32 + ISIZE trailer.  Built by hand so the bytes are pinned
# by THIS code, not by gzip-module internals that may drift.
_GZIP_HEADER = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff"


def _gzip_compress(data: bytes) -> bytes:
    obj = _zlib.compressobj(6, _zlib.DEFLATED, -15, 8, 0)
    body = obj.compress(data) + obj.flush()
    crc = _zlib.crc32(data) & 0xFFFFFFFF
    isize = len(data) & 0xFFFFFFFF
    return (
        _GZIP_HEADER
        + body
        + crc.to_bytes(4, "little")
        + isize.to_bytes(4, "little")
    )


def _native_codec_lib():
    """The host runtime's tb_codec_* surface when it loaded (None
    otherwise): the same C++ codec table the native server plane runs, so
    the planes stay byte-identical."""
    from incubator_brpc_tpu_torch import native

    return native.LIB


_SNAPPY_WIRE = 1  # options.proto CompressType SNAPPY


def _snappy_compress(data: bytes) -> bytes:
    lib = _native_codec_lib()
    if lib is None:
        return _snappy.compress(data)
    from incubator_brpc_tpu_torch.iobuf import IOBuf

    out = IOBuf()
    data = bytes(data)
    rc = lib.tb_codec_compress(_SNAPPY_WIRE, data, len(data), out._h)
    if rc < 0:  # cannot happen for snappy compress; fail loudly anyway
        raise ValueError(f"native snappy compress failed ({rc})")
    return out.to_bytes()


def _snappy_decompress(data: bytes) -> bytes:
    limit = max_decompress_bytes()
    lib = _native_codec_lib()
    if lib is None:
        return _snappy.decompress(data, max_out=limit)
    from incubator_brpc_tpu_torch.iobuf import IOBuf

    out = IOBuf()
    data = bytes(data)
    rc = lib.tb_codec_decompress(_SNAPPY_WIRE, data, len(data), limit, out._h)
    if rc == -2:
        raise ValueError(f"decompressed size exceeds max_decompress_bytes ({limit})")
    if rc < 0:
        # the native plane's reject text, so both planes read alike
        raise ValueError("corrupt snappy body")
    return out.to_bytes()


register_codec("gzip", _gzip_compress, lambda b: _bounded_inflate(b, 16 + 15))
register_codec(
    "zlib", lambda b: _zlib.compress(b, 6), lambda b: _bounded_inflate(b, 15)
)
# "zlib1" is the cheap/fast zlib variant (wire CompressType ZLIB).
register_codec(
    "zlib1", lambda b: _zlib.compress(b, 1), lambda b: _bounded_inflate(b, 15)
)
# snappy: the native codec seam, or the portable block codec
# (snappy_codec.py) without the library; the parse choices are the same.
register_codec("snappy", _snappy_compress, _snappy_decompress)
