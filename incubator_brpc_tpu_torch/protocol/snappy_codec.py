"""Portable snappy block-format codec — the port's copy of the JAX
package's ``protocol/snappy_codec.py``, itself the Python twin of the
encoder in src/tbnet/tbnet.cc.

Both encoders run the IDENTICAL greedy parse (same hash function, same
table sizing, same skip schedule, same literal/copy emit rules), so the
two planes, and this port, produce byte-for-byte equal compressed output
for the same input. Any standard snappy decoder reads this output, and this
decoder reads any standard snappy stream (the format is fixed; only encoder
*choices* vary between implementations, and here they are pinned).

Format (google/snappy format_description.txt): a varint uncompressed
length preamble, then a sequence of elements — literals (tag 00) and
back-references (tag 01 = 1-byte offset, 10 = 2-byte offset, 11 = 4-byte
offset; this encoder never needs 11 because candidate matches are limited
to a 64 KiB window).

Kept deliberately dependency-free: python-snappy's C encoder makes
different (legal) parse choices, so linking it would break byte-identity
with the JAX package.
"""

from __future__ import annotations

_HASH_MUL = 0x1E35A7BD
_MAX_TABLE = 1 << 14
_U32 = 0xFFFFFFFF


def _emit_literal(out: bytearray, data, start: int, end: int) -> None:
    n = end - start
    if n == 0:
        return
    n1 = n - 1
    if n1 < 60:
        out.append(n1 << 2)
    elif n1 < 0x100:
        out.append(60 << 2)
        out.append(n1)
    elif n1 < 0x10000:
        out.append(61 << 2)
        out.append(n1 & 0xFF)
        out.append((n1 >> 8) & 0xFF)
    elif n1 < 0x1000000:
        out.append(62 << 2)
        out.append(n1 & 0xFF)
        out.append((n1 >> 8) & 0xFF)
        out.append((n1 >> 16) & 0xFF)
    else:
        out.append(63 << 2)
        out.append(n1 & 0xFF)
        out.append((n1 >> 8) & 0xFF)
        out.append((n1 >> 16) & 0xFF)
        out.append((n1 >> 24) & 0xFF)
    out += data[start:end]


def _emit_copy2(out: bytearray, off: int, length: int) -> None:
    out.append((((length - 1) << 2) | 2) & 0xFF)
    out.append(off & 0xFF)
    out.append((off >> 8) & 0xFF)


def _emit_copy(out: bytearray, off: int, length: int) -> None:
    # the standard 60/64 split keeps every tail element >= 4 long
    while length >= 68:
        _emit_copy2(out, off, 64)
        length -= 64
    if length > 64:
        _emit_copy2(out, off, 60)
        length -= 60
    if length >= 12 or off >= 2048:
        _emit_copy2(out, off, length)
    else:
        out.append((((off >> 8) << 5) | ((length - 4) << 2) | 1) & 0xFF)
        out.append(off & 0xFF)


def _put_uvarint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def compress(data: bytes) -> bytes:
    data = bytes(data)
    n = len(data)
    out = bytearray()
    _put_uvarint(out, n)
    if n == 0:
        return bytes(out)
    if n < 4:
        _emit_literal(out, data, 0, n)
        return bytes(out)
    ts = 256
    shift = 24  # 32 - log2(ts)
    while ts < _MAX_TABLE and ts < n:
        ts <<= 1
        shift -= 1
    table = [-1] * ts
    i = 0
    lit = 0
    skip = 32
    while i + 4 <= n:
        seq = int.from_bytes(data[i : i + 4], "little")
        h = ((seq * _HASH_MUL) & _U32) >> shift
        cand = table[h]
        table[h] = i
        if (
            cand >= 0
            and i - cand <= 0xFFFF
            and data[cand : cand + 4] == data[i : i + 4]
        ):
            _emit_literal(out, data, lit, i)
            m = 4
            while i + m < n and data[cand + m] == data[i + m]:
                m += 1
            _emit_copy(out, i - cand, m)
            i += m
            lit = i
            skip = 32
        else:
            i += skip >> 5
            skip += 1
    _emit_literal(out, data, lit, n)
    return bytes(out)


def decompress(data: bytes, max_out: int = 0) -> bytes:
    """Decode one snappy block.  ``max_out`` > 0 rejects streams whose
    claimed uncompressed length exceeds it (the decompress-bomb ceiling)
    BEFORE any expansion happens."""
    data = bytes(data)
    n = len(data)
    # varint preamble
    ulen = 0
    shift = 0
    off = 0
    while True:
        if off >= n or shift > 63:
            raise ValueError("truncated snappy length preamble")
        b = data[off]
        off += 1
        ulen |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    if max_out and ulen > max_out:
        raise ValueError(
            f"decompressed size exceeds max_decompress_bytes ({max_out})"
        )
    out = bytearray()
    while off < n:
        tag = data[off]
        off += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                nb = length - 60  # 1..4 length bytes
                if off + nb > n:
                    raise ValueError("truncated snappy literal length")
                length = int.from_bytes(data[off : off + nb], "little") + 1
                off += nb
            if off + length > n or len(out) + length > ulen:
                raise ValueError("corrupt snappy literal")
            out += data[off : off + length]
            off += length
        else:  # copy
            if kind == 1:
                if off >= n:
                    raise ValueError("truncated snappy copy")
                length = ((tag >> 2) & 7) + 4
                cop = ((tag >> 5) << 8) | data[off]
                off += 1
            elif kind == 2:
                if off + 2 > n:
                    raise ValueError("truncated snappy copy")
                length = (tag >> 2) + 1
                cop = int.from_bytes(data[off : off + 2], "little")
                off += 2
            else:
                if off + 4 > n:
                    raise ValueError("truncated snappy copy")
                length = (tag >> 2) + 1
                cop = int.from_bytes(data[off : off + 4], "little")
                off += 4
            if cop == 0 or cop > len(out) or len(out) + length > ulen:
                raise ValueError("corrupt snappy copy")
            start = len(out) - cop
            if cop >= length:
                out += out[start : start + length]
            else:  # overlapping copy: byte-at-a-time RLE semantics
                for k in range(length):
                    out.append(out[start + k])
    if len(out) != ulen:
        raise ValueError("snappy stream shorter than its claimed length")
    return bytes(out)
