"""CRC32C (Castagnoli), table-driven, in pure Python.

The port's copy of the JAX package's no-native fallback (``native.py``
``_crc32c_py``): the port has no C++ host runtime yet, so this is its only
CRC32C. zlib-style chaining: pass the previous return value as ``seed``.
It runs a Python loop per byte, so tbus_std covers only the frame meta with
it unless a frame sets the body-checksum bit.
"""

from __future__ import annotations

_TABLE = None


def _table() -> list:
    global _TABLE
    if _TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if c & 1 else c >> 1
            table.append(c)
        _TABLE = table
    return _TABLE


def crc32c(data, seed: int = 0) -> int:
    """CRC32C of ``data`` (any bytes-like), continuing from ``seed``."""
    crc = ~seed & 0xFFFFFFFF
    tab = _table()
    for byte in bytes(data):
        crc = tab[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return ~crc & 0xFFFFFFFF
