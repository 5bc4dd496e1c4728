"""CRC32C (Castagnoli) on the port's native host runtime.

``crc32c`` runs ``tb_crc32c`` of ``csrc/host/tbutil`` (SSE4.2 where the CPU
has it). ``crc32c_plain`` is its plain twin, the JAX package's table loop
(``native.py`` ``_crc32c_py``) in pure Python; ``crc32c`` falls back to it
when the library did not build. Both chain zlib-style: pass the previous
return value as ``seed``.
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


def crc32c_plain(data, seed: int = 0) -> int:
    """CRC32C of ``data`` (any bytes-like), continuing from ``seed``, one
    table lookup a byte in Python."""
    crc = ~seed & 0xFFFFFFFF
    tab = _table()
    for byte in bytes(data):
        crc = tab[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return ~crc & 0xFFFFFFFF


def crc32c(data, seed: int = 0) -> int:
    """CRC32C of ``data`` (any bytes-like), continuing from ``seed``."""
    from incubator_brpc_tpu_torch import native

    return native.crc32c(data, seed)
