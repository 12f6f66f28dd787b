"""Host checksums: adler32 (RFC 1950) and crc32 (gzip/PNG side uses).

New capability relative to the reference, which contains no checksum code
at all (SURVEY §2.1: "the zlib adler32 trailer is never verified").  These
are vectorised NumPy implementations used by the host engine and tests;
``defl_jax.ops.checksums`` provides the batched on-device versions.
"""

from __future__ import annotations

import numpy as np

ADLER_MOD = 65521
# Largest n such that 255*n*(n+1)/2 + (n+1)*(MOD-1) fits in uint32 — the
# classic zlib NMAX bound for deferring the modulo.
_NMAX = 5552


def adler32(data, start: int = 1) -> int:
    """Vectorised adler32.

    a = 1 + sum(bytes) mod 65521;  b = sum of running a values mod 65521.
    For a block, b advances by n*a0 + sum((n-i)*d_i), computed as a
    weighted dot product per chunk with deferred modulo.
    """
    buf = np.frombuffer(bytes(data), dtype=np.uint8).astype(np.uint64)
    a = np.uint64(start & 0xFFFF)
    b = np.uint64((start >> 16) & 0xFFFF)
    n = buf.size
    for s in range(0, n, _NMAX):
        chunk = buf[s : s + _NMAX]
        m = chunk.size
        w = np.arange(m, 0, -1, dtype=np.uint64)
        b = (b + a * np.uint64(m) + np.dot(chunk, w)) % ADLER_MOD
        a = (a + chunk.sum()) % ADLER_MOD
    return int((b << np.uint64(16)) | a)


_CRC_POLY = 0xEDB88320


def _make_crc_table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_CRC_POLY if c & 1 else 0)
        t[i] = c
    return t


_CRC_TABLE = _make_crc_table()

# Slice-by-8 tables: T[k][b] = crc of byte b followed by k zero bytes.
_CRC_TABLES = np.zeros((8, 256), dtype=np.uint32)
_CRC_TABLES[0] = _CRC_TABLE
for _k in range(1, 8):
    _CRC_TABLES[_k] = _CRC_TABLE[_CRC_TABLES[_k - 1] & 0xFF] ^ (
        _CRC_TABLES[_k - 1] >> 8
    )


def crc32(data, start: int = 0) -> int:
    """Slice-by-8 crc32 (IEEE 802.3 polynomial, reflected)."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    crc = np.uint32(~start & 0xFFFFFFFF)
    n = buf.size
    head = n % 8
    t = _CRC_TABLES
    for i in range(head):
        crc = t[0][(crc ^ buf[i]) & 0xFF] ^ (crc >> np.uint32(8))
    body = buf[head:].reshape(-1, 8) if n - head else np.zeros((0, 8), np.uint8)
    for row in body:
        x = crc ^ (
            np.uint32(row[0])
            | (np.uint32(row[1]) << np.uint32(8))
            | (np.uint32(row[2]) << np.uint32(16))
            | (np.uint32(row[3]) << np.uint32(24))
        )
        crc = (
            t[7][x & 0xFF]
            ^ t[6][(x >> np.uint32(8)) & 0xFF]
            ^ t[5][(x >> np.uint32(16)) & 0xFF]
            ^ t[4][(x >> np.uint32(24)) & 0xFF]
            ^ t[3][row[4]]
            ^ t[2][row[5]]
            ^ t[1][row[6]]
            ^ t[0][row[7]]
        )
    return int(~crc & 0xFFFFFFFF)
