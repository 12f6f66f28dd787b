"""PNG IDAT decode — the reference's marquee use case (README.md:120-155
there): decompress a PNG's image data straight from its non-contiguous
IDAT chunks without joining them.

Builds a PNG in-memory (stdlib only), splits its zlib stream across many
IDAT chunks (PNG encoders routinely emit 8KB or even 1-byte chunks), then
decodes three ways and cross-checks:
  1. host InflateStream with one include() per IDAT chunk,
  2. the batched device decoder fed the chunk list directly,
  3. CPython zlib on the joined stream (the oracle).

Run: python examples/png_idat.py
"""

import struct
import sys
import zlib

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from defl_jax import InflateStream, Result, inflate_batch


def make_png(width=64, height=48, idat_chunk_size=913):
    """A minimal truecolor PNG with the zlib stream split across IDATs."""
    raw = bytearray()
    for y in range(height):
        raw.append(0)  # filter: None
        for x in range(width):
            raw += bytes(((x * 5 + y) & 0xFF for _ in (0,)))
            raw += bytes(((x ^ y) & 0xFF, (x * y) & 0xFF))
    compressed = zlib.compress(bytes(raw), 6)

    def chunk(typ, data):
        c = struct.pack(">I", len(data)) + typ + data
        return c + struct.pack(">I", zlib.crc32(typ + data))

    png = b"\x89PNG\r\n\x1a\n"
    png += chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2,
                                      0, 0, 0))
    for i in range(0, len(compressed), idat_chunk_size):
        png += chunk(b"IDAT", compressed[i : i + idat_chunk_size])
    png += chunk(b"IEND", b"")
    return png, bytes(raw)


def iter_idat(png: bytes):
    pos = 8
    while pos < len(png):
        (ln,) = struct.unpack(">I", png[pos : pos + 4])
        typ = png[pos + 4 : pos + 8]
        if typ == b"IDAT":
            yield png[pos + 8 : pos + 8 + ln]
        pos += 12 + ln


def main():
    png, expected = make_png()
    idats = list(iter_idat(png))
    print(f"PNG: {len(png)} bytes, {len(idats)} IDAT chunks, "
          f"{len(expected)} bytes of scanline data")

    # 1. host stream, one include per chunk (≙ infl_include / infl)
    st = InflateStream(len(expected) + 64)
    for c in idats:
        assert st.include(c) is Result.OK
    assert st.run() is Result.OK
    assert st.output == expected
    print("host chunked decode: OK")

    # 2. device batch path fed the raw chunk list
    res, outs = inflate_batch([idats], backend="device",
                              dst_capacities=len(expected) + 64)
    assert res[0] is Result.OK and outs[0] == expected
    print("device chunked decode: OK")

    # 3. oracle cross-check
    assert zlib.decompress(b"".join(idats)) == expected
    print("zlib cross-check: OK")


if __name__ == "__main__":
    main()
