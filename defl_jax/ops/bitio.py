"""Vectorised bitstream primitives for the lockstep device decoder.

Device-side equivalent of the reference's REFILL/EXTRACT/CONSUME bit-buffer
layer (`/root/reference/src/infl/apicommon.h:69-129`, `infl.c:1106-1130`) —
but stateless: each lane keeps only an absolute bit cursor; 32-bit windows
at any offset are assembled from adjacent little-endian words, which covers
every DEFLATE read (max field: 15-bit code + 13 extra bits = 28; stored
LEN/NLEN = 32 after byte-align).

Streams are packed host-side (runtime/pack.py) as uint32 words, little
endian, zero-padded: stream bit *i* (LSB-first per RFC 1951 §3.1.1) is bit
``i & 31`` of word ``i >> 5``.

`peek32` is the direct two-word-gather formulation; the XLA decoder
(ops.inflate_batch) instead extracts words through per-chunk windows and
multiplexers, and the GPU kernel (ops/pallas/decode_gpu.py) gathers its
words directly.
"""

from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32
I32 = jnp.int32


def bitrev16(x):
    """Bit-reverse a 16-bit value held in uint32 lanes (5 masked shifts)."""
    x = ((x & U32(0x5555)) << U32(1)) | ((x >> U32(1)) & U32(0x5555))
    x = ((x & U32(0x3333)) << U32(2)) | ((x >> U32(2)) & U32(0x3333))
    x = ((x & U32(0x0F0F)) << U32(4)) | ((x >> U32(4)) & U32(0x0F0F))
    x = ((x & U32(0x00FF)) << U32(8)) | ((x >> U32(8)) & U32(0x00FF))
    return x


def peek32(words, bitpos):
    """32-bit LSB-first window at an arbitrary per-lane bit offset.

    words : uint32 [N, W]  zero-padded packed stream
    bitpos: int32  [N]     absolute bit cursor per lane
    returns uint32 [N]
    """
    widx = (bitpos >> 5).astype(I32)
    b = (bitpos & 31).astype(U32)
    w = jnp.take_along_axis(
        words, jnp.stack([widx, widx + 1], axis=-1), axis=-1, mode="clip"
    )
    w0 = w[:, 0]
    w1 = w[:, 1]
    # (w1 << (32-b)) is undefined for b == 0; select w0 directly there.
    hi = jnp.where(b == 0, U32(0), w1 << ((U32(32) - b) & U32(31)))
    return jnp.where(b == 0, w0, (w0 >> b) | hi)


def mask_bits(n):
    """(1 << n) - 1 for uint32 lanes, valid for n in [0, 31]."""
    return (U32(1) << n.astype(U32)) - U32(1)


def extract(peek, offset, n):
    """n bits of `peek` starting at bit `offset` (both per-lane int32)."""
    return (peek >> offset.astype(U32)) & mask_bits(n)
