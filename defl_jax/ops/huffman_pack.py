"""Device-side Huffman bit-pack: the device half of the hybrid encoder.

The reference declares but never implements compression
(`/root/reference/include/defl/defl.h:17-25`, README TODO).  This
framework's encode splits between host and device the way the decode does:

  host (native/defl_host.cc, `dt_deflate_fields_batch`)
      LZ77 hash-chain matching + per-block Huffman tree construction +
      block layout — emitted as a lane-major array of FIELDS, each a
      ``(value, nbits)`` pair (nbits <= 16, value already bit-reversed
      for LSB-first emission where it is a canonical code).

  device (this module)
      lane-parallel bit concatenation of those fields: an exclusive
      prefix-sum of ``nbits`` gives every field its start bit; each
      field contributes its low part to word ``start >> 5`` and its
      carry-out to the next word; fields occupy disjoint bit ranges, so
      a scatter-ADD assembles words exactly (sum == OR).  This is the
      same two-pass trick the decode side's resolve uses, run in
      reverse.

Byte-identity with the serial C++ encoder is by construction: both
writers consume the identical put() sequence (templated
``deflate_core``/``emit_block``), so tests assert equality of the full
compressed byte string, not just round-trip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32
U32 = jnp.uint32


@jax.jit
def pack_fields_scan(fields, n_fields):
    """Lockstep reservoir pack: the fast device bit-pack.

    The scatter variant below scatters every field; this one advances all N lanes one FIELD per scan step
    through a 64-bit two-word reservoir — the exact mirror of the decode
    kernel's lockstep structure — at fused-elementwise speed.  Each step
    emits one u32 word slot per lane, used iff that lane's reservoir
    crossed 32 bits (the emission schedule is a pure function of the
    nbits sequence, so the host compactor reconstructs word positions
    without a flags plane — dt_encode_compact).

    fields: uint32 [N, F]; n_fields: int32 [N].
    Returns (slots uint32 [N, F], final_lo uint32 [N], total_bits [N]).
    """
    fields = fields.astype(U32)
    N, F = fields.shape
    fields_T = fields.T  # [F, N]: step t slices a row — no gathers
    live_cap = n_fields.astype(I32)

    def step(carry, xs):
        lo, hi, nres, t = carry
        f = xs
        nb = jnp.where(t < live_cap, (f >> U32(16)).astype(I32), 0)
        v = (f & U32(0xFFFF)) & ((U32(1) << nb.astype(U32)) - U32(1))
        s = nres.astype(U32)
        lo = lo | (v << s)
        hi = hi | ((v >> U32(1)) >> (U32(31) - s))
        n2 = nres + nb
        flush = n2 >= 32
        slot = jnp.where(flush, lo, U32(0))
        lo = jnp.where(flush, hi, lo)
        hi = jnp.where(flush, U32(0), hi)
        n2 = jnp.where(flush, n2 - 32, n2)
        return (lo, hi, n2, t + 1), slot

    z = jnp.zeros((N,), U32)
    (lo, _hi, nres, _t), slots = jax.lax.scan(
        step, (z, z, jnp.zeros((N,), I32), jnp.asarray(0, I32)), fields_T)
    nb_all = jnp.where(
        jnp.arange(F, dtype=I32)[None, :] < live_cap[:, None],
        (fields >> U32(16)).astype(I32), 0)
    return slots.T, lo, jnp.sum(nb_all, axis=1)


@functools.partial(jax.jit, static_argnames=("n_words",))
def pack_fields(fields, n_fields, n_words: int):
    """Concatenate per-lane bit fields into packed little-endian words.

    fields: uint32 [N, F], each ``nbits<<16 | value`` (nbits <= 16,
    value < 2**nbits, already LSB-first).  n_fields: int32 [N] live
    prefix per lane.  n_words: static output width (words per lane).

    Returns (words uint32 [N, n_words], total_bits int32 [N]).
    """
    fields = fields.astype(U32)
    nb = (fields >> U32(16)).astype(I32)
    val = fields & U32(0xFFFF)
    F = fields.shape[1]
    live = jnp.arange(F, dtype=I32)[None, :] < n_fields[:, None]
    nb = jnp.where(live, nb, 0)
    ends = jnp.cumsum(nb, axis=1, dtype=I32)
    starts = ends - nb
    total_bits = ends[:, -1]

    s = (starts & 31).astype(U32)
    lo = val << s
    # value bits above the word boundary; (v >> 1) >> (31 - s) is
    # v >> (32 - s) without the undefined s == 0 shift
    hi = (val >> U32(1)) >> (U32(31) - s)
    w = starts >> 5
    lane = jnp.arange(fields.shape[0], dtype=I32)[:, None]
    out = jnp.zeros((fields.shape[0], n_words), U32)
    out = out.at[lane, w].add(jnp.where(live, lo, U32(0)), mode="drop")
    out = out.at[lane, w + 1].add(jnp.where(live, hi, U32(0)), mode="drop")
    return out, total_bits
