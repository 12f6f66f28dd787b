"""Vectorised canonical-Huffman build for the lockstep decoder.

Device-side counterpart of ``core.huffman.build_decode`` and the
reference's table builder (`infl_ft_build`, infl.c:452-578) — but instead
of expanding flat lookup tables (a CPU-cache trick), it produces the
sorted-symbol form the device's *tableless* decode consumes:

    count[N,16], first_code[N,16], offset[N,16], sorted_syms[N,M]

All lanes build in lockstep; `argsort` over (length, symbol) keys gives the
canonical symbol order, and a 15-step cumulative pass gives first codes.
The Kraft oversubscription check (≙ infl.c:485-490) comes out as a per-lane
boolean.  Incomplete trees build fine (decode errors only if an unassigned
code is hit), matching the reference.
"""

from __future__ import annotations

import jax.numpy as jnp

from defl_jax.constants import MAX_CODE_LENGTH

I32 = jnp.int32

# syms-bank layout: one gather array serves all three alphabets.
CL_BASE = 0          # code-length alphabet: 19 symbols (pad 24)
LIT_BASE = 24        # literal/length: up to 288
DIST_BASE_ = 312     # distance: up to 32 (pad 36)
SYMS_BANK = 348      # all bases and widths are multiples of 3: the bank
                     # packs 3 x 10-bit symbols per u32 (SYMS_BANK // 3
                     # words), which makes the per-step one-hot lookup 3x
                     # cheaper (see ops.inflate_batch._canonical_decode)
SYMS_WORDS = SYMS_BANK // 3


def pack_syms(sorted_syms, width):
    """[N, M] int symbols -> [N, width//3] u32, 3 x 10-bit per word."""
    import jax.numpy as jnp

    N, M = sorted_syms.shape
    s = sorted_syms
    if M < width:
        s = jnp.pad(s, ((0, 0), (0, width - M)))
    s3 = s.reshape(N, width // 3, 3).astype(jnp.uint32)
    return s3[:, :, 0] | (s3[:, :, 1] << jnp.uint32(10)) \
        | (s3[:, :, 2] << jnp.uint32(20))


def build_canonical(lengths):
    """lengths: int32 [N, M] per-symbol code lengths (0 = unused).

    Returns (count [N,16], first [N,16], offs [N,16], sorted_syms [N,M],
    oversub [N] bool).  `offs` is local (0-based); callers add their bank
    base.  Entries of sorted_syms past the number of used symbols are
    garbage and never gathered (offs+rank always lands inside).
    """
    N, M = lengths.shape
    lens = lengths.astype(I32)

    counts = [jnp.zeros((N,), I32)]
    for l in range(1, MAX_CODE_LENGTH + 1):
        counts.append(jnp.sum((lens == l).astype(I32), axis=1))
    count = jnp.stack(counts, axis=1)  # [N, 16]

    # Kraft: left_{l} = 2*left_{l-1} - count_l ; negative => oversubscribed
    left = jnp.ones((N,), I32)
    oversub = jnp.zeros((N,), bool)
    firsts = [jnp.zeros((N,), I32)]
    offs_list = [jnp.zeros((N,), I32)]
    code = jnp.zeros((N,), I32)
    off = jnp.zeros((N,), I32)
    for l in range(1, MAX_CODE_LENGTH + 1):
        left = (left << 1) - count[:, l]
        oversub = oversub | (left < 0)
        code = (code + count[:, l - 1]) << 1
        firsts.append(code)
        offs_list.append(off)
        off = off + count[:, l]
    first = jnp.stack(firsts, axis=1)
    offs = jnp.stack(offs_list, axis=1)

    # canonical order: by (length, symbol), zero-length symbols last
    sym_ids = jnp.arange(M, dtype=I32)[None, :]
    key = jnp.where(lens == 0, I32(1 << 24), lens * 512 + sym_ids)
    sorted_syms = jnp.argsort(key, axis=1).astype(I32)

    return count, first, offs, sorted_syms, oversub
