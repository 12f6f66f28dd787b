"""Token-stream → output-bytes resolution (pass 2 of the device inflate).

The reference resolves LZ77 back-references with sequential sliding-window
copies tuned per-CPU (copy ladders, word splats, overrunning stores —
infl.c:269-376).  That is inherently serial per stream.  The device
replacement is fully data-parallel over every output byte of every stream:

  1. token lengths -> output positions by exclusive cumsum,
  2. a scatter-max + cummax pass labels every output byte with its
     covering token,
  3. literals and stored-runs resolve immediately (stored bytes gather
     straight from the packed input words),
  4. match bytes get a *source pointer* ``src[i] = i - dist`` — including
     overlapping matches (dist < len), whose chains the recurrence handles
     naturally — and a logarithmic pointer-doubling loop
     (``val[i] <- val[src[i]]; src[i] <- src[src[i]]``) resolves all
     chains in ceil(log2(max chain)) gather rounds.

A shared preset dictionary (north-star "dict broadcast") occupies a
resolved prefix of the value array; matches may point into it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from defl_jax.ops.bitio import I32, U32
from defl_jax.ops.inflate_batch import (
    TOK_LIT,
    TOK_LIT_PAIR_BIT,
    TOK_MATCH,
    TOK_STORED,
)


@functools.partial(jax.jit, static_argnames=("C", "dict_len"))
def resolve_tokens(tokens, words, dst_len, *, C: int, dict_len: int = 0,
                   dict_words=None, prefix=None):
    """tokens: uint32 [T, N] from decode_tokens;  words: uint32 [N, W]
    packed input;  dst_len: int32 [N] bytes actually produced per lane.

    Returns uint8 [N, C] output (bytes past dst_len are zero).

    `prefix` (uint8 [N, P], exclusive with dict_len) supports incremental
    streaming resolve: each lane's prior window bytes, right-aligned, sit
    before position 0 and back-references may reach into them (the
    per-lane analog of the shared dictionary prefix).
    """
    if prefix is not None:
        assert dict_len == 0, "prefix and dict_len are exclusive"
        dict_len = prefix.shape[1]
    toks = tokens.T  # [N, T]
    N, T = toks.shape
    D = dict_len
    CW = D + C

    kind = (toks >> U32(30)).astype(I32)
    lit_pair = (toks & U32(TOK_LIT_PAIR_BIT)) != 0
    tlen = jnp.where(
        kind == TOK_LIT, 1 + lit_pair.astype(I32),
        jnp.where(kind == TOK_MATCH,
                  ((toks >> U32(21)) & U32(0x1FF)).astype(I32) + 3,
                  jnp.where(kind == TOK_STORED,
                            ((toks >> U32(22)) & U32(0xFF)).astype(I32) + 1,
                            0)))
    pos = jnp.cumsum(tlen, axis=1) - tlen  # exclusive prefix sum

    # --- label every output byte with its covering token -------------------
    tok_ord = jnp.arange(T, dtype=I32)[None, :]
    rows = jnp.arange(N, dtype=I32)[:, None]
    scatter_col = jnp.where(tlen > 0, D + pos, CW)  # CW = dump slot
    arr = jnp.zeros((N, CW + 1), I32)
    arr = arr.at[rows, scatter_col].max(tok_ord + 1)
    cover = jax.lax.cummax(arr, axis=1)[:, :CW] - 1  # -1 = no token

    cov = jnp.clip(cover, 0)
    tok_at = jnp.take_along_axis(toks, cov, axis=1)
    pos_at = jnp.take_along_axis(pos, cov, axis=1) + D
    kind_at = (tok_at >> U32(30)).astype(I32)

    i = jnp.arange(CW, dtype=I32)[None, :]
    in_out = (i >= D) & (i < D + dst_len[:, None]) & (cover >= 0)

    # literals (pair tokens carry their second byte in bits [15:8])
    lit_byte = jnp.where((i - pos_at) == 0, tok_at & U32(0xFF),
                         (tok_at >> U32(8)) & U32(0xFF)).astype(I32)
    val = jnp.where(in_out & (kind_at == TOK_LIT), lit_byte, 0)

    # stored runs: gather source bytes straight from the packed input
    sb = ((tok_at & U32(0x3FFFFF)).astype(I32) + (i - pos_at))
    w = jnp.take_along_axis(words, jnp.clip(sb >> 2, 0, words.shape[1] - 1),
                            axis=1)
    sbyte = ((w >> (((sb & 3) * 8).astype(U32))) & U32(0xFF)).astype(I32)
    val = jnp.where(in_out & (kind_at == TOK_STORED), sbyte, val)

    # prefix region: per-lane prior-window bytes (streaming) or the
    # shared preset dictionary (resolved constants for every lane)
    if prefix is not None:
        val = jnp.where(i < D, jnp.pad(prefix.astype(I32), ((0, 0), (0, C))),
                        val)
    elif D:
        dw = jnp.take(dict_words, jnp.clip(i[0] >> 2, 0, dict_words.shape[0] - 1))
        dbyte = ((dw >> (((i[0] & 3) * 8).astype(U32))) & U32(0xFF)).astype(I32)
        val = jnp.where(i < D, dbyte[None, :], val)

    # matches: source pointer chains
    dist = (tok_at & U32(0x7FFF)).astype(I32) + 1
    src = jnp.where(in_out & (kind_at == TOK_MATCH), i - dist, -1)

    def unresolved(carry):
        _val, src = carry
        return jnp.any(src >= 0)

    def double(carry):
        val, src = carry
        live = src >= 0
        g = jnp.clip(src, 0)
        sval = jnp.take_along_axis(val, g, axis=1)
        ssrc = jnp.take_along_axis(src, g, axis=1)
        return (jnp.where(live, sval, val), jnp.where(live, ssrc, src))

    val, _ = jax.lax.while_loop(unresolved, double, (val, src))
    return val[:, D:].astype(jnp.uint8)
