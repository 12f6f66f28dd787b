"""Token-decode kernel for NVIDIA GPUs (Pallas, Triton route).

``ops.inflate_batch.decode_tokens`` runs every lockstep step as a chain
of small fused XLA kernels over all lanes, so on a GPU it pays several
kernel launches per step.  This kernel runs a whole K-step chunk in one
launch, one stream lane per GPU thread:

  - per-lane decoder state stays in registers for the K steps;
  - the bitstream is read with per-lane indexed loads straight from the
    packed input words (gathers are native on the GPU, so there is no
    window refill and no multiplexer);
  - Huffman decode is the boundary-sum form of the canonical decode: the
    15 left-justified code-space boundaries of each table sit in
    registers, the code length is 1 + the number of boundaries at or
    below the reversed peek, and the symbol takes two indexed loads (the
    offset row, then the packed symbol bank);
  - header parsing, stored runs and code-length writes run under scalar
    "some lane of this program needs it" branches, so bulk symbol decode
    executes only the S_SYM path.

The chunk driver (`decode_tokens_gpu`) keeps the signature, carry pytree
and token format of ``inflate_batch.decode_tokens`` and runs the same
between-chunk table builds (``inflate_batch._apply_builds``), so the two
decoders are interchangeable.  Per lane the emitted token sequence,
``status``, ``dst_pos`` and ``bitpos`` equal the XLA path's; only the
steps at which a lane idles differ (the XLA path idles lanes whose input
window misses their cursor, this kernel never does).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from defl_jax import constants as C
from defl_jax.errors import Result
from defl_jax.ops import inflate_batch as ib
from defl_jax.ops import tables
from defl_jax.ops.bitio import I32, U32, bitrev16, extract
from defl_jax.ops.inflate_batch import (
    LENS_WORDS, S_BHDR, S_CLEN_HDR, S_CLEN_LENS, S_DICTID, S_DONE, S_ERR,
    S_FULL, S_LENS, S_STORED, S_STORED_HDR, S_STORED_LEN, S_SYM, S_WAIT,
    S_ZHDR, STATUS_RUNNING, STORED_MAX_RUN, TOK_LIT, TOK_LIT_PAIR_BIT,
    TOK_MATCH, TOK_STORED, _dist_from_sym, _length_from_sym, _ord_arith,
    _window32,
)

#: lanes per program: one warp, one lane per thread.  8192 lanes make 256
#: programs, enough to put work on all 132 SMs of an H100.
LANES = 32
NUM_WARPS = LANES // 32
#: input words loaded per step: one step consumes at most 96 bits (two
#: whole matches), and the last 32-bit peek may start 96 bits in
STEP_WORDS = 5
#: chunk length the session and pipeline use with this decoder
CHUNK_STEPS = 256

#: rows of the packed per-lane state: the carried scan state, then the
#: per-call inputs the kernel only reads
ST_KEYS = ("state", "bitpos", "final", "hlit", "hdist", "hclen", "idx",
           "prev", "dst_pos", "need_build", "resume_state", "status",
           "cl_lo", "cl_hi")
IN_KEYS = ("nbits", "cap", "limit", "dict_reach", "in_base")
NST = len(ST_KEYS)
_U32_KEYS = ("cl_lo", "cl_hi")
#: kernel-facing table rows per lane: 3 alphabets (CL, LIT, DIST) x 16
TAB_ROWS = 48


def _bc(x, dt):
    return jax.lax.bitcast_convert_type(x, dt)


def _any(mask):
    """Scalar "some lane of this program" from a lane mask (a branch
    predicate must be a scalar; Triton has no boolean reduction)."""
    return jnp.max(mask.astype(I32)) > 0


def _make_kernel(K: int, has_dict: bool, shared_input: bool,
                 interpret: bool):
    def kernel(st_ref, words_ref, bound_ref, adjoff_ref, maxlen_ref,
               syms_ref, lens_in_ref, tok_ref, st_out_ref, lens_ref):
        # lens_ref aliases lens_in_ref: code lengths are read-modify-
        # written in place, and the between-chunk builds read them
        del lens_in_ref
        pid = pl.program_id(0)
        cols = pl.ds(pid * LANES, LANES)
        lane = pid * LANES + jnp.arange(LANES, dtype=I32)
        row = jnp.zeros_like(lane) if shared_input else lane
        n_words = words_ref.shape[1]
        nbits, cap, limit, dict_reach, in_base = (
            st_ref[NST + k, cols] for k in range(len(IN_KEYS)))
        zero = jnp.zeros_like(lane)

        def gather(ref, col):
            return plgpu.load(ref.at[lane, col])

        # code-space boundaries bound[kind][l-1] for l = 1..15, per lane
        bnd = [[gather(bound_ref, jnp.full_like(lane, kind * 16 + l))
                for l in range(1, C.MAX_CODE_LENGTH + 1)]
               for kind in range(3)]
        mlen = [gather(maxlen_ref, jnp.full_like(lane, kind))
                for kind in range(3)]

        def canon(peek, kind):
            """Canonical decode of `peek` against table `kind` (0 CL,
            1 LIT, 2 DIST; an int, or a per-lane LIT/DIST selector).
            Returns (sym, clen, found) as the XLA path's
            `_canonical_decode` does."""
            rv = (bitrev16(peek & U32(0x7FFF)) >> U32(1)).astype(I32)
            if isinstance(kind, int):
                b = bnd[kind]
            else:
                b = [jnp.where(kind == 2, d, l)
                     for d, l in zip(bnd[2], bnd[1])]
            nge = zero
            for bl in b:
                nge = nge + (rv >= bl).astype(I32)
            found = nge < C.MAX_CODE_LENGTH
            clen = jnp.where(found, nge + 1, 0)
            adj = gather(adjoff_ref, kind * 16 + clen)
            symidx = jnp.where(found, adj + (rv >> (15 - clen)), 0)
            q = jnp.clip(symidx // 3, 0, tables.SYMS_WORDS - 1)
            rem = jnp.clip(symidx - 3 * q, 0, 2)
            word = gather(syms_ref, q)
            sym = ((word >> (U32(10) * rem.astype(U32)))
                   & U32(0x3FF)).astype(I32)
            return sym, clen, found

        def write_lens(mask, start, end, val):
            """OR `val` nibbles into code lengths [start, end) of masked
            lanes: only the packed words each lane's run touches."""
            lo_w = start >> 3
            nw = jnp.where(mask, ((end - 1) >> 3) - lo_w + 1, 0)
            splat = val.astype(U32) * U32(0x11111111)

            def body(j, carry):
                w = lo_w + j
                on = mask & (j < nw)
                lo = jnp.clip(start - 8 * w, 0, 8)
                hi = jnp.clip(end - 8 * w, 0, 8)
                n = (hi - lo).astype(U32)
                m = jnp.where(n >= 8, U32(0xFFFFFFFF),
                              ((U32(1) << ((U32(4) * n) & U32(31)))
                               - U32(1))
                              << ((U32(4) * lo.astype(U32)) & U32(31)))
                at = lens_ref.at[jnp.clip(w, 0, LENS_WORDS - 1), lane]
                old = plgpu.load(at, mask=on, other=0)
                plgpu.store(at, old | (splat & m), mask=on)
                return carry

            jax.lax.fori_loop(0, jnp.max(nw), body, 0)
            if not interpret:
                plgpu.debug_barrier()

        def step(st):
            s = st["state"]
            bitpos = st["bitpos"]
            wi = bitpos >> 5
            w = [plgpu.load(words_ref.at[row, wi + j],
                            mask=wi + j < n_words, other=0)
                 for j in range(STEP_WORDS)]
            b = bitpos & 31
            peek = _window32(w[0], w[1], b)
            peek_i = peek.astype(I32)
            avail = nbits - bitpos

            consume = zero
            token = jnp.zeros_like(peek)
            token2 = token
            status = st["status"]
            final = st["final"]
            hlit, hdist, hclen = st["hlit"], st["hdist"], st["hclen"]
            idx, prev = st["idx"], st["prev"]
            dst_pos = st["dst_pos"]
            need_build = st["need_build"]
            cl_lo, cl_hi = st["cl_lo"], st["cl_hi"]
            resume_state = st["resume_state"]
            nstate = s
            stalled = s < 0
            is_lens = s == S_LENS

            # primary decode: LIT for S_SYM lanes, CL for S_LENS lanes
            # (the header branch swaps it in)
            sym, clen, found = canon(peek, 1)
            ml1 = mlen[1]

            def hdr_branch(a):
                (consume, nstate, final, hlit, hdist, hclen, idx,
                 need_build, cl_lo, cl_hi, stalled, sym, clen, found,
                 ml1) = a
                symC, clenC, foundC = canon(peek, 0)
                sym = jnp.where(is_lens, symC, sym)
                clen = jnp.where(is_lens, clenC, clen)
                found = jnp.where(is_lens, foundC, found)
                ml1 = jnp.where(is_lens, mlen[0], ml1)

                # ---- S_ZHDR ----
                m = s == S_ZHDR
                cmf = peek_i & 0xFF
                flg = (peek_i >> 8) & 0xFF
                zok = ((cmf & 0xF) == C.ZLIB_CM_DEFLATE) \
                    & ((cmf >> 4) <= C.ZLIB_MAX_CINFO) \
                    & ((((cmf << 8) + flg) % 31) == 0)
                fdict = (flg & C.ZLIB_FLAG_FDICT) != 0
                zh_next = jnp.where(~zok, S_ERR,
                                    jnp.where(fdict,
                                              S_DICTID if has_dict else S_ERR,
                                              S_BHDR))
                enough = avail >= 16
                nstate = jnp.where(m & enough, zh_next, nstate)
                consume = jnp.where(m & enough & zok, 16, consume)
                stalled = stalled | (m & ~enough)

                # ---- S_DICTID ----
                m = s == S_DICTID
                enough = avail >= 32
                nstate = jnp.where(m & enough, S_BHDR, nstate)
                consume = jnp.where(m & enough, 32, consume)
                stalled = stalled | (m & ~enough)

                # ---- S_BHDR ----
                m = s == S_BHDR
                # split decode (runtime/large.py): a lane reaching its
                # bit limit at a block boundary has finished its segment
                at_lim = m & (bitpos >= limit)
                m = m & ~at_lim
                nstate = jnp.where(at_lim, S_DONE, nstate)
                enough = avail >= 3
                bf = peek_i & 1
                bt = (peek_i >> 1) & 3
                bh_next = jnp.where(bt == 0, S_STORED_HDR,
                                    jnp.where(bt == 1, S_WAIT,
                                              jnp.where(bt == 2, S_CLEN_HDR,
                                                        S_ERR)))
                ok = m & enough
                nstate = jnp.where(ok, bh_next, nstate)
                consume = jnp.where(ok & (bt != 3), 3, consume)
                final = jnp.where(ok, bf, final)
                need_build = jnp.where(ok & (bt == 1), 3, need_build)
                stalled = stalled | (m & ~enough)

                # ---- S_STORED_HDR: byte-align ----
                m = s == S_STORED_HDR
                nstate = jnp.where(m, S_STORED_LEN, nstate)
                consume = jnp.where(m, (-bitpos) & 7, consume)

                # ---- S_STORED_LEN ----
                m = s == S_STORED_LEN
                enough = avail >= 32
                slen = peek_i & 0xFFFF
                snlen = (peek_i >> 16) & 0xFFFF
                lok = slen == (~snlen & 0xFFFF)   # ≙ infl.c:118
                end_nx = jnp.where(final > 0, S_DONE, S_BHDR)
                nstate = jnp.where(
                    m & enough,
                    jnp.where(~lok, S_ERR,
                              jnp.where(slen == 0, end_nx, S_STORED)),
                    nstate)
                consume = jnp.where(m & enough & lok, 32, consume)
                idx = jnp.where(m & enough & lok, slen, idx)
                stalled = stalled | (m & ~enough)

                # ---- S_CLEN_HDR ----
                m = s == S_CLEN_HDR
                enough = avail >= 14
                h_lit = 257 + (peek_i & 31)
                h_dist = 1 + ((peek_i >> 5) & 31)
                h_clen = 4 + ((peek_i >> 10) & 15)
                hok = (h_lit <= 286) & (h_dist <= 30)
                ok = m & enough
                nstate = jnp.where(ok, jnp.where(hok, S_CLEN_LENS, S_ERR),
                                   nstate)
                consume = jnp.where(ok & hok, 14, consume)
                hlit = jnp.where(ok & hok, h_lit, hlit)
                hdist = jnp.where(ok & hok, h_dist, hdist)
                hclen = jnp.where(ok & hok, h_clen, hclen)
                idx = jnp.where(ok & hok, 0, idx)
                cl_lo = jnp.where(ok & hok, U32(0), cl_lo)
                cl_hi = jnp.where(ok & hok, U32(0), cl_hi)
                stalled = stalled | (m & ~enough)

                # ---- S_CLEN_LENS: 3-bit lengths into two lane words ----
                m = s == S_CLEN_LENS
                enough = avail >= 3
                ok = m & enough
                ordi = _ord_arith(jnp.clip(idx, 0, 18))
                v3 = peek & U32(7)
                sh = (3 * ordi).astype(U32)
                cl_lo = jnp.where(ok & (ordi < 10),
                                  cl_lo | (v3 << (sh & U32(31))), cl_lo)
                cl_hi = jnp.where(ok & (ordi >= 10),
                                  cl_hi | (v3 << ((sh - U32(30)) & U32(31))),
                                  cl_hi)
                idx2 = idx + 1
                fin_cl = ok & (idx2 >= hclen)
                consume = jnp.where(ok, 3, consume)
                idx = jnp.where(ok, idx2, idx)
                need_build = jnp.where(fin_cl, 1, need_build)
                nstate = jnp.where(fin_cl, S_WAIT, nstate)
                stalled = stalled | (m & ~enough)
                return (consume, nstate, final, hlit, hdist, hclen, idx,
                        need_build, cl_lo, cl_hi, stalled, sym, clen, found,
                        ml1)

            any_hdr = _any((s <= S_LENS) & (s != S_STORED))
            (consume, nstate, final, hlit, hdist, hclen, idx, need_build,
             cl_lo, cl_hi, stalled, sym, clen, found, ml1) = jax.lax.cond(
                any_hdr, hdr_branch, lambda a: a,
                (consume, nstate, final, hlit, hdist, hclen, idx,
                 need_build, cl_lo, cl_hi, stalled, sym, clen, found, ml1))

            # ---- S_STORED: emit stored-run tokens (reads no bits) ----
            def stored_branch(a):
                (consume, nstate, status, idx, dst_pos, resume_state,
                 stalled, token) = a
                m = s == S_STORED
                end_next = jnp.where(final > 0, S_DONE, S_BHDR)
                space = cap - dst_pos
                run = jnp.minimum(jnp.minimum(idx, STORED_MAX_RUN), space)
                run_avail = jnp.minimum(run, avail >> 3)
                is_full = m & (space == 0)
                can = m & (space > 0) & (run_avail > 0)
                starv = m & (space > 0) & (run_avail <= 0)
                # offsets relative to the lane's input base (nonzero only
                # in shared-input split decode)
                off_bytes = ((bitpos >> 3) - in_base).astype(U32)
                token = jnp.where(
                    can,
                    (U32(TOK_STORED) << U32(30))
                    | ((run_avail.astype(U32) - U32(1)) << U32(22))
                    | off_bytes, token)
                consume = jnp.where(can, run_avail << 3, consume)
                dst_pos = jnp.where(can, dst_pos + run_avail, dst_pos)
                idx = jnp.where(can, idx - run_avail, idx)
                nstate = jnp.where(can & (idx == 0), end_next, nstate)
                nstate = jnp.where(is_full, S_FULL, nstate)
                status = jnp.where(is_full, Result.EFULL, status)
                resume_state = jnp.where(is_full, s, resume_state)
                stalled = stalled | starv
                return (consume, nstate, status, idx, dst_pos, resume_state,
                        stalled, token)

            (consume, nstate, status, idx, dst_pos, resume_state, stalled,
             token) = jax.lax.cond(
                _any(s == S_STORED), stored_branch, lambda a: a,
                (consume, nstate, status, idx, dst_pos, resume_state,
                 stalled, token))

            # ---- shared decode gates for S_LENS / S_SYM ----
            dec_mask = is_lens | (s == S_SYM)
            dec_stall = dec_mask & ((~found & (avail < ml1))
                                    | (found & (clen > avail)))
            dec_err = dec_mask & ~found & (avail >= ml1)
            dec_ok = dec_mask & found & (clen <= avail) & ~dec_err
            stalled = stalled | dec_stall
            nstate = jnp.where(dec_err, S_ERR, nstate)
            end_next = jnp.where(final > 0, S_DONE, S_BHDR)

            # ---- S_LENS: one code-length symbol -> packed lens nibbles ----
            m = is_lens & dec_ok
            is_lit_len = sym < 16
            is16 = sym == 16
            is17 = sym == 17
            is18 = sym == 18
            ebits = jnp.where(is16, 2, jnp.where(is17, 3,
                                                 jnp.where(is18, 7, 0)))
            lens_stall = m & (clen + ebits > avail)
            stalled = stalled | lens_stall
            m = m & ~lens_stall
            ev = extract(peek, clen, ebits).astype(I32)
            rep = jnp.where(is_lit_len, 1,
                            jnp.where(is16, 3 + ev,
                                      jnp.where(is17, 3 + ev, 11 + ev)))
            wval = jnp.where(is_lit_len, sym, jnp.where(is16, prev, 0))
            total = hlit + hdist
            bad16 = is16 & (idx == 0)
            over = idx + rep > total
            lerr = m & (bad16 | over)
            lok2 = m & ~(bad16 | over)
            nstate = jnp.where(lerr, S_ERR, nstate)
            wmask = lok2 & (wval > 0)

            @pl.when(_any(wmask))
            def _():
                write_lens(wmask, idx, idx + rep, wval)

            consume = jnp.where(lok2, clen + ebits, consume)
            prev = jnp.where(lok2 & is_lit_len, sym,
                             jnp.where(lok2 & (is17 | is18), 0, prev))
            idx = jnp.where(lok2, idx + rep, idx)
            fin_lens = lok2 & (idx == total)
            need_build = jnp.where(fin_lens, 2, need_build)
            nstate = jnp.where(fin_lens, S_WAIT, nstate)

            # ---- S_SYM: literal / EOB / whole match, one step ----
            m = (s == S_SYM) & dec_ok
            is_lit1 = m & (sym < 256)
            is_eob = m & (sym == 256)
            is_len = m & (sym > 256) & (sym <= 285)
            sym_err = m & (sym > 285)

            len_v, leb = _length_from_sym(sym, peek, clen)
            consumed1 = clen + jnp.where(is_len, leb, 0)
            b2 = b + consumed1            # 0..51 within (w0, w1, w2)
            peek2 = _window32(jnp.where(b2 >= 32, w[1], w[0]),
                              jnp.where(b2 >= 32, w[2], w[1]), b2 & 31)
            avail2 = avail - consumed1
            # distance code after a length, else a second literal
            sym2, clen2, found2 = canon(peek2, jnp.where(is_len, 2, 1))

            dv, deb = _dist_from_sym(sym2, peek2, clen2)
            consumed2 = clen2 + deb
            ml2 = mlen[2]
            d_stall = is_len & ((~found2 & (avail2 < ml2))
                                | (found2 & (consumed2 > avail2)))
            d_err = is_len & ~d_stall & (
                (found2 & (sym2 > 29)) | (~found2 & (avail2 >= ml2)))
            md = is_len & ~d_stall & ~d_err
            too_far = md & (dv > dst_pos + dict_reach)   # ≙ infl.c:1286
            m_full = md & ~too_far & (dst_pos + len_v > cap)
            m_ok = md & ~too_far & ~m_full
            stalled = stalled | d_stall
            token = jnp.where(
                m_ok,
                (U32(TOK_MATCH) << U32(30))
                | ((len_v - 3).astype(U32) << U32(21))
                | (dv - 1).astype(U32),
                token)
            consume = jnp.where(m_ok, consumed1 + consumed2, consume)
            dst_pos = jnp.where(m_ok, dst_pos + len_v, dst_pos)
            nstate = jnp.where(m_full, S_FULL, nstate)
            status = jnp.where(m_full, Result.EFULL, status)
            resume_state = jnp.where(m_full, s, resume_state)
            nstate = jnp.where(sym_err | d_err | too_far, S_ERR, nstate)

            lit_full = is_lit1 & (dst_pos >= cap)
            lit1_ok = is_lit1 & ~lit_full
            lit2_ok = lit1_ok & found2 & (sym2 < 256) & (clen2 <= avail2) \
                & (dst_pos + 1 < cap)
            token = jnp.where(
                lit1_ok,
                (U32(TOK_LIT) << U32(30)) | sym.astype(U32)
                | jnp.where(lit2_ok,
                            U32(TOK_LIT_PAIR_BIT)
                            | (sym2.astype(U32) << U32(8)),
                            U32(0)),
                token)
            consume = jnp.where(lit1_ok, clen + jnp.where(lit2_ok, clen2, 0),
                                consume)
            dst_pos = jnp.where(lit1_ok, dst_pos + 1 + lit2_ok.astype(I32),
                                dst_pos)
            nstate = jnp.where(lit_full, S_FULL, nstate)
            status = jnp.where(lit_full, Result.EFULL, status)
            resume_state = jnp.where(lit_full, s, resume_state)

            consume = jnp.where(is_eob, clen, consume)
            nstate = jnp.where(is_eob, end_next, nstate)

            # ---- opportunistic second token (defer-only: anything that
            # does not fit re-decodes next step as a primary token) ----
            t2 = m_ok | lit1_ok
            b3 = b + consume
            peek3 = ib._win_at(w, b3)
            avail3 = avail - consume
            sym3, clen3, found3 = canon(peek3, 1)
            t2v = t2 & found3 & (clen3 <= avail3)
            is_lit3 = t2v & (sym3 < 256)
            is_eob3 = t2v & (sym3 == 256)
            is_len3 = t2v & (sym3 > 256) & (sym3 <= 285)

            lit3_ok = is_lit3 & (dst_pos < cap)
            token2 = jnp.where(
                lit3_ok, (U32(TOK_LIT) << U32(30)) | sym3.astype(U32), token2)
            consume = jnp.where(lit3_ok, consume + clen3, consume)
            dst_pos = jnp.where(lit3_ok, dst_pos + 1, dst_pos)

            consume = jnp.where(is_eob3, consume + clen3, consume)
            nstate = jnp.where(is_eob3, end_next, nstate)

            len3, leb3 = _length_from_sym(sym3, peek3, clen3)
            c31 = clen3 + jnp.where(is_len3, leb3, 0)
            b4 = b3 + c31
            peek4 = ib._win_at(w, b4)
            avail4 = avail3 - c31
            sym4, clen4, found4 = canon(peek4, 2)
            dv4, deb4 = _dist_from_sym(sym4, peek4, clen4)
            c42 = clen4 + deb4
            m4_ok = (is_len3 & found4 & (c42 <= avail4) & (sym4 <= 29)
                     & (dv4 <= dst_pos + dict_reach)
                     & (dst_pos + len3 <= cap))
            token2 = jnp.where(
                m4_ok,
                (U32(TOK_MATCH) << U32(30))
                | ((len3 - 3).astype(U32) << U32(21))
                | (dv4 - 1).astype(U32),
                token2)
            consume = jnp.where(m4_ok, consume + c31 + c42, consume)
            dst_pos = jnp.where(m4_ok, dst_pos + len3, dst_pos)

            # ---- stalls & terminals ----
            status = jnp.where(stalled, Result.UNFINISHED, status)
            status = jnp.where(nstate == S_ERR, Result.ERR, status)
            status = jnp.where(nstate == S_DONE, Result.OK, status)

            out = dict(
                state=nstate, bitpos=bitpos + consume, final=final,
                hlit=hlit, hdist=hdist, hclen=hclen, idx=idx, prev=prev,
                dst_pos=dst_pos, need_build=need_build,
                resume_state=resume_state, status=status,
                cl_lo=cl_lo, cl_hi=cl_hi)
            return out, token, token2

        def live(st):
            # lanes that can still change within this chunk: waiting
            # lanes need a between-chunk build, finished or stalled ones
            # never move again in this call
            return _any((st["status"] == STATUS_RUNNING)
                        & (st["state"] != S_WAIT))

        def cond(c):
            k, st = c
            return (k < K) & live(st)

        def body(c):
            k, st = c
            st, tok, tok2 = step(st)
            tok_ref[2 * k, cols] = tok
            tok_ref[2 * k + 1, cols] = tok2
            return k + 1, st

        st0 = {key: st_ref[r, cols] for r, key in enumerate(ST_KEYS)}
        for key in _U32_KEYS:
            st0[key] = _bc(st0[key], U32)
        k_end, st_end = jax.lax.while_loop(cond, body,
                                           (jnp.asarray(0, I32), st0))

        # rows of the steps this program skipped hold NOP tokens
        def fill(j, carry):
            tok_ref[j, cols] = jnp.zeros((LANES,), U32)
            return carry

        jax.lax.fori_loop(2 * k_end, 2 * K, fill, 0)

        for r, key in enumerate(ST_KEYS):
            v = st_end[key]
            st_out_ref[r, cols] = _bc(v, I32) if key in _U32_KEYS else v

    return kernel


@functools.partial(jax.jit, static_argnames=("K", "has_dict", "shared_input",
                                             "interpret"))
def decode_chunk(st_pk, words, bound, adjoff, maxlen, syms, lens_pk, *,
                 K: int, has_dict: bool, shared_input: bool,
                 interpret: bool = False):
    """One K-step chunk over all lanes (N a multiple of LANES).

    st_pk int32 [NST + 5, N] (ST_KEYS then IN_KEYS); words uint32 [N, W]
    ([1, W] with shared_input); bound/adjoff int32 [N, 48] (alphabet*16
    + length: left-justified code-space boundaries and offset-minus-first
    rows); maxlen int32 [N, 3]; syms uint32 [N, SYMS_WORDS]; lens_pk
    uint32 [LENS_WORDS, N], updated in place.
    Returns (tokens uint32 [2K, N], state int32 [NST, N], lens_pk).
    """
    N = st_pk.shape[1]
    assert N % LANES == 0, N
    anywhere = pl.BlockSpec(memory_space=pl.ANY)
    return pl.pallas_call(
        _make_kernel(K, has_dict, shared_input, interpret),
        grid=(N // LANES,),
        in_specs=[anywhere] * 7,
        out_specs=(anywhere,) * 3,
        out_shape=(
            jax.ShapeDtypeStruct((2 * K, N), U32),
            jax.ShapeDtypeStruct((NST, N), I32),
            jax.ShapeDtypeStruct((LENS_WORDS, N), U32),
        ),
        input_output_aliases={6: 2},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="defl_decode_chunk",
    )(st_pk, words, bound, adjoff, maxlen, syms, lens_pk)


def kernel_tables(ck):
    """Kernel-facing rows from the canonical build (count, first, offs):
    bound[l] = (first[l] + count[l]) << (15 - l), the end of length-l
    codes in the left-justified 15-bit code space (non-decreasing in l,
    so the code length is 1 + #{l : rev >= bound[l]}), and
    adjoff[l] = offs[l] - first[l] (symbol index = adjoff[clen] +
    (rev >> (15 - clen)))."""
    N = ck["count"].shape[0]
    sh = (15 - jnp.arange(16, dtype=I32))[None, None, :]
    bound = ((ck["first"] + ck["count"]) << sh).reshape(N, TAB_ROWS)
    adjoff = (ck["offs"] - ck["first"]).reshape(N, TAB_ROWS)
    return bound, adjoff


@functools.partial(jax.jit, static_argnames=("T", "K", "dict_len",
                                             "has_dict", "shared_input",
                                             "interpret"))
def decode_tokens_gpu(words, nbits, zflag, cap, *, T: int,
                      K: int = CHUNK_STEPS, dict_len: int = 0,
                      has_dict: bool = False, carry=None, limit=None,
                      start_bit=None, dict_reach=None,
                      shared_input: bool = False, in_base=None,
                      interpret: bool = False):
    """Kernel-backed twin of ``inflate_batch.decode_tokens``: same
    arguments, carry pytree and token buffer.  N is padded up to a
    multiple of LANES; padded lanes hold empty streams and are sliced off
    the results.  `interpret` runs the kernel in the Pallas interpreter
    (CPU tests)."""
    N0 = nbits.shape[0]
    N = -(-N0 // LANES) * LANES
    if carry is not None:
        carry = {k: v for k, v in carry.items() if k != "tok_rows"}
    if limit is None:
        limit = jnp.full((N0,), 1 << 30, I32)  # never reached
    if dict_reach is None:
        dict_reach = jnp.full((N0,), dict_len, I32)
    if in_base is None:
        in_base = jnp.zeros((N0,), I32)
    if shared_input:
        words = words.reshape(1, -1)
    pad = N - N0
    if pad:
        if not shared_input:
            words = jnp.pad(words, ((0, pad), (0, 0)))
        nbits, zflag, cap, dict_reach, in_base = (
            jnp.pad(a, (0, pad))
            for a in (nbits, zflag, cap, dict_reach, in_base))
        limit = jnp.pad(limit, (0, pad), constant_values=1 << 30)
        if start_bit is not None:
            start_bit = jnp.pad(jnp.asarray(start_bit, I32), (0, pad))
        if carry is not None:
            filler = {**ib._init_scan_state(pad), **ib._init_chunk_state(pad)}
            filler["status"] = jnp.full((pad,), int(Result.ERR), I32)
            carry = {k: jnp.concatenate(
                [carry[k], filler[k]], axis=1 if k == "lens_pk" else 0)
                for k in carry}

    if carry is None:
        st = ib._init_scan_state(N)
        ck = ib._init_chunk_state(N)
        st["state"] = jnp.where(zflag > 0, S_ZHDR, S_BHDR)
        if start_bit is not None:
            st["bitpos"] = jnp.asarray(start_bit, I32)
    else:
        st = {k: carry[k] for k in ib._init_scan_state(1)}
        ck = {k: carry[k] for k in ib._init_chunk_state(1)}

    inputs = jnp.stack([nbits, cap, limit, dict_reach,
                        in_base]).astype(I32)  # IN_KEYS order
    n_steps = max(K, T // 2)
    n_chunks = (n_steps + K - 1) // K
    tokbuf = jnp.zeros((n_chunks * K * 2, N), U32)

    def chunk_active(c):
        ci, st, ck, tokbuf = c
        return (ci < n_chunks) & jnp.any(st["status"] == STATUS_RUNNING)

    def chunk_body(c):
        ci, st, ck, tokbuf = c
        ck, st = ib._apply_builds(ck, st)
        bound, adjoff = kernel_tables(ck)
        rows = [_bc(st[k], I32) if k in _U32_KEYS else st[k]
                for k in ST_KEYS]
        st_pk = jnp.concatenate([jnp.stack(rows), inputs])
        toks, st_out, lens = decode_chunk(
            st_pk, words, bound, adjoff, ck["maxlen"], ck["syms"],
            st["lens_pk"], K=K, has_dict=has_dict,
            shared_input=shared_input, interpret=interpret)
        st = {k: _bc(st_out[r], U32) if k in _U32_KEYS else st_out[r]
              for r, k in enumerate(ST_KEYS)}
        st["lens_pk"] = lens
        tokbuf = jax.lax.dynamic_update_slice(tokbuf, toks, (ci * 2 * K, 0))
        return ci + 1, st, ck, tokbuf

    ci, st, ck, tokbuf = jax.lax.while_loop(
        chunk_active, chunk_body, (jnp.asarray(0, I32), st, ck, tokbuf))
    if pad:
        tokbuf = tokbuf[:, :N0]
        st = {k: v[:, :N0] if k == "lens_pk" else v[:N0]
              for k, v in st.items()}
        ck = {k: v[:N0] for k, v in ck.items()}
    return tokbuf, {**st, **ck, "tok_rows": ci * 2 * K}

