"""Lockstep batched DEFLATE token decoder (pass 1 of the device inflate).

Data-parallel redesign of the reference's serial decode loops
(`infl_ft_block`, /root/reference/src/infl/infl.c:717-901, and the
streaming machine, stream.c:468-794).  DEFLATE is bit-serial *within* a
stream, so the exploitable parallelism is *across* streams: N independent
streams advance in lockstep, one per vector lane.

This is the plain XLA formulation: the device decoder on the CPU backend
and the reference the GPU kernel (ops/pallas/decode_gpu.py) is checked
against.  It was first shaped for a backend on which per-lane gathers
serialise and scan carries are copied every step, hence:

  - The scan carry holds ONLY small per-lane state.  Everything wide —
    packed input, Huffman structures — lives at *chunk* level, invariant
    inside the scan (no per-step copies).
  - Each lane reads its bitstream through a per-chunk window (`win`
    [N, WIN] words) recentred between chunks by a one-hot integer
    contraction over aligned segments; a mini-window is extracted once
    per step, and per-step word picks are where-chain multiplexers
    (select chains fuse into the surrounding elementwise kernel).
  - Huffman symbol decode is *tableless*: bit-reverse the peeked window
    once, then 15 rounds of compare/select against per-lane
    ``first_code[len]``; rank->symbol goes through a two-level multiplexer
    over the packed (3 x 10-bit per word) symbol bank.
  - Each step decodes a whole match (litlen + distance from a second
    32-bit window) or a literal *pair* — one token per step.
  - Dynamic-header code lengths accumulate nibble-packed in a word-major
    [40, N] carry written with pure arithmetic; the 19 code-length code
    lengths pack into two u32 lane scalars.

Huffman table builds (vectorised argsort over code lengths) run between
scan chunks, amortised over all lanes that flagged ``need_build``.

Pass 2 (`ops.resolve` on-device, or the multithreaded C++ resolver in
``native/defl_host.cc`` on the perf path) turns the token stream into
bytes — the two-pass replacement for the reference's sequential
sliding-window copies (infl.c:269-376).

The per-lane state machine mirrors the reference's streaming states
(`infl_stream_state_t`, src/common.h:86-97) and the whole decoder is
shape-static, jit-compatible, and resumable (the carry pytree is the
`unz__stream_t` analog; SURVEY §5 "checkpoint/resume").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from defl_jax import constants as C
from defl_jax.core import huffman
from defl_jax.errors import Result
from defl_jax.ops import tables
from defl_jax.ops.bitio import I32, U32, bitrev16, extract

# ---- lane states -----------------------------------------------------------
S_ZHDR = 0
S_DICTID = 1
S_BHDR = 2
S_STORED_HDR = 3    # byte-align after BTYPE
S_STORED_LEN = 4    # read LEN/NLEN
S_STORED = 5        # emit stored-run tokens
S_CLEN_HDR = 6      # HLIT/HDIST/HCLEN
S_CLEN_LENS = 7     # 3-bit codelen code lengths
S_LENS = 8          # codelen-coded litlen+dist lengths
S_WAIT = 9          # stalled until the between-chunk table build
S_SYM = 10          # symbol decode (litlen + same-step dist / 2nd literal)
S_DONE = 11
S_ERR = 12
S_FULL = 13

STATUS_RUNNING = 127

# ---- token encoding (u32) --------------------------------------------------
# kind in bits [31:30]: 0 NOP | 1 LIT | 2 MATCH | 3 STORED
# LIT:    byte in [7:0]; bit 16 set => second byte rides in [15:8]
# MATCH:  (len-3) in [29:21], (dist-1) in [14:0]
# STORED: (run-1) in [29:22], input byte offset in [21:0]  (=> streams <4MiB)
TOK_NOP = 0
TOK_LIT = 1
TOK_MATCH = 2
TOK_STORED = 3
TOK_LIT_PAIR_BIT = 1 << 16
STORED_MAX_RUN = 256

#: input window length in u32 words: WIN - SEG words are guaranteed
#: ahead of a freshly recentred cursor, which must cover one chunk's
#: consumption; a lane consuming faster than that idles out the chunk
#: tail until the next refill.  4 segments (384 words = 12288 bits)
#: cover K=128 steps at up to 96 bits/step.  The window is carried per
#: lane ([N, WIN] words), so WIN also sets the carry's size.
WIN = 512


def step_budget(dst_capacity: int) -> int:
    """Default decode-step budget for a given output capacity.

    With literal pairs and one-step matches, a valid stream needs at most
    ~C/2 symbol steps plus header steps; pathological streams (e.g. floods
    of empty blocks) that exceed the budget fall back to the host engine
    (runtime/session.py).
    """
    return dst_capacity * 5 // 8 + 4096

# ---- constant tables (NumPy on purpose: jax.Array module constants embed
# via device fetch at lowering time and serialise against backend init) ----
_fx_lit = huffman.build_decode(C.FIXED_LITLEN_LENGTHS)
_fx_dist = huffman.build_decode(C.FIXED_DIST_LENGTHS)


def _pack_syms_np(syms, width):
    """NumPy twin of tables.pack_syms for module-level constants."""
    s = np.zeros(width, np.uint32)
    s[: syms.size] = syms
    s3 = s.reshape(width // 3, 3)
    return s3[:, 0] | (s3[:, 1] << 10) | (s3[:, 2] << 20)


_FX_LIT_SYMS = _pack_syms_np(_fx_lit.sorted_syms, 288)
_FX_DIST_SYMS = _pack_syms_np(_fx_dist.sorted_syms, 36)
_FX_LIT_COUNT = _fx_lit.count
_FX_LIT_FIRST = _fx_lit.first_code
_FX_LIT_OFFS = _fx_lit.offset + tables.LIT_BASE
_FX_DIST_COUNT = _fx_dist.count
_FX_DIST_FIRST = _fx_dist.first_code
_FX_DIST_OFFS = _fx_dist.offset + tables.DIST_BASE_


#: litlen+dist code lengths, nibble-packed: 320 lengths x 4 bits = 40 u32
LENS_WORDS = 40


def _init_scan_state(N):
    """Small per-lane carry: (N,) scalars plus the nibble-packed lens
    array (320 x 4-bit lengths in 40 u32 words — small enough that the
    per-step carry copy is cheap, wide enough to hold a whole dynamic
    header without any chunk-level fold pass)."""
    z = lambda: jnp.zeros((N,), I32)
    return dict(
        state=z(), bitpos=z(), final=z(), hlit=z(), hdist=z(), hclen=z(),
        idx=z(), prev=z(), dst_pos=z(), need_build=z(), resume_state=z(),
        cl_lo=jnp.zeros((N,), U32), cl_hi=jnp.zeros((N,), U32),
        # transposed [words, lanes]: a [N, 40] layout pads each row to
        # 128-lane tiles (3.2x copy waste per scan step)
        lens_pk=jnp.zeros((LENS_WORDS, N), U32),
        status=jnp.full((N,), STATUS_RUNNING, I32),
    )


def _init_chunk_state(N):
    """Wide arrays touched only between chunks."""
    z16 = jnp.zeros((N, 16), I32)
    return dict(
        win=jnp.zeros((N, WIN), U32),
        win_word=jnp.full((N,), -(10 * WIN), I32),
        # refill round counter (same value in every lane): rotates the
        # second band's anchor so no consumption-rate cluster starves
        rr=jnp.zeros((N,), I32),
        count=jnp.stack([z16, z16, z16], axis=1),   # [N,3,16] CL/LIT/DIST
        first=jnp.stack([z16, z16, z16], axis=1),
        offs=jnp.stack([z16, z16, z16], axis=1),
        syms=jnp.zeros((N, tables.SYMS_WORDS), U32),  # 3 x 10-bit per word
        # longest assigned code length per table: the invalid-vs-need-input
        # decision point (all three engines error once maxlen bits are
        # available and no code matches — ≙ oracle._decode_symbol)
        maxlen=jnp.full((N, 3), C.MAX_CODE_LENGTH, I32),
    )


def _unpack_lens(lens_pk, width):
    """[LENS_WORDS, N] packed nibbles -> [N, width] int32 lengths."""
    cols = []
    for p in range(width):
        w = lens_pk[p >> 3, :]
        cols.append(((w >> U32(4 * (p & 7))) & U32(0xF)).astype(I32))
    return jnp.stack(cols, axis=1)


def _write_lens_run(lens_pk, mask, start, end, val):
    """OR value nibbles into positions [start, end) of the packed lens
    array ([LENS_WORDS, N], word-major) for masked lanes — pure
    arithmetic, no scatter."""
    w8 = 8 * jnp.arange(LENS_WORDS, dtype=I32)[:, None]
    lo = jnp.clip(start[None, :] - w8, 0, 8)
    hi = jnp.clip(end[None, :] - w8, 0, 8)
    n = (hi - lo).astype(U32)
    m = jnp.where(n >= 8, U32(0xFFFFFFFF),
                  ((U32(1) << ((U32(4) * n) & U32(31))) - U32(1))
                  << (U32(4) * lo.astype(U32)))
    m = jnp.where(mask[None, :] & (n > 0), m, U32(0))
    splat = (val.astype(U32) * U32(0x11111111))[None, :]
    return lens_pk | (splat & m)


def _ord_arith(idx):
    """RFC1951 code-length order (apicommon.h:52) as closed-form arithmetic
    (a 19-entry per-lane gather would serialise).  idx in [0, 19)."""
    j = idx - 4
    paired = jnp.where((j & 1) == 1, 8 - ((j + 1) >> 1), 8 + (j >> 1))
    return jnp.where(idx < 3, 16 + idx, jnp.where(idx == 3, 0, paired))


#: words in the per-step mini-window: one step's worst-case
#: consumption (96 bits for two whole matches) plus the furthest 32-bit
#: window, with room for the cursor's offset inside its first word.
SMALL = 24


def _mux_cols(bank, idx):
    """bank[n, idx[n]] via where-chain multiplexers over static columns.

    A chain of elementwise selects fuses into the surrounding
    computation, where a masked reduction would be a kernel of its own.
    Wide banks use two levels — the group stage selects [N, 16] slices —
    cutting the serial select-chain depth ~M/16-fold.
    """
    M = bank.shape[1]
    if M <= 24:
        acc = bank[:, 0]
        for k in range(1, M):
            acc = jnp.where(idx == k, bank[:, k], acc)
        return acc
    Gw = 16
    Mp = ((M + Gw - 1) // Gw) * Gw
    if Mp != M:
        bank = jnp.pad(bank, ((0, 0), (0, Mp - M)))
    b3 = bank.reshape(bank.shape[0], Mp // Gw, Gw)
    g = (idx >> 4)[:, None]
    grp = b3[:, 0, :]
    for k in range(1, Mp // Gw):
        grp = jnp.where(g == k, b3[:, k, :], grp)
    lo = idx & 15
    acc = grp[:, 0]
    for k in range(1, Gw):
        acc = jnp.where(lo == k, grp[:, k], acc)
    return acc


def _mux_groups(win3, gidx):
    """win3[n, gidx[n], :] via a where-chain over static group slices."""
    G = win3.shape[1]
    acc = win3[:, 0, :]
    g = gidx[:, None]
    for k in range(1, G):
        acc = jnp.where(g == k, win3[:, k, :], acc)
    return acc


def _extract_small(win, loc):
    """Per-lane extraction of SMALL consecutive words win[n, loc[n]+k]
    via two-stage multiplexers — runs once per step.

    win: [N, WIN] u32;  loc: [N] int32 in [0, WIN-SMALL].
    Returns [N, SMALL] u32.
    """
    N = win.shape[0]
    G = WIN // 16
    win3 = win.reshape(N, G, 16)
    hi = loc >> 4
    sel0 = _mux_groups(win3, hi)
    sel1 = _mux_groups(win3, jnp.clip(hi + 1, 0, G - 1))
    sel2 = _mux_groups(win3, jnp.clip(hi + 2, 0, G - 1))
    sub = jnp.concatenate([sel0, sel1, sel2], axis=1)  # [N, 48]
    lo = loc & 15
    cols = [_mux_cols(sub, lo + k) for k in range(SMALL)]
    return jnp.stack(cols, axis=1)


def _pick_words(small, off, k):
    """k consecutive words from the [N, SMALL] mini-window at per-lane
    offset off (clipped; callers check the miss mask)."""
    o = jnp.clip(off, 0, SMALL - k)
    return [_mux_cols(small, o + j) for j in range(k)]


def _win_at(w, bitofs):
    """32-bit LSB-first window at `bitofs` bits past word w[0] (list of
    per-lane words; bitofs < 32*(len(w)-1))."""
    wi = bitofs >> 5
    lo = w[0]
    hi = w[1]
    for k in range(1, len(w) - 1):
        lo = jnp.where(wi == k, w[k], lo)
        hi = jnp.where(wi == k, w[k + 1], hi)
    return _window32(lo, hi, bitofs & 31)


def _window32(w0, w1, b):
    """32-bit LSB-first window at bit offset b (0..63) within (w0,w1)."""
    b = b.astype(U32)
    hi = jnp.where(b == 0, U32(0), w1 << ((U32(32) - b) & U32(31)))
    return jnp.where(b == 0, w0, (w0 >> b) | hi)





def _canonical_decode(ck, peek, is_cl, is_dist):
    """Tableless canonical decode against a per-lane table selector.

    Returns (sym, clen, found).  The per-length compare/select rounds are
    the vectorised form of the oracle's `_decode_symbol`; the rank->symbol
    step is a one-hot reduction over the symbol bank.
    """
    rev = bitrev16(peek & U32(0x7FFF)) >> U32(1)  # 15-bit reversal
    found = jnp.zeros(is_cl.shape, bool)
    symidx = jnp.zeros(is_cl.shape, I32)
    clen = jnp.zeros(is_cl.shape, I32)
    for l in range(1, C.MAX_CODE_LENGTH + 1):
        cand = (rev >> U32(15 - l)).astype(I32)
        first = jnp.where(is_cl, ck["first"][:, 0, l],
                          jnp.where(is_dist, ck["first"][:, 2, l],
                                    ck["first"][:, 1, l]))
        cnt = jnp.where(is_cl, ck["count"][:, 0, l],
                        jnp.where(is_dist, ck["count"][:, 2, l],
                                  ck["count"][:, 1, l]))
        offs = jnp.where(is_cl, ck["offs"][:, 0, l],
                         jnp.where(is_dist, ck["offs"][:, 2, l],
                                   ck["offs"][:, 1, l]))
        off = cand - first
        hit = (~found) & (off >= 0) & (off < cnt)
        symidx = jnp.where(hit, offs + off, symidx)
        clen = jnp.where(hit, l, clen)
        found = found | hit
    # packed bank: word = syms[symidx // 3], symbol in 10-bit slot
    q = symidx // 3
    rem = symidx - 3 * q
    word = _mux_cols(ck["syms"], q)
    sym = ((word >> (U32(10) * rem.astype(U32))) & U32(0x3FF)).astype(I32)
    return sym, clen, found


def _length_from_sym(sym, peek, off):
    """Closed-form RFC1951 length-code expansion (no table gathers)."""
    eb = jnp.clip((sym - 261) >> 2, 0, 5)
    base = jnp.where(sym <= 264, sym - 254,
                     ((((sym - 261) & 3) + 4) << eb) + 3)
    eb = jnp.where(sym >= 285, 0, eb)
    base = jnp.where(sym >= 285, 258, base)
    return base + extract(peek, off, eb).astype(I32), eb


def _dist_from_sym(dsym, peek, off):
    """Closed-form distance expansion."""
    eb = jnp.clip((dsym >> 1) - 1, 0, 13)
    base = jnp.where(dsym < 4, dsym + 1, ((2 + (dsym & 1)) << eb) + 1)
    eb = jnp.where(dsym < 4, 0, eb)
    return base + extract(peek, off, eb).astype(I32), eb


# ---------------------------------------------------------------------------
# between-chunk passes: window refill, lens fold-in, table builds
# ---------------------------------------------------------------------------

SEG = 128  # segment width in words; windows cover WIN//SEG aligned segments


#: banded-refill width in segments: the one-hot contraction only reads
#: this many segments around the slowest active lane instead of the whole
#: input (HBM traffic per refill drops by S/BAND).  Lanes more than
#: (BAND-1)*SEG words ahead of the slowest fall outside the band, miss
#: their window, and idle until it catches up — safe by the
#: consume-only-on-success invariant, and cheap because total chunk count
#: is set by the slowest lane anyway.
BAND = 16


def _split_planes(wpad):
    """u32 words -> 4 int8 byte planes (bit patterns, sign-carried).

    The refill contractions run on 8-bit planes: an s8 x s8 dot with an
    i32 accumulator is EXACT by definition (no matmul precision knob can
    corrupt it, unlike f32 halves whose default-precision dot silently
    bf16-truncates — the round-3 bug regression-tested in
    tests/test_regressions.py), and the slab traffic is half that of two
    f32 16-bit halves.  The one-hot row has a single 1, so each result
    lane is the sign-extended source byte; `& 0xFF` recovers it.
    """
    return tuple(
        jax.lax.bitcast_convert_type(
            ((wpad >> U32(8 * p)) & U32(0xFF)).astype(jnp.uint8), jnp.int8)
        for p in range(4))


def _refill_windows_shared(ck, st, body_p):
    """Shared-input window refill: every lane reads the SAME body.

    Used by the speculative split decode (runtime/large.py), where the
    lanes are segments of one huge stream: per-lane input rows would
    duplicate the body N times and the banded refill would starve (every
    lane sits in its own segment region).  Here the one-hot contraction
    runs over the whole [S, SEG] body — read once per refill, not per
    lane — and every active lane is always served.
    """
    S = body_p[0].shape[0]

    def refill(ck):
        seg = jnp.clip((st["bitpos"] >> 5) // SEG, 0, S - 1)
        NSEG = WIN // SEG

        # all NSEG segments in one [N*NSEG, S] x [S, SEG] contraction
        # per byte plane (the body is streamed once per refill, not once
        # per segment); integer dot => exact (see _split_planes)
        ks = jnp.arange(NSEG, dtype=I32)[None, :]
        idx = jnp.minimum(seg[:, None] + ks, S - 1)               # [N,NSEG]
        oh = (jnp.arange(S, dtype=I32)[None, None, :]
              == idx[:, :, None]).astype(jnp.int8)                # [N,NSEG,S]
        bs = [jnp.einsum("nks,sw->nkw", oh, p,
                         preferred_element_type=I32).astype(U32) & U32(0xFF)
              for p in body_p]
        win = (bs[0] | (bs[1] << U32(8)) | (bs[2] << U32(16))
               | (bs[3] << U32(24))).reshape(seg.shape[0], NSEG * SEG)
        ck = dict(ck)
        ck["win"] = win
        ck["win_word"] = seg * SEG
        ck["rr"] = ck["rr"] + 1
        return ck

    active = st["status"] == STATUS_RUNNING
    loc = (st["bitpos"] >> 5) - ck["win_word"]
    need = jnp.any(active & ((loc < 0) | (loc > SEG)))
    return jax.lax.cond(need, refill, lambda c: c, ck)


def _refill_windows(ck, st, words_p):
    """Recentre lanes' input windows at their bit cursors.

    The refill is a one-hot contraction rather than a gather: the input is
    pre-split into int8 byte planes tiled as [N, S, SEG] (exact —
    _split_planes); selecting lane n's aligned segments is a batched
    vector-matrix product with a one-hot over band positions.  The
    contraction runs over a BAND-segment slice starting at the slowest
    active lane's segment, so each refill reads ~BAND*SEG words per
    lane, not the whole input.  Gated to run only when some active lane
    is past the halfway mark (a mid-chunk overrun merely stalls that
    lane until the next refill).
    """
    S = words_p[0].shape[1]
    B = min(BAND, S)

    def refill(ck):
        seg = jnp.clip((st["bitpos"] >> 5) // SEG, 0, S - 1)
        act = st["status"] == STATUS_RUNNING

        NSEG = WIN // SEG

        def in_band(base):
            # a lane is servable when its segment and the NSEG-1
            # following ones sit inside [base, base+B); at the true end
            # of the input the clamped duplicates are never consumed
            # (avail-gated)
            sb = seg - base
            return (sb >= 0) & ((sb <= B - NSEG)
                                | ((seg >= S - NSEG + 1) & (sb <= B - 1)))

        # two bands: lanes cluster by consumption rate (e.g. stored-heavy
        # racers vs literal-dense laggards); one band at the slowest
        # active lane, one among the lanes the first cannot serve — its
        # anchor alternates between the slowest and the fastest unserved
        # lane across refills, so with 3+ rate clusters the middle ones
        # are reached within a bounded number of refills instead of
        # starving until the extremes finish
        s0 = jnp.clip(jnp.min(jnp.where(act, seg, S - 1)), 0,
                      max(S - B, 0))
        left1 = act & ~in_band(s0)
        NSEG0 = WIN // SEG
        s1_slow = jnp.min(jnp.where(left1, seg, S - 1))
        s1_fast = jnp.max(jnp.where(left1, seg, 0)) - (B - NSEG0)
        s1 = jnp.clip(jnp.where((ck["rr"][0] & 1) == 0, s1_slow, s1_fast),
                      0, max(S - B, 0))
        in0 = in_band(s0)
        in1 = in_band(s1)

        subs = [jnp.concatenate(
            [jax.lax.dynamic_slice_in_dim(p, s0, B, axis=1),
             jax.lax.dynamic_slice_in_dim(p, s1, B, axis=1)], axis=1)
            for p in words_p]
        segb = jnp.where(in0, seg - s0,
                         jnp.where(in1, seg - s1 + B, 0))
        band_end = jnp.where(segb < B, B - 1, 2 * B - 1)

        # ALL NSEG window segments in ONE batched contraction per byte
        # plane: a per-segment einsum would stream the slab once per
        # segment; merged, each plane is read once per refill (refills
        # fire nearly every chunk).  Integer dot => exact (see
        # _split_planes).
        ks = jnp.arange(NSEG, dtype=I32)[None, :]
        idx = jnp.minimum(segb[:, None] + ks, band_end[:, None])  # [N,NSEG]
        oh = (jnp.arange(2 * B, dtype=I32)[None, None, :]
              == idx[:, :, None]).astype(jnp.int8)                # [N,NSEG,2B]
        bs = [jnp.einsum("nkb,nbw->nkw", oh, s,
                         preferred_element_type=I32).astype(U32) & U32(0xFF)
              for s in subs]
        win = (bs[0] | (bs[1] << U32(8)) | (bs[2] << U32(16))
               | (bs[3] << U32(24))).reshape(seg.shape[0], NSEG * SEG)
        ck = dict(ck)
        ck["win"] = win
        ck["rr"] = ck["rr"] + 1
        # unserved lanes get a window position guaranteed to miss their
        # cursor, so they idle until a later refill's bands reach them
        ck["win_word"] = jnp.where(in0 | in1, seg * SEG,
                                   seg * SEG - 2 * WIN)
        return ck

    active = st["status"] == STATUS_RUNNING
    loc = (st["bitpos"] >> 5) - ck["win_word"]
    need = jnp.any(active & ((loc < 0) | (loc > SEG)))
    return jax.lax.cond(need, refill, lambda c: c, ck)


def _unpack_cl(cl_lo, cl_hi):
    """Two packed u32 scalars -> [N, 19] code-length code lengths."""
    cols = []
    for j in range(19):
        if j < 10:
            cols.append(((cl_lo >> U32(3 * j)) & U32(7)).astype(I32))
        else:
            cols.append(((cl_hi >> U32(3 * (j - 10))) & U32(7)).astype(I32))
    return jnp.stack(cols, axis=1)


def _apply_builds(ck, st):
    """Convert lanes waiting on a Huffman build; vectorised and masked."""
    nb = st["need_build"]

    def set_table(ck, tbl, mask, count, first, offs, syms_packed, syms_base):
        """syms_packed: [N, W/3] u32 (3 symbols per word) or a [W/3]
        constant row; syms_base is the symbol-index base (multiple of 3)."""
        m = mask[:, None]
        ck["count"] = ck["count"].at[:, tbl, :].set(
            jnp.where(m, count, ck["count"][:, tbl, :]))
        ck["first"] = ck["first"].at[:, tbl, :].set(
            jnp.where(m, first, ck["first"][:, tbl, :]))
        ck["offs"] = ck["offs"].at[:, tbl, :].set(
            jnp.where(m, offs, ck["offs"][:, tbl, :]))
        wb = syms_base // 3
        w = syms_packed.shape[-1]
        ck["syms"] = ck["syms"].at[:, wb : wb + w].set(
            jnp.where(m, syms_packed, ck["syms"][:, wb : wb + w]))
        ml = jnp.max(jnp.arange(16, dtype=I32)[None, :] * (count > 0),
                     axis=-1)
        ck["maxlen"] = ck["maxlen"].at[:, tbl].set(
            jnp.where(mask, ml, ck["maxlen"][:, tbl]))
        return ck

    def build_cl(args):
        ck, st = args
        mask = nb == 1
        cl_lens = _unpack_cl(st["cl_lo"], st["cl_hi"])
        cnt, first, offs, syms, oversub = tables.build_canonical(cl_lens)
        ck = set_table(dict(ck), 0, mask, cnt, first, offs + tables.CL_BASE,
                       tables.pack_syms(syms, 24), tables.CL_BASE)
        bad = mask & oversub
        ok = mask & ~oversub
        st = dict(st)
        st["status"] = jnp.where(bad, Result.ERR, st["status"])
        st["state"] = jnp.where(bad, S_ERR,
                                jnp.where(ok, S_LENS, st["state"]))
        st["idx"] = jnp.where(ok, 0, st["idx"])
        st["prev"] = jnp.where(ok, 0, st["prev"])
        st["lens_pk"] = jnp.where(mask[None, :], U32(0), st["lens_pk"])
        return ck, st

    def build_litdist(args):
        ck, st = args
        mask = nb == 2
        lens = _unpack_lens(st["lens_pk"], 320)
        pos288 = jnp.arange(288, dtype=I32)[None, :]
        lit_lens = jnp.where(pos288 < st["hlit"][:, None], lens[:, :288], 0)
        cnt, first, offs, syms, over_l = tables.build_canonical(lit_lens)
        ck = set_table(dict(ck), 1, mask, cnt, first, offs + tables.LIT_BASE,
                       tables.pack_syms(syms, 288), tables.LIT_BASE)

        # distance lengths start at per-lane hlit: extract nibble hlit+k
        # straight from the packed words via a 40-word one-hot (the naive
        # [N,320,32] formulation materialises 42MB per build)
        k32 = jnp.arange(32, dtype=I32)[None, :]
        nib = st["hlit"][:, None] + k32            # [N, 32] nibble index
        wsel = jnp.arange(LENS_WORDS, dtype=I32)[None, None, :]
        word = jnp.sum(
            jnp.where(wsel == (nib >> 3)[:, :, None],
                      st["lens_pk"].T[:, None, :], U32(0)), axis=2)
        dist_lens = ((word >> (U32(4) * (nib & 7).astype(U32))) &
                     U32(0xF)).astype(I32)
        dist_lens = jnp.where(k32 < st["hdist"][:, None], dist_lens, 0)
        cntd, firstd, offsd, symsd, over_d = tables.build_canonical(dist_lens)
        ck = set_table(ck, 2, mask, cntd, firstd, offsd + tables.DIST_BASE_,
                       tables.pack_syms(symsd, 36), tables.DIST_BASE_)

        no_eob = lens[:, 256] == 0  # a block needs a real EOB code
        bad = mask & (over_l | over_d | no_eob)
        ok = mask & ~bad
        st = dict(st)
        st["status"] = jnp.where(bad, Result.ERR, st["status"])
        st["state"] = jnp.where(bad, S_ERR,
                                jnp.where(ok, S_SYM, st["state"]))
        return ck, st

    def build_fixed(args):
        ck, st = args
        mask = nb == 3
        ck = set_table(dict(ck), 1, mask,
                       _FX_LIT_COUNT[None, :], _FX_LIT_FIRST[None, :],
                       _FX_LIT_OFFS[None, :], _FX_LIT_SYMS[None, :],
                       tables.LIT_BASE)
        ck = set_table(ck, 2, mask,
                       _FX_DIST_COUNT[None, :], _FX_DIST_FIRST[None, :],
                       _FX_DIST_OFFS[None, :], _FX_DIST_SYMS[None, :],
                       tables.DIST_BASE_)
        st = dict(st)
        st["state"] = jnp.where(mask, S_SYM, st["state"])
        return ck, st

    def run(args):
        ck, st = args
        ck, st = jax.lax.cond(jnp.any(nb == 1), build_cl,
                              lambda a: a, (ck, st))
        ck, st = jax.lax.cond(jnp.any(nb == 2), build_litdist,
                              lambda a: a, (ck, st))
        ck, st = jax.lax.cond(jnp.any(nb == 3), build_fixed,
                              lambda a: a, (ck, st))
        st = dict(st)
        st["need_build"] = jnp.zeros_like(nb)
        return ck, st

    # Builds are batched: run only once enough lanes are waiting (they sit
    # in S_WAIT meanwhile), or when every remaining runnable lane is
    # waiting — amortises the argsort passes without ever deadlocking.
    n_wait = jnp.sum((nb > 0).astype(I32))
    runnable = (st["status"] == STATUS_RUNNING) & (st["state"] != S_WAIT)
    do_build = (n_wait > 0) & (
        (n_wait >= nb.shape[0] // 16) | ~jnp.any(runnable))
    return jax.lax.cond(do_build, run, lambda a: a, (ck, st))


# ---------------------------------------------------------------------------
# one lockstep step
# ---------------------------------------------------------------------------

def _step(st, ck, small, small_base, nbits, cap, limit, dict_reach,
          has_dict, in_base):
    s = st["state"]
    N = s.shape[0]

    # ---- input window extraction (elementwise) ----
    # the mini-window `small` [N, SMALL] was extracted for this step; a
    # lane whose cursor left it (only stored-block jumps) stalls until
    # the next refill.
    off = (st["bitpos"] >> 5) - small_base
    win_miss = (off < 0) | (off > SMALL - 5)
    w = _pick_words(small, off, 5)
    w0, w1, w2 = w[0], w[1], w[2]
    b = st["bitpos"] & 31
    peek = _window32(w0, w1, b)
    peek_i = peek.astype(I32)
    avail = nbits - st["bitpos"]

    consume = jnp.zeros_like(s)
    nstate = s
    token = jnp.zeros((N,), U32)
    status = st["status"]
    final = st["final"]
    hlit, hdist, hclen = st["hlit"], st["hdist"], st["hclen"]
    idx, prev = st["idx"], st["prev"]
    dst_pos = st["dst_pos"]
    need_build = st["need_build"]
    cl_lo, cl_hi = st["cl_lo"], st["cl_hi"]
    resume_state = st["resume_state"]

    stalled = jnp.zeros((N,), bool)
    # lanes whose window no longer covers the cursor idle until the next
    # chunk-boundary refill (only stored-block jumps land here); S_STORED
    # itself never reads the window.
    blocked = win_miss & (s != S_STORED) & (s < S_DONE) & (s != S_WAIT)

    def act(mask):
        return mask & ~blocked

    # ---- S_ZHDR ----
    m = act(s == S_ZHDR)
    cmf = peek_i & 0xFF
    flg = (peek_i >> 8) & 0xFF
    zok = ((cmf & 0xF) == C.ZLIB_CM_DEFLATE) & ((cmf >> 4) <= C.ZLIB_MAX_CINFO) \
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
    m = act(s == S_DICTID)
    enough = avail >= 32
    nstate = jnp.where(m & enough, S_BHDR, nstate)
    consume = jnp.where(m & enough, 32, consume)
    stalled = stalled | (m & ~enough)

    # ---- S_BHDR ----
    m = act(s == S_BHDR)
    # speculative split decode (runtime/large.py): a lane reaching its
    # bit limit at a block boundary is DONE — its segment is complete
    at_lim = m & (st["bitpos"] >= limit)
    m = m & ~at_lim
    nstate = jnp.where(at_lim, S_DONE, nstate)
    enough = avail >= 3
    bf = peek_i & 1
    bt = (peek_i >> 1) & 3
    bh_next = jnp.where(bt == 0, S_STORED_HDR,
                        jnp.where(bt == 1, S_WAIT,
                                  jnp.where(bt == 2, S_CLEN_HDR, S_ERR)))
    ok = m & enough
    nstate = jnp.where(ok, bh_next, nstate)
    consume = jnp.where(ok & (bt != 3), 3, consume)
    final = jnp.where(ok, bf, final)
    need_build = jnp.where(ok & (bt == 1), 3, need_build)
    stalled = stalled | (m & ~enough)

    # ---- S_STORED_HDR: byte-align ----
    m = act(s == S_STORED_HDR)
    pad = (-st["bitpos"]) & 7
    nstate = jnp.where(m, S_STORED_LEN, nstate)
    consume = jnp.where(m, pad, consume)

    # ---- S_STORED_LEN ----
    m = act(s == S_STORED_LEN)
    enough = avail >= 32
    slen = peek_i & 0xFFFF
    snlen = (peek_i >> 16) & 0xFFFF
    lok = slen == (~snlen & 0xFFFF)  # ≙ LEN==~NLEN check (infl.c:118)
    end_next = jnp.where(final > 0, S_DONE, S_BHDR)
    nstate = jnp.where(m & enough,
                       jnp.where(~lok, S_ERR,
                                 jnp.where(slen == 0, end_next, S_STORED)),
                       nstate)
    consume = jnp.where(m & enough & lok, 32, consume)
    idx = jnp.where(m & enough & lok, slen, idx)
    stalled = stalled | (m & ~enough)

    # ---- S_STORED: emit stored-run tokens (reads no window bits) ----
    m = s == S_STORED
    space = cap - dst_pos
    run = jnp.minimum(jnp.minimum(idx, STORED_MAX_RUN), space)
    run_avail = jnp.minimum(run, avail >> 3)
    is_full = m & (space == 0)
    can = m & (space > 0) & (run_avail > 0)
    starv = m & (space > 0) & (run_avail <= 0)
    # offsets are relative to the lane's input base (nonzero only in
    # shared-input split decode, where bitpos is a global stream
    # position and the 22-bit token field must stay segment-relative)
    off_bytes = ((st["bitpos"] >> 3) - in_base).astype(U32)
    token = jnp.where(can,
                      (U32(TOK_STORED) << U32(30))
                      | ((run_avail.astype(U32) - U32(1)) << U32(22))
                      | off_bytes,
                      token)
    consume = jnp.where(can, run_avail << 3, consume)
    dst_pos = jnp.where(can, dst_pos + run_avail, dst_pos)
    idx = jnp.where(can, idx - run_avail, idx)
    done_run = can & (idx == 0)  # idx is post-decrement here
    nstate = jnp.where(done_run, end_next, nstate)
    nstate = jnp.where(is_full, S_FULL, nstate)
    status = jnp.where(is_full, Result.EFULL, status)
    resume_state = jnp.where(is_full, s, resume_state)
    stalled = stalled | starv

    # ---- S_CLEN_HDR ----
    m = act(s == S_CLEN_HDR)
    enough = avail >= 14
    h_lit = 257 + (peek_i & 31)
    h_dist = 1 + ((peek_i >> 5) & 31)
    h_clen = 4 + ((peek_i >> 10) & 15)
    hok = (h_lit <= 286) & (h_dist <= 30)
    ok = m & enough
    nstate = jnp.where(ok, jnp.where(hok, S_CLEN_LENS, S_ERR), nstate)
    consume = jnp.where(ok & hok, 14, consume)
    hlit = jnp.where(ok & hok, h_lit, hlit)
    hdist = jnp.where(ok & hok, h_dist, hdist)
    hclen = jnp.where(ok & hok, h_clen, hclen)
    idx = jnp.where(ok & hok, 0, idx)
    cl_lo = jnp.where(ok & hok, U32(0), cl_lo)
    cl_hi = jnp.where(ok & hok, U32(0), cl_hi)
    stalled = stalled | (m & ~enough)

    # ---- S_CLEN_LENS: 3-bit lengths into packed lane scalars ----
    m = act(s == S_CLEN_LENS)
    enough = avail >= 3
    ok = m & enough
    ordi = _ord_arith(jnp.clip(idx, 0, 18))
    v3 = (peek & U32(7))
    sh = (3 * ordi).astype(U32)
    cl_lo = jnp.where(ok & (ordi < 10), cl_lo | (v3 << (sh & U32(31))), cl_lo)
    cl_hi = jnp.where(ok & (ordi >= 10),
                      cl_hi | (v3 << ((sh - U32(30)) & U32(31))), cl_hi)
    idx2 = idx + 1
    fin_cl = ok & (idx2 >= hclen)
    consume = jnp.where(ok, 3, consume)
    idx = jnp.where(ok, idx2, idx)
    need_build = jnp.where(fin_cl, 1, need_build)
    nstate = jnp.where(fin_cl, S_WAIT, nstate)
    stalled = stalled | (m & ~enough)

    # ---- canonical decode (primary) for S_LENS / S_SYM ----
    dec_mask = act((s == S_LENS) | (s == S_SYM))
    is_cl_tbl = s == S_LENS
    no_tbl = jnp.zeros_like(is_cl_tbl)
    sym, clen, found = _canonical_decode(ck, peek, is_cl_tbl, no_tbl)
    ml1 = jnp.where(is_cl_tbl, ck["maxlen"][:, 0], ck["maxlen"][:, 1])
    dec_stall = dec_mask & ((~found & (avail < ml1)) | (found & (clen > avail)))
    dec_err = dec_mask & ~found & (avail >= ml1)
    dec_ok = dec_mask & found & (clen <= avail) & ~dec_err
    stalled = stalled | dec_stall
    nstate = jnp.where(dec_err, S_ERR, nstate)

    # ---- S_LENS: one codelen symbol -> packed lens nibbles ----
    m = (s == S_LENS) & dec_ok
    is_lit_len = sym < 16
    is16 = sym == 16
    is17 = sym == 17
    is18 = sym == 18
    ebits = jnp.where(is16, 2, jnp.where(is17, 3, jnp.where(is18, 7, 0)))
    lens_stall = m & (clen + ebits > avail)
    stalled = stalled | lens_stall
    m = m & ~lens_stall
    ev = extract(peek, clen, ebits).astype(I32)
    rep = jnp.where(is_lit_len, 1,
                    jnp.where(is16, 3 + ev, jnp.where(is17, 3 + ev, 11 + ev)))
    wval = jnp.where(is_lit_len, sym, jnp.where(is16, prev, 0))
    total = hlit + hdist
    bad16 = is16 & (idx == 0)
    over = idx + rep > total
    lerr = m & (bad16 | over)
    lok2 = m & ~(bad16 | over)
    nstate = jnp.where(lerr, S_ERR, nstate)
    lens_pk = _write_lens_run(st["lens_pk"], lok2 & (wval > 0),
                              idx, idx + rep, wval)
    consume = jnp.where(lok2, clen + ebits, consume)
    prev = jnp.where(lok2 & is_lit_len, sym,
                     jnp.where(lok2 & (is17 | is18), 0, prev))
    idx = jnp.where(lok2, idx + rep, idx)
    fin_lens = lok2 & (idx == total)
    need_build = jnp.where(fin_lens, 2, need_build)
    nstate = jnp.where(fin_lens, S_WAIT, nstate)

    # ---- S_SYM: literal / EOB / whole match, one lockstep step ----------
    # A secondary canonical decode runs on a fresh 32-bit window past the
    # primary symbol: the *distance* code for matches, or a second literal
    # for literal runs (packed into one LIT-pair token).  (≙ the
    # reference's literal-run unrolling + fused extra-bit consume,
    # infl.c:755-774.)
    m = (s == S_SYM) & dec_ok
    is_lit1 = m & (sym < 256)
    is_eob = m & (sym == 256)
    is_len = m & (sym > 256) & (sym <= 285)
    sym_err = m & (sym > 285)

    len_v, leb = _length_from_sym(sym, peek, clen)
    consumed1 = clen + jnp.where(is_len, leb, 0)

    b2 = b + consumed1            # 0..51 within (w0,w1,w2)
    w0b = jnp.where(b2 >= 32, w1, w0)
    w1b = jnp.where(b2 >= 32, w2, w1)
    peek2 = _window32(w0b, w1b, b2 & 31)
    avail2 = avail - consumed1
    sym2, clen2, found2 = _canonical_decode(ck, peek2, no_tbl, is_len)

    # match path
    dv, deb = _dist_from_sym(sym2, peek2, clen2)
    consumed2 = clen2 + deb
    ml2 = ck["maxlen"][:, 2]
    d_stall = is_len & ((~found2 & (avail2 < ml2))
                        | (found2 & (consumed2 > avail2)))
    d_err = is_len & ~d_stall & (
        (found2 & (sym2 > 29)) | (~found2 & (avail2 >= ml2)))
    md = is_len & ~d_stall & ~d_err
    too_far = md & (dv > dst_pos + dict_reach)  # ≙ infl.c:1286
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

    # literal path (second literal rides along when it fits)
    lit_full = is_lit1 & (dst_pos >= cap)
    lit1_ok = is_lit1 & ~lit_full
    lit2_ok = lit1_ok & found2 & (sym2 < 256) & (clen2 <= avail2) \
        & (dst_pos + 1 < cap)
    token = jnp.where(
        lit1_ok,
        (U32(TOK_LIT) << U32(30)) | sym.astype(U32)
        | jnp.where(lit2_ok,
                    U32(TOK_LIT_PAIR_BIT) | (sym2.astype(U32) << U32(8)),
                    U32(0)),
        token)
    consume = jnp.where(lit1_ok, clen + jnp.where(lit2_ok, clen2, 0), consume)
    dst_pos = jnp.where(lit1_ok, dst_pos + 1 + lit2_ok.astype(I32), dst_pos)
    nstate = jnp.where(lit_full, S_FULL, nstate)
    status = jnp.where(lit_full, Result.EFULL, status)
    resume_state = jnp.where(lit_full, s, resume_state)

    # end of block
    consume = jnp.where(is_eob, clen, consume)
    nstate = jnp.where(is_eob, jnp.where(final > 0, S_DONE, S_BHDR), nstate)

    # ---- opportunistic second token (S_SYM continuation) -----------------
    # When token 1 fully succeeded and the lane stays in S_SYM, decode one
    # more symbol in the same lockstep step: a single literal, a whole
    # match, or the EOB.  Every failure mode (insufficient bits, invalid
    # code, capacity, distance) simply DEFERS — nothing is consumed and
    # the next step re-decodes it as a primary token with the full
    # semantics, so no new error paths exist here.
    token2 = jnp.zeros((N,), U32)
    t2 = m_ok | lit1_ok
    b3 = b + consume
    peek3 = _win_at(w, b3)
    avail3 = avail - consume
    sym3, clen3, found3 = _canonical_decode(ck, peek3, no_tbl, no_tbl)
    t2v = t2 & found3 & (clen3 <= avail3)
    is_lit3 = t2v & (sym3 < 256)
    is_eob3 = t2v & (sym3 == 256)
    is_len3 = t2v & (sym3 > 256) & (sym3 <= 285)

    lit3_ok = is_lit3 & (dst_pos < cap)
    token2 = jnp.where(lit3_ok,
                       (U32(TOK_LIT) << U32(30)) | sym3.astype(U32), token2)
    consume = jnp.where(lit3_ok, consume + clen3, consume)
    dst_pos = jnp.where(lit3_ok, dst_pos + 1, dst_pos)

    consume = jnp.where(is_eob3, consume + clen3, consume)
    nstate = jnp.where(is_eob3,
                       jnp.where(final > 0, S_DONE, S_BHDR), nstate)

    len3, leb3 = _length_from_sym(sym3, peek3, clen3)
    c31 = clen3 + jnp.where(is_len3, leb3, 0)
    b4 = b3 + c31
    peek4 = _win_at(w, b4)
    avail4 = avail3 - c31
    sym4, clen4, found4 = _canonical_decode(ck, peek4, no_tbl, is_len3)
    dv4, deb4 = _dist_from_sym(sym4, peek4, clen4)
    c42 = clen4 + deb4
    m4_ok = (is_len3 & found4 & (c42 <= avail4) & (sym4 <= 29)
             & (dv4 <= dst_pos + dict_reach) & (dst_pos + len3 <= cap))
    token2 = jnp.where(
        m4_ok,
        (U32(TOK_MATCH) << U32(30))
        | ((len3 - 3).astype(U32) << U32(21))
        | (dv4 - 1).astype(U32),
        token2)
    consume = jnp.where(m4_ok, consume + c31 + c42, consume)
    dst_pos = jnp.where(m4_ok, dst_pos + len3, dst_pos)

    # ---- stalls & terminals -------------------------------------------------
    status = jnp.where(stalled, Result.UNFINISHED, status)
    status = jnp.where(nstate == S_ERR, Result.ERR, status)
    status = jnp.where(nstate == S_DONE, Result.OK, status)

    out = dict(st)
    out["state"] = nstate
    # `consume` is only nonzero on fully-successful branches: the cursor
    # never moves on a stall, window miss, error, or EFULL halt.
    out["bitpos"] = st["bitpos"] + consume
    out["final"] = final
    out["hlit"], out["hdist"], out["hclen"] = hlit, hdist, hclen
    out["idx"], out["prev"] = idx, prev
    out["dst_pos"] = dst_pos
    out["status"] = status
    out["need_build"] = need_build
    out["cl_lo"], out["cl_hi"] = cl_lo, cl_hi
    out["lens_pk"] = lens_pk
    out["resume_state"] = resume_state
    return out, (token, token2)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("T", "K", "dict_len", "has_dict",
                                             "shared_input"))
def decode_tokens(words, nbits, zflag, cap, *, T: int, K: int = 128,
                  dict_len: int = 0, has_dict: bool = False, carry=None,
                  limit=None, start_bit=None, dict_reach=None,
                  shared_input: bool = False, in_base=None):
    """Run the lockstep decoder for up to T steps.

    words: uint32 [N, W] packed streams;  nbits/zflag/cap: int32 [N].
    dict_reach: optional int32 [N] per-lane back-reference reach before
    position 0 (overrides the static dict_len; used by the speculative
    split decode where the stream-head lane must have reach 0 so
    distance-too-far validation matches the serial engines).
    shared_input: every lane reads the SAME stream (words is [1, W] or
    [W]); bitpos/start_bit/limit/nbits are then global stream positions
    and `in_base` (int32 [N], byte units) rebases stored-token offsets
    to each lane's segment (runtime/large.py split decode).
    Returns (tokens [T, N] uint32, carry dict).

    The returned carry is the complete resumable decoder state — the
    device analog of the reference's `unz__stream_t` (src/common.h:150).
    Pass it back (with more input packed into `words`/`nbits`, and
    UNFINISHED/EFULL lanes revived via `revive_carry`) to continue a
    streaming decode exactly where it stopped; token buffers from
    successive calls concatenate along axis 0 for resolution.
    """
    N = nbits.shape[0]
    if limit is None:
        limit = jnp.full((N,), 1 << 30, I32)  # never reached
    if dict_reach is None:
        dict_reach = jnp.full((N,), dict_len, I32)
    if in_base is None:
        in_base = jnp.zeros((N,), I32)
    if carry is None:
        st = _init_scan_state(N)
        ck = _init_chunk_state(N)
        st["state"] = jnp.where(zflag > 0, S_ZHDR, S_BHDR)
        if start_bit is not None:
            # split decode: lanes may begin mid-byte (runtime/large.py)
            st["bitpos"] = jnp.asarray(start_bit, I32)
    else:
        st = {k: carry[k] for k in _init_scan_state(1)}
        ck = {k: carry[k] for k in _init_chunk_state(1)}
        # windows may be stale relative to regrown input
        ck = dict(ck)
        ck["win_word"] = jnp.full((N,), -(10 * WIN), I32)

    # input pre-split into exact int8 byte planes, tiled by aligned
    # segment (consumed by the one-hot window refill — _split_planes)
    if shared_input:
        body = words.reshape(-1)
        S = (body.shape[0] + SEG - 1) // SEG
        bpad = jnp.pad(body, (0, S * SEG - body.shape[0]))
        words_p = tuple(p.reshape(S, SEG) for p in _split_planes(bpad))
        refill_windows = _refill_windows_shared
    else:
        W = words.shape[1]
        S = (W + SEG - 1) // SEG
        wpad = jnp.pad(words, ((0, 0), (0, S * SEG - W)))
        words_p = tuple(p.reshape(N, S, SEG) for p in _split_planes(wpad))
        refill_windows = _refill_windows

    # two token slots per step: the step budget is T//2, keeping the
    # token buffer at ~T slots (valid streams emit >=2 tokens per symbol
    # step on average; pathological ones fall back to the host engine)
    n_steps = max(K, T // 2)
    n_chunks = (n_steps + K - 1) // K
    tokbuf = jnp.zeros((n_chunks * K * 2, N), U32)

    def chunk_active(carry):
        ci, st, ck, tokbuf = carry
        return (ci < n_chunks) & jnp.any(st["status"] == STATUS_RUNNING)

    def chunk_body(carry):
        ci, st, ck, tokbuf = carry
        ck = refill_windows(ck, st, words_p)
        ck, st = _apply_builds(ck, st)

        def sbody(st, _):
            # one lockstep step (chaining several steps in one body makes
            # XLA:CPU's loop fusions duplicate the producer graph)
            loc0 = jnp.clip((st["bitpos"] >> 5) - ck["win_word"],
                            0, WIN - SMALL)
            small = _extract_small(ck["win"], loc0)
            small_base = ck["win_word"] + loc0
            st, (tok, tok2) = _step(st, ck, small, small_base, nbits, cap,
                                    limit, dict_reach, has_dict, in_base)
            return st, jnp.stack([tok, tok2])  # [2, N]

        st, toks = jax.lax.scan(sbody, st, None, length=K)
        toks = toks.reshape(2 * K, toks.shape[-1])
        tokbuf = jax.lax.dynamic_update_slice(tokbuf, toks, (ci * 2 * K, 0))
        return ci + 1, st, ck, tokbuf

    ci, st, ck, tokbuf = jax.lax.while_loop(
        chunk_active, chunk_body, (jnp.asarray(0, I32), st, ck, tokbuf))
    # return every emitted slot (2 per step): truncating to T would
    # silently drop tokens from lanes that finish late.  tok_rows bounds
    # the occupied rows so callers can fetch only what was written.
    return tokbuf, {**st, **ck, "tok_rows": ci * 2 * K}


def revive_carry(carry, new_cap=None):
    """Prepare a decoder carry for resumption: UNFINISHED lanes (and, when
    `new_cap` raises their budget, EFULL lanes via their saved
    resume_state — ≙ infl_resize_output-then-continue, mem.c:277-288)
    go back to RUNNING."""
    carry = dict(carry)
    st_status = carry["status"]
    carry["status"] = jnp.where(st_status == Result.UNFINISHED,
                                STATUS_RUNNING, st_status)
    if new_cap is not None:
        efull = st_status == Result.EFULL
        carry["status"] = jnp.where(efull, STATUS_RUNNING, carry["status"])
        carry["state"] = jnp.where(efull, carry["resume_state"],
                                   carry["state"])
    return carry
