"""Host reference DEFLATE encoder.

The compress side the reference declares but never implements
(`/root/reference/include/defl/defl.h:17-25`, README TODO "implement
deflate").  Built from scratch: greedy LZ77 hash-chain matching with lazy
evaluation, per-block symbol statistics, and a cheapest-of
{stored, fixed, dynamic} block emitter with length-limited canonical
Huffman trees — the classic zlib-style architecture, written fresh.

This is the host oracle/reference encoder; the batched device encoder
(``defl_jax.ops.deflate_batch``) is tested against it.  Size target
(BASELINE.md): <= zlib level-6 output on the corpus.
"""

from __future__ import annotations

import numpy as np

from defl_jax.constants import (
    CODELEN_ORDER,
    DIST_EXTRA,
    DIST_TO_SYMBOL_NP,
    FIXED_DIST_LENGTHS,
    FIXED_LITLEN_LENGTHS,
    LENGTH_EXTRA,
    LENGTH_TO_SYMBOL_NP,
    LENGTH_BASE,
    DIST_BASE,
    MAX_DIST,
    MAX_MATCH,
    MIN_MATCH,
)
from defl_jax.core import huffman
from defl_jax.core.checksums import adler32
from defl_jax.errors import FLAG_ZLIB

_HASH_BITS = 15
_HASH_MASK = (1 << _HASH_BITS) - 1

#: per-level (max_chain, lazy, nice_length) — the usual speed/ratio knobs.
_LEVELS = {
    1: (8, False, 16),
    2: (16, False, 32),
    3: (32, False, 64),
    4: (48, True, 64),
    5: (96, True, 128),
    6: (192, True, 258),
    7: (384, True, 258),
    8: (1024, True, 258),
    9: (4096, True, 258),
}


def _hash3(data: bytes, i: int) -> int:
    return ((data[i] << 10) ^ (data[i + 1] << 5) ^ data[i + 2]) & _HASH_MASK


def lz77_tokens(data: bytes, level: int = 6, dict_len: int = 0):
    """Greedy+lazy hash-chain matcher.

    ``data`` may start with ``dict_len`` preset-dictionary bytes; emitted
    tokens only cover ``data[dict_len:]`` but matches may reach into the
    dictionary prefix.  Returns a list of int tokens: values < 256 are
    literals; otherwise ``(length << 16) | dist``.
    """
    max_chain, lazy, nice = _LEVELS[max(1, min(9, level))]
    n = len(data)
    tokens: list[int] = []
    if n - dict_len <= 0:
        return tokens

    head = [-1] * (1 << _HASH_BITS)
    prev = [-1] * n
    last_insertable = n - MIN_MATCH + 1  # positions [0, last_insertable) hashable
    ins = 0  # next position to insert into the chains

    def advance_insert(limit: int):
        """Insert every not-yet-inserted position < limit (each exactly
        once — double insertion would self-loop the chain)."""
        nonlocal ins
        stop = min(limit, last_insertable)
        while ins < stop:
            h = _hash3(data, ins)
            prev[ins] = head[h]
            head[h] = ins
            ins += 1

    def longest(i: int, best_in: int) -> tuple[int, int]:
        best = best_in
        best_d = 0
        limit = min(n - i, MAX_MATCH)
        if limit < MIN_MATCH:
            return 0, 0
        lo = i - MAX_DIST
        j = head[_hash3(data, i)]
        chain = max_chain
        while j >= 0 and j >= lo and chain and best < limit:
            chain -= 1
            if j < i and j + best < n and data[j + best] == data[i + best]:
                # slice comparisons run at C speed; extend 16 bytes at a time
                l = 0
                while l + 16 <= limit and data[j + l : j + l + 16] == data[i + l : i + l + 16]:
                    l += 16
                while l < limit and data[j + l] == data[i + l]:
                    l += 1
                if l > best:
                    best, best_d = l, i - j
                    if l >= nice:
                        break
            j = prev[j]
        if best >= MIN_MATCH and best_d:
            return best, best_d
        return 0, 0

    i = dict_len
    while i < n:
        advance_insert(i)
        if i + MIN_MATCH <= n:
            mlen, mdist = longest(i, MIN_MATCH - 1)
        else:
            mlen, mdist = 0, 0

        # One-step lazy evaluation: prefer a strictly longer match at i+1.
        if mlen and lazy and mlen < nice and i + 1 + MIN_MATCH <= n:
            advance_insert(i + 1)
            nlen, ndist = longest(i + 1, mlen)
            if nlen > mlen:
                tokens.append(data[i])
                i += 1
                mlen, mdist = nlen, ndist

        if mlen:
            tokens.append((mlen << 16) | mdist)
            i += mlen
        else:
            tokens.append(data[i])
            i += 1
    return tokens


class _BitPacker:
    """LSB-first bit packer; Huffman codes are written MSB-first
    (RFC 1951 §3.1.1)."""

    __slots__ = ("buf", "acc", "n")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    def bits(self, v: int, nb: int):
        self.acc |= (v & ((1 << nb) - 1)) << self.n
        self.n += nb
        while self.n >= 8:
            self.buf.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def code(self, code: int, nb: int):
        # bit-reverse the MSB-first canonical code into LSB-first order
        r = 0
        c = code
        for _ in range(nb):
            r = (r << 1) | (c & 1)
            c >>= 1
        self.bits(r, nb)

    def align(self):
        if self.n:
            self.buf.append(self.acc & 0xFF)
            self.acc = 0
            self.n = 0

    def getvalue(self) -> bytes:
        out = bytearray(self.buf)
        if self.n:
            out.append(self.acc & 0xFF)
        return bytes(out)


def _rle_code_lengths(lens: list[int]):
    """RFC 1951 §3.2.7 run-length encoding of the litlen+dist length list
    using symbols 16 (copy prev 3-6), 17 (zeros 3-10), 18 (zeros 11-138)."""
    out: list[tuple[int, int, int]] = []  # (symbol, extra_value, extra_bits)
    i = 0
    n = len(lens)
    while i < n:
        v = lens[i]
        run = 1
        while i + run < n and lens[i + run] == v:
            run += 1
        if v == 0:
            r = run
            while r >= 11:
                t = min(r, 138)
                out.append((18, t - 11, 7))
                r -= t
            if r >= 3:
                out.append((17, r - 3, 3))
                r = 0
            for _ in range(r):
                out.append((0, 0, 0))
        else:
            out.append((v, 0, 0))
            r = run - 1
            while r >= 3:
                t = min(r, 6)
                out.append((16, t - 3, 2))
                r -= t
            for _ in range(r):
                out.append((v, 0, 0))
        i += run
    return out


_FIXED_LIT_LENS = list(FIXED_LITLEN_LENGTHS)
_FIXED_DIST_LENS = list(FIXED_DIST_LENGTHS)
_FIXED_LIT_CODES = huffman.assign_codes(_FIXED_LIT_LENS)
_FIXED_DIST_CODES = huffman.assign_codes(_FIXED_DIST_LENS)

_LEN_EXTRA = list(LENGTH_EXTRA)
_DIST_EXTRA = list(DIST_EXTRA)
_LEN_BASE = list(LENGTH_BASE)
_DIST_BASE = list(DIST_BASE)
_LEN2SYM = LENGTH_TO_SYMBOL_NP.tolist()
_DIST2SYM = DIST_TO_SYMBOL_NP.tolist()


def _block_symbols(tokens):
    """Token list -> (litlen_sym, extra_val, extra_bits, dist_sym,
    dist_extra_val, dist_extra_bits) tuples plus frequency tables."""
    lit_freq = np.zeros(286, dtype=np.int64)
    dist_freq = np.zeros(30, dtype=np.int64)
    syms = []
    for t in tokens:
        if t < 256:
            lit_freq[t] += 1
            syms.append((t, 0, 0, -1, 0, 0))
        else:
            length = t >> 16
            dist = t & 0xFFFF
            ls = _LEN2SYM[length]
            ds = _DIST2SYM[dist]
            lit_freq[ls] += 1
            dist_freq[ds] += 1
            syms.append((ls, length - _LEN_BASE[ls - 257], _LEN_EXTRA[ls - 257],
                         ds, dist - _DIST_BASE[ds], _DIST_EXTRA[ds]))
    lit_freq[256] += 1  # EOB
    return syms, lit_freq, dist_freq


def _dynamic_header_plan(lit_lens, dist_lens):
    """Build the code-length-code layer; returns (cost_bits, emit_fn_args)."""
    # last nonzero litlen symbol index + 1, min 257
    last = 0
    for s, l in enumerate(lit_lens):
        if l:
            last = s
    hlit = max(257, last + 1)
    lastd = 0
    for s, l in enumerate(dist_lens):
        if l:
            lastd = s
    hdist = max(1, lastd + 1)

    all_lens = list(lit_lens[:hlit]) + list(dist_lens[:hdist])
    rle = _rle_code_lengths(all_lens)
    cl_freq = np.zeros(19, dtype=np.int64)
    for s, _v, _b in rle:
        cl_freq[s] += 1
    cl_lens = huffman.limited_code_lengths(cl_freq, 7)
    cl_codes = huffman.assign_codes(cl_lens)

    hclen = 19
    while hclen > 4 and cl_lens[CODELEN_ORDER[hclen - 1]] == 0:
        hclen -= 1

    cost = 5 + 5 + 4 + 3 * hclen
    for s, _v, b in rle:
        cost += int(cl_lens[s]) + b
    return cost, (hlit, hdist, hclen, rle, cl_lens, cl_codes)


def _emit_block(w: _BitPacker, tokens, final: bool, raw_bytes: bytes):
    """Emit one block, choosing the cheapest of stored/fixed/dynamic."""
    syms, lit_freq, dist_freq = _block_symbols(tokens)

    lit_lens = huffman.limited_code_lengths(lit_freq, 15)
    if not dist_freq.any():
        dist_lens = np.zeros(30, dtype=np.int32)
        dist_lens[0] = 1  # RFC requires at least one (possibly unused) code
    else:
        dist_lens = huffman.limited_code_lengths(dist_freq, 15)
        if int(np.count_nonzero(dist_lens)) == 1:
            # a lone 1-bit dist code is fine (incomplete tree, per RFC)
            pass
    lit_codes = huffman.assign_codes(lit_lens)
    dist_codes = huffman.assign_codes(dist_lens)

    hdr_cost, hdr = _dynamic_header_plan(lit_lens.tolist(), dist_lens.tolist())
    dyn_cost = hdr_cost + int(np.dot(lit_freq, lit_lens))
    fix_cost = int(np.dot(lit_freq, np.asarray(_FIXED_LIT_LENS[:286])))
    for (ls, _ev, eb, ds, _dev, deb) in syms:
        dyn_cost += eb
        fix_cost += eb
        if ds >= 0:
            dyn_cost += int(dist_lens[ds]) + deb
            fix_cost += 5 + deb
    stored_cost = (8 - 1) + 32 + 8 * len(raw_bytes) + 35 * (len(raw_bytes) // 65535)

    if stored_cost < min(dyn_cost, fix_cost) + 3 and raw_bytes is not None:
        # stored blocks (split at 65535)
        n = len(raw_bytes)
        off = 0
        while True:
            take = min(65535, n - off)
            last_piece = off + take == n
            w.bits(1 if (final and last_piece) else 0, 1)
            w.bits(0, 2)
            w.align()
            w.buf += take.to_bytes(2, "little")
            w.buf += (~take & 0xFFFF).to_bytes(2, "little")
            w.buf += raw_bytes[off : off + take]
            off += take
            if last_piece:
                break
        return

    if dyn_cost + 3 < fix_cost:
        w.bits(1 if final else 0, 1)
        w.bits(2, 2)
        hlit, hdist, hclen, rle, cl_lens, cl_codes = hdr
        w.bits(hlit - 257, 5)
        w.bits(hdist - 1, 5)
        w.bits(hclen - 4, 4)
        for k in range(hclen):
            w.bits(int(cl_lens[CODELEN_ORDER[k]]), 3)
        for s, v, b in rle:
            w.code(int(cl_codes[s]), int(cl_lens[s]))
            if b:
                w.bits(v, b)
        ll, lc, dl, dc = lit_lens, lit_codes, dist_lens, dist_codes
    else:
        w.bits(1 if final else 0, 1)
        w.bits(1, 2)
        ll, lc = _FIXED_LIT_LENS, _FIXED_LIT_CODES
        dl, dc = _FIXED_DIST_LENS, _FIXED_DIST_CODES

    for (ls, ev, eb, ds, dev, deb) in syms:
        w.code(int(lc[ls]), int(ll[ls]))
        if eb:
            w.bits(ev, eb)
        if ds >= 0:
            w.code(int(dc[ds]), int(dl[ds]))
            if deb:
                w.bits(dev, deb)
    w.code(int(lc[256]), int(ll[256]))


#: tokens per emitted block — per-block trees adapt to local statistics.
_BLOCK_TOKENS = 16384


def _emit_zlib_header(w: _BitPacker, dict_: bytes):
    cmf = 0x78  # CM=8, CINFO=7 (32K window)
    flg = 0x80 if dict_ else 0x00  # FLEVEL bits; FDICT if dictionary
    if dict_:
        flg |= 0x20
    rem = ((cmf << 8) | flg) % 31
    if rem:
        flg += 31 - rem
    w.buf.append(cmf)
    w.buf.append(flg)
    if dict_:
        w.buf += adler32(dict_).to_bytes(4, "big")


def _encode_segment(w: _BitPacker, data: bytes, dict_: bytes, level: int,
                    final: bool):
    """Encode `data` as a run of blocks into an existing (possibly
    misaligned) bit packer; matches may reach into `dict_` (the preset
    dictionary or, for streaming, the retained window tail)."""
    tokens = lz77_tokens(dict_ + data, level, len(dict_))
    if not tokens:
        if final:
            w.bits(1, 1)
            w.bits(1, 2)
            w.code(0, 7)  # fixed code for symbol 256
        return
    i = 0
    pos = 0
    while i < len(tokens):
        blk = tokens[i : i + _BLOCK_TOKENS]
        blk_bytes = sum(1 if t < 256 else (t >> 16) for t in blk)
        _emit_block(w, blk, final=final and (i + _BLOCK_TOKENS >= len(tokens)),
                    raw_bytes=data[pos : pos + blk_bytes])
        pos += blk_bytes
        i += _BLOCK_TOKENS


def deflate_oracle(data: bytes, level: int = 6, flags: int = FLAG_ZLIB,
                   dictionary: bytes | None = None) -> bytes:
    """One-shot compress to raw DEFLATE or zlib format."""
    data = bytes(data)
    dict_ = bytes(dictionary) if dictionary else b""
    w = _BitPacker()
    if flags & FLAG_ZLIB:
        _emit_zlib_header(w, dict_)
    _encode_segment(w, data, dict_, level, final=True)
    w.align()
    out = w.getvalue()
    if flags & FLAG_ZLIB:
        out += adler32(data).to_bytes(4, "big")
    return out


class DeflateStream:
    """Streaming compression — the encode-side counterpart of
    `InflateStream` (the reference has neither: defl.h is an empty stub).

    `compress(data)` buffers input and emits complete non-final blocks
    once enough accumulates, keeping a 32KB window tail so matches span
    feed boundaries; `flush()` emits the final block and (zlib mode) the
    adler32 trailer.
    """

    _EMIT_THRESHOLD = 1 << 18  # encode in ~256KB segments

    def __init__(self, level: int = 6, flags: int = FLAG_ZLIB,
                 dictionary: bytes | None = None):
        self.level = level
        self.flags = flags
        self._dict = bytes(dictionary) if dictionary else b""
        self._w = _BitPacker()
        self._pending = bytearray()
        self._window = self._dict[-32768:]
        self._adler = 1
        self._emitted = 0
        self._finished = False
        if flags & FLAG_ZLIB:
            _emit_zlib_header(self._w, self._dict)

    def _drain(self) -> bytes:
        # whole bytes currently in the packer
        out = bytes(self._w.buf[self._emitted :])
        self._emitted = len(self._w.buf)
        return out

    def compress(self, data) -> bytes:
        if self._finished:
            raise ValueError("stream already flushed")
        data = bytes(data)
        self._adler = adler32(data, self._adler)
        self._pending += data
        out = b""
        while len(self._pending) >= self._EMIT_THRESHOLD:
            seg = bytes(self._pending[: self._EMIT_THRESHOLD])
            del self._pending[: self._EMIT_THRESHOLD]
            _encode_segment(self._w, seg, self._window, self.level,
                            final=False)
            self._window = (self._window + seg)[-32768:]
            out += self._drain()
        return out

    def flush(self) -> bytes:
        if self._finished:
            return b""
        self._finished = True
        _encode_segment(self._w, bytes(self._pending), self._window,
                        self.level, final=True)
        self._pending.clear()
        self._w.align()
        out = self._drain()
        if self.flags & FLAG_ZLIB:
            out += int(self._adler).to_bytes(4, "big")
        return out
