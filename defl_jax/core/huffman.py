"""Canonical Huffman codes: validation, decode tables, and code assignment.

The decode-side structures here are the *sorted-symbol / first-code* form —
``(count, first_code, offset, sorted_syms)`` — rather than the flat
expanded lookup tables the reference builds (`infl_ft_build`,
`/root/reference/src/infl/infl.c:452-578`).  On a CPU a big flat table wins
because random loads are cheap; the lockstep vector decode is instead
*tableless*: bit-reverse the peeked window once, then 15 rounds of compare /
select against ``first_code[len]`` (pure vector ALU), with a single small
gather into ``sorted_syms`` at the end.  These structures are exactly what
that kernel consumes (see ``defl_jax.ops.inflate_batch``), and the host
oracle uses the same form so both sides share one validated builder.

Validation semantics match the reference:
- code length > 15 → error (infl.c:469)
- oversubscribed tree (Kraft sum exceeded) → error (infl.c:485-490)
- incomplete trees are *accepted at build time*; hitting an unassigned code
  during decode is the error (the reference leaves such entries invalid).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from defl_jax.constants import MAX_CODE_LENGTH


@dataclass
class CanonicalCode:
    """Decode-side canonical code description.

    Attributes
    ----------
    count : (16,) int32   — number of codes of each length (index = length)
    first_code : (16,) int32 — smallest (MSB-first) code of each length
    offset : (16,) int32  — index into ``sorted_syms`` of the first symbol
                            with that code length
    sorted_syms : (n,) int32 — symbols ordered by (code length, symbol)
    max_len : int         — longest assigned code length (0 if no codes)
    """

    count: np.ndarray
    first_code: np.ndarray
    offset: np.ndarray
    sorted_syms: np.ndarray
    max_len: int

    @property
    def num_symbols(self) -> int:
        return int(self.sorted_syms.shape[0])


def build_decode(lengths) -> CanonicalCode | None:
    """Build decode structures from per-symbol code lengths.

    Returns None for invalid inputs: any length > 15, or an oversubscribed
    tree.  Incomplete trees build successfully (decode flags the error only
    if an unassigned code is actually read), matching the reference.
    """
    lens = np.asarray(lengths, dtype=np.int32)
    if lens.size and int(lens.max(initial=0)) > MAX_CODE_LENGTH:
        return None

    count = np.zeros(MAX_CODE_LENGTH + 1, dtype=np.int32)
    for l in range(1, MAX_CODE_LENGTH + 1):
        count[l] = int(np.count_nonzero(lens == l))

    # Kraft check: `left` is the number of codes still available at each
    # length; going negative means the tree is oversubscribed.
    left = 1
    for l in range(1, MAX_CODE_LENGTH + 1):
        left = (left << 1) - int(count[l])
        if left < 0:
            return None

    first_code = np.zeros(MAX_CODE_LENGTH + 1, dtype=np.int32)
    offset = np.zeros(MAX_CODE_LENGTH + 1, dtype=np.int32)
    code = 0
    off = 0
    max_len = 0
    for l in range(1, MAX_CODE_LENGTH + 1):
        code = (code + int(count[l - 1])) << 1
        first_code[l] = code
        offset[l] = off
        off += int(count[l])
        if count[l]:
            max_len = l

    # Symbols sorted by (length, symbol): for each length, symbols in
    # ascending order — the canonical assignment of RFC 1951 §3.2.2.
    order = np.argsort(lens * 512 + np.arange(lens.size, dtype=np.int32),
                       kind="stable")
    nonzero = order[lens[order] > 0]
    sorted_syms = nonzero.astype(np.int32)

    return CanonicalCode(count, first_code, offset, sorted_syms, max_len)


def assign_codes(lengths) -> np.ndarray:
    """Encode-side: per-symbol canonical code values (MSB-first).

    Symbols with length 0 get code 0 (unused).  RFC 1951 §3.2.2.
    """
    lens = np.asarray(lengths, dtype=np.int32)
    count = np.bincount(lens, minlength=MAX_CODE_LENGTH + 1)
    count[0] = 0
    next_code = np.zeros(MAX_CODE_LENGTH + 2, dtype=np.int64)
    code = 0
    for l in range(1, MAX_CODE_LENGTH + 1):
        code = (code + int(count[l - 1])) << 1
        next_code[l] = code
    codes = np.zeros_like(lens)
    for s in range(lens.size):
        l = int(lens[s])
        if l:
            codes[s] = next_code[l]
            next_code[l] += 1
    return codes


def reverse_bits(value: int, nbits: int) -> int:
    """Bit-reverse the low ``nbits`` of ``value`` (MSB-first code -> LSB-first
    bitstream order, RFC 1951 §3.1.1)."""
    out = 0
    for _ in range(nbits):
        out = (out << 1) | (value & 1)
        value >>= 1
    return out


def limited_code_lengths(freqs, max_len: int) -> np.ndarray:
    """Length-limited Huffman code lengths from symbol frequencies.

    Uses a plain Huffman tree build followed by zlib-style overflow
    adjustment to respect ``max_len`` — the standard approach for DEFLATE's
    15-bit (and 7-bit code-length-alphabet) limits.  Returns one length per
    symbol; unused symbols get 0.  If <=1 symbol is used, the used symbol
    gets length 1 (DEFLATE requires a real code for e.g. the lone EOB).
    """
    import heapq

    f = np.asarray(freqs, dtype=np.int64)
    n = f.size
    used = np.nonzero(f > 0)[0]
    if used.size > (1 << max_len):
        raise ValueError(
            f"{used.size} symbols cannot fit in {max_len}-bit codes")
    lens = np.zeros(n, dtype=np.int32)
    if used.size == 0:
        return lens
    if used.size == 1:
        lens[used[0]] = 1
        return lens

    # Huffman build over (freq, tiebreak, node). Leaves are symbol ids;
    # internal nodes collect children.
    heap = [(int(f[s]), int(s), ("leaf", int(s))) for s in used]
    heapq.heapify(heap)
    tick = n
    while len(heap) > 1:
        fa, _, a = heapq.heappop(heap)
        fb, _, b = heapq.heappop(heap)
        heapq.heappush(heap, (fa + fb, tick, ("node", a, b)))
        tick += 1

    depth_count = np.zeros(64, dtype=np.int64)
    sym_depth: dict[int, int] = {}

    def walk(node, depth):
        stack = [(node, depth)]
        while stack:
            nd, d = stack.pop()
            if nd[0] == "leaf":
                dd = max(d, 1)
                sym_depth[nd[1]] = dd
                depth_count[min(dd, 63)] += 1
            else:
                stack.append((nd[1], d + 1))
                stack.append((nd[2], d + 1))

    walk(heap[0][2], 0)

    # Overflow adjustment (same strategy as zlib's gen_bitlen): move
    # overflowing leaves up to max_len, and push an equal weight of
    # shallower leaves one level down to keep the Kraft sum exact.
    overflow = int(depth_count[max_len + 1 :].sum())
    if overflow:
        depth_count[max_len] += overflow
        depth_count[max_len + 1 :] = 0
        while overflow > 0:
            l = max_len - 1
            while depth_count[l] == 0:
                l -= 1
            depth_count[l] -= 1
            depth_count[l + 1] += 2
            depth_count[max_len] -= 1
            overflow -= 2

        # Reassign lengths: order symbols by (original depth, frequency
        # descending is not required — any assignment with the adjusted
        # depth histogram is a valid prefix code; keep symbols sorted by
        # original depth then symbol id for determinism).
        syms = sorted(sym_depth, key=lambda s: (sym_depth[s], s))
        i = 0
        for l in range(1, max_len + 1):
            for _ in range(int(depth_count[l])):
                lens[syms[i]] = l
                i += 1
        return lens

    for s, d in sym_depth.items():
        lens[s] = d
    return lens
