"""Direct canonical-Huffman layer tests.

≙ the reference's direct huff-API tests (test_huff_error_conditions,
test/test_files.c:546-615): length>15 rejection, oversubscribed trees,
canonical ordering — plus encode-side code assignment and length-limited
construction, and the vectorised device builder against the host one.
"""

import numpy as np
import pytest

from defl_jax.core import huffman


def test_reject_length_over_15():
    assert huffman.build_decode([1, 16]) is None  # ≙ infl.c:469


def test_reject_oversubscribed():
    # three 1-bit codes: Kraft sum 1.5 > 1
    assert huffman.build_decode([1, 1, 1]) is None  # ≙ infl.c:485-490


def test_incomplete_tree_accepted():
    code = huffman.build_decode([2, 2, 2])  # Kraft sum 0.75
    assert code is not None
    assert code.num_symbols == 3


def test_canonical_ordering():
    # RFC1951 example: lengths (3,3,3,3,3,2,4,4) for A..H
    lens = [3, 3, 3, 3, 3, 2, 4, 4]
    codes = huffman.assign_codes(lens)
    assert list(codes) == [0b010, 0b011, 0b100, 0b101, 0b110,
                           0b00, 0b1110, 0b1111]
    dec = huffman.build_decode(lens)
    # decode each code back to its symbol via the sorted-symbol form
    for sym, (c, l) in enumerate(zip(codes, lens)):
        off = c - int(dec.first_code[l])
        assert 0 <= off < int(dec.count[l])
        assert int(dec.sorted_syms[int(dec.offset[l]) + off]) == sym


def test_limited_lengths_respect_bound_and_kraft():
    rng = np.random.default_rng(5)
    for maxlen, nsym in ((7, 19), (15, 286)):
        freqs = rng.integers(0, 10_000, nsym)
        lens = huffman.limited_code_lengths(freqs, maxlen)
        assert lens.max() <= maxlen
        used = lens[lens > 0]
        kraft = np.sum(2.0 ** (-used.astype(float)))
        assert kraft <= 1.0 + 1e-9
        # every used symbol got a code; every unused symbol got none
        assert np.all((freqs > 0) == (lens > 0))


def test_limited_lengths_single_symbol():
    lens = huffman.limited_code_lengths([0, 7, 0], 15)
    assert list(lens) == [0, 1, 0]


def test_reverse_bits():
    assert huffman.reverse_bits(0b110, 3) == 0b011
    assert huffman.reverse_bits(0b1, 5) == 0b10000


def test_device_builder_matches_host():
    """ops.tables.build_canonical (vectorised) vs core.huffman (host)."""
    import jax.numpy as jnp

    from defl_jax.ops import tables

    rng = np.random.default_rng(9)
    batch = []
    for _ in range(6):
        freqs = rng.integers(0, 100, 60)
        lens = huffman.limited_code_lengths(freqs, 15)
        batch.append(np.pad(lens, (0, 64 - lens.size)))
    arr = jnp.asarray(np.stack(batch).astype(np.int32))
    cnt, first, offs, syms, oversub = tables.build_canonical(arr)
    cnt, first, offs, syms, oversub = (np.asarray(x) for x in
                                       (cnt, first, offs, syms, oversub))
    for i, lens in enumerate(batch):
        ref = huffman.build_decode(lens)
        assert not oversub[i]
        assert list(cnt[i]) == list(ref.count)
        assert list(first[i]) == list(ref.first_code)
        assert list(offs[i]) == list(ref.offset)
        n = ref.sorted_syms.size
        assert list(syms[i][:n]) == list(ref.sorted_syms)


def test_device_builder_flags_oversubscription():
    import jax.numpy as jnp

    from defl_jax.ops import tables

    lens = np.zeros((2, 8), np.int32)
    lens[0, :3] = 1          # oversubscribed
    lens[1, :2] = 1          # exactly complete
    _, _, _, _, oversub = tables.build_canonical(jnp.asarray(lens))
    assert bool(np.asarray(oversub)[0]) is True
    assert bool(np.asarray(oversub)[1]) is False
