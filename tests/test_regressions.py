"""Regression tests for cross-engine behaviour fixes (round-2 advice).

Covers:
- native deflate: flush landing exactly at end-of-input must not emit a
  duplicate final block (defl_host.cc block-token flush).
- invalid-vs-need-input decision gated on the table's actual max code
  length: all engines must return ERR (not UNFINISHED) once maxlen bits
  are available and no code matches (≙ core/oracle.py _decode_symbol).
- device_inflate with no declared capacity must deliver full output for
  high-ratio streams (EFULL lanes re-run via the host engine).
- native FLAG_VERIFY_ADLER32 trailer check.
"""

import zlib

import numpy as np
import pytest

from defl_jax.core.oracle import inflate_oracle
from defl_jax.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, Result
from defl_jax.runtime import native
from tests.gendata import BitWriter

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native library unavailable")


def _unique_trigram_bytes(n: int) -> bytes:
    """n bytes with no repeated 3-gram: encodes as all-literal tokens."""
    out = bytearray()
    i = 0
    while len(out) < n:
        out += bytes(((i >> 8) & 0xFF, i & 0xFF))
        i += 1
    return bytes(out[:n])


@needs_native
@pytest.mark.parametrize("n", [16384, 32768, 16384 * 3])
def test_deflate_block_boundary_no_duplicate_final(n):
    # Token count an exact multiple of the 16384-token block flush: the
    # mid-loop flush must never finalize, or a second empty final block
    # lands between the real final block and the adler trailer.
    data = _unique_trigram_bytes(n)
    comp = native.native_deflate(data, level=6, flags=FLAG_ZLIB)
    assert zlib.decompress(comp) == data


def _incomplete_code_truncated() -> bytes:
    """Raw-deflate stream: dynamic block whose litlen table assigns only
    two 2-bit codes (incomplete tree, legal), then data bits that land in
    the unassigned '11' prefix.  maxlen=2, so with >=2 bits available this
    is a hard ERR -- engines gating on 15 bits would wrongly wait."""
    w = BitWriter().bits(1, 1).bits(2, 2)    # final, dynamic
    w.bits(0, 5)                             # HLIT  = 257
    w.bits(0, 5)                             # HDIST = 1
    w.bits(18 - 4, 4)                        # HCLEN = 18 (covers sym 1)
    # codelen lens over order 16 17 18 0 8 7 9 6 10 5 11 4 12 3 13 2 14 1:
    cl = {16: 0, 17: 0, 18: 2, 0: 2, 8: 0, 7: 0, 9: 0, 6: 0, 10: 0,
          5: 0, 11: 0, 4: 0, 12: 0, 3: 0, 13: 0, 2: 2, 14: 0, 1: 0}
    for s in (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1):
        w.bits(cl[s], 3)
    # canonical codelen codes (all len 2): 0->00, 2->01, 18->10
    C0, C2, C18 = 0b00, 0b01, 0b10
    # litlen lens: sym 88 -> 2, sym 256 -> 2, everything else 0
    w.code(C18, 2).bits(88 - 11, 7)          # 88 zeros
    w.code(C2, 2)                            # sym 88: len 2
    w.code(C18, 2).bits(138 - 11, 7)         # zeros 89..226
    w.code(C18, 2).bits(29 - 11, 7)          # zeros 227..255
    w.code(C2, 2)                            # sym 256: len 2
    # distance table: one entry, len 2 (incomplete, unused)
    w.code(C2, 2)
    # data: litlen canonical codes are 88->00, 256->01; '11' is unassigned
    w.code(3, 2)
    return w.getvalue()


def test_invalid_code_vs_need_input_oracle():
    r, _ = inflate_oracle(_incomplete_code_truncated(), flags=0)
    assert r is Result.ERR


@needs_native
def test_invalid_code_vs_need_input_native():
    r, _ = native.native_inflate(_incomplete_code_truncated(), 64, flags=0)
    assert r is Result.ERR


@pytest.mark.needs_jax
def test_invalid_code_vs_need_input_device():
    from defl_jax.runtime.session import device_inflate

    res, _, _ = device_inflate([_incomplete_code_truncated()], flags=0,
                               dst_capacities=64)
    assert res[0] is Result.ERR


@pytest.mark.needs_jax
def test_no_capacity_high_ratio_full_output():
    # ratio > 64x: the generous-cap guess EFULLs on device; the lane must
    # resume ON DEVICE via revive_carry with a grown budget (≙
    # infl_resize_output-then-continue, mem.c:277-288) — zero host
    # fallbacks — and deliver the complete output.
    from defl_jax.runtime.session import device_inflate

    raw = b"\0" * 100_000
    res, outs, stats = device_inflate([zlib.compress(raw)],
                                      dst_capacities=None)
    assert res[0] is Result.OK
    assert outs[0] == raw
    assert stats["host_fallbacks"] == []


@needs_native
def test_native_adler_verify():
    data = b"adler verified payload " * 40
    comp = bytearray(zlib.compress(data))
    fl = FLAG_ZLIB | FLAG_VERIFY_ADLER32
    r, out = native.native_inflate(bytes(comp), len(data), flags=fl)
    assert r is Result.OK and out == data
    comp[-1] ^= 0xFF                        # corrupt the trailer
    r, _ = native.native_inflate(bytes(comp), len(data), flags=fl)
    assert r is Result.ERR
    r, _ = native.native_inflate(bytes(comp[:-2]), len(data), flags=fl)
    assert r is Result.UNFINISHED


@pytest.mark.needs_jax
def test_shared_refill_window_words_exact():
    # the shared-input refill's one-hot contraction is a plain matmul;
    # when it ran on f32 16-bit halves, default XLA dot precision
    # truncated them to bf16 and silently corrupted every window word
    # (round-3 regression: 100% of split-decode lanes ERRed ~8 bits in,
    # masked by the span fallback).  Round 5 moved the contraction to
    # int8 byte planes (integer dot — exact by definition); this test
    # still pins the invariant: windows must reproduce the body words
    # bit-exactly through whatever the refill's plane format is.
    import jax.numpy as jnp

    from defl_jax.ops import inflate_batch as ib

    rng = np.random.default_rng(0)
    W = 220_000
    body = rng.integers(0, 1 << 32, W, dtype=np.uint32)
    S = (W + ib.SEG - 1) // ib.SEG
    bpad = np.zeros(S * ib.SEG + ib.WIN, np.uint32)
    bpad[:W] = body
    planes = tuple(p.reshape(S, ib.SEG) for p in
                   ib._split_planes(jnp.asarray(bpad[: S * ib.SEG])))
    pos = np.array([0, W // 3, W // 2, W - 2 * ib.WIN], np.int64)
    st = {"bitpos": jnp.asarray(pos * 32, jnp.int32),
          "status": jnp.full(4, int(ib.STATUS_RUNNING), jnp.int32)}
    ck = {"win": jnp.zeros((4, ib.WIN), jnp.uint32),
          "win_word": jnp.full((4,), -(10 * ib.WIN), jnp.int32),
          "rr": jnp.zeros((4,), jnp.int32)}
    ck2 = ib._refill_windows_shared(ck, st, planes)
    win = np.asarray(ck2["win"])
    ww = np.asarray(ck2["win_word"])
    for n in range(4):
        assert ww[n] <= pos[n] < ww[n] + ib.WIN
        np.testing.assert_array_equal(win[n], bpad[ww[n] : ww[n] + ib.WIN])


@needs_native
def test_resolver_literal_on_last_row_byte():
    # round-4 regression: the adversarial-token containment bounded
    # literal tokens by the PAIR width (p + 2 > row_cap), truncating the
    # final byte of any capacity-exact lane whose last token is a single
    # literal (1638/8192 bench lanes).  Bound by the token's actual width.
    from defl_jax.runtime.native import native_resolve_tokens

    C = 64
    # 62 bytes via 31 pair-literals, a single literal at byte 62, then
    # the failing case: a single literal landing exactly on byte 63 (the
    # last row byte, p + 2 > row_cap but p + 1 == row_cap)
    toks = [(1 << 30) | (1 << 16) | (0x41 << 8) | 0x42] * 31
    toks += [(1 << 30) | 0x59, (1 << 30) | 0x5A]
    tokens = np.asarray([toks], np.uint32)
    dst_len = np.asarray([64], np.int32)
    out = native_resolve_tokens(tokens, np.zeros((1, 4), np.uint32),
                                dst_len, C)
    assert out[0].tobytes() == b"BA" * 31 + b"YZ"
