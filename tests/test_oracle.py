"""Host oracle engine: golden-corpus parity with CPython zlib, chunked and
streaming feeds, EFULL/resize resume, error conditions, accounting.

Mirrors the reference's test strategy (SURVEY §4; test/test_files.c):
corpus round-trip through every input path, plus negative tests.
"""

import zlib

import pytest

from defl_jax.core.oracle import InflateEngine, inflate_oracle
from defl_jax.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, Result
from tests.gendata import BitWriter, compress_variants, edge_streams, make_corpus

CORPUS = make_corpus()


@pytest.fixture(scope="module", params=sorted(CORPUS))
def corpus_item(request):
    raw = CORPUS[request.param]
    return request.param, raw, compress_variants(raw)


def test_contiguous_zlib(corpus_item):
    name, raw, comp = corpus_item
    res, out = inflate_oracle(comp["zlib"], FLAG_ZLIB)
    assert res is Result.OK, name
    assert out == raw


def test_contiguous_raw(corpus_item):
    name, raw, comp = corpus_item
    res, out = inflate_oracle(comp["raw"], 0)
    assert res is Result.OK, name
    assert out == raw


@pytest.mark.parametrize("chunk_size", [1, 3, 8])
def test_chunked_include(chunk_size):
    """≙ test_file_chunked (test/test_files.c:259-331): many tiny
    infl_include chunks, then one-shot decode."""
    for name in ("text", "period_7", "rand_255", "png_simulation"):
        raw = CORPUS[name]
        comp = compress_variants(raw)["zlib"]
        eng = InflateEngine(len(raw) + 16, FLAG_ZLIB)
        for i in range(0, len(comp), chunk_size):
            assert eng.include(comp[i : i + chunk_size]) is Result.OK
        assert eng.step() is Result.OK
        assert bytes(eng.out) == raw


@pytest.mark.parametrize("feed", [1, 64, 1024])
def test_streaming(feed):
    """≙ test_file_streaming (test/test_files.c:688-790): incremental
    feeds returning UNFINISHED until the stream completes."""
    for name in ("json", "period_3", "zeros_65536"):
        raw = CORPUS[name]
        comp = compress_variants(raw)["zlib"]
        eng = InflateEngine(len(raw) + 16, FLAG_ZLIB)
        res = Result.UNFINISHED
        for i in range(0, len(comp), feed):
            eng.include(comp[i : i + feed])
            res = eng.step()
            if res is Result.OK:
                break
            assert res is Result.UNFINISHED
        assert res is Result.OK
        assert bytes(eng.out) == raw


def test_edge_streams():
    for name, (comp, raw) in edge_streams().items():
        res, out = inflate_oracle(comp, 0)
        assert res is Result.OK, name
        assert out == raw, name


def test_efull_resize_resume():
    """≙ infl_resize_output flow (infl.h:50-58): EFULL mid-decode, grow,
    continue to completion."""
    raw = CORPUS["period_13"]
    comp = compress_variants(raw)["zlib"]
    eng = InflateEngine(10, FLAG_ZLIB)
    eng.include(comp)
    grows = 0
    while True:
        res = eng.step()
        if res is Result.EFULL:
            assert eng.resize_output(eng.capacity * 4) is Result.OK
            grows += 1
            continue
        break
    assert res is Result.OK
    assert grows > 0
    assert bytes(eng.out) == raw


def test_resize_smaller_than_written_rejected():
    eng = InflateEngine(4, FLAG_ZLIB)
    eng.include(zlib.compress(b"hello world hello world"))
    assert eng.step() is Result.EFULL
    assert eng.resize_output(2) is Result.EPERM  # ≙ mem.c:277-288


def test_positions():
    raw = b"abcabcabc" * 10
    comp = zlib.compress(raw, 6)
    eng = InflateEngine(len(raw), FLAG_ZLIB)
    eng.include(comp)
    assert eng.step() is Result.OK
    assert eng.output_pos == len(raw)
    # All input consumed except the unread adler32 trailer (4 bytes), up to
    # bit-buffer slack: input_pos must be >= payload end and <= len(comp).
    assert eng.input_pos <= len(comp)
    assert eng.input_pos >= len(comp) - 8


class TestErrors:
    """≙ test_error_conditions (test/test_files.c:460-544)."""

    def test_bad_btype(self):
        w = BitWriter().bits(1, 1).bits(3, 2)
        res, _ = inflate_oracle(w.getvalue() + b"\x00" * 8, 0)
        assert res is Result.ERR

    def test_bad_cm(self):
        bad = bytes([0x79, 0x9C]) + b"\x03\x00"  # CM=9
        res, _ = inflate_oracle(bad, FLAG_ZLIB)
        assert res is Result.ERR

    def test_bad_cinfo(self):
        bad = bytes([0x88, 0x98]) + b"\x03\x00"  # CINFO=8, fcheck valid
        assert ((0x88 << 8) | 0x98) % 31 == 0
        res, _ = inflate_oracle(bad, FLAG_ZLIB)
        assert res is Result.ERR

    def test_bad_fcheck(self):
        good = zlib.compress(b"x")
        bad = bytes([good[0], good[1] ^ 1]) + good[2:]
        res, _ = inflate_oracle(bad, FLAG_ZLIB)
        assert res is Result.ERR

    def test_fdict_rejected_without_dictionary(self):
        co = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=b"dictionary")
        data = co.compress(b"dictionary-backed") + co.flush()
        res, _ = inflate_oracle(data, FLAG_ZLIB)
        assert res is Result.ERR  # reference parity: zlib.h:88-93

    def test_truncated(self):
        comp = zlib.compress(CORPUS["text"])
        res, _ = inflate_oracle(comp[: len(comp) // 2], FLAG_ZLIB)
        assert res is Result.UNFINISHED

    def test_stored_len_nlen_mismatch(self):
        w = BitWriter().bits(1, 1).bits(0, 2).align()
        w.raw((5).to_bytes(2, "little") + (123).to_bytes(2, "little") + b"hello")
        res, _ = inflate_oracle(w.getvalue(), 0)
        assert res is Result.ERR  # ≙ infl.c:118

    def test_distance_too_far(self):
        w = BitWriter().bits(1, 1).bits(1, 2)
        # literal 'a', then len=10/dist=5 with only 1 byte of history
        from tests.gendata import _fixed_lit_code
        w.code(*_fixed_lit_code(ord("a")))
        w.code(*_fixed_lit_code(264))
        w.code(4, 5)  # dist sym 4 -> base 5, 1 extra bit
        w.bits(0, 1)
        w.code(*_fixed_lit_code(256))
        res, _ = inflate_oracle(w.getvalue(), 0)
        assert res is Result.ERR  # ≙ infl.c:1286

    def test_oversubscribed_dynamic(self):
        # dynamic header whose codelen code is oversubscribed
        w = BitWriter().bits(1, 1).bits(2, 2)
        w.bits(0, 5).bits(0, 5).bits(15, 4)  # HCLEN=19
        for _ in range(19):
            w.bits(1, 3)  # nineteen 1-bit codes: wildly oversubscribed
        res, _ = inflate_oracle(w.getvalue() + b"\x00" * 8, 0)
        assert res is Result.ERR  # ≙ infl.c:485-490

    def test_repeat_before_any_length(self):
        # first codelen symbol is 16 (copy-previous) with no previous
        w = BitWriter().bits(1, 1).bits(2, 2)
        w.bits(0, 5).bits(0, 5).bits(0, 4)  # HCLEN=4 -> syms 16,17,18,0
        w.bits(1, 3).bits(0, 3).bits(0, 3).bits(1, 3)  # 16:len1, 0:len1
        # canonical: sym 0 -> code 0, sym 16 -> code 1
        w.bits(1, 1)  # emit sym 16 (copy-previous) first
        res, _ = inflate_oracle(w.getvalue() + b"\x00" * 8, 0)
        assert res is Result.ERR


class TestDictionary:
    def test_preset_dictionary(self):
        d = b"the quick brown fox jumps over the lazy dog" * 4
        co = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=d)
        payload = b"the quick brown fox says hello to the lazy dog"
        data = co.compress(payload) + co.flush()
        res, out = inflate_oracle(data, FLAG_ZLIB, dictionary=d)
        assert res is Result.OK
        assert out == payload


class TestAdler:
    def test_verify_ok(self):
        raw = CORPUS["text"]
        comp = zlib.compress(raw)
        res, out = inflate_oracle(comp, FLAG_ZLIB | FLAG_VERIFY_ADLER32)
        assert res is Result.OK
        assert out == raw

    def test_verify_corrupt_trailer(self):
        comp = bytearray(zlib.compress(b"check me"))
        comp[-1] ^= 0xFF
        res, _ = inflate_oracle(bytes(comp), FLAG_ZLIB | FLAG_VERIFY_ADLER32)
        assert res is Result.ERR

    def test_trailer_ignored_by_default(self):
        """Reference parity: trailer never verified (SURVEY §2.1)."""
        comp = bytearray(zlib.compress(b"check me"))
        comp[-1] ^= 0xFF
        res, out = inflate_oracle(bytes(comp), FLAG_ZLIB)
        assert res is Result.OK
        assert out == b"check me"


def test_noop_like_empty_then_data():
    """Streaming call with no data then data (≙ UNZ_NOOP-adjacent flow)."""
    raw = b"streaming!"
    comp = zlib.compress(raw)
    eng = InflateEngine(64, FLAG_ZLIB)
    assert eng.step() is Result.UNFINISHED
    eng.include(comp)
    assert eng.step() is Result.OK
    assert bytes(eng.out) == raw


def test_checksums_against_zlib():
    import defl_jax.core.checksums as cks

    for name in ("empty", "text", "rand_4095", "zeros_65536"):
        data = CORPUS[name]
        assert cks.adler32(data) == zlib.adler32(data)
        assert cks.crc32(data) == zlib.crc32(data)
