"""Corpus-wide API-layer parity: every corpus payload through
`api.InflateStream` across the same path matrix the reference drives
(`/root/reference/test/test_files.c`):

  - contiguous one-shot (test_file, :174-257)
  - chunked include at 1/2/4/8-byte chunks (test_file_chunked, :259-331)
  - streaming at 64..1024-byte feeds with empty-feed drains
    (test_file_streaming, :688-790)
  - bytewise streaming on a representative payload
    (test_file_streaming_bytewise, :792-869)

plus lifecycle negatives (NOOP / EBADF-after-destroy / reset-reuse /
input_pos & output_pos accounting, :871-1029).  Round-1 coverage drove
the engine layer; these drive the public stream object itself.
"""

import zlib

import pytest

from defl_jax.api import InflateStream
from defl_jax.errors import FLAG_ZLIB, Result
from tests.gendata import make_corpus

CORPUS = make_corpus()
NAMES = sorted(CORPUS)


def _cap(payload: bytes) -> int:
    return max(len(payload), 1)


@pytest.mark.parametrize("name", NAMES)
def test_contiguous_one_shot(name):
    payload = CORPUS[name]
    st = InflateStream(_cap(payload))
    assert st.include(zlib.compress(payload, 6)) is Result.OK
    assert st.run() is Result.OK
    assert st.output == payload
    assert st.output_pos == len(payload)


@pytest.mark.parametrize("chunk", [1, 2, 4, 8])
@pytest.mark.parametrize("name", NAMES)
def test_chunked_include(name, chunk):
    payload = CORPUS[name]
    comp = zlib.compress(payload, 6)
    st = InflateStream(_cap(payload))
    for i in range(0, len(comp), chunk):
        assert st.include(comp[i : i + chunk]) is Result.OK
    assert st.run() is Result.OK
    assert st.output == payload


@pytest.mark.parametrize("feed", [64, 256, 1024])
@pytest.mark.parametrize("name", NAMES)
def test_streaming_feeds(name, feed):
    payload = CORPUS[name]
    comp = zlib.compress(payload, 6)
    st = InflateStream(_cap(payload))
    r = Result.UNFINISHED
    for i in range(0, len(comp), feed):
        r = st.stream(comp[i : i + feed])
        assert r in (Result.OK, Result.UNFINISHED), (name, i, r)
    assert r is Result.OK, name
    # trailing empty-feed drains are no-ops after completion
    assert st.stream(b"") in (Result.OK, Result.NOOP)
    assert st.output == payload


def test_streaming_bytewise():
    payload = CORPUS["png_simulation"]
    payload = payload[:3000]
    comp = zlib.compress(payload, 6)
    st = InflateStream(len(payload) or 1)
    r = Result.UNFINISHED
    for i in range(len(comp)):
        r = st.stream(comp[i : i + 1])
    assert r is Result.OK
    assert st.output == payload


def test_lifecycle_noop_ebadf_reset_positions():
    payload = CORPUS["text"][:500]
    comp = zlib.compress(payload, 6)

    st = InflateStream(len(payload))
    assert st.stream(b"") is Result.NOOP           # ≙ stream.c:505-507
    assert st.stream(comp) is Result.OK
    assert st.output == payload
    assert st.output_pos == len(payload)
    # trailer is never consumed (decode stops at the final EOB)
    assert st.input_pos == len(comp) - 4

    # reset-reuse with a different payload
    other = CORPUS["json"][:400]
    st.reset(len(other))
    assert st.stream(zlib.compress(other, 6)) is Result.OK
    assert st.output == other

    st.destroy()
    assert st.stream(b"x") is Result.EBADF
    assert st.include(b"x") is Result.EBADF
    assert st.run() is Result.EBADF
    assert st.output_pos == 0 and st.input_pos == 0


def test_raw_deflate_paths():
    payload = CORPUS["period_13"]
    comp = zlib.compress(payload, 6, -15)          # raw DEFLATE, no header
    st = InflateStream(len(payload), flags=0)
    for i in range(0, len(comp), 4):
        st.include(comp[i : i + 4])
    assert st.run() is Result.OK
    assert st.output == payload


def test_one_shot_takes_native_fast_path():
    """A fresh contiguous run() must route through the C++ engine (≙ the
    reference's infl_buf being its fastest path, infl.h:125-145) and
    agree with the oracle engine on output AND input_pos accounting."""
    from defl_jax.runtime import native

    if not native.available():
        pytest.skip("native library unavailable")
    for name in ("text", "json", "period_13"):
        payload = CORPUS[name]
        comp = zlib.compress(payload, 6)
        st = InflateStream(_cap(payload))
        st.include(comp)
        assert st.run() is Result.OK
        assert st.native_path_used
        # oracle twin for parity (forced off the fast path via dictionary
        # arg being absent is not enough: drive the engine directly)
        from defl_jax.core.oracle import InflateEngine

        eng = InflateEngine(_cap(payload))
        eng.include(comp)
        assert eng.step() is Result.OK
        assert st.output == bytes(eng.out) == payload
        assert st.input_pos == eng.input_pos


def test_native_fast_path_preserves_resumable_semantics():
    """Non-OK one-shots (truncated input, small capacity) must stay on the
    resumable oracle engine: UNFINISHED + more input, EFULL +
    resize_output both continue correctly after a failed fast path."""
    from defl_jax.runtime import native

    if not native.available():
        pytest.skip("native library unavailable")
    payload = CORPUS["text"]
    comp = zlib.compress(payload, 6)

    st = InflateStream(_cap(payload))
    st.include(comp[:100])
    assert st.run() is Result.UNFINISHED
    assert not st.native_path_used
    st.include(comp[100:])
    assert st.run() is Result.OK
    assert st.output == payload

    st = InflateStream(16)
    st.include(comp)
    assert st.run() is Result.EFULL
    assert st.resize_output(_cap(payload)) is Result.OK
    assert st.run() is Result.OK
    assert st.output == payload


def test_metrics_counters_wired():
    """Observability counters (≙ the reference's UNZ_STATS, declared but
    never wired there — src/common.h:181-187) must move when the real
    entry points run."""
    import zlib as _z

    from defl_jax import metrics
    from defl_jax.api import inflate_buffer

    metrics.reset()
    payload = CORPUS["text"]
    out = inflate_buffer(_z.compress(payload, 6))
    assert out == payload
    snap = metrics.snapshot()
    assert snap.get("inflate_buffer_calls", 0) == 1
    assert snap.get("inflate_bytes_out", 0) == len(payload)
    metrics.reset()
    assert metrics.snapshot() == {}
