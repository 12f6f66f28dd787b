"""Encoder round-trip and size tests.

The reference never implemented deflate (include/defl/defl.h:17-25); the
test strategy here is the one SURVEY §4 prescribes for the build: our
encode must (a) inflate correctly under an independent decoder (CPython
zlib), (b) inflate correctly under OUR decoder, and (c) meet the size
target (<= zlib level-6 output overall, BASELINE.md).
"""

import zlib

import pytest

from defl_jax.api import deflate_buffer, inflate_buffer
from defl_jax.errors import FLAG_ZLIB
from tests.gendata import make_corpus

CORPUS = make_corpus()


@pytest.fixture(scope="module", params=sorted(CORPUS))
def item(request):
    return request.param, CORPUS[request.param]


def test_roundtrip_zlib_decodes_ours(item):
    name, raw = item
    comp = deflate_buffer(raw, level=6, flags=FLAG_ZLIB)
    assert zlib.decompress(comp) == raw, name


def test_roundtrip_raw_format(item):
    name, raw = item
    comp = deflate_buffer(raw, level=6, flags=0)
    assert zlib.decompress(comp, -15) == raw, name


def test_roundtrip_our_decoder(item):
    name, raw = item
    comp = deflate_buffer(raw, level=6, flags=FLAG_ZLIB)
    assert inflate_buffer(comp) == raw, name


@pytest.mark.parametrize("level", [1, 4, 6, 9])
def test_levels_roundtrip(level):
    raw = CORPUS["text"] + CORPUS["png_simulation"]
    comp = deflate_buffer(raw, level=level)
    assert zlib.decompress(comp) == raw


def test_adler_trailer_correct():
    raw = CORPUS["json"]
    comp = deflate_buffer(raw)
    assert int.from_bytes(comp[-4:], "big") == zlib.adler32(raw)


def test_size_vs_zlib6_aggregate():
    """Aggregate size target (BASELINE.md): <= zlib level-6 on the corpus."""
    ours = 0
    zl = 0
    for name, raw in CORPUS.items():
        ours += len(deflate_buffer(raw, level=6, flags=0))
        zl += len(zlib.compress(raw, 6)) - 6  # strip zlib wrapper overhead
    assert ours <= zl * 1.01, f"ours={ours} zlib6={zl}"


def test_size_per_file_reasonable():
    """No single file should blow up badly vs zlib-6."""
    for name, raw in CORPUS.items():
        if len(raw) < 64:
            continue  # tiny inputs are all header
        ours = len(deflate_buffer(raw, level=6, flags=0))
        zl = len(zlib.compress(raw, 9, )) - 6
        zl6 = len(zlib.compress(raw, 6)) - 6
        assert ours <= max(zl6 * 1.10, zl6 + 64), (name, ours, zl6)


def test_dictionary_encode_roundtrip():
    d = b"a preset dictionary with common phrases the payload reuses " * 8
    payload = b"the payload reuses common phrases from a preset dictionary!"
    comp = deflate_buffer(payload, dictionary=d)
    do = zlib.decompressobj(zdict=d)
    assert do.decompress(comp) == payload
    # and with our own decoder
    assert inflate_buffer(comp, dictionary=d) == payload
    # dictionary should actually help
    assert len(comp) < len(deflate_buffer(payload))


def test_empty_input():
    comp = deflate_buffer(b"")
    assert zlib.decompress(comp) == b""


def test_incompressible_uses_stored():
    import random

    raw = random.Random(7).randbytes(70000)
    comp = deflate_buffer(raw, flags=0)
    # stored framing costs ~5 bytes/64K block + 3 bits: must be tight
    assert len(comp) <= len(raw) + 40
    assert zlib.decompress(comp, -15) == raw


def test_size_beats_zlib6_on_bench_mix():
    """North-star size gate (BASELINE.md: encode <= zlib-level-6 size) on
    the bench corpus mix — the aggregate that bench.py reports."""
    from defl_jax.bench import make_silesia_like
    from defl_jax.runtime import native

    if not native.available():
        pytest.skip("native library unavailable")
    blocks = make_silesia_like(4 << 20, 65536)
    ours = sum(len(native.native_deflate(p, 6)) for p in blocks)
    zl6 = sum(len(zlib.compress(p, 6)) for p in blocks)
    assert ours <= zl6, f"ours={ours} zlib6={zl6}"


def test_encoder_fuzz_sequence_dependent():
    """Cross-engine encoder fuzz with a long in-process call sequence.

    Regression for two latent encoder bugs that only sequence-dependent
    fuzz exposed: (a) assign_codes reading ll[286..287]/dl[30..31] that
    huff_lengths(n=286/30) never initialised — stack garbage shifted
    every canonical code; (b) the depth-limit fixup in huff_lengths
    under-counting oversubscription (emitted an oversubscribed codelen
    tree).  Both were nondeterministic across processes but deterministic
    given the same preceding call sequence."""
    import random

    from defl_jax.runtime import native

    if not native.available():
        pytest.skip("native library unavailable")
    rng = random.Random(11)
    corpus = list(CORPUS.values())
    for it in range(300):
        kind = rng.randrange(5)
        if kind == 0:
            p = rng.randbytes(rng.randrange(0, 3000))
        elif kind == 1:
            p = rng.randbytes(rng.choice([1, 2, 3, 17])) * rng.randrange(1, 2000)
        elif kind == 2:
            p = bytes(rng.choice(corpus)) + rng.randbytes(60)
        elif kind == 3:
            p = b"\0" * rng.randrange(0, 100000)
        else:
            p = bytes(bytearray(rng.randbytes(150)) * rng.randrange(1, 60))
        lvl = rng.choice([1, 2, 4, 6, 9])
        c = native.native_deflate(p, lvl)
        assert zlib.decompress(c) == p, (it, kind, lvl, len(p))


class TestDeviceDeflate:
    """Hybrid device encode (host LZ77 + trees -> device Huffman bit-pack).

    Fills the encode half the reference never implements
    (include/defl/defl.h:17-25): dt_deflate_fields_batch
    exports (value, nbits) fields, ops/huffman_pack.pack_fields
    concatenates them lane-parallel on device."""

    def _payloads(self):
        import random

        rng = random.Random(5)
        return (list(CORPUS.values())[:12]
                + [b"", b"x", rng.randbytes(70000), b"\0" * 50000,
                   rng.randbytes(64) * 500])

    def test_byte_identical_to_host_encoder(self):
        from defl_jax.runtime import native
        from defl_jax.runtime.session import device_deflate

        if not native.available():
            pytest.skip("native library unavailable")
        payloads = self._payloads()
        st = {}
        outs = device_deflate(payloads, level=6, stats_out=st)
        _, host = native.native_deflate_batch(payloads, level=6)
        for i, (a, b) in enumerate(zip(outs, host)):
            assert a == b, i
        assert st["device_fallbacks"] == []

    def test_roundtrip_and_raw_mode(self):
        from defl_jax.runtime import native
        from defl_jax.runtime.session import device_deflate

        if not native.available():
            pytest.skip("native library unavailable")
        payloads = self._payloads()
        for flags, wbits in ((FLAG_ZLIB, 15), (0, -15)):
            outs = device_deflate(payloads, level=6, flags=flags)
            for o, p in zip(outs, payloads):
                assert zlib.decompress(o, wbits) == p

    def test_batch_api_device_backend(self):
        from defl_jax.api import deflate_batch
        from defl_jax.runtime import native

        if not native.available():
            pytest.skip("native library unavailable")
        payloads = self._payloads()
        outs = deflate_batch(payloads, backend="device")
        for o, p in zip(outs, payloads):
            assert zlib.decompress(o) == p


class TestDeflateStream:
    def test_streaming_compress_roundtrip(self):
        from defl_jax.core.deflate_ref import DeflateStream

        payload = (CORPUS["text"] + CORPUS["png_simulation"]) * 8  # ~1.8MB
        st = DeflateStream(level=6)
        out = bytearray()
        for i in range(0, len(payload), 50_000):
            out += st.compress(payload[i : i + 50_000])
        mid_emitted = len(out)
        out += st.flush()
        assert mid_emitted > 0          # blocks flowed before finish
        assert zlib.decompress(bytes(out)) == payload
        # window continuity: size should be close to one-shot
        one_shot = deflate_buffer(payload, level=6)
        assert len(out) <= len(one_shot) * 1.05

    def test_empty_stream(self):
        from defl_jax.core.deflate_ref import DeflateStream

        st = DeflateStream()
        out = st.compress(b"") + st.flush()
        assert zlib.decompress(out) == b""

    def test_compress_after_flush_rejected(self):
        from defl_jax.core.deflate_ref import DeflateStream

        st = DeflateStream()
        st.flush()
        import pytest as _pt
        with _pt.raises(ValueError):
            st.compress(b"x")

    def test_streaming_with_dictionary(self):
        from defl_jax.core.deflate_ref import DeflateStream

        d = b"shared words appear early " * 40
        st = DeflateStream(dictionary=d)
        payload = b"shared words appear early in this payload too"
        out = st.compress(payload) + st.flush()
        do = zlib.decompressobj(zdict=d)
        assert do.decompress(out) == payload
