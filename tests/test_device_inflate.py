"""Device (JAX) batched inflate: bit-exact parity with the oracle/zlib.

Runs on the CPU backend (conftest's default); identical code runs on the
GPU.
Shapes are kept inside one compile bucket (C=1024) so the lockstep decoder
compiles once per test session.
"""

import zlib

import pytest

from defl_jax.errors import FLAG_ZLIB, Result
from defl_jax.runtime.session import batch_inflate, device_inflate
from tests.gendata import edge_streams, make_corpus

CORPUS = make_corpus()

# payloads small enough for the 1024-byte capacity bucket
SMALL = {k: v for k, v in CORPUS.items() if 0 < len(v) <= 900}
CAP = 1024


def dev(streams, **kw):
    kw.setdefault("dst_capacities", CAP)
    return device_inflate(streams, **kw)


def test_zlib_corpus_batch():
    names = sorted(SMALL)
    payloads = [CORPUS[n] for n in names]
    streams = [zlib.compress(p, 6) for p in payloads]
    res, outs, _ = dev(streams)
    for n, r, o, p in zip(names, res, outs, payloads):
        assert r is Result.OK, (n, r)
        assert o == p, n


def test_raw_deflate_batch():
    payloads = [CORPUS["rand_255"], CORPUS["rand_64"], b"x" * 700]
    streams = []
    for p in payloads:
        co = zlib.compress(p, 6)
        streams.append(co)
    # decode zlib-wrapped with flags=0 must fail or garbage; use raw streams
    raw_streams = []
    for p in payloads:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        raw_streams.append(co.compress(p) + co.flush())
    res, outs, _ = dev(raw_streams, flags=0)
    for r, o, p in zip(res, outs, payloads):
        assert r is Result.OK
        assert o == p


def test_edge_streams_device():
    cases = edge_streams()
    small = {k: v for k, v in cases.items() if len(v[1]) <= CAP}
    names = sorted(small)
    res, outs, _ = dev([small[n][0] for n in names], flags=0)
    for n, r, o in zip(names, res, outs):
        assert r is Result.OK, (n, r)
        assert o == small[n][1], n


def test_all_compression_levels():
    p = CORPUS["period_7"][:800]
    streams = [zlib.compress(p, lvl) for lvl in (0, 1, 6, 9)]
    res, outs, _ = dev(streams)
    assert all(r is Result.OK for r in res)
    assert all(o == p for o in outs)


def test_stored_blocks_device():
    import random

    p = random.Random(5).randbytes(800)  # incompressible -> stored
    res, outs, _ = dev([zlib.compress(p, 6)])
    assert res[0] is Result.OK
    assert outs[0] == p


def test_chunked_streams():
    """Non-contiguous chunk lists (≙ infl_include) pack transparently."""
    p = CORPUS["text"][:700]
    comp = zlib.compress(p, 6)
    chunks = [comp[i : i + 3] for i in range(0, len(comp), 3)]
    res, outs, _ = dev([chunks])
    assert res[0] is Result.OK
    assert outs[0] == p


def test_error_containment():
    """A malformed lane must not poison its batch (SURVEY §5)."""
    good = CORPUS["json"][:500]
    gz = zlib.compress(good, 6)
    bad_btype = b"\x07\x00\x00\x00"  # bfinal=1, btype=3
    truncated = gz[: len(gz) // 2]
    res, outs, _ = dev([gz, bad_btype, truncated, gz], flags=FLAG_ZLIB)
    assert res[0] is Result.OK and outs[0] == good
    assert res[3] is Result.OK and outs[3] == good
    assert res[1] is Result.ERR
    assert res[2] is Result.UNFINISHED


def test_bad_zlib_headers():
    bad_cm = bytes([0x79, 0x9C, 0, 0])
    bad_check = bytes([0x78, 0x9D, 0, 0])
    res, _, _ = dev([bad_cm, bad_check])
    assert res[0] is Result.ERR
    assert res[1] is Result.ERR


def test_efull_lane():
    p = b"z" * 600
    res, outs, _ = dev([zlib.compress(p)], dst_capacities=[100])
    assert res[0] is Result.EFULL
    assert outs[0] == p[:100] or len(outs[0]) <= 100


def test_distance_too_far_device():
    from tests.gendata import BitWriter, _fixed_lit_code

    w = BitWriter().bits(1, 1).bits(1, 2)
    w.code(*_fixed_lit_code(ord("a")))
    w.code(*_fixed_lit_code(264))
    w.code(4, 5)
    w.bits(0, 1)
    w.code(*_fixed_lit_code(256))
    res, _, _ = dev([w.getvalue()], flags=0)
    assert res[0] is Result.ERR


def test_dictionary_broadcast():
    d = b"shared dictionary content for every stream in the batch " * 4
    payloads = [b"shared dictionary content says hi %d" % i for i in range(4)]
    streams = []
    for p in payloads:
        co = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=d)
        streams.append(co.compress(p) + co.flush())
    res, outs, _ = dev(streams, dictionary=d)
    for r, o, p in zip(res, outs, payloads):
        assert r is Result.OK
        assert o == p


def test_fdict_without_dictionary_errors():
    d = b"dict" * 10
    co = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=d)
    s = co.compress(b"hello") + co.flush()
    res, _, _ = dev([s])
    assert res[0] is Result.ERR  # reference parity: zlib.h:88-93


def test_our_encoder_device_roundtrip():
    from defl_jax.api import deflate_buffer

    payloads = [CORPUS["period_3"][:800], CORPUS["unicode"][:600]]
    streams = [deflate_buffer(p, level=6) for p in payloads]
    res, outs, _ = dev(streams)
    assert all(r is Result.OK for r in res)
    assert outs[0] == payloads[0] and outs[1] == payloads[1]


def test_batch_inflate_auto_backend():
    payloads = [CORPUS["rand_64"]] * 10
    streams = [zlib.compress(p) for p in payloads]
    res, outs = batch_inflate(streams, dst_capacities=CAP)
    assert all(r is Result.OK for r in res)
    assert all(o == payloads[0] for o in outs)


def test_input_pos_accounting_device():
    p = CORPUS["rand_64"]
    s = zlib.compress(p, 6)
    res, outs, stats = dev([s])
    assert res[0] is Result.OK
    consumed = (int(stats["bitpos"][0]) + 7) // 8
    # everything but the 4-byte adler trailer, modulo final-byte slack
    assert len(s) - 5 <= consumed <= len(s) - 4


def test_host_resolve_parity():
    """Hybrid pipeline (device pass-1 + C++ pass-2) must match the device
    resolver bit for bit, including dictionary back-references."""
    from defl_jax.runtime.native import available

    if not available():
        pytest.skip("native library unavailable")
    names = sorted(SMALL)[:10]
    payloads = [CORPUS[n] for n in names]
    streams = [zlib.compress(p, 6) for p in payloads]
    r1, o1, _ = device_inflate(streams, dst_capacities=CAP, resolve="host")
    r2, o2, _ = device_inflate(streams, dst_capacities=CAP, resolve="device")
    assert r1 == r2
    assert o1 == o2
    assert all(o == p for o, p in zip(o1, payloads))

    d = b"common prefix material " * 16
    zs = []
    for p in payloads[:4]:
        co = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=d)
        zs.append(co.compress(p) + co.flush())
    r3, o3, _ = device_inflate(zs, dst_capacities=CAP, dictionary=d,
                               resolve="host")
    assert all(r is Result.OK for r in r3)
    assert o3 == payloads[:4]


def test_adler32_batch_device():
    """Batched device adler32 (new capability; reference has none)."""
    import numpy as np
    import jax.numpy as jnp

    from defl_jax.ops.checksums import adler32_batch

    rng = np.random.default_rng(1)
    lens = np.array([0, 1, 100, 3072, 3073, 8191], np.int32)
    data = np.zeros((6, 8192), np.uint8)
    for i, L in enumerate(lens):
        data[i, :L] = rng.integers(0, 256, L, dtype=np.uint8)
    got = np.asarray(adler32_batch(jnp.asarray(data), jnp.asarray(lens)))
    for i in range(6):
        assert int(got[i]) == zlib.adler32(data[i, : lens[i]].tobytes()), i


def test_verify_adler32_device():
    """FLAG_VERIFY_ADLER32 on the device path (extension; the reference
    never checks the trailer)."""
    from defl_jax.errors import FLAG_VERIFY_ADLER32

    p = CORPUS["text"][:600]
    good = zlib.compress(p, 6)
    corrupt = bytearray(good)
    corrupt[-1] ^= 0xFF
    res, outs, _ = dev([good, bytes(corrupt)],
                       flags=FLAG_ZLIB | FLAG_VERIFY_ADLER32)
    assert res[0] is Result.OK and outs[0] == p
    assert res[1] is Result.ERR
    # default mode still ignores the trailer (reference parity)
    res2, outs2, _ = dev([bytes(corrupt)])
    assert res2[0] is Result.OK and outs2[0] == p


def test_step_budget_exhaustion_falls_back_to_host():
    """Adversarial many-empty-blocks streams exhaust the device step
    budget; the session transparently retries them on the host engine."""
    from tests.gendata import BitWriter, _fixed_lit_code

    w = BitWriter()
    for i in range(3000):  # thousands of empty non-final static blocks
        w.bits(0, 1).bits(1, 2)
        w.code(*_fixed_lit_code(256))
    w.bits(1, 1).bits(1, 2)
    w.code(*_fixed_lit_code(ord("Z")))
    w.code(*_fixed_lit_code(256))
    evil = w.getvalue()

    good = zlib.compress(b"fine " * 50, 6)
    res, outs, _ = dev([evil, good], flags=0)
    # evil lane decodes via host fallback (budget is ~C*5/8+4096 < 3000*10)
    assert res[0] is Result.OK
    assert outs[0] == b"Z"
    assert res[1] is Result.ERR or res[1] is Result.OK  # good is zlib-wrapped

