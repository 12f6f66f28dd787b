"""Fuzzing: malformed/mutated inputs must fail cleanly, never crash or
hang, and host/device/native engines must agree.

≙ the reference's deterministic LCG fuzzer (test/test_fuzz.c:136-312):
semi-valid DEFLATE streams with mutation strategies, asserting sane
return codes.  Extended with cross-engine agreement: for every fuzz case
the oracle, the C++ engine and the device decoder must produce the same
(result-class, output) pair.
"""

import random
import zlib

import pytest

from defl_jax.core.oracle import inflate_oracle
from defl_jax.errors import FLAG_ZLIB, Result
from tests.gendata import make_corpus

CORPUS = make_corpus()
CAP = 1024


def _gen_cases(seed, n):
    rng = random.Random(seed)
    base_payloads = [CORPUS["text"][:400], CORPUS["rand_255"],
                     CORPUS["period_3"][:300], b"", b"a"]
    cases = []
    for i in range(n):
        kind = rng.randrange(5)
        if kind == 0:           # valid zlib
            data = zlib.compress(rng.choice(base_payloads), rng.randrange(10))
        elif kind == 1:         # truncated valid
            d = zlib.compress(rng.choice(base_payloads), 6)
            data = d[: rng.randrange(1, max(2, len(d)))]
        elif kind == 2:         # bit flips in valid stream
            d = bytearray(zlib.compress(rng.choice(base_payloads), 6))
            for _ in range(rng.randrange(1, 5)):
                if d:
                    p = rng.randrange(len(d))
                    d[p] ^= 1 << rng.randrange(8)
            data = bytes(d)
        elif kind == 3:         # random garbage
            data = rng.randbytes(rng.randrange(1, 200))
        else:                   # valid header + garbage body
            data = b"\x78\x9c" + rng.randbytes(rng.randrange(1, 150))
        cases.append(data)
    return cases


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_oracle_fuzz_no_crash(seed):
    for data in _gen_cases(seed, 60):
        res, out = inflate_oracle(data, FLAG_ZLIB, CAP)
        assert res in (Result.OK, Result.ERR, Result.UNFINISHED, Result.EFULL)
        assert len(out) <= CAP


@pytest.mark.needs_jax
def test_cross_engine_agreement_device():
    """Oracle vs device decoder on fuzz cases."""
    from defl_jax.runtime.session import device_inflate

    cases = _gen_cases(7, 48)
    oracle_res = [inflate_oracle(d, FLAG_ZLIB, CAP) for d in cases]

    dev_res, dev_out, _ = device_inflate(cases, dst_capacities=CAP)
    for i, (data, (orr, oro)) in enumerate(zip(cases, oracle_res)):
        # identical result code and identical decoded prefix
        assert dev_res[i] is orr, (i, data.hex()[:40], dev_res[i], orr)
        if orr is Result.OK:
            assert dev_out[i] == oro, i


def test_cross_engine_agreement_native():
    """Oracle vs C++ engine on fuzz cases (runs under the sanitizer
    preload too — this is the ASan-audited agreement check)."""
    from defl_jax.runtime.native import available, native_inflate

    if not available():
        pytest.skip("native library unavailable")
    cases = _gen_cases(7, 48)
    for i, data in enumerate(cases):
        orr, oro = inflate_oracle(data, FLAG_ZLIB, CAP)
        nr, no = native_inflate(data, CAP, 1)
        assert nr is orr, (i, data.hex()[:40], nr, orr)
        if orr is Result.OK:
            assert no == oro, i


@pytest.mark.needs_jax
def test_fuzz_raw_mode_device():
    from defl_jax.runtime.session import device_inflate

    rng = random.Random(11)
    cases = [rng.randbytes(rng.randrange(1, 120)) for _ in range(24)]
    res, outs, _ = device_inflate(cases, flags=0, dst_capacities=CAP)
    for r, o in zip(res, outs):
        assert int(r) in (0, -1, 2, -105)
        assert len(o) <= CAP


# ---------------------------------------------------------------------------
# C++-tier fuzzing (≙ the reference's libFuzzer harness,
# test/test_fuzz.c:35-94, built -fsanitize=fuzzer,address there): drive the
# arbitrary-bit-offset entry points — dt_find_block_start, dt_inflate_span,
# dt_resolve_tokens (adversarial token words), dt_stitch (corrupted lane
# metadata) — over mutated streams.  The CI sanitizer job runs this file
# with DEFL_NATIVE_LIB pointing at the ASan/UBSan build, so any OOB
# read/write here is a hard failure, not a silent corruption.
# ---------------------------------------------------------------------------

import numpy as np

from defl_jax.runtime import native


def _need_native():
    if not native.available():
        pytest.skip("native library unavailable")


def _mutated_bodies(seed, n):
    rng = random.Random(seed)
    payload = (CORPUS["text"] + CORPUS["period_3"] + CORPUS["rand_255"]) * 2
    base = zlib.compress(payload, 6)[2:]  # raw body past the zlib header
    bodies = []
    for _ in range(n):
        d = bytearray(base)
        for _ in range(rng.randrange(0, 12)):
            p = rng.randrange(len(d))
            d[p] ^= 1 << rng.randrange(8)
        if rng.random() < 0.3:
            d = d[: rng.randrange(1, len(d))]
        bodies.append(np.frombuffer(bytes(d), np.uint8))
    bodies.append(np.frombuffer(rng.randbytes(4096), np.uint8))
    bodies.append(np.frombuffer(b"\0" * 64, np.uint8))
    return bodies


@pytest.mark.parametrize("seed", [21, 22])
def test_fuzz_find_block_start(seed):
    _need_native()
    lib = native.get_lib()
    rng = random.Random(seed)
    for body in _mutated_bodies(seed, 10):
        nbits = 8 * body.size
        for _ in range(8):
            lo = rng.randrange(0, max(1, nbits))
            hi = lo + rng.randrange(0, nbits + 256)
            r = native.find_block_start(lib, body, lo, hi)
            assert r == -1 or lo <= r < nbits


@pytest.mark.parametrize("seed", [31, 32])
def test_fuzz_inflate_span(seed):
    _need_native()
    lib = native.get_lib()
    rng = random.Random(seed)
    cap = 1 << 16
    out = np.zeros(cap, np.uint8)
    for body in _mutated_bodies(seed, 10):
        nbits = 8 * body.size
        for _ in range(8):
            start = rng.randrange(0, max(1, nbits))
            limit = start + rng.randrange(0, nbits)
            r, dl, eb = native.inflate_span(lib, body, start, limit, out,
                                            rng.randrange(0, 64))
            assert r in (Result.OK, Result.ERR, Result.UNFINISHED,
                         Result.EFULL)
            assert 0 <= dl <= cap


@pytest.mark.parametrize("seed", [41, 42])
def test_fuzz_resolve_adversarial_tokens(seed):
    """Random u32 token words: lying len fields (up to 514B), stored-run
    offsets far past the input row, dist reaching before the window,
    lying dst_len/dst_start — all must be contained in the lane row."""
    _need_native()
    rng = np.random.default_rng(seed)
    N, T, C = 16, 256, 2048
    tokens = rng.integers(0, 1 << 32, (N, T), dtype=np.uint64) \
        .astype(np.uint32)
    inputs = rng.integers(0, 1 << 32, (N, 64), dtype=np.uint64) \
        .astype(np.uint32)
    dst_len = rng.integers(-5, 4 * C, N).astype(np.int32)
    out = native.native_resolve_tokens(tokens, inputs, dst_len, C)
    assert out.shape == (N, C)
    # adversarial dst_start as well
    dst_start = rng.integers(-10, 2 * C, N).astype(np.int32)
    native.native_resolve_tokens(tokens, inputs, dst_len, C,
                                 out=out, dst_start=dst_start)


@pytest.mark.parametrize("seed", [51, 52, 53])
def test_fuzz_stitch_corrupt_lane_metadata(seed):
    """dt_stitch walks untrusted lane status/bit_end/dst_pos arrays; lies
    must produce a sane Result, never OOB (runs under ASan in CI)."""
    _need_native()
    lib = native.get_lib()
    rng = np.random.default_rng(seed)
    py_rng = random.Random(seed)
    payload = (CORPUS["text"] + CORPUS["json"]) * 8
    body = np.frombuffer(zlib.compress(payload, 6)[2:], np.uint8)
    nbits = 8 * body.size
    # semi-plausible candidate chain: some real block starts, some junk
    cands = [0]
    pos = 0
    while True:
        nxt = native.find_block_start(lib, body, pos + 999, nbits)
        if nxt < 0:
            break
        cands.append(nxt)
        pos = nxt
    for j in range(3):
        fake = py_rng.randrange(1, nbits)
        if fake not in cands:
            cands.append(fake)
    cands = sorted(set(cands))
    M = len(cands)
    T = 128
    toks = rng.integers(0, 1 << 32, (M, T), dtype=np.uint64) \
        .astype(np.uint32)
    dst_pos = rng.integers(-3, 1 << 20, M).astype(np.int32)
    status = rng.integers(-2, 3, M).astype(np.int32)
    final = rng.integers(0, 2, M).astype(np.int32)
    bit_end = rng.integers(-100, nbits + 100, M).astype(np.int64)
    # make a few seams "validate" so the lane-resolve path runs on the
    # garbage tokens
    for k in range(M - 1):
        if py_rng.random() < 0.5:
            bit_end[k] = cands[k + 1]
            status[k] = 0
    out = np.zeros(len(payload) + (1 << 16), np.uint8)
    r, total, end_bit = native.stitch(
        lib, body, cands, (toks, dst_pos, status, final, bit_end), out)
    assert r in (Result.OK, Result.ERR, Result.UNFINISHED, Result.EFULL)
    assert 0 <= total <= out.size


@pytest.mark.parametrize("seed", [61, 62])
def test_fuzz_inflate_large_parallel(seed):
    """dt_inflate_large over mutated/truncated/garbage bodies at several
    segmentations: must return a sane Result with in-bounds output (runs
    under ASan in CI), and agree with the serial engine whenever the
    serial engine accepts the stream."""
    _need_native()
    lib = native.get_lib()
    rng = random.Random(seed)
    for body in _mutated_bodies(seed, 8):
        cap = 64 * body.size + 4096
        out = np.zeros(cap, np.uint8)
        segb = rng.choice([4096, 16384, 65536])
        r, total, end_bit, st = native.inflate_large_parallel(
            lib, body, out, seg_bytes=segb, n_threads=3)
        native.large_free(lib, st)
        assert r in (Result.OK, Result.ERR, Result.UNFINISHED, Result.EFULL)
        assert 0 <= total <= cap
        rs, out_serial = native.native_inflate(body.tobytes(), cap, flags=0)
        if rs is Result.OK:  # serial accepts: parallel must match exactly
            assert r is Result.OK
            assert out[:total].tobytes() == out_serial


def test_stitch_unsorted_candidates_rejected():
    _need_native()
    lib = native.get_lib()
    body = np.frombuffer(zlib.compress(b"x" * 1000, 6)[2:], np.uint8)
    out = np.zeros(4096, np.uint8)
    r, total, _ = native.stitch(lib, body, [40, 10], None, out)
    assert r is Result.ERR and total == 0
