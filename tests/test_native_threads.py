"""Threaded native-tier stress: the pthread code paths the TSan CI job
checks (≙ the reference's TSan job, .github/workflows/test.yml:167-197
there, which guards against hazards like its non-thread-safe static
Huffman table init, infl.c:1510-1511).

Covers: resolve_all's worker pool (dt_resolve_tokens n_threads>1), the
dt_inflate_batch / dt_deflate_batch pools, and concurrent independent
library calls from python threads (thread_local Inflater state).
"""

import random
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from defl_jax.errors import Result
from defl_jax.runtime import native
from tests.gendata import make_corpus

CORPUS = make_corpus()

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")


def _payloads(n):
    rng = random.Random(5)
    base = [CORPUS["text"], CORPUS["json"], CORPUS["period_3"],
            CORPUS["rand_255"], b"\0" * 3000]
    return [base[i % len(base)] * (1 + rng.randrange(3)) for i in range(n)]


def test_inflate_batch_threaded():
    payloads = _payloads(64)
    streams = [zlib.compress(p, 6) for p in payloads]
    rs, outs = native.native_inflate_batch(
        streams, [len(p) for p in payloads], 1, n_threads=8)
    for r, o, p in zip(rs, outs, payloads):
        assert r is Result.OK and o == p


def test_deflate_batch_threaded_roundtrip():
    payloads = _payloads(48)
    rs, comps = native.native_deflate_batch(payloads, level=6, flags=1,
                                            n_threads=8)
    assert all(r is Result.OK for r in rs)
    for c, p in zip(comps, payloads):
        assert zlib.decompress(c) == p


def test_resolve_tokens_threaded():
    # real token streams via the XLA decoder would need a device; build
    # adversarial + literal-only rows directly instead (the resolver's
    # thread pool doesn't care where tokens came from)
    rng = np.random.default_rng(9)
    N, T, C = 64, 512, 4096
    tokens = np.zeros((N, T), np.uint32)
    want = np.zeros(N, np.int32)
    for i in range(N):
        n = int(rng.integers(1, T))
        by = rng.integers(0, 256, n).astype(np.uint32)
        tokens[i, :n] = (1 << 30) | by          # single-byte literals
        want[i] = n
    inputs = np.zeros((N, 8), np.uint32)
    out = native.native_resolve_tokens(tokens, inputs, want, C,
                                       n_threads=8)
    for i in range(N):
        exp = (tokens[i, : want[i]] & 0xFF).astype(np.uint8)
        np.testing.assert_array_equal(out[i, : want[i]], exp)


def test_concurrent_oneshot_calls():
    # thread_local Inflater: concurrent dt_inflate calls from python
    # threads must not race (the reference's lazy static-table init is
    # exactly this hazard)
    payloads = _payloads(32)
    streams = [zlib.compress(p, 6) for p in payloads]

    def work(i):
        r, o = native.native_inflate(streams[i], len(payloads[i]), 1)
        return r is Result.OK and o == payloads[i]

    with ThreadPoolExecutor(max_workers=8) as ex:
        assert all(ex.map(work, range(len(streams))))


def test_concurrent_stitch_calls():
    lib = native.get_lib()
    payload = (CORPUS["text"] + CORPUS["json"]) * 6
    body = np.frombuffer(zlib.compress(payload, 6)[2:], np.uint8)

    def work(_):
        out = np.zeros(len(payload) + 64, np.uint8)
        r, total, _eb = native.stitch(lib, body, [0], None, out)
        return (r is Result.OK and total == len(payload)
                and out[:total].tobytes() == payload)

    with ThreadPoolExecutor(max_workers=6) as ex:
        assert all(ex.map(work, range(12)))
