"""Device streaming session: carry-resume across incremental feeds.

≙ the reference's infl_stream tests (test_file_streaming,
test/test_files.c:688-790) run against the device decoder's carry pytree.
"""

import zlib

import pytest

from defl_jax.errors import Result
from defl_jax.runtime.stream_device import DeviceInflateSession
from tests.gendata import make_corpus

CORPUS = make_corpus()


def test_incremental_feeds_resume():
    payloads = [CORPUS["text"][:700], CORPUS["period_7"][:600],
                CORPUS["rand_255"], CORPUS["json"][:500]]
    streams = [zlib.compress(p, 6) for p in payloads]
    sess = DeviceInflateSession(4, 1024)

    feed = 48
    pos = [0] * 4
    done = False
    rounds = 0
    while not done and rounds < 60:
        chunk = []
        for i, s in enumerate(streams):
            chunk.append(s[pos[i] : pos[i] + feed])
            pos[i] += feed
        res = sess.feed(chunk)
        done = all(r is not Result.UNFINISHED for r in res)
        rounds += 1

    res, outs = sess.outputs()
    assert all(r is Result.OK for r in res), res
    assert outs == payloads
    assert rounds > 1  # genuinely incremental


def test_single_byte_feeds():
    p = CORPUS["rand_64"]
    s = zlib.compress(p, 6)
    sess = DeviceInflateSession(2, 256)
    for i in range(len(s)):
        res = sess.feed([s[i : i + 1], s[i : i + 1]])
    assert all(r is Result.OK for r in res)
    _, outs = sess.outputs()
    assert outs == [p, p]


def test_efull_resize_resume_device():
    p = b"w" * 800
    s = zlib.compress(p, 6)
    sess = DeviceInflateSession(1, 100)
    res = sess.feed([s])
    assert res[0] is Result.EFULL
    sess.resize_output(1024)
    res = sess.feed([b""])
    assert res[0] is Result.OK
    _, outs = sess.outputs()
    assert outs[0] == p


def test_feed_cost_independent_of_history():
    """Rebasing must keep the unconsumed backlog (the per-feed repack and
    upload volume) bounded by the feed size, regardless of how much has
    streamed through (≙ mem.c:219-232 chunk drop).  Streams ~400KB
    through a 64KB-window session in 4KB feeds and asserts the retained
    input never grows with history."""
    import numpy as np

    rng = np.random.default_rng(3)
    # compressible but non-trivial: repeated 64-byte units + noise
    parts = []
    for _ in range(100):
        unit = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
        parts.append(unit * 60 + rng.integers(0, 256, 256,
                                              dtype=np.uint8).tobytes())
    payload = b"".join(parts)[:400_000]
    s = zlib.compress(payload, 6)
    sess = DeviceInflateSession(1, 1 << 19)

    feed = 4096
    max_backlog = 0
    for off in range(0, len(s), feed):
        sess.feed([s[off : off + feed]])
        max_backlog = max(max_backlog, len(sess.bufs[0]))
    res, outs = sess.outputs()
    assert res[0] is Result.OK
    assert outs[0] == payload
    # backlog stays O(feed), not O(history): all consumed input dropped
    assert max_backlog <= 4 * feed, max_backlog
    # the 4-byte adler trailer is never consumed (reference parity:
    # decode stops at the final block's EOB, SURVEY §2.1)
    assert sess.input_pos(0) == len(s) - 4
