"""Overlapped decode‖resolve pipeline (runtime/pipeline.py) on CPU.

The perf shape is benchmarked on the GPU (bench.py phase 3); these tests
cover correctness plumbing: per-batch results, sink consumption, and the
host retry of step-budget-exhausted lanes.
"""

import zlib

import pytest

from defl_jax.errors import Result
from defl_jax.runtime import native
from defl_jax.runtime.pipeline import pipeline_inflate

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native library unavailable")


@needs_native
def test_pipeline_batches_bit_exact():
    payloads = [b"data %d " % i * 50 for i in range(16)]
    batch = [zlib.compress(p, 6) for p in payloads]
    per_batch, wall = pipeline_inflate([batch, batch], 4096, as_bytes=True)
    assert wall > 0
    for results, outputs in per_batch:
        assert results == [Result.OK] * 16
        assert outputs == payloads


@needs_native
def test_pipeline_retries_budget_exhausted_lanes():
    from tests.gendata import BitWriter, _fixed_lit_code

    w = BitWriter()
    for _ in range(3000):
        w.bits(0, 1).bits(1, 2)
        w.code(*_fixed_lit_code(256))
    w.bits(1, 1).bits(1, 2)
    w.code(*_fixed_lit_code(ord("Y")))
    w.code(*_fixed_lit_code(256))
    evil = w.getvalue()

    payloads = [b"ok stream " * 30 for _ in range(7)]
    batch = [zlib.compress(p, 6)[2:-4] for p in payloads] + [evil]
    per_batch, _ = pipeline_inflate([batch], 2048, flags=0, as_bytes=True)
    results, outputs = per_batch[0]
    assert results == [Result.OK] * 8
    assert outputs[:7] == payloads
    assert outputs[7] == b"Y"


@needs_native
def test_pipeline_retry_does_not_corrupt_later_batches():
    """A retry batch defers to its own worker; the shared sink output
    buffer must be snapshotted so later batches' resolves (which reuse
    the buffer) don't corrupt the retried batch's rows."""
    from tests.gendata import BitWriter, _fixed_lit_code

    w = BitWriter()
    for _ in range(3000):
        w.bits(0, 1).bits(1, 2)
        w.code(*_fixed_lit_code(256))
    w.bits(1, 1).bits(1, 2)
    w.code(*_fixed_lit_code(ord("Y")))
    w.code(*_fixed_lit_code(256))
    evil = w.getvalue()

    pay_a = [b"batch A lane %d " % k * 20 for k in range(7)]
    pay_b = [b"batch B lane %d " % k * 25 for k in range(8)]
    batch_a = [zlib.compress(p, 6)[2:-4] for p in pay_a] + [evil]
    batch_b = [zlib.compress(p, 6)[2:-4] for p in pay_b]

    got = {}

    def sink(i, status, out, dst_pos):
        got[i] = (list(status),
                  [out[k, : int(dst_pos[k])].tobytes()
                   for k in range(len(status))])
        return i

    per_batch, _ = pipeline_inflate([batch_a, batch_b], 2048, flags=0,
                                    sink=sink)
    assert per_batch == [0, 1]
    st_a, out_a = got[0]
    assert all(s == 0 for s in st_a)
    assert out_a[:7] == pay_a and out_a[7] == b"Y"
    st_b, out_b = got[1]
    assert all(s == 0 for s in st_b)
    assert out_b == pay_b
