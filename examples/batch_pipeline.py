"""Production-shape usage: batch decode, overlapped pipeline, encode,
and the distributed codec.

The reference's README demonstrates per-stream usage (infl_buf /
infl_include / infl_stream, README.md:90-155); this example shows the
batch shapes that replace them at scale.  Runs on any backend — CPU
for a smoke run, the GPU for rate:

    python examples/batch_pipeline.py          # real backend
    JAX_PLATFORMS=cpu python examples/batch_pipeline.py
"""

import os
import sys
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import numpy as np

    from defl_jax import deflate_batch, inflate_batch

    rng = np.random.default_rng(1)
    payloads = [
        (b"a structured record, " * 50)[: rng.integers(200, 1000)]
        for _ in range(64)
    ]

    # -- encode a batch (threads on host; backend="device" adds the device
    #    Huffman bit-pack stage), sizes at-or-below zlib level 6 --------
    streams = deflate_batch(payloads, level=6)
    z6 = sum(len(zlib.compress(bytes(p), 6)) for p in payloads)
    print(f"encode: {sum(map(len, streams))} bytes vs zlib-6 {z6}")

    # -- batch decode: one call, per-stream status containment ---------
    results, outputs = inflate_batch(streams, backend="auto")
    assert all(int(r) == 0 for r in results)
    assert all(bytes(o) == bytes(p) for o, p in zip(outputs, payloads))
    print(f"inflate_batch: {len(streams)} streams ok")

    # a malformed stream errs alone; the batch survives (≙ the per-lane
    # status arrays replacing the reference's single UnzResult)
    broken = list(streams)
    broken[3] = b"\x78\x9c" + b"\xff" * 40
    results, outputs = inflate_batch(broken)
    assert int(results[3]) != 0
    assert sum(int(r) != 0 for r in results) == 1
    print("containment: lane 3 ERR, 63 lanes ok")

    # -- overlapped pipeline: device decode ‖ host resolve, a sink
    #    consumes each batch as it lands (streaming outputs onward) -----
    from defl_jax.runtime.pipeline import pipeline_inflate

    batches = [streams[i:] + streams[:i] for i in range(4)]
    seen = []
    per_batch, wall = pipeline_inflate(
        batches, dst_capacity=1024,
        sink=lambda i, status, out, dst_pos: seen.append(
            (i, int((status == 0).sum()))))
    assert sorted(s[0] for s in seen) == [0, 1, 2, 3]
    print(f"pipeline: 4 batches in {wall:.2f}s, ok-counts "
          f"{[s[1] for s in sorted(seen)]}")

    # -- distributed: shard the stream axis over every device, preset
    #    dictionary broadcast, submission-order gather ------------------
    from defl_jax.parallel.shard import DistributedCodec

    dictionary = b"a structured record, "
    dict_streams = []
    for p in payloads[:16]:
        co = zlib.compressobj(6, zlib.DEFLATED, 15, 8,
                              zlib.Z_DEFAULT_STRATEGY, zdict=dictionary)
        dict_streams.append(co.compress(bytes(p)) + co.flush())
    codec = DistributedCodec(dictionary=dictionary)
    res, outs, stats = codec.inflate(dict_streams, dst_capacities=1024)
    assert all(int(r) == 0 for r in res)
    assert all(bytes(o) == bytes(p) for o, p in zip(outs, payloads[:16]))
    print(f"DistributedCodec: {len(dict_streams)} FDICT streams over "
          f"{stats['shards']} shard(s) ok")


if __name__ == "__main__":
    main()
