"""Distribution layer: sharded decode on the virtual 8-device CPU mesh.

SURVEY §4's prescription: multi-chip tests via
``--xla_force_host_platform_device_count`` CPU simulation (set in
conftest).  Covers: stream-axis sharding, submission-order gather,
dictionary broadcast, psum'd stats, 2-D host×chip mesh, error containment
across shards.
"""

import zlib

import jax
import numpy as np
import pytest

from defl_jax.errors import Result
from defl_jax.parallel.mesh import make_host_chip_mesh, make_stream_mesh
from defl_jax.parallel.shard import DistributedCodec
from tests.gendata import make_corpus

CORPUS = make_corpus()


@pytest.fixture(scope="module")
def codec():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    return DistributedCodec(make_stream_mesh(), chunk_steps=128)


def test_sharded_batch_order_preserved(codec):
    """Outputs must come back in submission order (north-star 'ordered
    gather') even though lanes finish at different steps."""
    payloads = [bytes([i & 0xFF]) * (50 + 40 * i) for i in range(24)]
    streams = [zlib.compress(p, 6) for p in payloads]
    res, outs, stats = codec.inflate(streams, dst_capacities=1024)
    assert all(r is Result.OK for r in res)
    for i, (o, p) in enumerate(zip(outs, payloads)):
        assert o == p, i
    assert stats["shards"] == 8
    assert stats["total_bytes"] >= sum(len(p) for p in payloads)


def test_psum_stats(codec):
    payloads = [CORPUS["rand_64"]] * 16
    streams = [zlib.compress(p) for p in payloads]
    res, outs, stats = codec.inflate(streams, dst_capacities=1024)
    assert stats["ok_lanes"] >= 16  # padding lanes may also be counted OK? no:
    # padded lanes stall UNFINISHED, so ok_lanes == real ok count
    assert stats["ok_lanes"] == 16
    assert stats["total_bytes"] == 16 * 64


def test_error_containment_across_shards(codec):
    good = zlib.compress(CORPUS["text"][:500], 6)
    bad = b"\x07\x00\x00\x00"
    streams = [good, bad] * 8
    res, outs, _ = codec.inflate(streams, dst_capacities=1024)
    for i in range(0, 16, 2):
        assert res[i] is Result.OK
        assert outs[i] == CORPUS["text"][:500]
        assert res[i + 1] is Result.ERR


def test_dictionary_broadcast_sharded():
    d = b"the broadcast dictionary shared by all shards " * 8
    mesh = make_stream_mesh()
    codec = DistributedCodec(mesh, dictionary=d, chunk_steps=128)
    payloads = [b"the broadcast dictionary says stream %02d" % i
                for i in range(16)]
    streams = []
    for p in payloads:
        co = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=d)
        streams.append(co.compress(p) + co.flush())
    res, outs, _ = codec.inflate(streams, dst_capacities=1024)
    assert all(r is Result.OK for r in res)
    assert outs == payloads


def test_host_chip_2d_mesh():
    mesh = make_host_chip_mesh()
    assert mesh.devices.size == 8
    codec = DistributedCodec(mesh, chunk_steps=128)
    payloads = [CORPUS["period_4"][:700]] * 8
    streams = [zlib.compress(p) for p in payloads]
    res, outs, _ = codec.inflate(streams, dst_capacities=1024)
    assert all(r is Result.OK for r in res)
    assert all(o == payloads[0] for o in outs)


def test_uneven_batch_padding(codec):
    """Batch size not divisible by shard count."""
    payloads = [CORPUS["rand_255"]] * 11
    streams = [zlib.compress(p) for p in payloads]
    res, outs, _ = codec.inflate(streams, dst_capacities=1024)
    assert len(res) == 11
    assert all(r is Result.OK for r in res)
    assert all(o == payloads[0] for o in outs)


def test_budget_exhaustion_retries_on_host(codec):
    # a stream of thousands of empty blocks exhausts the device step
    # budget (status RUNNING); the sharded path must retry it on the
    # host engine instead of surfacing UNFINISHED (round-2 advisor)
    from tests.gendata import BitWriter, _fixed_lit_code

    w = BitWriter()
    for _ in range(3000):
        w.bits(0, 1).bits(1, 2)
        w.code(*_fixed_lit_code(256))
    w.bits(1, 1).bits(1, 2)
    w.code(*_fixed_lit_code(ord("Z")))
    w.code(*_fixed_lit_code(256))
    evil = w.getvalue()

    payload = b"normal stream " * 40
    # one flags value per call: run everything raw (strip zlib framing)
    streams = [zlib.compress(payload, 6)[2:-4] for _ in range(7)] + [evil]
    res, outs, _ = codec.inflate(streams, flags=0, dst_capacities=4096)
    assert res == [Result.OK] * 8
    assert outs[:7] == [payload] * 7
    assert outs[7] == b"Z"


def test_scaling_measurement_runs():
    """The scaling-evidence harness (bench_scaling.measure) must produce
    sane numbers on the virtual mesh: sharded decode correct, 8-shard
    never catastrophically slower than 1-shard, and the shard_map
    machinery not adding gross overhead over raw device_inflate.  Exact
    efficiency is recorded by bench.py (BENCH fields shard8_speedup /
    dist_overhead_pct); hard >=85% assertions need real chips."""
    from defl_jax.bench_scaling import measure, measure_overhead

    m = measure(n_streams=64, block=4096, reps=2)
    assert m["scaling_n_devices"] == 8
    assert m["shard1_s"] > 0 and m["shard8_s"] > 0
    # the virtual mesh shares 4 physical cores, so demand only "sharding
    # does not destroy throughput", not linear speedup
    assert m["shard8_speedup"] > 0.5, m
    # overhead measured here under the 8-virtual-device test env (the
    # bench runs it in a clean single-device process where it is ~0%);
    # only guard against gross machinery cost
    o = measure_overhead(n_streams=64, block=4096, reps=2)
    assert o["dist_overhead_pct"] < 60.0, o
