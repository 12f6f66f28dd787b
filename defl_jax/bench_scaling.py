"""Sharding-overhead probes on the virtual CPU mesh.  These are CPU
numbers, never device metrics: they check that the shard_map machinery
adds no gross cost.  Two proxies are measured:

  - ``shard8_speedup``: wall-clock of the SAME total batch decoded by
    ``DistributedCodec`` on an 8-virtual-device mesh vs a 1-device mesh
    (strong scaling of the shard_map pipeline; on a shared-core CPU host
    this is bounded by physical cores, so it falsifies gross sharding
    overhead rather than demonstrating device scaling),
  - ``dist_overhead_pct``: ``DistributedCodec`` on a 1-device mesh vs raw
    ``device_inflate`` on the same batch — the cost of the shard_map /
    sharding machinery itself (per-device work is identical across
    devices; only this wrapper and the psum'd stats differ from the
    single-device path).  Measured in a CLEAN
    single-device process (``overhead`` mode): under a virtual 8-device
    backend the XLA:CPU thread-pool split skews the 1-device comparison
    by ~20%, an environment artifact, not codec overhead.

Run standalone:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python -m defl_jax.bench_scaling            # virtual-mesh scaling
  JAX_PLATFORMS=cpu python -m defl_jax.bench_scaling overhead

Each prints one JSON line.
"""

from __future__ import annotations

import json
import sys
import time
import zlib


def measure(n_streams: int = 256, block: int = 32768, reps: int = 5):
    import jax
    import numpy as np

    from defl_jax.bench import make_silesia_like
    from defl_jax.parallel.mesh import make_stream_mesh
    from defl_jax.parallel.shard import DistributedCodec
    from defl_jax.runtime.session import device_inflate

    devs = jax.devices()
    payloads = make_silesia_like(n_streams * block, block)[:n_streams]
    streams = [zlib.compress(p, 6) for p in payloads]
    raw_bytes = sum(len(p) for p in payloads)

    def time_codec(codec):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            res, outs, _ = codec.inflate(streams, dst_capacities=block)
            best = min(best, time.perf_counter() - t0)
        assert all(int(r) == 0 for r in res)
        assert outs[17] == payloads[17]
        return best

    codec1 = DistributedCodec(mesh=make_stream_mesh(devs[:1]))
    codec_n = DistributedCodec(mesh=make_stream_mesh(devs))
    time_codec(codec1)   # compile
    time_codec(codec_n)  # compile
    shard1_s = time_codec(codec1)
    shardn_s = time_codec(codec_n)

    n = len(devs)
    out = {
        "scaling_n_devices": n,
        "scaling_raw_mb": round(raw_bytes / 1e6, 1),
        "shard1_s": round(shard1_s, 4),
        f"shard{n}_s": round(shardn_s, 4),
        f"shard{n}_speedup": round(shard1_s / shardn_s, 3),
    }
    # NOTE: speedup here compares n devices to an UNPINNED 1-device run
    # whose XLA:CPU intra-op threads already use every core, so
    # speedup/n is NOT an efficiency number (measured swing 48-90%
    # depending on how much intra-op parallelism helped the baseline).
    # The honest efficiency pairs shard<n>_s with the pinned1 mode's
    # one-core baseline — bench.py computes scaling_eff_cores_matched.
    return out


def measure_pinned1(n_streams: int = 256, block: int = 32768,
                    reps: int = 5):
    """1-device decode with the PROCESS PINNED TO ONE CORE (affinity set
    in main() before XLA spawns its thread pool).  This is the honest
    single-device baseline for cores-matched scaling efficiency: an
    unpinned 1-device run lets XLA:CPU's intra-op threads use every core,
    which deflates the measured speedup of the N-device mesh by however
    much intra-op parallelism happened to help that day (measured swing:
    48-90%).  Efficiency = shard1core_s / (cores * shard<cores>_s) is
    then a true strong-scaling number: same total work, N x the cores,
    one device per core — the CPU-mesh analog of the >=85% multi-chip
    north star (SURVEY §6)."""
    import jax

    from defl_jax.bench import make_silesia_like
    from defl_jax.parallel.mesh import make_stream_mesh
    from defl_jax.parallel.shard import DistributedCodec

    payloads = make_silesia_like(n_streams * block, block)[:n_streams]
    streams = [zlib.compress(p, 6) for p in payloads]
    codec = DistributedCodec(mesh=make_stream_mesh(jax.devices()[:1]))
    codec.inflate(streams, dst_capacities=block)  # compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        res, outs, _ = codec.inflate(streams, dst_capacities=block)
        best = min(best, time.perf_counter() - t0)
    assert all(int(r) == 0 for r in res)
    assert outs[17] == payloads[17]
    return {"shard1core_s": round(best, 4)}


def measure_overhead(n_streams: int = 256, block: int = 32768,
                     reps: int = 3):
    """DistributedCodec(1-device mesh) vs raw device_inflate, same batch,
    clean single-device process: the shard_map/gather/psum machinery's
    own cost (north-star reachability requires <=5%)."""
    import jax

    from defl_jax.bench import make_silesia_like
    from defl_jax.parallel.mesh import make_stream_mesh
    from defl_jax.parallel.shard import DistributedCodec
    from defl_jax.runtime.session import device_inflate

    payloads = make_silesia_like(n_streams * block, block)[:n_streams]
    streams = [zlib.compress(p, 6) for p in payloads]

    codec = DistributedCodec(mesh=make_stream_mesh(jax.devices()[:1]))

    def t_codec():
        t0 = time.perf_counter()
        res, outs, _ = codec.inflate(streams, dst_capacities=block)
        dt = time.perf_counter() - t0
        assert outs[17] == payloads[17]
        return dt

    def t_raw():
        t0 = time.perf_counter()
        res, outs, _ = device_inflate(streams, dst_capacities=block,
                                      resolve="device")
        dt = time.perf_counter() - t0
        assert outs[17] == payloads[17]
        return dt

    t_codec(); t_raw()  # compile both
    # interleave A/B rounds: background machine drift otherwise swings
    # the comparison by +-12% (measured)
    codec_s = raw_s = float("inf")
    for _ in range(reps):
        codec_s = min(codec_s, t_codec())
        raw_s = min(raw_s, t_raw())
    return {
        "dist_overhead_pct": round(100.0 * (codec_s - raw_s) / raw_s, 1),
        "codec1_s": round(codec_s, 4),
        "raw_device_inflate_s": round(raw_s, 4),
    }


def main():
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"  # a virtual-mesh tool
    mode = sys.argv[1] if len(sys.argv) > 1 else "scaling"
    flags = os.environ.get("XLA_FLAGS", "")
    if mode == "pinned1":
        # pin before jax import: XLA's thread pool inherits the mask
        os.sched_setaffinity(0, {sorted(os.sched_getaffinity(0))[0]})
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=1").strip()
    elif (mode.startswith("scaling")
            and "xla_force_host_platform_device_count" not in flags):
        # "scaling" = 8 virtual devices (sharding overhead at scale);
        # "scaling4" = devices matched to physical cores, where the
        # speedup/devices ratio is a real efficiency number
        nd = int(mode[7:]) if len(mode) > 7 else 8
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={nd}").strip()
        mode = "scaling"
    res = (measure() if mode == "scaling" else
           measure_pinned1() if mode == "pinned1" else measure_overhead())
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
