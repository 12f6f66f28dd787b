"""Smoke run of the device inflate path on one NVIDIA GPU.

    python chip_smoke.py               # phases a-f on one card
    python chip_smoke.py --four-cards  # phase g alone, on four cards

Phases (one process; every kernel is the compiled one, none interpreted):
  a. ``defl_jax.inflate_batch(streams, backend="device")`` on the seeded
     8192 x 64 KB mixed corpus (the bench corpus), every lane
     byte-compared with its payload;
  b. the GPU decode kernel against the XLA lockstep decoder on the same
     packed batch: per-lane token sequences, status, dst_pos and bitpos
     bit-identical (integer work, exact);
  c. ``pipeline_inflate`` over distinct batches with the real
     device->host token fetch, every lane byte-compared;
  d. the device resolver (ops/resolve.py) against the C++ resolver on
     1024 lanes, byte-identical;
  e. ``device_deflate`` against the host encoder, byte-identical, and a
     ``DeviceInflateSession`` fed in pieces;
  f. the tests marked ``gpu``, in this process;
  g. (``--four-cards``) ``DistributedCodec`` on a 1-D mesh of 4 cards
     against zlib and against the one-card ``inflate_batch``.

Fails (non-zero exit, no result line) when JAX's device is not a GPU, the
C++ host library does not build, any lane mismatches, or any valid lane
takes the host fallback.  Wall times printed here are smoke timings of
one run, not benchmark numbers.  The last stdout line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

STREAMS = 8192
BLOCK = 65536
PIPELINE_BATCHES = 3
RESOLVE_LANES = 1024
DEFLATE_LANES = 1024


def say(*a):
    print(*a, flush=True)


class Check(Exception):
    """A smoke phase found a wrong result."""


def check(cond, what):
    if not cond:
        raise Check(what)


def timed(label, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    say(f"  smoke timing: {label} {time.perf_counter() - t0:.3f} s")
    return out


def fallback_lanes():
    from defl_jax import metrics

    return metrics.snapshot().get("host_fallback_lanes", 0)


def phase_a(payloads, streams):
    import defl_jax

    for run in ("first call (compile + run)", "second call"):
        before = fallback_lanes()
        res, outs = timed(f"inflate_batch {run}", defl_jax.inflate_batch,
                          streams, backend="device", dst_capacities=BLOCK)
        bad = sum(r != defl_jax.Result.OK or o != p
                  for r, o, p in zip(res, outs, payloads))
        check(bad == 0, f"inflate_batch: {bad} lanes mismatch")
        check(fallback_lanes() == before, "inflate_batch: host fallback")
    say(f"a. inflate_batch: {len(streams)} lanes byte-exact, "
        "0 host-fallback lanes")
    return outs


def compile_and_run(label, fn, args, reps=2):
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    say(f"  {label}: compile {time.perf_counter() - t0:.1f} s; "
        f"{compiled.memory_analysis()}")
    out = jax.block_until_ready(compiled(*args))
    for _ in range(reps):
        out = timed(label, lambda: jax.block_until_ready(compiled(*args)))
    return out


def phase_b(packed):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from defl_jax.ops.inflate_batch import decode_tokens, step_budget
    from defl_jax.ops.pallas.decode_gpu import CHUNK_STEPS, decode_tokens_gpu

    T = step_budget(BLOCK)
    args = [jax.device_put(a) for a in (packed.words, packed.nbits,
                                        packed.zflag, packed.dst_cap)]
    kern = compile_and_run(
        "decode kernel", lambda *a: decode_tokens_gpu(*a, T=T,
                                                      K=CHUNK_STEPS), args)
    xla = compile_and_run(
        "decode XLA", lambda *a: decode_tokens(*a, T=T, K=128), args,
        reps=1)

    @jax.jit
    def compact(t):
        # per lane: the non-NOP tokens moved to the front, in order
        keep = t != 0
        pos = jnp.where(keep, jnp.cumsum(keep, axis=0, dtype=jnp.int32) - 1,
                        t.shape[0])
        lane = jnp.broadcast_to(jnp.arange(t.shape[1]), t.shape)
        return (jnp.zeros_like(t).at[pos, lane].set(t, mode="drop"),
                keep.sum(axis=0))

    (ta, na), (tb, nb) = compact(kern[0]), compact(xla[0])
    rows = min(ta.shape[0], tb.shape[0])
    check(bool(jnp.all(na == nb)) and int(na.max()) <= rows
          and bool(jnp.all(ta[:rows] == tb[:rows])),
          "kernel and XLA token sequences differ")
    for key in ("status", "dst_pos", "bitpos"):
        check(np.array_equal(np.asarray(kern[1][key]),
                             np.asarray(xla[1][key])),
              f"kernel and XLA {key} differ")
    check(bool((kern[1]["status"] == 0).all()), "kernel: lanes not OK")
    say(f"b. kernel vs XLA: tokens ({int(na.sum())}), status, dst_pos, "
        "bitpos bit-identical")
    return kern


def phase_c(payloads, streams):
    from defl_jax.bench import rotated_sink
    from defl_jax.runtime.pipeline import pipeline_inflate

    batches = [streams[i:] + streams[:i] for i in range(PIPELINE_BATCHES)]
    before = fallback_lanes()
    per_batch, wall = pipeline_inflate(batches, BLOCK,
                                       sink=rotated_sink(payloads))
    check(all(per_batch), "pipeline: lanes mismatch")
    check(fallback_lanes() == before, "pipeline: host fallback")
    say(f"c. pipeline_inflate: {PIPELINE_BATCHES} batches byte-exact; "
        f"smoke timing: wall {wall:.3f} s")


def phase_d(packed, kern):
    import jax.numpy as jnp
    import numpy as np

    from defl_jax.ops.resolve import resolve_tokens
    from defl_jax.runtime import native

    n = RESOLVE_LANES
    toks, st = kern
    rows = -(-int(st["tok_rows"]) // 4096) * 4096
    toks = toks[:rows, :n]
    words = jnp.asarray(packed.words[:n])
    dst = st["dst_pos"][:n]
    dev = timed("device resolve (compile + run)",
                lambda: np.asarray(resolve_tokens(toks, words, dst,
                                                  C=BLOCK)))
    host = timed("C++ resolve", native.native_resolve_tokens,
                 np.asarray(jnp.transpose(toks)), packed.words[:n],
                 np.asarray(dst), BLOCK)
    # the C++ resolver may leave slack bytes past a lane's end
    host[np.arange(BLOCK)[None, :] >= np.asarray(dst)[:, None]] = 0
    check(np.array_equal(dev, host), "device and C++ resolvers differ")
    say(f"d. device resolver vs C++ resolver: {n} lanes byte-identical")


def phase_e(payloads):
    import numpy as np

    from defl_jax.runtime import native
    from defl_jax.runtime.session import device_deflate
    from defl_jax.runtime.stream_device import DeviceInflateSession

    pays = payloads[:DEFLATE_LANES]
    _, host = native.native_deflate_batch(pays, level=6)
    st = {}
    dev = timed("device_deflate (compile + run)", device_deflate, pays,
                level=6, stats_out=st)
    check(dev == host, "device_deflate differs from the host encoder")
    check(not st["device_fallbacks"], "device_deflate: host fallback")
    check(all(zlib.decompress(c) == p for c, p in zip(dev[:64], pays)),
          "device_deflate output does not inflate")

    n, piece = 64, 4096
    streams = [zlib.compress(p, 6) for p in payloads[:n]]
    sess = DeviceInflateSession(n, BLOCK)
    longest = max(len(s) for s in streams)
    for lo in range(0, longest, piece):
        sess.feed([s[lo:lo + piece] for s in streams])
    for _ in range(4):  # lanes still running drain their backlog
        if not (np.asarray(sess.carry["status"]) == 127).any():
            break
        sess.feed([b""] * n)
    res, outs = sess.outputs()
    check(all(int(r) == 0 for r in res) and outs == list(payloads[:n]),
          "DeviceInflateSession output differs")
    check(np.all(np.asarray(sess.carry["status"]) == 0),
          "DeviceInflateSession lanes not OK")
    say(f"e. device_deflate: {len(pays)} payloads byte-identical to the "
        f"host encoder; DeviceInflateSession: {n} lanes fed in "
        f"{piece}-byte pieces, byte-exact")


def phase_f():
    import pytest

    class Count:
        passed = failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed:
                self.failed += 1

    count = Count()
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(tests, "test_decode_gpu.py"),
                      os.path.join(tests, "test_large.py")],
                     plugins=[count])
    check(rc == 0 and count.failed == 0 and count.passed > 0,
          f"gpu tests: rc={rc} passed={count.passed} "
          f"failed={count.failed}")
    say(f"f. gpu-marked tests: {count.passed} passed")


def phase_g(payloads, streams):
    import jax

    import defl_jax
    from defl_jax.parallel.mesh import make_stream_mesh
    from defl_jax.parallel.shard import DistributedCodec

    check(len(jax.devices()) >= 4,
          f"--four-cards needs 4 GPUs, found {len(jax.devices())}")
    mesh = make_stream_mesh(jax.devices()[:4])
    codec = DistributedCodec(mesh)
    before = fallback_lanes()
    for run in ("first call (compile + run)", "second call"):
        res, outs, stats = timed(f"DistributedCodec 4 cards {run}",
                                 codec.inflate, streams,
                                 dst_capacities=BLOCK)
    check(all(r == defl_jax.Result.OK for r in res),
          "DistributedCodec: lanes not OK")
    check(outs == list(payloads), "DistributedCodec differs from zlib")
    check(stats["shards"] == 4 and stats["ok_lanes"] == len(streams),
          f"DistributedCodec stats {stats['shards']} "
          f"{stats['ok_lanes']}")
    res1, outs1 = timed("inflate_batch one card", defl_jax.inflate_batch,
                        streams, backend="device", dst_capacities=BLOCK)
    check(outs1 == outs and res1 == res,
          "DistributedCodec differs from the one-card path")
    check(fallback_lanes() == before, "host fallback")
    say(f"g. DistributedCodec on 4 cards: {len(streams)} lanes "
        "byte-identical to zlib and to the one-card inflate_batch")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the DistributedCodec phase on 4 cards")
    opts = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        say(f"no GPU: JAX's first device is {d.platform} ({d.device_kind})")
        return 1
    from defl_jax.bench import gpu_name_and_power, make_corpus
    from defl_jax.runtime import native
    from defl_jax.runtime.pack import pack_streams

    if not native.available():
        say("the C++ host library did not build")
        return 1
    card = gpu_name_and_power()
    say(f"device: {d.platform} {d.device_kind} x{len(devs)}")
    t_start = time.perf_counter()
    payloads, streams = timed("corpus", make_corpus, STREAMS, BLOCK)
    try:
        if opts.four_cards:
            phase_g(payloads, streams)
        else:
            phase_a(payloads, streams)
            packed = timed("pack", pack_streams, streams, 1, BLOCK)
            kern = phase_b(packed)
            phase_d(packed, kern)
            del kern
            phase_c(payloads, streams)
            phase_e(payloads)
            phase_f()
    except Check as e:
        say(f"FAILED: {e}")
        return 1
    stats = d.memory_stats() or {}
    say(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}; "
        f"smoke timing: total {time.perf_counter() - t_start:.1f} s")
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
