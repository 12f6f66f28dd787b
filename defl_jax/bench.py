"""Benchmark: batched inflate throughput on one NVIDIA GPU.

Decodes a batch of independent 64KB-block zlib streams (Silesia-style mix:
text, structured, binary, high-redundancy — generated from a seed) with
the device pipeline and reports the wall-clock rate of decompressed
output, every lane byte-compared.

Prints ONE JSON line on stdout:
  {"metric": "inflate_GBps_per_chip", "value": X, "unit": "GB/s", ...,
   "device": {"platform": "gpu", "kind": ..., "count": ...}}
``value`` is the wall clock of the overlapped pipeline over distinct
batches (device decode ‖ device→host token fetch ‖ host C++ resolve).
Diagnostics go to stderr.  Any failure, and a missing GPU, exit non-zero
with no JSON line.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time
import zlib


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def require_gpu():
    """(platform, device_kind, count) of JAX's devices; raises when the
    first device is not a GPU — measurements never fall back to the CPU."""
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's first device is {d.platform} "
                           f"({d.device_kind})")
    return d.platform, d.device_kind, len(devs)


def gpu_name_and_power() -> str:
    """The card's name and power limit as nvidia-smi reports them (a card
    below its maximum power limit runs slower under load)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60,
                       check=True)
    return r.stdout.strip()


def make_silesia_like(total_bytes: int, block: int = 65536, seed: int = 42):
    """Mixed-characteristic corpus blocks (text / JSON-ish / binary-struct /
    high-redundancy / semi-random), ~2:1 zlib ratio like Silesia."""
    rng = random.Random(seed)
    words = ("the of and to in is was he for it with as his on be at by had "
             "not are but from or have an they which one you were her all "
             "she there would their we him been has when who will more no "
             "if out so said what up its about into than them can only "
             "other new some could time these two may then do first any my "
             "now such like our over man me even most made after also did "
             "many before must through years where much your way down "
             "should because each just those people how too little state "
             "good very make world still own see men work long get here "
             "between both life being under never day same another know "
             "while last might us great old year off come since against go "
             "came right used take three").split()

    # generate up to 64 unique blocks and cycle them: per-lane decode work
    # is identical either way (lanes are independent), and corpus
    # generation stays O(seconds) at multi-GB batch sizes
    n_unique = min(64, (total_bytes + block - 1) // block)
    blocks = []
    produced = 0
    kind = 0
    while produced < n_unique * block:
        k = kind % 5
        kind += 1
        if k == 0:      # english-ish text
            b = (" ".join(rng.choice(words)
                          for _ in range(block // 5))).encode()[:block]
        elif k == 1:    # structured records (xml/json-ish)
            rows = []
            while sum(len(r) for r in rows) < block:
                rows.append(
                    b'<row id="%d" name="item-%d" value="%.6f"/>'
                    % (rng.randrange(10**6), rng.randrange(10**4),
                       rng.random()))
            b = b"\n".join(rows)[:block]
        elif k == 2:    # binary structs: correlated little-endian ints
            vals = bytearray()
            x = 1 << 20
            while len(vals) < block:
                x = (x + rng.randrange(-1000, 1000)) & 0xFFFFFFFF
                vals += x.to_bytes(4, "little")
            b = bytes(vals[:block])
        elif k == 3:    # high redundancy
            unit = rng.randbytes(rng.choice([3, 17, 64, 256]))
            b = (unit * (block // len(unit) + 1))[:block]
        else:           # semi-random with embedded repeats
            b = bytearray(rng.randbytes(block))
            blob = rng.randbytes(600)
            for _ in range(20):
                p = rng.randrange(0, block - 600)
                b[p : p + 600] = blob
            b = bytes(b)
        blocks.append(b)
        produced += len(b)
    n_total = (total_bytes + block - 1) // block
    return [blocks[i % len(blocks)] for i in range(n_total)]


def make_corpus(n_streams: int, block: int = 65536, seed: int = 42):
    """(payloads, zlib level-6 streams): n_streams blocks of the mix,
    each distinct block compressed once."""
    payloads = make_silesia_like(n_streams * block, block, seed)[:n_streams]
    comp = {}
    streams = []
    for p in payloads:
        if id(p) not in comp:
            comp[id(p)] = zlib.compress(p, 6)
        streams.append(comp[id(p)])
    return payloads, streams


def rotated_sink(payloads):
    """Pipeline sink checking batch i = streams[i:] + streams[:i]: True
    when every lane is OK and byte-equal to its payload."""
    import numpy as np

    n = len(payloads)
    want = [np.frombuffer(p, np.uint8) for p in payloads]

    def sink(i, status, out, dst_pos):
        return bool((status == 0).all()) and all(
            dst_pos[k] == want[(k + i) % n].size
            and np.array_equal(out[k, : dst_pos[k]], want[(k + i) % n])
            for k in range(n))

    return sink


def main():
    platform, kind, count = require_gpu()
    card = gpu_name_and_power()
    log(f"device: {platform} {kind} x{count}; nvidia-smi: {card}")

    n_streams = int(os.environ.get("DEFL_BENCH_STREAMS", "8192"))
    block = int(os.environ.get("DEFL_BENCH_BLOCK", "65536"))
    reps = int(os.environ.get("DEFL_BENCH_REPS", "3"))
    n_batches = int(os.environ.get("DEFL_BENCH_PIPELINE_BATCHES", "4"))

    import jax
    import jax.numpy as jnp
    import numpy as np

    from defl_jax.ops.inflate_batch import step_budget
    from defl_jax.runtime import native
    from defl_jax.runtime.pack import pack_streams
    from defl_jax.runtime.pipeline import pipeline_inflate
    from defl_jax.runtime.session import _pick_decoder

    if not native.available():
        raise RuntimeError("the C++ host library did not build")
    decode_tokens, K = _pick_decoder()

    log(f"generating {n_streams} x {block}B blocks ...")
    payloads, streams = make_corpus(n_streams, block)
    raw_bytes = sum(len(p) for p in payloads)
    comp_bytes = sum(len(s) for s in streams)
    log(f"raw={raw_bytes/1e6:.1f}MB comp={comp_bytes/1e6:.1f}MB "
        f"ratio={raw_bytes/comp_bytes:.2f}")

    packed = pack_streams(streams, 1, block)
    C = block
    T = step_budget(C)
    args = [jax.device_put(a) for a in (packed.words, packed.nbits,
                                        packed.zflag, packed.dst_cap)]

    # ---- phase 1: device token decode (compressed words already on the
    # device; timed to block_until_ready) ----
    fn = jax.jit(lambda *a: decode_tokens(*a, T=T, K=K))
    t0 = time.perf_counter()
    toks, st = jax.block_until_ready(fn(*args))
    log(f"decode first call (compile + run): {time.perf_counter()-t0:.1f}s")
    dec = []
    for _ in range(reps):
        t0 = time.perf_counter()
        toks, st = jax.block_until_ready(fn(*args))
        dec.append(time.perf_counter() - t0)
    dec_s = min(dec)
    log(f"decode: {[round(t, 4) for t in dec]} s -> "
        f"{raw_bytes/dec_s/1e9:.3f} GB/s")

    # ---- phase 2: token fetch + host multithreaded LZ77 resolve ----
    t0 = time.perf_counter()
    rows = min(toks.shape[0], -(-int(st["tok_rows"]) // 4096) * 4096)
    toks_nt = np.asarray(jnp.transpose(toks[:rows]))
    dst_pos = np.asarray(st["dst_pos"])
    status = np.asarray(st["status"])
    fetch_s = time.perf_counter() - t0
    res = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = native.native_resolve_tokens(toks_nt, packed.words, dst_pos, C)
        res.append(time.perf_counter() - t0)
    res_s = min(res)
    log(f"fetch {toks_nt.nbytes/1e6:.0f}MB: {fetch_s:.3f}s; host resolve: "
        f"{[round(t, 4) for t in res]} s -> {raw_bytes/res_s/1e9:.3f} GB/s")
    bad = int((status != 0).sum()) + sum(
        out[i, : dst_pos[i]].tobytes() != payloads[i]
        for i in range(n_streams))
    if bad:
        raise RuntimeError(f"{bad} lanes mismatch")
    del toks, toks_nt, out

    # ---- phase 3: the overlapped pipeline over distinct batches (rotated
    # stream order), real device->host fetch; every lane byte-compared ----
    batches = [streams[i:] + streams[:i] for i in range(n_batches)]
    wall = float("inf")
    for _ in range(reps):
        per_batch, w = pipeline_inflate(batches, C,
                                        sink=rotated_sink(payloads),
                                        chunk_steps=K)
        if not all(per_batch):
            raise RuntimeError("pipeline output mismatch")
        wall = min(wall, w)
    pipe_gbps = raw_bytes * n_batches / wall / 1e9
    log(f"pipeline: {n_batches} batches in {wall:.3f}s -> "
        f"{pipe_gbps:.3f} GB/s")

    result = {
        "metric": "inflate_GBps_per_chip",
        "value": round(pipe_gbps, 4),
        "unit": "GB/s",
        "decode_GBps": round(raw_bytes / dec_s / 1e9, 4),
        "token_fetch_s": round(fetch_s, 4),
        "host_resolve_GBps": round(raw_bytes / res_s / 1e9, 4),
        "pipeline_wall_s": round(wall, 4),
        "streams": n_streams,
        "block": block,
        "decode_K": K,
        "raw_mb": round(raw_bytes / 1e6, 1),
        "host_cores": os.cpu_count(),
        "card": card,
        "device": {"platform": platform, "kind": kind, "count": count},
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
