"""Long-running cross-engine differential soak (not collected by pytest).

Ground truth is CPython zlib.  Every iteration builds a payload from a
randomized generator mix, compresses it (zlib at a random level, or our
own encoder), and drives the result through every decode engine:

  - core.oracle (pure-Python resumable engine, random feed granularity)
  - native serial (dt_inflate)
  - native parallel large-stream (dt_inflate_large, random seg_bytes)
  - XLA lockstep decode + native resolve (CPU backend, small batches)

plus mutation rounds where all engines must agree on accept/reject and
never crash.  Run manually / from a cron lane:

    JAX_PLATFORMS=cpu python tests/soak_differential.py [seconds] [seed]

Prints a one-line summary; exits non-zero on any divergence.
"""

from __future__ import annotations

import os
import random
import sys
import time
import zlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def gen_payload(rng: random.Random, blocks) -> bytes:
    kind = rng.randrange(8)
    if kind == 0:
        return rng.randbytes(rng.randrange(0, 20000))
    if kind == 1:
        return rng.randbytes(rng.choice([1, 2, 3, 4, 7, 32])) \
            * rng.randrange(1, 5000)
    if kind == 2:
        return bytes(rng.choice(blocks)[: rng.randrange(1, 65536)])
    if kind == 3:
        return b"\x00" * rng.randrange(0, 300000)
    if kind == 4:
        return bytes(bytearray(rng.randbytes(300)) * rng.randrange(1, 200))
    if kind == 5:  # far matches
        base = rng.randbytes(400)
        out = bytearray(base)
        for _ in range(rng.randrange(1, 60)):
            out += rng.randbytes(rng.randrange(0, 2000))
            out += base[: rng.randrange(3, 400)]
        return bytes(out)
    if kind == 6:  # text-ish
        return (b" ".join(rng.choice(blocks)[:50] for _ in range(200)))
    return rng.choice(blocks) + rng.randbytes(rng.randrange(0, 500))


def main():
    budget_s = float(sys.argv[1]) if len(sys.argv) > 1 else 600
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else int(time.time())
    rng = random.Random(seed)

    import numpy as np

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from defl_jax.bench import make_silesia_like
    from defl_jax.core.oracle import InflateEngine
    from defl_jax.errors import Result
    from defl_jax.ops.inflate_batch import decode_tokens, step_budget
    from defl_jax.runtime import native
    from defl_jax.runtime.large import inflate_large
    from defl_jax.runtime.pack import pack_streams

    blocks = make_silesia_like(8 << 20, 65536)
    t_end = time.time() + budget_s
    it = 0
    device_batch: list[tuple[bytes, bytes]] = []

    def run_device_batch():
        streams = [c for c, _ in device_batch]
        wants = [p for _, p in device_batch]
        cap = max(max(len(p) for p in wants), 1)
        cap = 1 << (cap - 1).bit_length()
        packed = pack_streams(streams, 1, cap)
        # bucket the words width to a power of two: every distinct W is
        # a fresh XLA:CPU compile of the lockstep decoder, and a 30-min
        # soak at one-compile-per-batch accumulates LLVM state until the
        # process OOMs (observed: ENOMEM -> SIGSEGV ~25 min in)
        W = packed.words.shape[1]
        w_pad = 1 << max(W - 1, 1).bit_length()
        if w_pad != W:
            wp = np.zeros((packed.n, w_pad), packed.words.dtype)
            wp[:, :W] = packed.words
            packed.words = wp
        toks, st = decode_tokens(
            jnp.asarray(packed.words), jnp.asarray(packed.nbits),
            jnp.asarray(packed.zflag), jnp.asarray(packed.dst_cap),
            T=step_budget(cap), K=128)
        tn = np.asarray(jnp.transpose(toks))
        dp = np.asarray(st["dst_pos"])
        status = np.asarray(st["status"])
        out = native.native_resolve_tokens(tn, packed.words, dp, cap)
        for i, want in enumerate(wants):
            assert status[i] == 0, (seed, it, "device status", status[i])
            assert out[i, : dp[i]].tobytes() == want, \
                (seed, it, "device mismatch", i)
        device_batch.clear()

    while time.time() < t_end:
        it += 1
        p = gen_payload(rng, blocks)
        lvl = rng.choice([0, 1, 2, 4, 6, 9])
        if rng.random() < 0.25:
            comp = native.native_deflate(p, max(lvl, 1))
        else:
            comp = zlib.compress(p, lvl)

        # oracle at a random feed granularity
        if len(comp) < 300000 and rng.random() < 0.3:
            eng = InflateEngine(len(p) + 1)
            g = rng.choice([1, 7, 4096, len(comp) or 1])
            r = None
            for ofs in range(0, len(comp), g):
                eng.include(comp[ofs : ofs + g])
                r = eng.step()
            assert r is Result.OK and bytes(eng.out) == p, (seed, it, "oracle")

        r, out = native.native_inflate(comp, len(p) + 1)
        assert r is Result.OK and out == p, (seed, it, "serial")

        r, out = inflate_large(comp, seg_bytes=rng.choice([8192, 65536]),
                               n_threads=rng.choice([1, 3]))
        assert r is Result.OK and out == p, (seed, it, "large")

        if len(p) <= 1 << 18:
            device_batch.append((comp, p))
            if len(device_batch) == 16:
                run_device_batch()

        # mutation round: engines agree on accept/reject, never crash
        if len(comp) > 4 and rng.random() < 0.5:
            m = bytearray(comp)
            for _ in range(rng.randrange(1, 6)):
                m[rng.randrange(len(m))] ^= 1 << rng.randrange(8)
            m = bytes(m[: rng.randrange(1, len(m) + 1)])
            r1, o1 = native.native_inflate(m, len(p) * 2 + 64)
            r2, o2 = inflate_large(m, dst_capacity=len(p) * 2 + 64)
            # accept/reject may legitimately differ only in UNFINISHED vs
            # ERR (engines detect truncation at different points); OK
            # results must agree byte-for-byte
            if r1 is Result.OK and r2 is Result.OK:
                assert o1 == o2, (seed, it, "mutation divergence")

    if device_batch:
        run_device_batch()
    print(f"soak OK: {it} iterations, seed={seed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
