"""Batch codec sessions: orchestration of the device decode pipeline.

Drives pack -> decode_tokens -> resolve_tokens and converts device results
back into per-stream (Result, bytes) pairs.  Error containment follows the
reference's errors-as-values design (SURVEY §5): each lane carries its own
status; a malformed stream never poisons its batch.  Pathological streams
that exhaust the device step budget (e.g. adversarial floods of empty
blocks) fall back to the host engine transparently.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from defl_jax.core.oracle import inflate_oracle
from defl_jax.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, Result
from defl_jax.runtime.pack import MAX_STREAM_BYTES, pack_dictionary, pack_streams

def _bucket(x: int) -> int:
    """Round shape knobs up to power-of-two-ish buckets to bound jit
    recompiles across calls."""
    b = 1024
    while b < x:
        b *= 2
    return b


class Decoder(NamedTuple):
    """A token decoder with the ``inflate_batch.decode_tokens`` signature
    and the chunk length (K) its callers pass it."""
    fn: Callable
    chunk_steps: int


def _pick_decoder(platform: str | None = None) -> Decoder:
    """The token decoder for `platform` (default: the first device's).

    On a GPU the Triton kernel (ops/pallas/decode_gpu.py) runs a whole
    K-step chunk per launch; elsewhere the XLA lockstep decoder runs,
    with shorter chunks because it compiles faster at K=128.
    """
    if platform is None:
        import jax

        platform = jax.devices()[0].platform
    if platform == "gpu":
        from defl_jax.ops.pallas.decode_gpu import (
            CHUNK_STEPS,
            decode_tokens_gpu,
        )

        return Decoder(decode_tokens_gpu, CHUNK_STEPS)
    from defl_jax.ops.inflate_batch import decode_tokens

    return Decoder(decode_tokens, 128)


def device_inflate(streams, flags=FLAG_ZLIB, dictionary=None,
                   dst_capacities=None, chunk_steps: int | None = None,
                   resolve: str = "device"):
    """Batched device decode.  Returns (results, outputs, stats dict).

    resolve: "device" runs the XLA pointer-doubling resolver (output stays
    on device); "host" ships the token stream to the multithreaded C++
    resolver (native/defl_host.cc) — the fast path when the decompressed
    bytes are destined for host memory anyway.
    """
    import jax.numpy as jnp

    from defl_jax.ops.inflate_batch import STATUS_RUNNING
    from defl_jax.ops.resolve import resolve_tokens

    decode_tokens, default_k = _pick_decoder()
    chunk_steps = chunk_steps or default_k

    n_in = len(streams)
    if n_in == 0:
        return [], [], {}

    if dst_capacities is None:
        # No declared capacity: assume a generous ratio; lanes that still
        # hit EFULL are re-run through the host engine with grow-on-EFULL
        # semantics (same result the host backend produces).
        caps = [min(64 * len(b) if isinstance(b, (bytes, bytearray)) else
                    64 * sum(len(c) for c in b), 1 << 26) or 64
                for b in streams]
    else:
        caps = ([int(dst_capacities)] * n_in
                if np.isscalar(dst_capacities) else
                [int(c) for c in dst_capacities])

    zf = flags & FLAG_ZLIB
    packed = pack_streams(streams, zf, caps)
    C = _bucket(max(caps))
    from defl_jax.ops.inflate_batch import step_budget
    T = step_budget(C)

    # Pad N and W up to buckets so repeated calls reuse compiled shapes.
    # Generous minimums: compiling the lockstep decoder costs minutes per
    # bucket (the dominant cost of a cold test run); padding idle lanes
    # and words costs microseconds.
    n_pad = 32
    while n_pad < packed.n:
        n_pad *= 2
    w_pad = 256
    while w_pad < packed.words.shape[1]:
        w_pad *= 2
    if n_pad != packed.n or w_pad != packed.words.shape[1]:
        words = np.zeros((n_pad, w_pad), dtype=np.uint32)
        words[: packed.n, : packed.words.shape[1]] = packed.words
        packed.words = words
        packed.nbits = np.pad(packed.nbits, (0, n_pad - packed.n))
        packed.zflag = np.pad(packed.zflag, (0, n_pad - packed.n))
        packed.dst_cap = np.pad(packed.dst_cap, (0, n_pad - packed.n))

    dict_words = None
    dict_len = 0
    if dictionary:
        dict_words_np, dict_len = pack_dictionary(dictionary)
        dict_words = jnp.asarray(dict_words_np)

    tokens, st = decode_tokens(
        jnp.asarray(packed.words), jnp.asarray(packed.nbits),
        jnp.asarray(packed.zflag), jnp.asarray(packed.dst_cap),
        T=T, K=chunk_steps, dict_len=dict_len,
        has_dict=dictionary is not None)

    # Undeclared-capacity EFULL lanes resume ON DEVICE with a grown
    # budget (revive_carry + a second decode continuing from the saved
    # resume state — ≙ infl_resize_output-then-continue, mem.c:277-288)
    # instead of throwing the device work away on a host re-decode.
    # Token buffers from successive calls concatenate along the step axis.
    tok_parts = [tokens]
    if dst_capacities is None:
        from defl_jax.ops.inflate_batch import revive_carry

        caps_np = packed.dst_cap.astype(np.int64)
        for _ in range(4):  # 64 -> up to 16384x the compressed size
            status_np = np.asarray(st["status"])
            efull = status_np == int(Result.EFULL)
            if not efull.any() or caps_np.max() >= (1 << 30):
                break
            caps_np = np.where(efull, np.minimum(caps_np * 4, 1 << 30),
                               caps_np)
            cap_dev = jnp.asarray(caps_np.astype(np.int32))
            carry = revive_carry(st, new_cap=cap_dev)
            C = _bucket(int(caps_np.max()))
            T = step_budget(C)
            tokens, st = decode_tokens(
                jnp.asarray(packed.words), jnp.asarray(packed.nbits),
                jnp.asarray(packed.zflag), cap_dev,
                T=T, K=chunk_steps, dict_len=dict_len,
                has_dict=dictionary is not None, carry=carry)
            tok_parts.append(tokens)
        caps = [int(c) for c in caps_np[:n_in]]
    if len(tok_parts) > 1:
        tokens = jnp.concatenate(tok_parts, axis=0)

    if resolve == "host":
        from defl_jax.runtime.native import available, native_resolve_tokens

        if not available():
            resolve = "device"

    verify = bool(flags & FLAG_VERIFY_ADLER32) and bool(zf)
    adler_dev = None

    if resolve == "host":
        toks_nt = np.asarray(jnp.transpose(tokens))  # [N, T] lane-major
        dst_pos = np.asarray(st["dst_pos"])
        out_np = native_resolve_tokens(
            toks_nt, packed.words, dst_pos, C, dictionary)
    else:
        out = resolve_tokens(tokens, jnp.asarray(packed.words),
                             st["dst_pos"], C=C, dict_len=dict_len,
                             dict_words=dict_words)
        if verify:
            # trailers verified on device: outputs never ship to the host
            # for the checksum (≙ the docstring contract in ops.checksums)
            from defl_jax.ops.checksums import adler32_batch

            adler_dev = np.asarray(adler32_batch(out, st["dst_pos"]))
        out_np = np.asarray(out)
        dst_pos = np.asarray(st["dst_pos"])

    status = np.asarray(st["status"])
    bitpos = np.asarray(st["bitpos"])
    in_bytes = packed.words.view(np.uint8)

    # Lanes needing a host-engine pass: step-budget exhaustion
    # (pathological streams) only — undeclared-capacity EFULL lanes were
    # already resumed on device above (a lane still EFULL here ran into
    # the 1GB growth ceiling and keeps its EFULL status, matching the
    # host backend's ceiling).  Routed through the multithreaded C++
    # batch engine, not the single-threaded Python oracle.
    fb_idx = [i for i in range(n_in) if int(status[i]) == STATUS_RUNNING]
    fb = {}
    if fb_idx:
        datas = [bytes(streams[i]) if isinstance(streams[i],
                                                 (bytes, bytearray))
                 else b"".join(bytes(c) for c in streams[i])
                 for i in fb_idx]
        fb = dict(zip(fb_idx, _host_fallback(
            datas, None if dst_capacities is None
            else [caps[i] for i in fb_idx], flags, dictionary)))

    results: list[Result] = []
    outputs: list[bytes] = []
    for i in range(n_in):
        if i in fb:
            r, o = fb[i]
            results.append(r)
            outputs.append(o)
            continue
        r = Result(int(status[i]))
        o = out_np[i, : int(dst_pos[i])].tobytes()
        if verify and r is Result.OK:
            # zlib trailer: 4 big-endian bytes after the byte-aligned end
            # of the final block (the reference never checks it; this is
            # the FLAG_VERIFY_ADLER32 extension)
            tp = (int(bitpos[i]) + 7) // 8
            stored = int.from_bytes(in_bytes[i, tp : tp + 4], "big")
            if tp + 4 > packed.nbits[i] // 8:
                r = Result.UNFINISHED
            elif stored != (int(adler_dev[i]) if adler_dev is not None
                            else _host_adler32(o)):
                r = Result.ERR
        results.append(r)
        outputs.append(o)
    stats = {"bitpos": bitpos, "dst_pos": dst_pos, "T": T, "C": C,
             "host_fallbacks": fb_idx}
    from defl_jax import metrics

    metrics.inc("device_inflate_batches")
    metrics.inc("device_inflate_lanes", n_in)
    metrics.inc("device_inflate_bytes_out",
                int(sum(len(o) for o in outputs)))
    metrics.inc("host_fallback_lanes", len(fb_idx))
    return results, outputs, stats


def _host_adler32(data: bytes) -> int:
    from defl_jax.runtime import native

    if native.available():
        return native.native_adler32(data)
    from defl_jax.core.checksums import adler32

    return adler32(data)


def _host_fallback(datas, caps, flags, dictionary):
    """Host-engine decode for lanes the device path couldn't finish.

    caps=None means grow-on-EFULL semantics (matching inflate_oracle with
    cap=None).  Uses the multithreaded C++ batch engine when available;
    dictionary streams go through the oracle (the native one-shot path
    rejects FDICT, ≙ reference zlib.h:88-93 behaviour)."""
    from defl_jax.runtime import native

    if native.available() and not dictionary:
        grow = caps is None
        cur = ([max(64 * len(d), 4096) for d in datas] if grow
               else list(caps))
        results: list = [None] * len(datas)
        outputs: list = [b""] * len(datas)
        pending = list(range(len(datas)))
        while pending:
            rs, os_ = native.native_inflate_batch(
                [datas[i] for i in pending],
                [cur[i] for i in pending], flags)
            nxt = []
            for j, i in enumerate(pending):
                if grow and rs[j] is Result.EFULL and cur[i] < (1 << 31):
                    cur[i] *= 4
                    nxt.append(i)
                else:
                    results[i], outputs[i] = rs[j], os_[j]
            pending = nxt
        return list(zip(results, outputs))
    return [inflate_oracle(bytes(d), flags,
                           None if caps is None else caps[k], dictionary)
            for k, d in enumerate(datas)]


def batch_inflate(streams, flags=FLAG_ZLIB, backend="auto", dictionary=None,
                  dst_capacities=None):
    """Public batch decode entry (see api.inflate_batch)."""
    n = len(streams)
    sizes = [len(s) if isinstance(s, (bytes, bytearray)) else
             sum(len(c) for c in s) for s in streams]
    big = [i for i, sz in enumerate(sizes) if sz > MAX_STREAM_BYTES]
    if big and backend in ("auto", "device") and not dictionary:
        # streams past the per-lane packing limit take the speculative
        # block-parallel path (runtime/large.py); the rest batch normally
        from defl_jax.runtime.large import inflate_large

        big_set = set(big)
        small_idx = [i for i in range(n) if i not in big_set]
        small = [streams[i] for i in small_idx]
        sub_caps = None
        if dst_capacities is not None:
            sub_caps = (dst_capacities if np.isscalar(dst_capacities)
                        else [dst_capacities[i] for i in small_idx])
        s_res, s_out = batch_inflate(small, flags, backend, dictionary,
                                     sub_caps) if small else ([], [])
        results = [None] * n
        outputs = [b""] * n
        for j, i in enumerate(small_idx):
            results[i], outputs[i] = s_res[j], s_out[j]
        for i in big:
            cap = None
            if dst_capacities is not None:
                cap = (int(dst_capacities) if np.isscalar(dst_capacities)
                       else int(dst_capacities[i]))
            data = streams[i] if isinstance(streams[i], (bytes, bytearray)) \
                else b"".join(bytes(c) for c in streams[i])
            results[i], outputs[i] = inflate_large(bytes(data), flags, cap)
        return results, outputs

    use_device = backend == "device" or (
        backend == "auto" and n >= 8 and not big)
    if use_device:
        # decompressed bytes land host-side here, so the multithreaded C++
        # resolver is the natural pass-2 (bit-exact with the device one)
        from defl_jax.runtime import native

        results, outputs, _ = device_inflate(
            streams, flags, dictionary, dst_capacities,
            resolve="host" if native.available() else "device")
        return results, outputs

    results = []
    outputs = []
    for i, s in enumerate(streams):
        data = s if isinstance(s, (bytes, bytearray)) else \
            b"".join(bytes(c) for c in s)
        cap = None
        if dst_capacities is not None:
            cap = int(dst_capacities) if np.isscalar(dst_capacities) \
                else int(dst_capacities[i])
        r, o = inflate_oracle(bytes(data), flags, cap, dictionary)
        results.append(r)
        outputs.append(o)
    return results, outputs


def device_deflate(payloads, level=6, flags=FLAG_ZLIB, stats_out=None,
                   pack="scan"):
    """Hybrid device encode: host C++ computes LZ77 tokens + Huffman trees
    + block layout as (value, nbits) fields; the device concatenates the
    fields lane-parallel (ops/huffman_pack).  Byte-identical to the
    serial C++ encoder by construction (both consume the same templated
    put() sequence).  Fills the encode half the reference never
    implements (include/defl/defl.h:17-25).  Returns list[bytes].

    pack="scan" (default) runs the lockstep reservoir scan —
    fused-elementwise speed, mirror of the decode kernel; the host
    compactor reconstructs word positions from the nbits schedule.
    pack="scatter" runs the prefix-sum + scatter-add variant (simpler;
    not measured on the GPU)."""
    import time

    import jax.numpy as jnp

    from defl_jax.runtime import native

    payloads = [bytes(p) for p in payloads]
    st = stats_out if stats_out is not None else {}
    t0 = time.perf_counter()
    fields, n_fields, total_bits, adlers, results = \
        native.native_deflate_fields(payloads, level=level)
    st["fields_s"] = time.perf_counter() - t0

    zf = bool(flags & FLAG_ZLIB)
    t0 = time.perf_counter()
    if pack == "scan":
        import jax

        from defl_jax.ops.huffman_pack import pack_fields_scan

        fj = jax.device_put(fields)
        nj = jax.device_put(n_fields.astype(np.int32))
        jax.block_until_ready(fj)
        st["upload_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        slots, final_lo, tb = pack_fields_scan(fj, nj)
        slots.block_until_ready()
        st["pack_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        slots_np = np.asarray(slots)
        lo_np = np.asarray(final_lo)
        st["fetch_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bodies = native.native_encode_compact(fields, slots_np, n_fields,
                                              lo_np, total_bits)
    else:
        from defl_jax.ops.huffman_pack import pack_fields

        W = 1024
        while W * 32 < int(total_bits.max()) + 32:
            W *= 2
        words, _tb = pack_fields(jnp.asarray(fields),
                                 jnp.asarray(n_fields.astype(np.int32)),
                                 n_words=W)
        wb = np.asarray(words)
        st["pack_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bodies = [wb[i].view(np.uint8)[: (int(total_bits[i]) + 7) // 8]
                  .tobytes() for i in range(len(payloads))]

    outs = []
    fallback = []
    for i, p in enumerate(payloads):
        if results[i] is not Result.OK:
            fallback.append(i)
            outs.append(b"")
            continue
        if zf:
            outs.append(b"\x78\x01" + bodies[i]
                        + int(adlers[i]).to_bytes(4, "big"))
        else:
            outs.append(bodies[i])
    if fallback:  # field-budget overflow: serial encoder for those lanes
        rs, fb_outs = native.native_deflate_batch(
            [payloads[i] for i in fallback], level=level, flags=flags)
        for j, i in enumerate(fallback):
            outs[i] = fb_outs[j]
    st["assemble_s"] = time.perf_counter() - t0
    st["device_fallbacks"] = fallback
    from defl_jax import metrics

    metrics.inc("device_deflate_lanes", len(payloads))
    metrics.inc("deflate_bytes_in", int(sum(len(p) for p in payloads)))
    metrics.inc("deflate_bytes_out", int(sum(len(o) for o in outs)))
    return outs


def batch_deflate(payloads, level=6, flags=FLAG_ZLIB, backend="auto"):
    """Compress many payloads.

    backend: "host" = multithreaded C++ engine (pure-Python reference
    encoder if no toolchain); "device" = hybrid host-tokens +
    device-bit-pack (device_deflate); "auto" = host."""
    from defl_jax.runtime import native

    # "auto" routes to the host engine: the device bit-pack is
    # byte-identical, but the host field export dominates it and no
    # measurement shows the device stage paying for itself (not measured
    # on the GPU).  Explicit backend="device" opts in.
    if backend == "device" and native.available():
        return device_deflate(payloads, level=level, flags=flags)

    if native.available():
        results, outs = native.native_deflate_batch(
            [bytes(p) for p in payloads], level=level, flags=flags)
        if all(r is Result.OK for r in results):
            return outs

    from defl_jax.core.deflate_ref import deflate_oracle

    return [deflate_oracle(bytes(p), level=level, flags=flags)
            for p in payloads]
