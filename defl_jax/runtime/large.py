"""Arbitrary-size single-stream inflate via speculative block-parallel decode.

The reference decodes streams of any length with O(1) state but strictly
serially (`/root/reference/src/infl/infl.c:1507-1675`).  DEFLATE is
bit-serial, so a single huge stream cannot be lane-parallelised directly;
the data-parallel answer (SURVEY §5 long-sequence row; rapidgzip/CODAG in
PAPERS.md) is speculation on block boundaries:

  1. The native block finder (`dt_find_block_start`) scans for dynamic-
     block headers at arbitrary bit offsets near evenly spaced byte
     targets (~650 MB/s/core: 3-bit BTYPE filter + codelen-Kraft filter
     + full table-free header validation).
  2. Every segment becomes one lane of the lockstep device decoder.
     Lanes run with `dict_len=32768` — back-references reaching before
     the segment's start are emitted speculatively (they resolve against
     the previous segment's output, like a preset dictionary) — and a
     per-lane `limit` stops each lane at the first block boundary at or
     past the next segment's start.
  3. The host stitches: lane k is valid iff it ended exactly at lane
     k+1's start bit.  Valid segments resolve straight into one output
     buffer (C++ resolver, `dst_start` window chaining); any gap —
     false-positive candidate, EFULL, budget exhaustion — is re-decoded
     serially by `dt_inflate_span` from the last good boundary, and the
     chain re-synchronises at the next candidate.

A wrong candidate can never corrupt output: it only costs a serial
re-decode of its segment.  Worst case (no candidates validate) equals
the serial C++ engine.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from defl_jax.constants import (
    ZLIB_CM_DEFLATE,
    ZLIB_FLAG_FDICT,
    ZLIB_MAX_CINFO,
)
from defl_jax.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, Result

#: target compressed bytes per device lane (≈ one deflate block at zlib-6)
SEGMENT_BYTES = 24576
#: target compressed bytes per host-parallel work unit (several deflate
#: blocks: keeps the boundary-find cost — ~0.5ms/scan, dominated by the
#: distance to the next dynamic header — well under the token decode).
#: Chosen by a sweep on an earlier 4-core host (64MB stream): smaller
#: units pay more finds and cross-segment ramp, larger ones regress on
#: tail imbalance.  Not re-swept on the GPU machine's host.
HOST_SEGMENT_BYTES = 393216
#: per-lane output capacity: speculative segments whose output exceeds
#: this EFULL out and take the serial-fallback path
SEGMENT_CAP = 1 << 19
WINDOW = 32768


def device_route_allowed(body_size: int) -> bool:
    """Whether the device split-decode engine can take a compressed body.

    The lockstep decoder's shared-input mode addresses the body with
    int32 global *bit* cursors, bounding it to just under 256MB of
    compressed input (minus a guard for per-lane lookahead).  Larger
    bodies always use the host-parallel engine — whose cursors are
    int64 — even when the caller asked for ``use_device=True``; that
    engine is also the default path, so the reroute never degrades
    below the default."""
    return 8 * body_size < (1 << 31) - (1 << 22)


def _find_candidates(body: np.ndarray, start_bit: int, n_seg: int,
                     seg_bits: int, n_threads: int = 4) -> list[int]:
    from defl_jax.runtime import native

    lib = native.get_lib()
    nbits = 8 * body.size

    def find(k):
        lo = start_bit + k * seg_bits
        return int(native.find_block_start(
            lib, body, lo, min(lo + 2 * seg_bits, nbits)))

    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        hits = list(ex.map(find, range(1, n_seg)))
    out = [start_bit]
    for h in hits:
        if h > out[-1]:
            out.append(h)
    return out


def inflate_large(data, flags=FLAG_ZLIB, dst_capacity=None,
                  chunk_steps: int | None = None, use_device: bool | None = None,
                  stats_out: dict | None = None, seg_bytes: int | None = None,
                  n_threads: int | None = None, out=None):
    """One huge stream -> (Result, bytes), or (Result, n_bytes) with `out`.

    ``out`` (writable uint8 ndarray): caller-owned output buffer, ≙ the
    reference's ``infl_init(dst, dstlen)`` contract — the decode writes
    in place, returns the byte count, and never allocates or copies the
    output (a fresh multi-hundred-MB buffer costs more in page faults
    than the decode itself on small hosts).  EFULL is returned to the
    caller (grow-and-retry is the caller's job, ≙ infl_resize_output).

    Two speculative block-parallel engines share the find/validate/stitch
    design (module docstring):

    - ``use_device=False`` (the default): the all-native parallel engine
      (`dt_inflate_large`) — worker threads find boundaries and
      token-decode segments while the calling thread stitches behind
      them; no device round-trip.
    - ``use_device=True``: segments decode as lanes of the lockstep
      device decoder (shared device-resident body), host stitches.  Worth
      it when the host is weak relative to its PCIe link and the device
      is otherwise idle; the batch APIs remain the device's main use.
      Bodies at or above ~256MB compressed exceed the device engine's
      int32 bit cursors and transparently reroute to the host-parallel
      engine (see `device_route_allowed`).

    ``use_device=None`` resolves to the DEFL_LARGE_DEVICE env knob
    (default host: the device route's round-trip is not timed on the
    GPU yet).  stats_out (optional
    dict) receives per-stage seconds: parallel_s (host engine) or
    find/decode/fetch/stitch (device engine)."""
    import time

    from defl_jax.runtime import native

    data = bytes(data)
    zf = bool(flags & FLAG_ZLIB)
    caller_out = out is not None
    empty = 0 if caller_out else b""
    start = 0
    if zf:
        if len(data) < 2:
            return Result.UNFINISHED, empty
        cmf, flg = data[0], data[1]
        if ((cmf & 0xF) != ZLIB_CM_DEFLATE or (cmf >> 4) > ZLIB_MAX_CINFO
                or ((cmf << 8) | flg) % 31 != 0):
            return Result.ERR, empty
        if flg & ZLIB_FLAG_FDICT:
            return Result.ERR, empty  # preset dict on huge streams: host path
        start = 2

    if not native.available():
        from defl_jax.core.oracle import inflate_oracle

        r, ob = inflate_oracle(data, flags, dst_capacity)
        if not caller_out:
            return r, ob
        n = min(len(ob), out.size)
        out[:n] = np.frombuffer(ob, np.uint8)[:n]
        return r, n

    body = np.frombuffer(data, np.uint8)[start:]
    if caller_out:
        grow = False
        cap_total = min(int(dst_capacity), out.size) \
            if dst_capacity is not None else out.size
    else:
        grow = dst_capacity is None
        cap_total = int(dst_capacity) if dst_capacity is not None \
            else max(16 * body.size, 1 << 20)

    st = stats_out if stats_out is not None else {}
    if use_device is None:
        import os

        use_device = os.environ.get("DEFL_LARGE_DEVICE") == "1"

    from defl_jax import metrics

    metrics.inc("large_streams")
    metrics.inc("large_bytes_in", len(data))
    if not use_device:
        return _host_parallel(body, data, zf, flags, cap_total, grow,
                              seg_bytes, n_threads, st, out)

    body_dev = None
    n_seg = max(1, body.size // SEGMENT_BYTES)
    if not device_route_allowed(body.size):
        return _host_parallel(body, data, zf, flags, cap_total, grow,
                              seg_bytes, n_threads, st, out)
    if use_device and n_seg > 2:
        # async upload of the shared body overlaps the block find below
        # (the decoder's shared-input mode reads one [S, SEG] body for
        # every lane — nothing per-lane ships to the device)
        import jax
        import jax.numpy as jnp

        pad = (-body.size) % 4 + 8
        body_dev = jax.device_put(jnp.asarray(
            np.concatenate([body, np.zeros(pad, np.uint8)]).view("<u4")))

    t0 = time.perf_counter()
    cands = _find_candidates(body, 0, n_seg, 8 * SEGMENT_BYTES) \
        if n_seg > 1 else [0]
    st["find_s"] = time.perf_counter() - t0

    lane_info = None
    if body_dev is not None and len(cands) > 2:
        lane_info = _device_decode(body_dev, body.size, cands, chunk_steps,
                                   st)
        # observability: how many speculative lanes validated (status OK
        # and ended exactly on the next candidate / final).  The stitch
        # span-decodes any gap, so a broken device path silently degrades
        # to serial speed — this stat makes that visible and testable.
        _, dst_pos, status, final, bit_end = lane_info
        nxt = np.concatenate([np.asarray(cands[1:], np.int64), [-1]])
        st["lanes_valid"] = int(((status == 0)
                                 & ((final > 0) | (bit_end == nxt))).sum())
        st["lanes"] = len(cands)

    # Undeclared capacity has grow-on-EFULL semantics (≙ the oracle and
    # device_inflate fallbacks): only the stitch depends on the output
    # buffer, so a high-ratio stream retries the stitch alone — the block
    # find and device decode are reused.
    t0 = time.perf_counter()
    while True:
        buf = out if caller_out else np.zeros(cap_total, np.uint8)
        r, total, end_bit = _stitch(body, cands, lane_info, buf)
        if r is Result.EFULL and grow and cap_total < (1 << 40):
            cap_total *= 4
            continue
        break
    st["stitch_s"] = time.perf_counter() - t0

    def ret(res):
        return (res, total) if caller_out else (res, buf[:total].tobytes())

    if r is not Result.OK:
        return ret(r)
    if (flags & FLAG_VERIFY_ADLER32) and zf:
        # 4 big-endian trailer bytes after the byte-aligned final block
        tb = (end_bit + 7) // 8
        if tb + 4 > body.size:
            return ret(Result.UNFINISHED)
        stored = int.from_bytes(body[tb : tb + 4].tobytes(), "big")
        if stored != native.native_adler32(buf[:total]):
            return ret(Result.ERR)
    return ret(Result.OK)


def _host_parallel(body, data, zf, flags, cap_total, grow, seg_bytes,
                   n_threads, st, caller_buf=None):
    """All-native parallel engine: dt_inflate_large (find ‖ token-decode
    workers + stitcher on this thread).  Grow-on-EFULL retries reuse the
    decoded tokens — only the stitch re-runs."""
    import time

    from defl_jax.runtime import native

    lib = native.get_lib()
    t0 = time.perf_counter()
    state = None
    try:
        while True:
            out = caller_buf if caller_buf is not None \
                else np.zeros(cap_total, np.uint8)
            r, total, end_bit, state = native.inflate_large_parallel(
                lib, body, out[:cap_total],
                seg_bytes=seg_bytes or HOST_SEGMENT_BYTES,
                n_threads=n_threads, state=state)
            if r is Result.EFULL and grow and cap_total < (1 << 40):
                cap_total *= 4
                continue
            break
    finally:
        native.large_free(lib, state)
    st["parallel_s"] = time.perf_counter() - t0

    def ret(res):
        return (res, total) if caller_buf is not None \
            else (res, out[:total].tobytes())

    if r is not Result.OK:
        return ret(r)
    if (flags & FLAG_VERIFY_ADLER32) and zf:
        tb = (end_bit + 7) // 8
        if tb + 4 > body.size:
            return ret(Result.UNFINISHED)
        stored = int.from_bytes(body[tb : tb + 4].tobytes(), "big")
        if stored != native.native_adler32(out[:total]):
            return ret(Result.ERR)
    return ret(Result.OK)


def _device_decode(body_dev, body_bytes, cands, chunk_steps, stats=None):
    """Decode every candidate segment as one lockstep lane against the
    SHARED device-resident body (one upload, per-lane global bit
    cursors).  Returns (toks [N, T'], dst_pos, status, final, bit_end)."""
    import time

    import jax.numpy as jnp

    from defl_jax.runtime.session import _pick_decoder

    decode_tokens, default_k = _pick_decoder()
    chunk_steps = chunk_steps or default_k
    M = len(cands)
    start = np.asarray(cands, np.int64)
    end = np.concatenate([start[1:], [8 * body_bytes]])
    # step budget from the LONGEST segment (the decoder's chunk loop
    # exits early once every lane finishes; over-long tail segments that
    # exhaust it fall back to the serial span decode in the stitch)
    max_seg_bits = int((end - start).max())
    T = 16384
    while T < max_seg_bits // 5 + 8192:
        T *= 2

    # the stream-head lane has NO window before position 0: its
    # distance-too-far check must match the serial engines' (a corrupt
    # distance in the first 32KB errors instead of resolving to garbage);
    # speculative lanes get the full 32KB reach into the prior segment
    reach = np.full(M, WINDOW, np.int32)
    if cands[0] == 0:
        reach[0] = 0
    t0 = time.perf_counter()
    toks, st = decode_tokens(
        body_dev, jnp.full((M,), 8 * body_bytes, jnp.int32),
        jnp.zeros((M,), jnp.int32),
        jnp.full((M,), SEGMENT_CAP, jnp.int32),
        T=T, K=chunk_steps, dict_len=WINDOW, shared_input=True,
        limit=jnp.asarray(end.astype(np.int32)),
        start_bit=jnp.asarray(start.astype(np.int32)),
        dict_reach=jnp.asarray(reach),
        in_base=jnp.asarray((start // 8).astype(np.int32)))
    # fetch only the occupied token rows (bucketed for stable shapes);
    # the budgeted buffer is sized for worst-case literal density
    rows = min(toks.shape[0],
               -(-int(st["tok_rows"]) // 8192) * 8192)
    if stats is not None:
        stats["decode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    toks_nt = np.asarray(jnp.transpose(toks[:rows]))
    dst_pos = np.asarray(st["dst_pos"])
    status = np.asarray(st["status"])
    final = np.asarray(st["final"])
    if stats is not None:
        stats["fetch_s"] = time.perf_counter() - t0
    bit_end = np.asarray(st["bitpos"]).astype(np.int64)
    return toks_nt, dst_pos, status, final, bit_end


def _stitch(body, cands, lane_info, out):
    """Stitch the speculative chain: resolve valid lanes, span-decode the
    gaps.  Returns (Result, total_bytes, end_bit).  One native call
    (dt_stitch) walks the whole chain — per-lane ctypes round-trips from
    Python used to dominate this stage at ~1000 lanes per 64MB."""
    from defl_jax.runtime import native

    return native.stitch(native.get_lib(), body, cands, lane_info, out)
