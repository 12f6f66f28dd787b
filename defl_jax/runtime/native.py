"""ctypes bindings for the C++ host engine (defl_jax/native/defl_host.cc).

Builds the shared library on first use (g++, ~1s) and caches it next to
the source.  If it cannot be built the callers fall back to the
pure-Python oracle and to device resolve, so the framework never
hard-depends on the native tier; the failure is reported once as a
warning, and ``available()`` says which tier is in use.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings

from defl_jax.errors import Result

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
# DEFL_NATIVE_LIB overrides the library (e.g. the ASan build in CI)
_LIB_PATH = os.environ.get(
    "DEFL_NATIVE_LIB", os.path.join(_NATIVE_DIR, "libdefl_host.so"))
_SRC_PATH = os.path.join(_NATIVE_DIR, "defl_host.cc")

_lock = threading.Lock()
_lib = None
_tried = False
_fields_buf = None  # shared encode-fields buffer (see native_deflate_fields)


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
             "-o", _LIB_PATH, _SRC_PATH],
            check=True, capture_output=True, timeout=120)
        return True
    except Exception as e:
        detail = getattr(e, "stderr", b"") or b""
        warnings.warn(f"C++ host library did not build ({e}): "
                      f"{detail.decode(errors='replace')[-2000:]}; using the "
                      "Python engines and device resolve")
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) or (
                os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.dt_inflate.restype = ctypes.c_int
        lib.dt_inflate.argtypes = [u8p, ctypes.c_uint64, u8p, ctypes.c_uint64,
                                   ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.c_int]
        lib.dt_inflate_pos.restype = ctypes.c_int
        lib.dt_inflate_pos.argtypes = [u8p, ctypes.c_uint64, u8p,
                                       ctypes.c_uint64,
                                       ctypes.POINTER(ctypes.c_uint64),
                                       ctypes.POINTER(ctypes.c_uint64),
                                       ctypes.c_int]
        lib.dt_deflate.restype = ctypes.c_int
        lib.dt_deflate.argtypes = [u8p, ctypes.c_uint64, u8p, ctypes.c_uint64,
                                   ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.c_int, ctypes.c_int]
        lib.dt_adler32.restype = ctypes.c_uint32
        lib.dt_adler32.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint32]
        lib.dt_crc32.restype = ctypes.c_uint32
        lib.dt_crc32.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint32]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        pptr = ctypes.POINTER(ctypes.c_void_p)
        lib.dt_resolve_tokens.restype = ctypes.c_int
        lib.dt_resolve_tokens.argtypes = [
            u32p, ctypes.c_int64, ctypes.c_int64,
            u8p, ctypes.c_uint64, ctypes.c_int64,
            u8p, ctypes.c_uint64, ctypes.c_uint64,
            i32p, i32p, u8p, ctypes.c_uint32, ctypes.c_int]
        for name in ("dt_deflate_batch", "dt_inflate_batch"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [pptr, u64p, pptr, u64p, u64p, i32p,
                           ctypes.c_int64] + (
                [ctypes.c_int, ctypes.c_int, ctypes.c_int]
                if name == "dt_deflate_batch"
                else [ctypes.c_int, ctypes.c_int])
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.dt_find_block_start.restype = ctypes.c_int64
        lib.dt_find_block_start.argtypes = [u8p, ctypes.c_uint64,
                                            ctypes.c_int64, ctypes.c_int64]
        lib.dt_inflate_span.restype = ctypes.c_int
        lib.dt_inflate_span.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
            u8p, ctypes.c_uint64, ctypes.c_uint64, u64p, i64p]
        lib.dt_stitch.restype = ctypes.c_int
        lib.dt_stitch.argtypes = [
            u8p, ctypes.c_uint64, i64p, ctypes.c_int64,
            u32p, ctypes.c_int64, i32p, i32p, i32p, i64p,
            u8p, ctypes.c_uint64, u64p, i64p]
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.dt_deflate_fields_batch.restype = ctypes.c_int
        lib.dt_deflate_fields_batch.argtypes = [
            pptr, u64p, u32p, ctypes.c_int64, i64p, i64p, u32p, i32p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.dt_encode_compact.restype = ctypes.c_int
        lib.dt_encode_compact.argtypes = [
            u32p, u32p, ctypes.c_int64, ctypes.c_int64, i64p, u32p,
            pptr, u64p, u64p, ctypes.c_int]
        lib.dt_inflate_large.restype = ctypes.c_int
        lib.dt_inflate_large.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int,
            u8p, ctypes.c_uint64, u64p, i64p, pptr]
        lib.dt_large_free.restype = None
        lib.dt_large_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _u8(buf):
    return (ctypes.c_uint8 * len(buf)).from_buffer_copy(bytes(buf)) \
        if len(buf) else (ctypes.c_uint8 * 1)()


def native_inflate(data: bytes, dst_capacity: int, flags: int = 1,
                   out=None):
    """One-shot native inflate; (Result, output).

    With ``out`` (a writable uint8 ndarray — the caller-owned output
    buffer, ≙ the reference's ``infl_init(dst, dstlen)`` contract,
    include/defl/infl.h:31-33) the decode writes in place and returns
    (Result, bytes_written) with zero copies or allocations — the fast
    path for callers that reuse buffers across calls."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    src = _u8(data)
    outlen = ctypes.c_uint64(0)
    if out is not None:
        assert out.dtype == np.uint8 and out.flags.c_contiguous
        cap = min(int(dst_capacity), out.size)
        r = lib.dt_inflate(src, len(data), _np_u8p(out), cap,
                           ctypes.byref(outlen), flags)
        return Result(r), int(outlen.value)
    dst = (ctypes.c_uint8 * max(dst_capacity, 1))()
    r = lib.dt_inflate(src, len(data), dst, dst_capacity,
                       ctypes.byref(outlen), flags)
    return Result(r), ctypes.string_at(dst, outlen.value)


def native_inflate_pos(data: bytes, dst_capacity: int,
                       flags: int = 1) -> tuple[Result, bytes, int]:
    """One-shot native inflate reporting the consumed input position
    (reference infl_input_pos semantics); (Result, output, in_pos)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    src = _u8(data)
    dst = (ctypes.c_uint8 * max(dst_capacity, 1))()
    outlen = ctypes.c_uint64(0)
    in_pos = ctypes.c_uint64(0)
    r = lib.dt_inflate_pos(src, len(data), dst, dst_capacity,
                           ctypes.byref(outlen), ctypes.byref(in_pos), flags)
    return Result(r), ctypes.string_at(dst, outlen.value), int(in_pos.value)


def native_deflate(data: bytes, level: int = 6,
                   flags: int = 1) -> bytes:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    src = _u8(data)
    cap = len(data) + len(data) // 2 + 1024
    dst = (ctypes.c_uint8 * cap)()
    outlen = ctypes.c_uint64(0)
    r = lib.dt_deflate(src, len(data), dst, cap, ctypes.byref(outlen),
                       level, flags)
    if r != 0:
        raise RuntimeError(f"native deflate failed: {Result(r).name}")
    return ctypes.string_at(dst, outlen.value)


def native_resolve_tokens(tokens, input_words, dst_len, C: int,
                          dictionary: bytes | None = None,
                          n_threads: int | None = None,
                          out=None, dst_start=None):
    """Multithreaded pass-2 token resolution (hybrid device+host inflate).

    tokens: uint32 [N, T] C-contiguous (lane-major);
    input_words: the packed uint32 [N, W] input (stored-run source bytes);
    dst_len: int32 [N].  Returns uint8 [N, C].

    For incremental streaming resolve, pass `out` preloaded with each
    lane's prior window bytes in out[i, :dst_start[i]]; resolution starts
    at dst_start and back-references read the preloaded prefix.
    """
    import numpy as np

    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    tokens = np.ascontiguousarray(tokens, dtype=np.uint32)
    inputs = np.ascontiguousarray(input_words, dtype=np.uint32)
    dst_len = np.ascontiguousarray(dst_len, dtype=np.int32)
    N, T = tokens.shape
    if out is None:
        out = np.zeros((N, C), dtype=np.uint8)
    assert out.shape == (N, C) and out.dtype == np.uint8 \
        and out.flags.c_contiguous
    i32p = ctypes.POINTER(ctypes.c_int32)
    if dst_start is not None:
        dst_start = np.ascontiguousarray(dst_start, dtype=np.int32)
        start_p = dst_start.ctypes.data_as(i32p)
    else:
        start_p = ctypes.cast(None, i32p)
    d = bytes(dictionary) if dictionary else b""
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)
    lib.dt_resolve_tokens(
        tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), N, T,
        inputs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        inputs.strides[0], inputs.strides[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), C, C,
        dst_len.ctypes.data_as(i32p), start_p,
        _u8(d), len(d), n_threads)
    return out


def _batch_call(fn_name, payloads, caps, *extra, n_threads=None):
    import numpy as np

    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(payloads)
    srcs = [np.frombuffer(bytes(p), np.uint8) if p else
            np.zeros(1, np.uint8) for p in payloads]
    dsts = [np.zeros(max(c, 1), np.uint8) for c in caps]
    src_ptrs = (ctypes.c_void_p * n)(
        *[s.ctypes.data_as(ctypes.c_void_p).value for s in srcs])
    dst_ptrs = (ctypes.c_void_p * n)(
        *[d.ctypes.data_as(ctypes.c_void_p).value for d in dsts])
    srclens = (ctypes.c_uint64 * n)(*[len(p) for p in payloads])
    dstcaps = (ctypes.c_uint64 * n)(*[len(d) for d in dsts])
    dstlens = (ctypes.c_uint64 * n)()
    results = (ctypes.c_int32 * n)()
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)
    getattr(lib, fn_name)(src_ptrs, srclens, dst_ptrs, dstcaps, dstlens,
                          results, n, *extra, n_threads)
    outs = [dsts[i][: dstlens[i]].tobytes() for i in range(n)]
    return [Result(int(r)) for r in results], outs


def native_deflate_batch(payloads, level: int = 6, flags: int = 1,
                         n_threads=None):
    """Multithreaded batch compress (one C++ worker per stream group)."""
    caps = [len(p) + len(p) // 2 + 1024 for p in payloads]
    return _batch_call("dt_deflate_batch", payloads, caps, level, flags,
                       n_threads=n_threads)


def native_inflate_batch(payloads, dst_capacities, flags: int = 1,
                         n_threads=None):
    """Multithreaded batch host inflate."""
    caps = ([int(dst_capacities)] * len(payloads)
            if isinstance(dst_capacities, int) else list(dst_capacities))
    return _batch_call("dt_inflate_batch", payloads, caps, flags,
                       n_threads=n_threads)


def native_deflate_fields(payloads, level: int = 6, F: int | None = None,
                          n_threads=None):
    """Host half of the hybrid device encode (dt_deflate_fields_batch):
    LZ77 matching + Huffman trees + block layout per payload, exported
    as (value, nbits) field arrays for the device bit-pack kernel
    (ops/huffman_pack.pack_fields).

    Returns (fields u32 [N, F], n_fields i64 [N], total_bits i64 [N],
    adlers u32 [N], results) — results[i] is EFULL when payload i
    overflowed F (route that lane to the serial encoder).
    """
    import numpy as np

    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(payloads)
    srcs = [np.frombuffer(bytes(p), np.uint8) if p else
            np.zeros(1, np.uint8) for p in payloads]
    if F is None:
        # worst case one field per input byte (all-literal / stored) plus
        # per-block header overhead, bucketed for stable device shapes
        # (multiple-of-8K buckets: a power-of-2 bucket wastes up to 2x on
        # 64KB+overhead inputs, and rows beyond n_fields are never read)
        worst = max(len(p) for p in payloads) + 512
        F = max(1024, -(-worst // 8192) * 8192)
    # reuse one cached buffer across calls: first-touch page faults on a
    # fresh multi-hundred-MB allocation cost multiples of the actual
    # field generation (measured 5s vs 1s per 2048x64KB batch).  The
    # returned array IS the shared buffer — callers consume it (device
    # upload) before the next call, which every current caller does.
    global _fields_buf
    if _fields_buf is None or _fields_buf.shape != (n, F):
        _fields_buf = np.empty((n, F), np.uint32)
    fields = _fields_buf
    n_fields = np.zeros(n, np.int64)
    total_bits = np.zeros(n, np.int64)
    adlers = np.zeros(n, np.uint32)
    results = (ctypes.c_int32 * n)()
    src_ptrs = (ctypes.c_void_p * n)(
        *[s.ctypes.data_as(ctypes.c_void_p).value for s in srcs])
    srclens = (ctypes.c_uint64 * n)(*[len(p) for p in payloads])
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.dt_deflate_fields_batch(
        src_ptrs, srclens,
        fields.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), F,
        n_fields.ctypes.data_as(i64p), total_bits.ctypes.data_as(i64p),
        adlers.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        results, n, level, n_threads)
    return (fields, n_fields, total_bits, adlers,
            [Result(int(r)) for r in results])


def native_encode_compact(fields, slots, n_fields, final_lo, total_bits,
                          n_threads=None):
    """Gather the used word slots of the device lockstep pack into dense
    per-lane compressed bodies (dt_encode_compact).  Returns list[bytes]
    (raw deflate bodies, no zlib framing)."""
    import numpy as np

    lib = get_lib()
    fields = np.ascontiguousarray(fields, dtype=np.uint32)
    slots = np.ascontiguousarray(slots, dtype=np.uint32)
    n_fields = np.ascontiguousarray(n_fields, dtype=np.int64)
    final_lo = np.ascontiguousarray(final_lo, dtype=np.uint32)
    N, F = fields.shape
    caps = [(int(tb) + 7) // 8 for tb in total_bits]
    dsts = [np.empty(max(c, 1), np.uint8) for c in caps]
    dst_ptrs = (ctypes.c_void_p * N)(
        *[d.ctypes.data_as(ctypes.c_void_p).value for d in dsts])
    dstcaps = (ctypes.c_uint64 * N)(*[len(d) for d in dsts])
    dstlens = (ctypes.c_uint64 * N)()
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    r = lib.dt_encode_compact(
        fields.ctypes.data_as(u32p), slots.ctypes.data_as(u32p), N, F,
        n_fields.ctypes.data_as(i64p), final_lo.ctypes.data_as(u32p),
        dst_ptrs, dstcaps, dstlens, n_threads)
    if r != 0:
        raise RuntimeError("encode compact overflow")
    return [dsts[i][: dstlens[i]].tobytes() for i in range(N)]


def _u8_view(data):
    """Zero-copy (pointer, length) for ndarray/bytes-like checksum input —
    copying a multi-hundred-MB output just to checksum it costs more than
    the checksum."""
    import numpy as np

    if isinstance(data, np.ndarray):
        a = np.ascontiguousarray(data.reshape(-1).view(np.uint8))
        # `a` is returned as the keepalive: the pointer dangles without it
        # whenever ascontiguousarray had to copy
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), a.size, a
    b = bytes(data)
    return _u8(b), len(b), b


def native_adler32(data, start: int = 1) -> int:
    lib = get_lib()
    p, n, keep = _u8_view(data)
    r = int(lib.dt_adler32(p, n, start))
    del keep
    return r


def native_crc32(data, start: int = 0) -> int:
    lib = get_lib()
    p, n, keep = _u8_view(data)
    r = int(lib.dt_crc32(p, n, start))
    del keep
    return r


# ---- speculative large-stream helpers (runtime/large.py) ------------------

def _np_u8p(arr):
    import ctypes as _ct

    return arr.ctypes.data_as(_ct.POINTER(_ct.c_uint8))


def find_block_start(lib, body, bit_lo: int, bit_hi: int) -> int:
    """First validated dynamic-block header bit offset in [bit_lo, bit_hi)
    of `body` (uint8 ndarray), or -1."""
    return int(lib.dt_find_block_start(_np_u8p(body), body.size,
                                       bit_lo, bit_hi))


def inflate_span(lib, body, bit_start: int, bit_limit: int, out, out_pos: int):
    """Serial raw-deflate decode from an arbitrary bit position with
    out[:out_pos] as the back-reference window; stops at the first block
    boundary at/after bit_limit or after the final block.

    Returns (Result, new_out_pos, end_bit) — end_bit < 0 encodes
    "final block consumed" as -(bit + 1)."""
    dl = ctypes.c_uint64(out_pos)
    eb = ctypes.c_int64(bit_start)
    r = lib.dt_inflate_span(_np_u8p(body), body.size, bit_start, bit_limit,
                            _np_u8p(out), out.size, out_pos,
                            ctypes.byref(dl), ctypes.byref(eb))
    return Result(r), int(dl.value), int(eb.value)


def resolve_tokens_into(lib, lane_tokens, lane_input, out, start: int,
                        end: int) -> None:
    """Resolve one lane's token stream into out[start:end) with
    out[:start] as its back-reference window (segment chaining).
    lane_input: the lane's compressed bytes (stored-run source), any
    dtype — read as raw bytes at the lane's token-offset base."""
    import numpy as np

    toks = np.ascontiguousarray(lane_tokens, dtype=np.uint32)
    inp = np.ascontiguousarray(lane_input)
    dst_len = np.array([end], np.int32)
    dst_start = np.array([start], np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.dt_resolve_tokens(
        toks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        1, toks.size,
        inp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 0, inp.nbytes,
        _np_u8p(out), 0, out.size,
        dst_len.ctypes.data_as(i32p), dst_start.ctypes.data_as(i32p),
        ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8)), 0, 1)


def inflate_large_parallel(lib, body, out, seg_bytes: int = 16384,
                           n_threads: int | None = None, state=None):
    """Parallel large-stream inflate (dt_inflate_large): worker threads
    find block boundaries + token-decode their segments while the calling
    thread stitches/resolves behind them — the host-parallel replacement
    for a serial decode of one huge stream (≙ the reference's core
    `infl()` use case, infl.c:1507-1675, which is strictly serial).

    body: uint8 ndarray of the raw-deflate body; out: uint8 output array.
    Returns (Result, total_bytes, end_bit, state).  On EFULL, grow `out`
    and call again passing `state` back (tokens are reused, only the
    stitch re-runs); free the state with `large_free`."""
    if n_threads is None:
        # one worker per core: the stitcher work-steals the segment it
        # blocks on, so brief oversubscription beats an idle core
        n_threads = min(16, max(1, os.cpu_count() or 2))
    total = ctypes.c_uint64(0)
    end_bit = ctypes.c_int64(0)
    if state is None:
        state = ctypes.c_void_p(None)
    r = lib.dt_inflate_large(_np_u8p(body), body.size, seg_bytes, n_threads,
                             _np_u8p(out), out.size, ctypes.byref(total),
                             ctypes.byref(end_bit), ctypes.byref(state))
    return Result(r), int(total.value), int(end_bit.value), state


def large_free(lib, state) -> None:
    if state:
        lib.dt_large_free(state)


def stitch(lib, body, cands, lane_info, out):
    """One-call native stitch of the speculative lane chain (dt_stitch):
    resolve validated lanes, span-decode gaps, all inside the library —
    the per-lane ctypes round-trips of the old Python loop dominated the
    stitch stage (~0.2s/64MB of pure call overhead).

    Returns (Result, total_bytes, end_bit)."""
    import numpy as np

    from defl_jax.errors import Result

    cands_a = np.ascontiguousarray(cands, dtype=np.int64)
    if lane_info is not None:
        toks_nt, dst_pos, status, final, bit_end = lane_info
        toks_a = np.ascontiguousarray(toks_nt, dtype=np.uint32)
        toks_p = toks_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        T = toks_a.shape[1]
        dst_pos_a = np.ascontiguousarray(dst_pos, dtype=np.int32)
        status_a = np.ascontiguousarray(status, dtype=np.int32)
        final_a = np.ascontiguousarray(final, dtype=np.int32)
        bit_end_a = np.ascontiguousarray(bit_end, dtype=np.int64)
    else:
        toks_p = ctypes.cast(None, ctypes.POINTER(ctypes.c_uint32))
        T = 0
        dst_pos_a = status_a = final_a = np.zeros(1, np.int32)
        bit_end_a = np.zeros(1, np.int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    total = ctypes.c_uint64(0)
    end_bit = ctypes.c_int64(0)
    r = lib.dt_stitch(
        _np_u8p(np.ascontiguousarray(body)), body.size,
        cands_a.ctypes.data_as(i64p), cands_a.size,
        toks_p, T,
        dst_pos_a.ctypes.data_as(i32p), status_a.ctypes.data_as(i32p),
        final_a.ctypes.data_as(i32p), bit_end_a.ctypes.data_as(i64p),
        _np_u8p(out), out.size, ctypes.byref(total), ctypes.byref(end_bit))
    return Result(r), int(total.value), int(end_bit.value)
