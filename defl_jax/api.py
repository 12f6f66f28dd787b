"""User-facing API, mirroring the reference surface.

Mapping to `/root/reference/include/defl/infl.h`:

| reference                      | defl_jax                              |
|--------------------------------|---------------------------------------|
| `infl_init(dst, len, flags)`   | `InflateStream(capacity, flags)`      |
| `infl_include(st, p, len)`     | `stream.include(data)`                |
| `infl(st)`                     | `stream.run()`                        |
| `infl_stream(st, p, len)`      | `stream.stream(data)`                 |
| `infl_buf(...)` (infl.h:125)   | `inflate_buffer(data, ...)`           |
| `infl_reset` (mem.c:257)       | `stream.reset(capacity, flags)`       |
| `infl_reset_pool` (mem.c:219)  | `stream.reset_pool()`                 |
| `infl_resize_output` (mem.c:277)| `stream.resize_output(capacity)`     |
| `infl_output_pos` / input_pos  | `stream.output_pos` / `.input_pos`    |
| `infl_destroy` (mem.c:331)     | `stream.destroy()`                    |
| `defl.h` (empty stub)          | `deflate_buffer` / `deflate_batch`    |

Batch entry points (`inflate_batch` / `deflate_batch`) are the device
extension: many independent streams processed data-parallel on device
(SURVEY §2.12), with per-stream `Result` codes so a bad stream never
poisons its batch.
"""

from __future__ import annotations

from defl_jax.core.oracle import InflateEngine, inflate_oracle
from defl_jax.errors import FLAG_ZLIB, DeflError, Result


class InflateStream:
    """Stateful inflate session over a growable chunk list.

    Semantics follow the reference stream object (`unz__stream_t`,
    src/common.h:150-188): caller-declared output capacity, EFULL +
    resize_output resume, byte-granular streaming with UNFINISHED.
    """

    def __init__(self, dst_capacity: int, flags: int = FLAG_ZLIB,
                 dictionary: bytes | None = None):
        self._capacity = int(dst_capacity)
        self._flags = int(flags)
        self._dictionary = dictionary
        self._engine = InflateEngine(self._capacity, self._flags, dictionary)
        self._destroyed = False
        #: observability: True once run() took the C++ fast path
        self.native_path_used = False

    # -- input ---------------------------------------------------------------
    def include(self, data) -> Result:
        """Append a (possibly non-contiguous) compressed chunk.
        ≙ infl_include (mem.c:114-216)."""
        if self._destroyed:
            return Result.EBADF
        return self._engine.include(data)

    # -- one-shot ------------------------------------------------------------
    def run(self) -> Result:
        """Decode everything included so far.  ≙ infl() (infl.c:1507-1675).
        Returns OK, UNFINISHED (more input needed), EFULL, or an error.

        A fresh one-shot decode routes through the C++ engine (the
        reference's `infl_buf` is its *fastest* path, infl.h:125-145);
        dictionary streams and resumable states (UNFINISHED / EFULL /
        errors) stay on the byte-granular oracle engine."""
        if self._destroyed:
            return Result.EBADF
        eng = self._engine
        if (not eng._started and eng._finished is None
                and not self._dictionary and eng.reader.chunks):
            from defl_jax.runtime import native

            if native.available():
                data = b"".join(eng.reader.chunks)
                r, out, in_pos = native.native_inflate_pos(
                    data, eng.capacity, self._flags)
                if r is Result.OK:
                    from defl_jax import metrics

                    eng.adopt_native_result(out, in_pos)
                    self.native_path_used = True
                    metrics.inc("oneshot_native_fast_path")
                    metrics.inc("inflate_bytes_out", len(out))
                    return Result.OK
        return eng.step()

    # -- streaming -----------------------------------------------------------
    def stream(self, data=b"") -> Result:
        """Incremental decode.  ≙ infl_stream (stream.c:468-794).

        Feeding empty data with no in-flight state returns NOOP
        (stream.c:505-507); otherwise decode proceeds as far as possible.
        """
        if self._destroyed:
            return Result.EBADF
        had_state = self._engine._started or bool(self._engine.reader.chunks)
        if data:
            self._engine.include(data)
        elif not had_state:
            return Result.NOOP
        return self._engine.step()

    # -- lifecycle -----------------------------------------------------------
    def reset(self, dst_capacity: int | None = None,
              flags: int | None = None) -> Result:
        """Reuse the stream for a new decode.  ≙ infl_reset (mem.c:257-275)."""
        if self._destroyed:
            return Result.EBADF
        if dst_capacity is not None:
            self._capacity = int(dst_capacity)
        if flags is not None:
            self._flags = int(flags)
        self._engine = InflateEngine(self._capacity, self._flags,
                                     self._dictionary)
        return Result.OK

    def reset_pool(self) -> Result:
        """Drop retained input chunks for the next image without touching
        other state.  ≙ infl_reset_pool (mem.c:219-232)."""
        if self._destroyed:
            return Result.EBADF
        return Result.OK  # chunk memory is GC-managed host-side

    def resize_output(self, dst_capacity: int) -> Result:
        """Grow the output budget after EFULL and continue.
        ≙ infl_resize_output (mem.c:277-288)."""
        if self._destroyed:
            return Result.EBADF
        return self._engine.resize_output(int(dst_capacity))

    def destroy(self) -> None:
        """≙ infl_destroy (mem.c:331-361).  Subsequent calls get EBADF."""
        self._destroyed = True
        self._engine = None

    # -- accounting ----------------------------------------------------------
    @property
    def output_pos(self) -> int:
        """Bytes produced so far.  ≙ infl_output_pos (mem.c:290-294)."""
        return self._engine.output_pos if not self._destroyed else 0

    @property
    def input_pos(self) -> int:
        """Compressed bytes consumed (partially-read final byte counts).
        ≙ infl_input_pos (mem.c:296-329)."""
        return self._engine.input_pos if not self._destroyed else 0

    @property
    def output(self) -> bytes:
        return bytes(self._engine.out) if not self._destroyed else b""


def inflate_buffer(data, dst_capacity: int | None = None,
                   flags: int = FLAG_ZLIB,
                   dictionary: bytes | None = None) -> bytes:
    """One-shot convenience inflate.  ≙ infl_buf (include/defl/infl.h:125-145).

    Runs on the C++ engine (the reference's fastest path) with
    grow-on-EFULL semantics when no capacity is declared; dictionary
    streams use the oracle engine (the native one-shot path rejects
    FDICT, ≙ reference zlib.h:88-93).  Raises DeflError on failure.
    """
    from defl_jax.runtime import native

    data = bytes(data)
    if native.available() and not dictionary:
        grow = dst_capacity is None
        cap = max(64 * len(data), 4096) if grow else int(dst_capacity)
        while True:
            res, out = native.native_inflate(data, cap, flags)
            if res is Result.EFULL and grow and cap < (1 << 31):
                cap *= 4
                continue
            break
    else:
        res, out = inflate_oracle(data, flags, dst_capacity, dictionary)
    if res is not Result.OK:
        raise DeflError(res, f"inflate failed after {len(out)} bytes")
    from defl_jax import metrics

    metrics.inc("inflate_buffer_calls")
    metrics.inc("inflate_bytes_in", len(data))
    metrics.inc("inflate_bytes_out", len(out))
    return out


def DeflateStream(level: int = 6, flags: int = FLAG_ZLIB,
                  dictionary: bytes | None = None):
    """Streaming compressor factory (see core.deflate_ref.DeflateStream) —
    encode-side counterpart of InflateStream; the reference has no encode
    at all (include/defl/defl.h:17-25)."""
    from defl_jax.core.deflate_ref import DeflateStream as _DS

    return _DS(level=level, flags=flags, dictionary=dictionary)


def deflate_buffer(data, level: int = 6, flags: int = FLAG_ZLIB,
                   dictionary: bytes | None = None) -> bytes:
    """One-shot compress — the half the reference declares but never
    implements (include/defl/defl.h:17-25, README TODO).

    Runs on the C++ engine when available (same deflate_core as the
    batch/device paths); dictionary streams and level 0 (stored-only)
    use the Python reference encoder, which implements both.
    """
    from defl_jax.runtime import native

    data = bytes(data)
    if native.available() and not dictionary and level >= 1:
        return native.native_deflate(data, level=level, flags=flags)
    from defl_jax.core.deflate_ref import deflate_oracle

    return deflate_oracle(data, level=level, flags=flags,
                          dictionary=dictionary)


def inflate_batch(streams, flags: int = FLAG_ZLIB, backend: str = "auto",
                  dictionary: bytes | None = None,
                  dst_capacities=None):
    """Decode many independent streams.

    backend:
      - "host":   per-stream host engine (oracle / native C++ when built)
      - "device": batched lockstep decode on the default JAX backend
      - "auto":   device for large batches, host otherwise

    Returns (results, outputs): a list of Result and a list of bytes.
    """
    from defl_jax.runtime.session import batch_inflate

    return batch_inflate(streams, flags=flags, backend=backend,
                         dictionary=dictionary, dst_capacities=dst_capacities)


def deflate_batch(payloads, level: int = 6, flags: int = FLAG_ZLIB,
                  backend: str = "auto"):
    """Compress many independent payloads.

    backend: "host" (multithreaded C++), "device" (hybrid: host LZ77 +
    trees, device Huffman bit-pack — ops/huffman_pack.py), or "auto".
    """
    from defl_jax.runtime.session import batch_deflate

    return batch_deflate(payloads, level=level, flags=flags,
                         backend=backend)
