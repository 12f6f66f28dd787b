"""defl_jax — a batched DEFLATE / zlib codec framework in JAX.

Built from scratch around JAX / XLA / Pallas: the unit of work is a *batch of
independent streams* decoded data-parallel across device lanes and devices,
rather than the reference's (recp/defl) single-threaded per-stream C loops.

Layers
------
- ``defl_jax.constants``  DEFLATE/zlib format tables (≙ apicommon.h)
- ``defl_jax.core``       host oracle codec + canonical Huffman (≙ infl.c paths,
                          plus the encode side the reference never implemented)
- ``defl_jax.ops``        device compute path: lockstep batched token decode,
                          two-pass LZ77 resolution, batched checksums
- ``defl_jax.runtime``    stream/chunk management, packing, carry state
                          (≙ mem.c + stream.c semantics)
- ``defl_jax.parallel``   mesh / shard_map distribution, ordered gather,
                          dictionary broadcast (new capability; §2.12 of SURVEY)
- ``defl_jax.api``        user-facing API mirroring include/defl/infl.h
"""

from defl_jax.errors import Result, DeflError, FLAG_ZLIB, FLAG_VERIFY_ADLER32
from defl_jax.api import (
    inflate_buffer,
    deflate_buffer,
    inflate_batch,
    deflate_batch,
    InflateStream,
    DeflateStream,
)

__version__ = "0.1.0"

__all__ = [
    "Result",
    "DeflError",
    "FLAG_ZLIB",
    "FLAG_VERIFY_ADLER32",
    "inflate_buffer",
    "deflate_buffer",
    "inflate_batch",
    "deflate_batch",
    "InflateStream",
    "DeflateStream",
    "__version__",
]
