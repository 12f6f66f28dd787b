"""Device compute ops (JAX/XLA/Pallas).

Importing this package enables JAX's persistent compilation cache: the
lockstep decoder compiles once per shape bucket and the executable is
reused across processes — the same role the reference's lazily-built
static Huffman tables play for it (infl.c:1044-1052), but at compilation
granularity.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing is set here; otherwise the cache lives at the fixed
path ``<checkout>/.jax_cache``.
"""

import os

_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def _enable_compile_cache():
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_enable_compile_cache()
