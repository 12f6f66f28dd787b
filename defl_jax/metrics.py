"""Process-wide codec counters (observability).

The reference declares per-stream UNZ_STATS counters but never sets or
reads them anywhere (`/root/reference/src/common.h:181-187`).  This
module is the working equivalent: cheap process-global counters wired
into the real entry points (one-shot API, batch device pipeline, the
large-stream engines, encode), readable as one snapshot dict.

Usage::

    from defl_jax import metrics
    metrics.reset()
    ... do work ...
    print(metrics.snapshot())

Counters are guarded by a lock (the batch pipelines increment from
worker threads).  Overhead is a few ns per *batch*, not per byte.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_counters: dict[str, int] = {}


def inc(name: str, value: int = 1) -> None:
    """Add ``value`` to counter ``name`` (created on first use)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(value)


def snapshot() -> dict[str, int]:
    """A consistent copy of every counter."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    with _lock:
        _counters.clear()
