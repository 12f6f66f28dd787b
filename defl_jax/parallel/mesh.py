"""Device-mesh construction for stream-parallel decode.

The reference has no distribution at all (SURVEY §2.12: single process,
single thread).  Here the batch axis ("streams") is the unit of data
parallelism: independent zlib streams shard across every device of a host
and across hosts.  Collectives ride the mesh (NVLink within a host, the
network across hosts) via standard JAX sharding — never raw sockets.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

STREAM_AXIS = "streams"


def make_stream_mesh(devices=None) -> Mesh:
    """1-D mesh over every available device; axis name "streams"."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (STREAM_AXIS,))


def make_host_chip_mesh(devices=None) -> Mesh:
    """2-D (hosts, chips) mesh.  With a single host this is (1, n); in a
    multi-host run rows map to hosts so the stream axis can be laid out
    host-major (each host feeds its own rows — no cross-host input
    scatter)."""
    devices = list(devices) if devices is not None else jax.devices()
    n_hosts = max(1, jax.process_count())
    per_host = len(devices) // n_hosts
    grid = np.asarray(devices).reshape(n_hosts, per_host)
    return Mesh(grid, ("hosts", "chips"))


def stream_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (stream) axis over every mesh axis."""
    return NamedSharding(mesh, P(mesh.axis_names))


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully replicated (dictionary broadcast, scalars)."""
    return NamedSharding(mesh, P())
