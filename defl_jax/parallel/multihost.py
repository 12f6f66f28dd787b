"""Multi-host launch glue.

North-star requirement (BASELINE.json): 10k independent streams sharded
over N>=2 hosts with dictionary broadcast and submission-order gather.
This module wires ``jax.distributed`` so every host contributes its local
chips to one global mesh; each host feeds only the rows of the stream
batch that live on its own chips (host-major layout from
``mesh.make_host_chip_mesh``), so input staging never crosses hosts — only
the psum'd stats and any cross-host gather do.

Hardware note: this environment exposes a single chip, so multi-host runs
here are validated with the virtual CPU mesh
(``--xla_force_host_platform_device_count``) and via
``__graft_entry__.dryrun_multichip``; the code paths are identical on a
real pod slice.
"""

from __future__ import annotations

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join (or bootstrap) a multi-host JAX runtime.

    Where the cluster environment is one JAX detects (e.g. SLURM) the
    three arguments may be omitted; pass them explicitly otherwise.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def local_stream_slice(n_streams: int) -> slice:
    """Rows of a global stream batch this host is responsible for packing.

    With the host-major mesh layout, host h owns rows
    [h * n/H, (h+1) * n/H): its local chips consume exactly those rows, so
    packed input never needs a cross-host scatter.
    """
    h = jax.process_index()
    nh = jax.process_count()
    per = (n_streams + nh - 1) // nh
    return slice(h * per, min(n_streams, (h + 1) * per))


def global_codec(dictionary: bytes | None = None):
    """A DistributedCodec spanning every chip of every host."""
    from defl_jax.parallel.mesh import make_host_chip_mesh
    from defl_jax.parallel.shard import DistributedCodec

    return DistributedCodec(make_host_chip_mesh(), dictionary=dictionary)
