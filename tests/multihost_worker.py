"""Worker process for the 2-process jax.distributed test.

Each process owns 4 virtual CPU devices; together they form one 8-device
(2 hosts x 4 chips) global mesh.  Every host packs only its own rows
(multihost.local_stream_slice) and receives only its own rows back —
the multi-controller contract of DistributedCodec.inflate.
"""

import os
import sys
import zlib

port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from defl_jax.parallel import multihost  # noqa: E402

multihost.initialize(f"localhost:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc, jax.devices()

N = 16


def payload(i: int) -> bytes:
    return (b"multihost payload %03d " % i) * 40


sl = multihost.local_stream_slice(N)
local = [zlib.compress(payload(i), 6) for i in range(sl.start, sl.stop)]
codec = multihost.global_codec()
res, outs, stats = codec.inflate(local, dst_capacities=4096)

assert len(res) == sl.stop - sl.start, (pid, len(res))
assert all(int(r) == 0 for r in res), (pid, res)
for k, i in enumerate(range(sl.start, sl.stop)):
    assert outs[k] == payload(i), (pid, i)
assert stats["ok_lanes"] == N, stats          # psum'd across hosts
assert stats["total_bytes"] == sum(len(payload(i)) for i in range(N)), stats
print(f"WORKER {pid} OK", flush=True)
