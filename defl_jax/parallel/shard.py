"""Sharded batch decode over a device mesh.

Design (SURVEY §2.12 / §7): the lockstep decoder is embarrassingly
parallel along the stream axis, so the whole decode+resolve pipeline runs
under ``shard_map`` — each device drives its *own* chunk loop with a
device-local termination test (no per-chunk cross-device sync), exactly
the property that keeps scaling efficiency high.  Only three things cross
devices:

  - the preset dictionary, replicated (north-star "dict broadcast"),
  - reduced statistics (total bytes, status histogram) via ``psum``,
  - the ordered output gather: lane order is preserved end-to-end, so
    outputs come back in submission order even though streams finish out
    of order on-device (north-star "ordered gather").
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from defl_jax.errors import FLAG_ZLIB, Result
from defl_jax.parallel import mesh as mesh_lib
from defl_jax.runtime.pack import pack_dictionary, pack_streams

try:  # jax>=0.6 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


class DistributedCodec:
    """Stream-parallel inflate over a mesh (defaults to all devices)."""

    def __init__(self, mesh=None, dictionary: bytes | None = None,
                 chunk_steps: int | None = None):
        self.mesh = mesh if mesh is not None else mesh_lib.make_stream_mesh()
        self.n_shards = int(np.prod([self.mesh.shape[a]
                                     for a in self.mesh.axis_names]))
        self.dictionary = bytes(dictionary) if dictionary else None
        self.chunk_steps = chunk_steps
        self._fns = {}

    # -- compiled pipeline per (T, C, dict) ---------------------------------
    def _pipeline(self, T: int, C: int, dict_len: int):
        key = (T, C, dict_len)
        if key in self._fns:
            return self._fns[key]

        from defl_jax.ops.resolve import resolve_tokens
        from defl_jax.runtime.session import _pick_decoder

        decode_tokens, default_k = _pick_decoder(
            self.mesh.devices.flat[0].platform)
        K = self.chunk_steps or default_k

        axes = self.mesh.axis_names
        data_spec = P(axes)       # shard leading stream axis
        repl_spec = P()           # dictionary broadcast

        def local_pipeline(words, nbits, zflag, cap, dict_words):
            toks, st = decode_tokens(
                words, nbits, zflag, cap, T=T, K=K,
                dict_len=dict_len, has_dict=dict_len > 0)
            out = resolve_tokens(toks, words, st["dst_pos"], C=C,
                                 dict_len=dict_len, dict_words=dict_words)
            # cross-device reduced stats: decoded bytes + ok-lane count
            total = jax.lax.psum(jnp.sum(st["dst_pos"]), axes)
            n_ok = jax.lax.psum(
                jnp.sum((st["status"] == Result.OK).astype(jnp.int32)), axes)
            return out, st["status"], st["dst_pos"], st["bitpos"], total, n_ok

        fn = shard_map(
            local_pipeline, mesh=self.mesh,
            in_specs=(data_spec, data_spec, data_spec, data_spec, repl_spec),
            out_specs=(data_spec, data_spec, data_spec, data_spec,
                       repl_spec, repl_spec),
            check_vma=False,
        )
        jfn = jax.jit(fn)
        self._fns[key] = jfn
        return jfn

    def inflate(self, streams, flags=FLAG_ZLIB, dst_capacities=1 << 16):
        """Decode a batch sharded over the mesh; submission-order results.

        Returns (results, outputs, stats).

        Single-controller (one process): ``streams`` is the full batch.
        Multi-controller (``jax.process_count() > 1``, SPMD — every host
        runs this same call): ``streams`` is THIS host's rows of the
        host-major global batch (``multihost.local_stream_slice``), every
        host must pass the same row count, and the returned
        results/outputs cover only the local rows — input packing and
        output landing stay host-local, only dict broadcast and psum'd
        stats cross hosts.  stats["total_bytes"]/"ok_lanes" are global.
        """
        from defl_jax.ops.inflate_batch import step_budget
        from defl_jax.runtime.session import _bucket

        n_in = len(streams)
        caps = ([int(dst_capacities)] * n_in if np.isscalar(dst_capacities)
                else [int(c) for c in dst_capacities])
        packed = pack_streams(streams, flags & FLAG_ZLIB, caps)
        C = _bucket(max(caps))
        T = step_budget(C)

        n_proc = jax.process_count()
        multi = n_proc > 1

        # pad N to a multiple of the shard count (local shard count when
        # every host contributes its own rows)
        shards = self.n_shards // n_proc if multi else self.n_shards
        n_pad = max(shards, ((packed.n + shards - 1) // shards) * shards)
        w_pad = 64
        while w_pad < packed.words.shape[1]:
            w_pad *= 2
        if multi:
            # hosts must agree on compiled shapes: take the max over hosts
            from jax.experimental import multihost_utils

            agreed = multihost_utils.process_allgather(
                np.array([n_pad, w_pad], np.int64))
            n_pad = int(agreed[:, 0].max())
            w_pad = int(agreed[:, 1].max())
        words = np.zeros((n_pad, w_pad), np.uint32)
        words[: packed.n, : packed.words.shape[1]] = packed.words
        nbits = np.pad(packed.nbits, (0, n_pad - packed.n))
        zflag = np.pad(packed.zflag, (0, n_pad - packed.n))
        cap = np.pad(packed.dst_cap, (0, n_pad - packed.n))

        dict_len = 0
        dict_words = np.zeros(2, np.uint32)
        if self.dictionary:
            dict_words, dict_len = pack_dictionary(self.dictionary)

        sharding = mesh_lib.stream_sharding(self.mesh)
        repl = mesh_lib.replicated(self.mesh)
        if multi:
            # every host contributes its local rows of the host-major
            # global batch; input bytes never cross hosts
            gN = n_pad * n_proc
            dev_args = [jax.make_array_from_process_local_data(
                            sharding, a, (gN,) + a.shape[1:])
                        for a in (words, nbits, zflag, cap)]
            dev_args.append(jax.make_array_from_process_local_data(
                repl, np.asarray(dict_words),
                np.asarray(dict_words).shape))
        else:
            dev_args = [jax.device_put(a, sharding)
                        for a in (words, nbits, zflag, cap)]
            dev_args.append(jax.device_put(jnp.asarray(dict_words), repl))

        fn = self._pipeline(T, C, dict_len)
        out, status, dst_pos, bitpos, total, n_ok = fn(*dev_args)

        if multi:
            # only this host's rows are addressable; reassemble them in
            # global row order (host-major => local submission order)
            def local_rows(arr):
                sh = sorted(arr.addressable_shards,
                            key=lambda s: s.index[0].start or 0)
                return np.concatenate([np.asarray(s.data) for s in sh])

            status = local_rows(status)[: n_in]
            dst_pos = local_rows(dst_pos)[: n_in]
            out = local_rows(out)
            bitpos_np = local_rows(bitpos)[: n_in]
        else:
            status = np.asarray(status)[: n_in]
            dst_pos = np.asarray(dst_pos)[: n_in]
            out = np.asarray(out)
            bitpos_np = np.asarray(bitpos)[: n_in]
        results = [Result(int(s)) if int(s) != 127 else Result.UNFINISHED
                   for s in status]
        outputs = [out[i, : int(dst_pos[i])].tobytes() for i in range(n_in)]
        # lanes that exhausted the device step budget (banded-refill
        # starvation under adversarial rate spreads, or pathological
        # block floods) retry on the host engine — valid input must never
        # surface as UNFINISHED (≙ session.device_inflate's fallback)
        rerun = [i for i, s in enumerate(status) if int(s) == 127]
        if rerun:
            from defl_jax.runtime.session import _host_fallback

            datas = [bytes(streams[i])
                     if isinstance(streams[i], (bytes, bytearray))
                     else b"".join(bytes(c) for c in streams[i])
                     for i in rerun]
            for i, (r, o) in zip(rerun, _host_fallback(
                    datas, [caps[i] for i in rerun], flags,
                    self.dictionary)):
                results[i], outputs[i] = r, o
        stats = {
            "total_bytes": int(np.asarray(total.addressable_shards[0].data)
                               if multi else total),
            "ok_lanes": int(np.asarray(n_ok.addressable_shards[0].data)
                            if multi else n_ok),
            "bitpos": bitpos_np,
            "shards": self.n_shards,
        }
        return results, outputs, stats
