"""Incremental batched device decode with an explicit carry.

The device analog of the reference's byte-granular streaming API
(`infl_stream`, /root/reference/src/infl/stream.c:468-794): the decoder
carry pytree (ops.inflate_batch) is the `unz__stream_t` of the device path —
bit cursors, Huffman structures, block micro-state — and survives across
`feed()` calls at byte granularity.

Each feed appends per-lane input, resumes the lockstep decode, resolves
the new tokens straight into the per-lane output accumulator, then
**rebases**: consumed whole bytes are dropped from the input buffers and
every bit cursor shifts down accordingly — the analog of the reference
dropping consumed chunks (mem.c:219-232) and extending the tail chunk in
place (stream.c:481-488).  Per-feed cost therefore depends on the feed
size and the decoder's unconsumed backlog, not on the session history.

EFULL works like the reference's resize-then-continue protocol
(infl_resize_output, mem.c:277-288): `resize_output` raises per-lane
budgets and revives EFULL lanes through their saved resume state.
"""

from __future__ import annotations

import numpy as np

from defl_jax.errors import FLAG_ZLIB, Result
from defl_jax.runtime.pack import MAX_STREAM_BYTES

#: back-reference reach: the DEFLATE window (RFC 1951 max distance)
_WINDOW = 32768


class DeviceInflateSession:
    def __init__(self, n_lanes: int, dst_capacity: int,
                 flags: int = FLAG_ZLIB, dictionary: bytes | None = None,
                 chunk_steps: int | None = None,
                 feed_step_budget: int = 8192):
        self.n = n_lanes
        self.flags = flags
        self.dictionary = bytes(dictionary) if dictionary else None
        self.chunk_steps = chunk_steps
        self.feed_step_budget = feed_step_budget
        self.caps = np.full(n_lanes, int(dst_capacity), np.int32)
        self.bufs = [bytearray() for _ in range(n_lanes)]  # unconsumed only
        self.carry = None
        self.consumed = np.zeros(n_lanes, np.int64)  # rebased-away bytes
        self.dst_pos = np.zeros(n_lanes, np.int64)   # absolute output pos
        self.out = np.zeros((n_lanes, int(dst_capacity)), np.uint8)

    # -- input ---------------------------------------------------------------
    def feed(self, new_data) -> list[Result]:
        """Append per-lane compressed chunks (None/b'' = no new data for
        that lane), run the decoder as far as it can go, resolve the new
        tokens into the output accumulator, and rebase consumed input."""
        import jax.numpy as jnp

        from defl_jax.ops.inflate_batch import revive_carry
        from defl_jax.runtime.session import _pick_decoder

        for i, d in enumerate(new_data):
            if d:
                if len(self.bufs[i]) + len(d) > MAX_STREAM_BYTES:
                    raise ValueError(
                        f"lane {i}: unconsumed backlog would exceed "
                        f"{MAX_STREAM_BYTES} bytes — drain the lane "
                        f"(resize_output on EFULL) before feeding more")
                self.bufs[i] += bytes(d)

        w_bytes = max(8, max(len(b) for b in self.bufs))
        w_pad = 256        # generous minimum: one compile bucket (see
        while w_pad * 4 < w_bytes + 8:   # session.py bucket rationale)
            w_pad *= 2
        words = np.zeros((self.n, w_pad), np.uint32)
        nbits = np.zeros(self.n, np.int32)
        for i, b in enumerate(self.bufs):
            arr = np.frombuffer(bytes(b) + b"\x00" * ((-len(b)) % 4), "<u4")
            words[i, : arr.size] = arr
            nbits[i] = 8 * len(b)

        dict_len = len(self.dictionary) if self.dictionary else 0
        carry = None
        if self.carry is not None:
            carry = revive_carry(self.carry)

        decode_tokens, default_k = _pick_decoder()
        tokens, carry = decode_tokens(
            jnp.asarray(words), jnp.asarray(nbits),
            jnp.asarray(np.full(self.n, self.flags & FLAG_ZLIB, np.int32)),
            jnp.asarray(self.caps),
            T=self.feed_step_budget, K=self.chunk_steps or default_k,
            dict_len=dict_len, has_dict=self.dictionary is not None,
            carry=carry)
        self.carry = carry

        bitpos = np.asarray(carry["bitpos"]).astype(np.int64)
        new_dst = np.asarray(carry["dst_pos"]).astype(np.int64)
        self._resolve_feed(tokens, words, new_dst)

        # rebase: drop consumed whole bytes, keep the partial byte
        drop = (bitpos >> 3).astype(np.int64)
        for i in range(self.n):
            if drop[i]:
                del self.bufs[i][: int(drop[i])]
        self.consumed += drop
        self.dst_pos = new_dst
        carry = dict(carry)
        carry["bitpos"] = jnp.asarray((bitpos & 7).astype(np.int32))
        self.carry = carry
        return self.statuses()

    # -- incremental resolve -------------------------------------------------
    def _resolve_feed(self, tokens, words, new_dst):
        """Resolve this feed's tokens into self.out[prev:new) per lane.
        Back-references may reach up to 32KB into the already-resolved
        output (and the preset dictionary below that)."""
        import jax.numpy as jnp

        if not np.any(new_dst > self.dst_pos):
            return
        C = self.out.shape[1]

        from defl_jax.runtime.native import available, native_resolve_tokens

        if available():
            toks_nt = np.asarray(jnp.transpose(tokens))
            native_resolve_tokens(
                toks_nt, words, new_dst.astype(np.int32), C,
                self.dictionary, out=self.out,
                dst_start=self.dst_pos.astype(np.int32))
            return

        from defl_jax.ops.resolve import resolve_tokens

        # JAX fallback: per-lane window prefix = last D bytes of
        # (dictionary ⊕ resolved output), right-aligned
        dict_len = len(self.dictionary) if self.dictionary else 0
        D = min(_WINDOW, C + dict_len)
        prefix = np.zeros((self.n, D), np.uint8)
        for i in range(self.n):
            hist = (self.dictionary or b"") + \
                self.out[i, : int(self.dst_pos[i])].tobytes()
            tail = hist[-D:] if len(hist) > D else hist
            if tail:
                prefix[i, D - len(tail):] = np.frombuffer(tail, np.uint8)
        feed_len = (new_dst - self.dst_pos).astype(np.int32)
        val = np.asarray(resolve_tokens(
            tokens, jnp.asarray(words), jnp.asarray(feed_len), C=C,
            prefix=jnp.asarray(prefix)))
        for i in range(self.n):
            lo, hi = int(self.dst_pos[i]), int(new_dst[i])
            if hi > lo:
                self.out[i, lo:hi] = val[i, : hi - lo]

    def resize_output(self, new_capacity) -> None:
        """Raise per-lane output budgets and revive EFULL lanes."""
        from defl_jax.ops.inflate_batch import revive_carry

        self.caps = (np.full(self.n, int(new_capacity), np.int32)
                     if np.isscalar(new_capacity)
                     else np.asarray(new_capacity, np.int32))
        cap = int(self.caps.max())
        if cap > self.out.shape[1]:
            self.out = np.pad(self.out, ((0, 0), (0, cap - self.out.shape[1])))
        if self.carry is not None:
            self.carry = revive_carry(self.carry, new_cap=self.caps)

    # -- results -------------------------------------------------------------
    def statuses(self) -> list[Result]:
        from defl_jax.ops.inflate_batch import STATUS_RUNNING

        s = np.asarray(self.carry["status"])
        return [Result(int(v)) if int(v) != STATUS_RUNNING
                else Result.UNFINISHED for v in s]

    def input_pos(self, lane: int) -> int:
        """Compressed bytes consumed so far, counting a partially-consumed
        final byte (≙ infl_input_pos, mem.c:296-329)."""
        bp = int(np.asarray(self.carry["bitpos"])[lane]) if self.carry \
            else 0
        return int(self.consumed[lane]) + (bp + 7) // 8

    def outputs(self):
        """(statuses, list[bytes]) — everything decoded so far."""
        return self.statuses(), [
            self.out[i, : int(self.dst_pos[i])].tobytes()
            for i in range(self.n)]
