"""The GPU token-decode kernel (ops/pallas/decode_gpu.py).

CPU tier: the kernel runs in the Pallas interpreter and must agree with
the XLA lockstep decoder (per-lane token sequence, status, dst_pos,
bitpos) and with zlib (resolved bytes), one payload class per case.
Every case packs into one fixed batch shape so the interpreted kernel
compiles once per variant (plain, preset dictionary, resumed carry).

GPU tier (``@pytest.mark.gpu``): the same checks through the compiled
kernel; they skip without a card and run on the chip via
``chip_smoke.py``.
"""

import zlib

import numpy as np
import pytest

from defl_jax.errors import Result
from tests.gendata import make_corpus

N_LANES = 32       # one program of the kernel
WORDS = 256        # packed words per lane (1 KB of input)
CAP = 2048
T, K = 512, 16     # keeps the interpreted kernel quick to compile


def _zraw(data, level=6, strategy=zlib.Z_DEFAULT_STRATEGY, zdict=None):
    """Raw deflate (no zlib wrapper)."""
    co = (zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
          if zdict is None else
          zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy, zdict))
    return co.compress(data) + co.flush()


def _zlib(data, level=6, strategy=zlib.Z_DEFAULT_STRATEGY, zdict=None):
    co = (zlib.compressobj(level, zlib.DEFLATED, 15, 9, strategy)
          if zdict is None else
          zlib.compressobj(level, zlib.DEFLATED, 15, 9, strategy, zdict))
    return co.compress(data) + co.flush()


_TEXT = make_corpus()["text"][:1200]
_DICT = b"a shared preset dictionary: common header material " * 4
_RAND = np.random.default_rng(7).integers(0, 256, 700, dtype=np.uint8) \
    .tobytes()

#: name -> (stream, zlib flag, expected status, expected payload or None)
CASES = {
    "dynamic": (_zlib(_TEXT), 1, Result.OK, _TEXT),
    "fixed": (_zlib(b"abc" * 100, strategy=zlib.Z_FIXED), 1, Result.OK,
              b"abc" * 100),
    "stored": (_zlib(b"stored " * 60, level=0), 1, Result.OK,
               b"stored " * 60),
    "raw_deflate": (_zraw(_TEXT[:400]), 0, Result.OK, _TEXT[:400]),
    "rle_dist1": (_zlib(b"\0" * 1500), 1, Result.OK, b"\0" * 1500),
    "incompressible": (_zlib(_RAND), 1, Result.OK, _RAND),
    "truncated": (_zlib(_TEXT)[:-12], 1, Result.UNFINISHED, None),
    "btype3": (b"\x78\x9c" + b"\x07\xff\xff\xff", 1, Result.ERR, None),
    "preset_dict": (_zlib(_DICT[:120] + b" and then some", zdict=_DICT),
                    1, Result.OK, _DICT[:120] + b" and then some"),
    "efull_resume": (_zlib(_TEXT), 1, Result.OK, _TEXT),
}


def _btype(stream, zflag):
    return (stream[2 if zflag else 0] >> 1) & 3


def test_case_streams_are_what_they_claim():
    assert _btype(CASES["dynamic"][0], 1) == 2
    assert _btype(CASES["fixed"][0], 1) == 1
    assert _btype(CASES["stored"][0], 1) == 0
    assert _btype(CASES["rle_dist1"][0], 1) in (1, 2)


def _batch(stream, zflag, cap=CAP, n_lanes=N_LANES):
    """Lane 0 holds the case stream, the rest a filler stream."""
    import jax.numpy as jnp

    from defl_jax.runtime.pack import pack_streams

    filler = _zlib(b"filler lane " * 20)
    streams = [stream] + [filler] * (n_lanes - 1)
    packed = pack_streams(streams, [zflag] + [1] * (n_lanes - 1),
                          [cap] + [CAP] * (n_lanes - 1))
    words = np.zeros((n_lanes, WORDS), np.uint32)
    words[:, : packed.words.shape[1]] = packed.words
    return (jnp.asarray(words), jnp.asarray(packed.nbits),
            jnp.asarray(packed.zflag), jnp.asarray(packed.dst_cap))


def _compact(tokens):
    """Per-lane token sequences with the NOP slots dropped."""
    t = np.asarray(tokens)
    return [t[:, i][t[:, i] != 0] for i in range(t.shape[1])]


def _assert_same(got, want):
    (tg, sg), (tw, sw) = got, want
    for key in ("status", "dst_pos", "bitpos", "final"):
        np.testing.assert_array_equal(np.asarray(sg[key]),
                                      np.asarray(sw[key]), err_msg=key)
    for i, (a, b) in enumerate(zip(_compact(tg), _compact(tw))):
        np.testing.assert_array_equal(a, b, err_msg=f"lane {i}")


def _resolve(tokens, words, st, dictionary=None):
    import jax.numpy as jnp

    from defl_jax.ops.resolve import resolve_tokens
    from defl_jax.runtime.pack import pack_dictionary

    dict_len, dict_words = 0, None
    if dictionary:
        dw, dict_len = pack_dictionary(dictionary)
        dict_words = jnp.asarray(dw)
    return np.asarray(resolve_tokens(tokens, words, st["dst_pos"], C=CAP,
                                     dict_len=dict_len,
                                     dict_words=dict_words))


def _decode_both(name, interpret):
    """(kernel result, XLA result, batch) for one case; efull_resume runs
    a too-small first call, then resumes the carry with a grown cap."""
    import jax.numpy as jnp

    from defl_jax.ops.inflate_batch import decode_tokens, revive_carry
    from defl_jax.ops.pallas.decode_gpu import decode_tokens_gpu

    stream, zflag, _, _ = CASES[name]
    kw = dict(T=T, K=K)
    if name == "preset_dict":
        kw.update(dict_len=len(_DICT), has_dict=True)
    cap0 = 100 if name == "efull_resume" else CAP
    batch = _batch(stream, zflag, cap=cap0)
    runs = []
    for fn, extra in ((decode_tokens_gpu, dict(interpret=interpret)),
                      (decode_tokens, {})):
        toks, st = fn(*batch, **kw, **extra)
        if name == "efull_resume":
            assert int(st["status"][0]) == int(Result.EFULL)
            cap = jnp.full_like(batch[3], CAP)
            toks2, st = fn(*batch[:3], cap, **kw, **extra,
                           carry=revive_carry(st, new_cap=cap))
            toks = jnp.concatenate([toks, toks2])
        runs.append((toks, st))
    return runs[0], runs[1], batch


def _check_case(name, interpret):
    got, want, batch = _decode_both(name, interpret)
    _assert_same(got, want)
    _, _, status, payload = CASES[name]
    toks, st = got
    assert int(st["status"][0]) == int(status), int(st["status"][0])
    out = _resolve(toks, batch[0], st,
                   _DICT if name == "preset_dict" else None)
    if payload is not None:
        assert out[0, : int(st["dst_pos"][0])].tobytes() == payload
    filler = b"filler lane " * 20
    assert out[1, : int(st["dst_pos"][1])].tobytes() == filler


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_interpret_matches_xla_and_zlib(name):
    _check_case(name, interpret=True)


def test_wrapper_pads_lanes_to_the_program_width():
    """N not a multiple of LANES: padded lanes are sliced off every
    result, and the real lanes agree with the XLA decoder."""
    from defl_jax.ops.inflate_batch import decode_tokens
    from defl_jax.ops.pallas.decode_gpu import LANES, decode_tokens_gpu

    n = LANES + 5
    batch = _batch(CASES["dynamic"][0], 1, n_lanes=n)
    got = decode_tokens_gpu(*batch, T=T, K=K, interpret=True)
    want = decode_tokens(*batch, T=T, K=K)
    toks, st = got
    assert toks.shape[1] == n
    assert st["lens_pk"].shape[1] == n
    assert all(v.shape[0] == n for k, v in st.items()
               if k not in ("lens_pk", "tok_rows"))
    _assert_same(got, want)
    assert all(int(s) == 0 for s in np.asarray(st["status"]))


def test_wrapper_shared_input_matches_xla():
    """Shared-input mode (the split decode of runtime/large.py): every
    lane reads one body through global bit cursors."""
    import jax.numpy as jnp

    from defl_jax.ops.inflate_batch import decode_tokens
    from defl_jax.ops.pallas.decode_gpu import decode_tokens_gpu

    raw = _zraw(_TEXT)
    body = np.frombuffer(raw + b"\0" * ((-len(raw)) % 4 + 8), "<u4")
    n = 3
    kw = dict(T=T, K=K, dict_len=32768, shared_input=True,
              start_bit=jnp.zeros((n,), jnp.int32),
              dict_reach=jnp.zeros((n,), jnp.int32),
              in_base=jnp.zeros((n,), jnp.int32))
    args = (jnp.asarray(body), jnp.full((n,), 8 * len(raw), jnp.int32),
            jnp.zeros((n,), jnp.int32), jnp.full((n,), CAP, jnp.int32))
    got = decode_tokens_gpu(*args, **kw, interpret=True)
    want = decode_tokens(*args, **kw)
    _assert_same(got, want)
    assert all(int(s) == 0 for s in np.asarray(got[1]["status"]))
    assert int(got[1]["dst_pos"][0]) == len(_TEXT)


@pytest.mark.parametrize("platform", ["gpu", "cpu", None])
def test_pick_decoder_by_platform(platform):
    from defl_jax.ops.inflate_batch import decode_tokens
    from defl_jax.ops.pallas.decode_gpu import CHUNK_STEPS, decode_tokens_gpu
    from defl_jax.runtime.session import _pick_decoder

    fn, k = _pick_decoder(platform)
    if platform == "gpu":
        assert fn is decode_tokens_gpu and k == CHUNK_STEPS
    else:  # this suite runs on the CPU backend
        assert fn is decode_tokens and k == 128


def test_kernel_tables_boundary_sum_matches_first_hit():
    """The kernel's boundary-sum decode, fed by kernel_tables, agrees
    with the first-hit canonical decode of the XLA path over random
    complete and incomplete trees and random peeks."""
    import jax.numpy as jnp

    from defl_jax.ops import tables
    from defl_jax.ops.pallas.decode_gpu import kernel_tables

    rng = np.random.default_rng(11)
    n, m = 16, 288
    lens = np.zeros((n, m), np.int32)
    for i in range(n):
        budget = 1.0
        for s in rng.permutation(m)[: int(rng.integers(2, m))]:
            depth = int(rng.integers(1, 16))
            while depth <= 15 and 2.0 ** -depth > budget:
                depth += 1
            if depth > 15:
                break
            lens[i, s] = depth
            budget -= 2.0 ** -depth
    cnt, first, offs, syms, over = (np.asarray(x) for x in
                                    tables.build_canonical(jnp.asarray(lens)))
    assert not over.any()
    z = np.zeros_like(cnt)
    ck = {"count": jnp.asarray(np.stack([z, cnt, z], 1)),
          "first": jnp.asarray(np.stack([z, first, z], 1)),
          "offs": jnp.asarray(np.stack([z, offs, z], 1))}
    bound, adjoff = (np.asarray(x).reshape(n, 3, 16)[:, 1]
                     for x in kernel_tables(ck))
    rev = rng.integers(0, 1 << 15, (n, 64))
    for i in range(n):
        for rv in rev[i]:
            # first hit over lengths (≙ inflate_batch._canonical_decode)
            want = None
            for length in range(1, 16):
                off = (rv >> (15 - length)) - first[i, length]
                if 0 <= off < cnt[i, length]:
                    want = (length, offs[i, length] + off)
                    break
            nge = int((rv >= bound[i, 1:]).sum())
            got = None if nge == 15 else (
                nge + 1, adjoff[i, nge + 1] + (rv >> (14 - nge)))
            assert got == want, (i, rv)


# ---------------------------------------------------------------------------
# GPU tier: the compiled kernel (skips without a card)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dynamic", "stored", "raw_deflate",
                                  "truncated", "btype3", "preset_dict",
                                  "efull_resume"])
def test_kernel_compiled_matches_xla_and_zlib(name):
    _check_case(name, interpret=False)


@pytest.mark.gpu
def test_device_inflate_uses_the_kernel_on_gpu():
    from defl_jax.ops.pallas.decode_gpu import decode_tokens_gpu
    from defl_jax.runtime.session import _pick_decoder, device_inflate

    assert _pick_decoder().fn is decode_tokens_gpu
    payloads = [b"hello hello hello world" * 40, bytes(range(256)) * 16,
                b"\0" * 5000, _RAND, b"ab" * 4000, b"x"]
    res, outs, stats = device_inflate([zlib.compress(p, 6)
                                       for p in payloads])
    assert all(r is Result.OK for r in res)
    assert outs == payloads
    assert stats["host_fallbacks"] == []
