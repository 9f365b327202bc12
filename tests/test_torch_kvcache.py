"""The port's KV codecs, paged int8 pool and bucket ladder on the CPU
against the JAX package's, on the same numpy inputs.

Tolerances: the int8 quantizer must be BIT-equal (payload and scales);
cache contents after writes are compared exactly; attention outputs
within atol 1e-5 (both sides read the same values and accumulate in
f32, in another order). Output dtypes must match the JAX codecs': a
float codec returns the cache dtype, the int8 codecs f32."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dnn_tpu.runtime import decode_buckets as jdb
from dnn_tpu.runtime import kvcache as jkv
from dnn_tpu.runtime import paged_kvcache as jpk
from dnn_tpu_torch.runtime import decode_buckets as tdb
from dnn_tpu_torch.runtime import kvcache as tkv
from dnn_tpu_torch.runtime import paged_kvcache as tpk

from test_torch_llama import one_torch_thread  # noqa: F401,E402 — autouse:
# one intra-op thread; the suite's parallel workers oversubscribe the cores

ATOL = 1e-5
CFG = types.SimpleNamespace(n_layer=2, n_head=2, n_embd=64)  # D = 32


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_quantize_rows_bit_equal_to_jax():
    """Random rows, rows whose scaled values sit exactly on .5 (round
    half to even on both sides), an all-zero row (scale 1), and rows
    that hit the +-127 clip."""
    rng = np.random.default_rng(0)
    rows = [rng.standard_normal((6, 32)).astype(np.float32) * 3]
    tie = np.zeros((2, 32), np.float32)
    tie[0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]   # scale exactly 1
    tie[1, :5] = [254.0, 5.0, -7.0, 1.0, -3.0]          # scale 2: x/s = k.5
    rows += [tie, np.zeros((1, 32), np.float32),
             np.full((1, 32), -4.25, np.float32)]
    x = np.concatenate(rows)[None]  # (1, 10, 32)
    q, s = tkv._quantize_rows(torch.from_numpy(x))
    jq, js = jkv._quantize_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    assert s.numpy()[0, 8] == 1.0 and not q.numpy()[0, 8].any()
    np.testing.assert_array_equal(q.numpy()[0, 6, :6], [127, 2, -4, 0, 0, 126])


def test_quantize_rows_int4_bit_equal_to_jax():
    """The 7-level quantizer: values and scales bit-equal to JAX's
    _quantize_rows_int4 (random rows, exact .5 ties, an all-zero row,
    the +-7 clip), and the packed bytes byte-equal to the block wire's
    nibble packing (dnn_tpu/kvtier/migrate._pack_nibbles) of JAX's
    values; unpack_nibbles inverts it."""
    from dnn_tpu.kvtier.migrate import _pack_nibbles
    from dnn_tpu_torch.ops.cuda.cached_attention import unpack_nibbles

    rng = np.random.default_rng(5)
    tie = np.zeros((2, 32), np.float32)
    tie[0, :6] = [7.0, 2.5, -3.5, 0.5, -0.5, 6.5]    # scale exactly 1
    tie[1, :5] = [14.0, 5.0, -7.0, 1.0, -3.0]        # scale 2: x/s = k.5
    x = np.concatenate([rng.standard_normal((6, 32)).astype(np.float32) * 3,
                        tie, np.zeros((1, 32), np.float32),
                        np.full((1, 32), -4.25, np.float32)])[None]
    q, s = tkv._quantize_rows_int4(torch.from_numpy(x))
    jq, js = jkv._quantize_rows_int4(jnp.asarray(x))
    jvals = np.asarray(jq).astype(np.int8)
    assert q.dtype == torch.uint8 and q.shape == (1, 10, 16)
    np.testing.assert_array_equal(unpack_nibbles(q).numpy(), jvals)
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    assert q.numpy().tobytes() == _pack_nibbles(jvals)
    np.testing.assert_array_equal(jvals[0, 6, :6], [7, 2, -4, 0, 0, 6])


def _codecs(kind):
    if kind == "int8":
        return tkv.Int8KV(), jkv.Int8KV()
    if kind == "int4":
        return tkv.Int4KV(), jkv.Int4KV()
    return tkv.FloatKV(torch.float32), jkv.FloatKV(jnp.float32)


def _vals(x):
    """A cache leaf's values as numpy: a port int4 leaf unpacked, a JAX
    int4 leaf widened to int8."""
    from dnn_tpu_torch.ops.cuda.cached_attention import unpack_nibbles

    if isinstance(x, torch.Tensor):
        return (unpack_nibbles(x) if x.dtype == torch.uint8 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.int8) if a.dtype.name == "int4" else a


def _layer0(cache):
    return {k: v[0] for k, v in cache.items()}


@pytest.mark.parametrize("kind", ["f32", "int8", "int4"])
@pytest.mark.parametrize("t", [1, 5])
def test_codec_write_attend_matches_jax(kind, t):
    """write + attend(base): a T-row chunk at start 7 of a 32-position
    cache after a 7-row prefix (T=1 is the K6 decode step, T=5 the K5
    chunk). Cache leaves equal JAX's exactly; outputs within 1e-5."""
    tc, jc = _codecs(kind)
    rng = np.random.default_rng(1)
    tcache = _layer0(tc.init(CFG, 2, 32, "cpu"))
    jcache = _layer0(jc.init(CFG, 2, 32))
    for start, n in ((0, 7), (7, t)):
        k, v, q = (rng.standard_normal((2, 2, n, 32)).astype(np.float32)
                   for _ in range(3))
        tc.write(tcache, torch.from_numpy(k), torch.from_numpy(v), start)
        jcache = jc.write(jcache, jnp.asarray(k), jnp.asarray(v), start)
        got = tc.attend(torch.from_numpy(q), tcache, start)
        want = jc.attend(jnp.asarray(q), jcache, start + jnp.arange(n),
                         base=start)
    for name in jcache:
        np.testing.assert_array_equal(_vals(tcache[name]), _vals(jcache[name]))
    assert got.dtype == torch.float32  # f32 cache dtype, or int8's f32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["f32", "int8", "int4"])
@pytest.mark.parametrize("rows", [1, 2])
def test_codec_rows_match_jax(kind, rows):
    """write_rows + attend_rows at per-slot positions, with a gated
    slot whose stale pos equals the cache length S: its row is not
    changed (bit for bit) and indexes nothing past the cache; the live
    slots' writes and R-row attention match JAX's."""
    tc, jc = _codecs(kind)
    rng = np.random.default_rng(2)
    s_len = 16
    tcache = _layer0(tc.init(CFG, 3, s_len, "cpu"))
    jcache = _layer0(jc.init(CFG, 3, s_len))
    k, v = (rng.standard_normal((3, 2, s_len, 32)).astype(np.float32)
            for _ in range(2))
    tc.write(tcache, torch.from_numpy(k), torch.from_numpy(v), 0)
    jcache = jc.write(jcache, jnp.asarray(k), jnp.asarray(v), 0)
    before = {n: _np(t).copy() for n, t in tcache.items()}
    pos = np.array([3, s_len, 15], np.int32)
    gate = np.array([True, False, True])
    k1, v1 = (rng.standard_normal((3, 2, 1, 32)).astype(np.float32)
              for _ in range(2))
    tc.write_rows(tcache, torch.from_numpy(k1), torch.from_numpy(v1),
                  torch.from_numpy(pos), torch.from_numpy(gate))
    jcache = jc.write_rows(jcache, jnp.asarray(k1), jnp.asarray(v1),
                           jnp.asarray(pos), jnp.asarray(gate))
    for name in jcache:
        np.testing.assert_array_equal(_vals(tcache[name]), _vals(jcache[name]))
        np.testing.assert_array_equal(_np(tcache[name])[1], before[name][1])
    q = rng.standard_normal((3, 2, rows, 32)).astype(np.float32)
    got = tc.attend_rows(torch.from_numpy(q), tcache, torch.from_numpy(pos))
    want = jc.attend_rows(jnp.asarray(q), jcache, jnp.asarray(pos))
    assert got.dtype == torch.float32 and got.shape == (3, 2, rows, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_output_dtypes_follow_the_jax_codecs():
    """A bf16 float cache attends to bf16 (cast to the cache dtype, as
    the JAX codec does); an int8 cache to f32, never to int8."""
    q = torch.randn(1, 2, 1, 32)
    for codec, want in ((tkv.FloatKV(torch.bfloat16), torch.bfloat16),
                        (tkv.Int8KV(), torch.float32)):
        c = _layer0(codec.init(CFG, 1, 8, "cpu"))
        codec.write(c, torch.randn(1, 2, 3, 32), torch.randn(1, 2, 3, 32), 0)
        pos = torch.tensor([2], dtype=torch.int32)
        assert codec.attend(q, c, 2).dtype == want
        assert codec.attend_rows(q, c, pos).dtype == want
    assert isinstance(tkv.codec_for_cache(tkv.Int8KV().init(CFG, 1, 8, "cpu")),
                      tkv.Int8KV)


@pytest.mark.parametrize("kwargs", [{"rolling": True}, {"window": 4},
                                    {"softcap": 30.0}])
def test_codec_for_cache_refuses_unported(kwargs):
    """The rolling ring, the band and the softcap are ported: each builds
    JAX's codec (codec_for_cache of the JAX package on the same
    arguments, a rolling ring over a window), and so does an int4 cache:
    Int4KV with the band and the cap, and JAX's ValueError for a rolling
    int4 ring."""
    import jax.numpy as jnp

    from dnn_tpu.runtime import kvcache as jkv

    cache = tkv.FloatKV().init(CFG, 1, 8, "cpu")
    kw = dict(kwargs, window=4) if "rolling" in kwargs else kwargs
    got = tkv.codec_for_cache(cache, **kw)
    want = jkv.codec_for_cache({"k": jnp.zeros((1, 2, 8, 32)),
                                "v": jnp.zeros((1, 2, 8, 32))}, **kw)
    assert type(got).__name__ == type(want).__name__
    assert (got.window, got.softcap) == (want.window, want.softcap)
    i4 = tkv.Int4KV().init(CFG, 1, 8, "cpu")
    j4 = {"k": jnp.zeros((1, 2, 8, 32), jnp.int4),
          "v": jnp.zeros((1, 2, 8, 32), jnp.int4),
          "ks": jnp.ones((1, 2, 8)), "vs": jnp.ones((1, 2, 8))}
    if "rolling" in kwargs:
        with pytest.raises(ValueError, match="rolling int4"):
            jkv.codec_for_cache(j4, **kw)
        with pytest.raises(ValueError, match="rolling int4"):
            tkv.codec_for_cache(i4, **kw)
        return
    got, want = tkv.codec_for_cache(i4, **kw), jkv.codec_for_cache(j4, **kw)
    assert type(got).__name__ == type(want).__name__ == "Int4KV"
    assert (got.window, got.softcap) == (want.window, want.softcap)


def test_write_overhang_raises():
    """The JAX codec clamps an overhanging write back onto real
    positions; the port refuses it, for int8 caches too."""
    codec = tkv.Int8KV()
    c = _layer0(codec.init(CFG, 1, 8, "cpu"))
    with pytest.raises(ValueError, match="overhangs"):
        codec.write(c, torch.zeros(1, 2, 3, 32), torch.zeros(1, 2, 3, 32), 6)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_paged_int8_matches_jax(dtype):
    """An int8 (and an int4) pool: install_row of a prefilled transient
    row (payload AND scale blocks, unowned blocks routed to junk block
    0), then write_rows with a gated slot, then attend_rows through the
    scale blocks — pool leaves equal JAX's PagedKV exactly (int4: their
    values), outputs within 1e-5, f32 out. JAX's int4 pool attends on
    its einsum, the port's runs K7's plain version."""
    bp, slots, max_len, n_blocks = 4, 2, 16, 9
    tcache = tpk.init_paged_cache(CFG, slots, max_len, n_blocks=n_blocks,
                                  block_len=bp, dtype=dtype, device="cpu")
    jcache = jpk.init_paged_cache(CFG, slots, max_len, n_blocks=n_blocks,
                                  block_len=bp, dtype=dtype)
    codec = tkv.Int4KV() if dtype == "int4" else tkv.Int8KV()
    assert tcache["ks"].dtype == torch.float32
    assert (tcache["ks"].numpy() == 1).all()
    tcodec, jcodec = tpk.PagedKV(bp), jpk.PagedKV(bp)
    rng = np.random.default_rng(4)
    # slot 0 owns blocks 3, 1 (8 positions); slot 1 owns 5, 2, 7
    ids = [np.array([3, 1, 0, 0], np.int32), np.array([5, 2, 7, 0], np.int32)]
    for slot, blk in enumerate(ids):
        row_t = codec.init(CFG, 1, max_len, "cpu")
        k, v = (rng.standard_normal((CFG.n_layer, 1, 2, max_len, 32))
                .astype(np.float32) for _ in range(2))
        for i in range(CFG.n_layer):
            codec.write({n: t[i] for n, t in row_t.items()},
                        torch.from_numpy(k[i]), torch.from_numpy(v[i]), 0)
        row_j = {n: jnp.asarray(_vals(t), jcache[n].dtype)
                 for n, t in row_t.items()}
        tcodec.install_row(tcache, row_t, torch.from_numpy(blk))
        jcache = jcodec.install_row(jcache, row_j, jnp.asarray(blk))
        tcache["tables"][slot] = torch.from_numpy(blk)
        jcache["tables"] = jcache["tables"].at[:, slot].set(jnp.asarray(blk))
    for name in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(_vals(tcache[name]),
                                      _vals(jcache[name]))
    tview = {n: (t if n == "tables" else t[0]) for n, t in tcache.items()}
    jview = {n: t[0] for n, t in jcache.items()}
    pos = np.array([6, 15], np.int32)
    gate = np.array([True, False])
    k1, v1 = (rng.standard_normal((2, 2, 1, 32)).astype(np.float32)
              for _ in range(2))
    tcodec.write_rows(tview, torch.from_numpy(k1), torch.from_numpy(v1),
                      torch.from_numpy(pos), torch.from_numpy(gate))
    jview = jcodec.write_rows(jview, jnp.asarray(k1), jnp.asarray(v1),
                              jnp.asarray(pos), jnp.asarray(gate))
    for name in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(_vals(tview[name]),
                                      _vals(jview[name]))
    q = rng.standard_normal((2, 2, 1, 32)).astype(np.float32)
    got = tcodec.attend_rows(torch.from_numpy(q), tview, torch.from_numpy(pos))
    want = jcodec.attend_rows(jnp.asarray(q), jview, jnp.asarray(pos))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_bucket_helpers_match_jax():
    for max_len in (1, 64, 100, 1024, 1536):
        assert tdb.bucket_ladder(max_len) == jdb.bucket_ladder(max_len)
    assert tdb.bucket_ladder(300, 48) == jdb.bucket_ladder(300, 48)
    for buckets in ((16, 32), (8, 64, 128), (16, 200)):
        assert tdb.normalize_ladder(buckets, 100) == \
            jdb.normalize_ladder(buckets, 100)
    ladder = tdb.bucket_ladder(1024)
    for need in (1, 64, 65, 300, 1024):
        assert tdb.bucket_for(ladder, need) == jdb.bucket_for(ladder, need)
    for bad in ((lambda m: m.normalize_ladder((32, 16), 64)),
                (lambda m: m.bucket_for((16, 32), 33)),
                (lambda m: m.bucket_ladder(0))):
        with pytest.raises(ValueError):
            bad(tdb)
        with pytest.raises(ValueError):
            bad(jdb)


def test_pad_cache_to_matches_jax():
    """Every leaf — int8 K/V and the (L, B, H, S) scales — grows along
    the position axis with zeros, as jnp.pad does; the input is not
    modified; shrinking raises."""
    cache = tkv.Int8KV().init(CFG, 2, 8, "cpu")
    rng = np.random.default_rng(5)
    for name, t in cache.items():
        t.copy_(torch.from_numpy(rng.integers(-5, 6, t.shape)).to(t.dtype))
    src = {n: t.clone() for n, t in cache.items()}
    got = tdb.pad_cache_to(cache, 16)
    want = jdb.pad_cache_to({n: jnp.asarray(t.numpy()) for n, t in src.items()},
                            16)
    for name in cache:
        assert got[name].dtype == cache[name].dtype
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
        assert torch.equal(cache[name], src[name])
    assert tdb.pad_cache_to(got, 16)["k"] is got["k"]
    with pytest.raises(ValueError, match="shrink"):
        tdb.pad_cache_to(got, 8)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int4_cache_crosses_both_ways(paged):
    """convert.int4_cache_from_jax takes a JAX int4 cache (dense, or a
    paged pool with its tables) written by JAX's codec into the port's
    packed layout, and int4_cache_to_jax back: the values, scales and
    tables survive exactly, the packed K/V equal the port's own writes of
    the same rows, and the port's attention over the carried cache equals
    JAX's over its own (1e-5)."""
    from dnn_tpu_torch.convert import int4_cache_from_jax, int4_cache_to_jax

    rng = np.random.default_rng(9)
    k, v = (rng.standard_normal((2, 2, 12, 32)).astype(np.float32)
            for _ in range(2))
    if paged:
        jcache = jpk.init_paged_cache(CFG, 2, 16, n_blocks=5, block_len=4,
                                      dtype="int4")
        jview = {n: t[0] for n, t in jcache.items()}
        jview["tables"] = jnp.asarray([[1, 2, 0, 0], [3, 4, 0, 0]],
                                      jnp.int32)
        for p in range(6):
            pos = jnp.full((2,), p, jnp.int32)
            jview = jpk.PagedKV(4).write_rows(
                jview, jnp.asarray(k[:, :, p:p + 1]),
                jnp.asarray(v[:, :, p:p + 1]), pos, jnp.ones((2,), bool))
        tview = int4_cache_from_jax(jview)
        q = rng.standard_normal((2, 2, 1, 32)).astype(np.float32)
        pos = np.array([5, 3], np.int32)
        got = tpk.PagedKV(4).attend_rows(torch.from_numpy(q), tview,
                                         torch.from_numpy(pos))
        want = jpk.PagedKV(4).attend_rows(jnp.asarray(q), jview,
                                          jnp.asarray(pos))
    else:
        jview = jkv.Int4KV().write(
            {n: t[0] for n, t in jkv.Int4KV().init(CFG, 2, 12).items()},
            jnp.asarray(k), jnp.asarray(v), 0)
        tview = int4_cache_from_jax(jview)
        mine = _layer0(tkv.Int4KV().init(CFG, 2, 12, "cpu"))
        tkv.Int4KV().write(mine, torch.from_numpy(k), torch.from_numpy(v), 0)
        for name in mine:
            assert torch.equal(mine[name], tview[name])
        q = rng.standard_normal((2, 2, 3, 32)).astype(np.float32)
        got = tkv.Int4KV().attend(torch.from_numpy(q), tview, 9)
        want = jkv.Int4KV().attend(jnp.asarray(q), jview, 9 + jnp.arange(3),
                                   base=9)
    assert tview["k"].dtype == torch.uint8 and tview["k"].shape[-1] == 16
    back = int4_cache_to_jax(tview)
    for name, leaf in jview.items():
        np.testing.assert_array_equal(back[name], _vals(leaf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
