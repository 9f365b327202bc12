"""Sliding windows, logit softcapping and head dim 256 in the port, on
the CPU, against the JAX package on the same weights (mirroring
tests/test_sliding_window.py and tests/test_gemma.py):

  * the kernels' plain versions with the band and the cap against JAX's
    einsum codecs (FloatKV / Int8KV with window / softcap: attend,
    attend_rows, attend_rows_causal; PagedKV with window), and at D = 256
    against JAX's reference_* functions;
  * ring_positions and the rolling codecs against JAX's;
  * mistral-test and gemma2-test logits through from_jax_params, the
    cached forward and the solo decoder's greedy streams across the
    window (the rolling ring, f32 and int8).

The served paths (batchers, refusals, beam, embed, stages, checkpoints)
are in test_torch_window_serving.py.

Weights: test_torch_llama.drawn_tree (every leaf drawn; matrices at std
0.3 where tokens are compared, so that a random 4-layer model emits
varied tokens). Tolerances: attention and logits 1e-5 absolute in f32
(both sides compute in f32; only the summation order differs); greedy
tokens identical. Each JAX program compiles once (module fixtures)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.models import llama as jllama
from dnn_tpu.ops.pallas import cached_attention as jca
from dnn_tpu.runtime import kvcache as jkv
from dnn_tpu.runtime import paged_kvcache as jpkv
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import llama as tllama
from dnn_tpu_torch.ops.cuda import cached_attention as tca
from dnn_tpu_torch.runtime import kvcache as tkv
from dnn_tpu_torch.runtime import paged_kvcache as tpkv
from dnn_tpu_torch.runtime.generate import make_generate

from test_torch_llama import drawn_tree, jax_prepared
from test_torch_llama import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


# ----------------------------------------------------------------------
# the codecs and the kernels' plain versions
# ----------------------------------------------------------------------

def _caches(kind, b, hk, s, d, seed):
    """The same written dense cache in both packages: positions 0..s-1
    written through each codec's own write (int8: each quantizes)."""
    rng = np.random.default_rng(seed)
    jk, tk = _pair(rng, (b, hk, s, d), 2.0)
    jv, tv = _pair(rng, (b, hk, s, d))
    if kind == "int8":
        jc = {"k": jnp.zeros((b, hk, s, d), jnp.int8),
              "v": jnp.zeros((b, hk, s, d), jnp.int8),
              "ks": jnp.ones((b, hk, s)), "vs": jnp.ones((b, hk, s))}
        tc = {kk: torch.from_numpy(np.array(v)) for kk, v in jc.items()}
    else:
        jc = {"k": jnp.zeros((b, hk, s, d)), "v": jnp.zeros((b, hk, s, d))}
        tc = {kk: torch.zeros(b, hk, s, d) for kk in jc}
    return jc, tc, (jk, jv, tk, tv)


def _codecs(kind, **kw):
    if kind == "int8":
        return jkv.Int8KV(**kw), tkv.Int8KV(**kw)
    return jkv.FloatKV(**kw), tkv.FloatKV(**kw)


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("window,softcap", [(5, None), (None, 4.0),
                                            (7, 4.0)])
def test_codecs_band_and_softcap_match_jax(kind, window, softcap):
    """FloatKV / Int8KV with a window and / or a softcap against JAX's
    codecs: a grouped chunk (attend at base 10, the group folded as JAX's
    LLaMA path folds it), shared-limit decode rows (attend_rows) with a
    per-call window override, and the verify block (attend_rows_causal)
    at per-slot bases. 1e-5."""
    b, hk, g, s, d, t = 2, 2, 3, 24, 32, 6
    jc, tc, (jk, jv, tk, tv) = _caches(kind, b, hk, s, d, seed=1)
    jcod, tcod = _codecs(kind, window=window, softcap=softcap)
    jc = jcod.write(jc, jk, jv, 0)
    tcod.write(tc, tk, tv, 0)
    for name in jc:
        np.testing.assert_array_equal(_np(tc[name]), np.asarray(jc[name]))
    rng = np.random.default_rng(2)
    jq, tq = _pair(rng, (b, hk * g, t, d), 2.0)
    limits = 10 + jnp.arange(t)
    want = jcod.attend(jq.reshape(b, hk, g * t, d), jc, jnp.tile(limits, g))
    got = tcod.attend(tq, tc, 10)
    np.testing.assert_allclose(_np(got), np.asarray(want).reshape(
        b, hk * g, t, d), atol=ATOL)
    jr, tr = _pair(rng, (b, hk, g, d), 2.0)
    pos = np.asarray([3, 23], np.int32)
    for w in (None, 9):
        want = jcod.attend_rows(jr, jc, jnp.asarray(pos), window=w)
        got = tcod.attend_rows(tr, tc, torch.from_numpy(pos), window=w)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    jv_, tv_ = _pair(rng, (b, hk, 4, d), 2.0)
    bases = np.asarray([2, 19], np.int32)
    want = jcod.attend_rows_causal(jv_, jc, jnp.asarray(bases))
    got = tcod.attend_rows_causal(tv_, tc, torch.from_numpy(bases))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_paged_band_matches_jax(kind):
    """PagedKV(window=) decode rows through a permuted table against
    JAX's PagedKV(window=) (its band on the gathered view), 1e-5; a
    per-call window raises JAX's ValueError."""
    rng = np.random.default_rng(3)
    n_blocks, hk, bp, d, b, r = 13, 2, 4, 16, 3, 2
    tables = (rng.permutation(n_blocks - 1)[:12] + 1).reshape(b, 4)
    tables = tables.astype(np.int32)
    jk, tk = _pair(rng, (n_blocks, hk, bp, d), 2.0)
    jv, tv = _pair(rng, (n_blocks, hk, bp, d))
    if kind == "int8":
        jk, jv = (jnp.asarray(np.clip(np.round(np.asarray(x) * 40), -127,
                                      127).astype(np.int8)) for x in (jk, jv))
        tk, tv = (torch.from_numpy(np.array(x)) for x in (jk, jv))
    jc = {"k": jk, "v": jv, "tables": jnp.asarray(tables)}
    tc = {"k": tk, "v": tv, "tables": torch.from_numpy(tables)}
    if kind == "int8":
        jks, tks = _pair(rng, (n_blocks, hk, bp), 0.01)
        jc.update(ks=jnp.abs(jks) + 1e-3, vs=jnp.abs(jks) + 2e-3)
        tc.update(ks=tks.abs() + 1e-3, vs=tks.abs() + 2e-3)
    jq, tq = _pair(rng, (b, hk, r, d), 2.0)
    pos = np.asarray([15, 6, 11], np.int32)
    want = jpkv.PagedKV(bp, window=5).attend_rows(jq, jc, jnp.asarray(pos))
    got = tpkv.PagedKV(bp, window=5).attend_rows(tq, tc, torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError, match="per-layer window channel"):
        tpkv.PagedKV(bp, window=5).attend_rows(tq, tc, torch.from_numpy(pos),
                                              window=3)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_plain_versions_at_head_dim_256_match_jax(kind):
    """K5 / K6 / K7's plain versions at D = 256 (Gemma) against JAX's
    reference_cached_attention / reference_decode_attention /
    reference_paged_decode_attention (the TPU kernels' oracles), 1e-5;
    and with a band and a cap against JAX's codecs' einsum."""
    rng = np.random.default_rng(4)
    b, h, s, d = 2, 2, 20, 256
    jk, tk = _pair(rng, (b, h, s, d))
    jv, tv = _pair(rng, (b, h, s, d))
    sc = {}
    if kind == "int8":
        jk, jv = (jnp.asarray(np.clip(np.round(np.asarray(x) * 40), -127,
                                      127).astype(np.int8)) for x in (jk, jv))
        tk, tv = (torch.from_numpy(np.array(x)) for x in (jk, jv))
        a = (np.abs(rng.standard_normal((2, b, h, s))) * 0.02 + 1e-3)
        a = a.astype(np.float32)
        sc = {"j": {"ks": jnp.asarray(a[0]), "vs": jnp.asarray(a[1])},
              "t": {"ks": torch.from_numpy(a[0]), "vs": torch.from_numpy(a[1])}}
    js, ts = sc.get("j", {}), sc.get("t", {})
    jq, tq = _pair(rng, (b, h, 5, d))
    pos = np.asarray([0, 14], np.int32)
    np.testing.assert_allclose(
        _np(tca.reference_cached_attention(tq, tk, tv, torch.from_numpy(pos),
                                           **ts)),
        np.asarray(jca.reference_cached_attention(jq, jk, jv,
                                                  jnp.asarray(pos), **js)),
        atol=ATOL)
    np.testing.assert_allclose(
        _np(tca.reference_decode_attention(tq, tk, tv, torch.from_numpy(pos),
                                           **ts)),
        np.asarray(jca.reference_decode_attention(jq, jk, jv,
                                                  jnp.asarray(pos), **js)),
        atol=ATOL)
    tables = np.asarray([[3, 1, 4, 2, 0], [5, 0, 0, 0, 0]], np.int32)
    pool = {kk: x.reshape(b * h * s // 4 // h, h, 4, *x.shape[3:])[:6]
            for kk, x in (("k", tk), ("v", tv))}
    jpool = {kk: jnp.asarray(np.array(x)) for kk, x in pool.items()}
    pool_s = {kk: x.reshape(-1, h, 4)[:6] for kk, x in ts.items()}
    jpool_s = {kk: jnp.asarray(np.array(x)) for kk, x in pool_s.items()}
    np.testing.assert_allclose(
        _np(tca.reference_paged_decode_attention(
            tq, pool["k"], pool["v"], torch.from_numpy(tables),
            torch.from_numpy(pos), **pool_s)),
        np.asarray(jca.reference_paged_decode_attention(
            jq, jpool["k"], jpool["v"], jnp.asarray(tables), jnp.asarray(pos),
            **jpool_s)), atol=ATOL)
    jcod = (jkv.Int8KV if kind == "int8" else jkv.FloatKV)(window=6,
                                                          softcap=3.0)
    jc = {"k": jk, "v": jv, **js}
    want = jcod.attend_rows(jq, jc, jnp.asarray(pos))
    got = tca.reference_decode_attention(tq, tk, tv, torch.from_numpy(pos),
                                         window=6, softcap=3.0, **ts)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_ring_positions_and_rolling_codecs_match_jax():
    """ring_positions equals JAX's before and after the wrap; the rolling
    codecs (f32 and int8) fed a position stream give JAX's ring leaves and
    JAX's ring attention (its occupancy mask; the port's K6 over the ring
    with pos clipped to W - 1), before the first wrap and after it; a
    multi-position write keeps the last W rows; multi-row attends raise."""
    for p in (0, 5, 15, 16, 27, 40):
        np.testing.assert_array_equal(
            tkv.ring_positions(torch.tensor(p), 8).numpy(),
            np.asarray(jkv.ring_positions(p, 8)))
    np.testing.assert_array_equal(
        tkv.ring_positions(torch.tensor([3, 20]), 8).numpy(),
        np.asarray(jkv.ring_positions(jnp.asarray([3, 20]), 8)))
    b, hk, d, w = 2, 2, 16, 8
    rng = np.random.default_rng(5)
    for kind in ("f32", "int8"):
        jcod = (jkv.RollingInt8KV(window=w) if kind == "int8"
                else jkv.RollingFloatKV(window=w))
        tcod = (tkv.RollingInt8KV(window=w) if kind == "int8"
                else tkv.RollingFloatKV(window=w))
        jc, tc, _ = _caches(kind, b, hk, w, d, seed=6)
        jk, tk = _pair(rng, (b, hk, 11, d))
        jc = jcod.write(jc, jk, jk * 0.5, 0)  # 11 positions: wraps once
        tcod.write(tc, tk, tk * 0.5, 0)
        # one JAX program each for the step's write and attend (the int8
        # write stays eager: under jit XLA turns the scale's division by
        # 127 into a product, an ulp off the eager codec the port matches)
        jattend = jax.jit(jcod.attend_rows)
        jwrite = jcod.write_rows if kind == "int8" else jax.jit(jcod.write_rows)
        for p in range(11, 21):
            jk, tk = _pair(rng, (b, hk, 1, d))
            act = np.asarray([True, True])
            jc = jwrite(jc, jk, -jk, jnp.full((b,), p, jnp.int32),
                        jnp.asarray(act))
            tcod.write_rows(tc, tk, -tk, torch.full((b,), p,
                                                    dtype=torch.int32),
                            torch.from_numpy(act))
            for name in jc:
                np.testing.assert_array_equal(_np(tc[name]),
                                              np.asarray(jc[name]))
            jq, tq = _pair(rng, (b, hk, 2, d), 2.0)
            pos = np.asarray([p, p], np.int32)
            np.testing.assert_allclose(
                _np(tcod.attend_rows(tq, tc, torch.from_numpy(pos))),
                np.asarray(jattend(jq, jc, jnp.asarray(pos))), atol=ATOL)
        with pytest.raises(ValueError, match="single decode rows"):
            tcod.attend(torch.zeros(b, hk, 2, d), tc, 3)
    short = tkv.RollingFloatKV(window=w)
    c = {"k": torch.zeros(1, 1, w, 4), "v": torch.zeros(1, 1, w, 4)}
    short.write(c, torch.ones(1, 1, 3, 4), torch.ones(1, 1, 3, 4), 0)
    y = short.attend_rows(torch.ones(1, 1, 1, 4), c,
                          torch.tensor([2], dtype=torch.int32))
    np.testing.assert_allclose(y.numpy(), np.ones((1, 1, 1, 4)), atol=ATOL)


def test_codec_for_cache_builds_jax_codecs():
    """codec_for_cache as JAX's: a window and a softcap ride the float and
    int8 codecs; rolling builds the ring codecs, refuses a softcap with
    JAX's ValueError; an int4 cache still raises, naming ROADMAP item 2."""
    f = {"k": torch.zeros(1, 1, 4, 4), "v": torch.zeros(1, 1, 4, 4)}
    i8 = {"k": torch.zeros(1, 1, 4, 4, dtype=torch.int8),
          "v": torch.zeros(1, 1, 4, 4, dtype=torch.int8),
          "ks": torch.ones(1, 1, 4), "vs": torch.ones(1, 1, 4)}
    c = tkv.codec_for_cache(f, window=4, softcap=30.0)
    assert isinstance(c, tkv.FloatKV) and (c.window, c.softcap) == (4, 30.0)
    c = tkv.codec_for_cache(i8, window=4, softcap=30.0)
    assert isinstance(c, tkv.Int8KV) and (c.window, c.softcap) == (4, 30.0)
    assert isinstance(tkv.codec_for_cache(f, window=4, rolling=True),
                      tkv.RollingFloatKV)
    assert isinstance(tkv.codec_for_cache(i8, window=4, rolling=True),
                      tkv.RollingInt8KV)
    with pytest.raises(ValueError, match="softcap is not supported"):
        tkv.codec_for_cache(f, window=4, rolling=True, softcap=30.0)
    with pytest.raises(ValueError, match="positive window"):
        tkv.codec_for_cache(f, rolling=True)
    i4 = dict(i8, k=torch.zeros(1, 1, 4, 4, dtype=torch.uint8))
    with pytest.raises(NotImplementedError, match="item 2"):
        tkv.codec_for_cache(i4, window=4)


# ----------------------------------------------------------------------
# the models
# ----------------------------------------------------------------------

NAMES = ["mistral-test", "gemma2-test"]


@pytest.fixture(scope="module")
def models():
    """{name: (port cfg, JAX cfg, tree, JAX prepared, port prepared)} at
    a token-comparing scale: std 0.3, or 0.05 for gemma2-test, whose tied
    head makes a larger random model repeat one token."""
    out = {}
    for name, seed, scale in (("mistral-test", 3, 0.3),
                              ("gemma2-test", 5, 0.05)):
        tree = drawn_tree(name, seed=seed, scale=scale)
        out[name] = (tllama.PRESETS[name], jllama.PRESETS[name], tree,
                     jax_prepared(name, tree),
                     from_jax_params(tree, tllama.PRESETS[name], "cpu"))
    return out


def _ids(cfg, b, t, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t))


@pytest.mark.parametrize("name", NAMES)
def test_logits_and_cached_forward_match_jax(models, name):
    """make_apply_stacked (the band past the window, Gemma-2's softcaps,
    post norms and alternating windows) and the cached forward (a
    40-token prompt in chunks of 16 then one-token steps, the band inside
    K5's and K6's plain versions, per-layer windows) against JAX's on the
    same weights, 1e-5 relative to the logits' scale."""
    cfg, jcfg, tree, jprep, tprep = models[name]
    ids = _ids(cfg, 2, 40, seed=7)
    want = np.asarray(jax.jit(jllama.make_apply(jcfg))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(ids)))
    got = tllama.make_apply_stacked(cfg)(tprep, torch.from_numpy(ids))
    tol = ATOL * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=tol)
    jcache = jllama.init_cache(jcfg, 2, 48)
    tcache = tllama.init_cache(cfg, 2, 48, torch.float32, "cpu")
    # one JAX program per chunk width, the start a traced argument
    jfwd = jax.jit(jllama.forward_with_cache,
                   static_argnames=("cfg", "attn_kernel"))
    for start, n in ((0, 16), (16, 16), (32, 8), (40, 1), (41, 1)):
        chunk = (ids[:, start:start + n] if start < 40
                 else np.full((2, 1), 7 + start))
        jl, jcache = jfwd(jprep, jnp.asarray(chunk), jcache,
                          jnp.int32(start), cfg=jcfg, attn_kernel=False)
        tl, _ = tllama.forward_with_cache(tprep, torch.from_numpy(chunk),
                                          tcache, start, cfg=cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
    if name == "gemma2-test":
        assert np.abs(want).max() <= jcfg.final_softcap


@pytest.mark.parametrize("name,t,kv", [("mistral-test", 12, "f32"),
                                       ("mistral-test", 24, "f32"),
                                       ("mistral-test", 12, "int8"),
                                       ("gemma2-test", 12, "f32")])
def test_make_generate_across_the_window_matches_jax(models, name, t, kv):
    """Greedy streams that cross the window (prompt + 20 > 16) identical
    to JAX's make_generate: mistral-test on the rolling ring (a prompt
    shorter and one longer than the window; f32 and int8 rings),
    gemma2-test on its full-length cache with per-layer windows."""
    cfg, jcfg, _, jprep, tprep = models[name]
    ids = _ids(cfg, 2, t, seed=8)
    n = 20
    jkvd = None if kv == "f32" else "int8"
    want = np.asarray(jllama.make_generate(
        jcfg, max_new_tokens=n, kv_dtype=jkvd, attn_kernel=False)(
        jprep, jnp.asarray(ids), jax.random.PRNGKey(0)))
    got = make_generate(cfg, max_new_tokens=n, kv_dtype=kv,
                        device="cpu")(tprep, ids)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want.ravel().tolist())) > 3  # varied streams
