"""The port's cache-attention wrappers on the CPU (their plain versions)
against the JAX package: its reference math and its Pallas kernels run
in interpret mode, on the same numpy inputs.

Tolerance: atol 1e-5 everywhere. Both sides read the same (f32,
bf16-rounded, or int8 payload with f32 scales) K/V values and accumulate
in f32; only the summation order differs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dnn_tpu.ops.pallas import cached_attention as jca
from dnn_tpu_torch.ops.cuda import _build
from dnn_tpu_torch.ops.cuda import cached_attention as tca

ATOL = 1e-5
KV_DTYPES = ["f32", "bf16", "int8"]


def _inputs(seed, q_shape, kv_shape, dtype):
    """((q, k, v, ks, vs) torch, the same in jax): f32 draws, rounded to
    bf16, or an int8 payload with positive f32 scales of shape
    kv_shape[:-1] (None for the float types)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(q_shape).astype(np.float32)
    if dtype == "int8":
        k, v = (rng.integers(-127, 128, kv_shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(1e-3, 0.05, kv_shape[:-1]).astype(np.float32)
                  for _ in range(2))
        t = [torch.from_numpy(a) for a in (q, k, v, ks, vs)]
        return t, [jnp.asarray(a) for a in (q, k, v, ks, vs)]
    k = rng.standard_normal(kv_shape).astype(np.float32)
    v = rng.standard_normal(kv_shape).astype(np.float32)
    t_dt, j_dt = ((torch.float32, jnp.float32) if dtype == "f32"
                  else (torch.bfloat16, jnp.bfloat16))
    return ([torch.from_numpy(q), torch.from_numpy(k).to(t_dt),
             torch.from_numpy(v).to(t_dt), None, None],
            [jnp.asarray(q), jnp.asarray(k, j_dt), jnp.asarray(v, j_dt),
             None, None])


@pytest.mark.parametrize("dtype", KV_DTYPES)
@pytest.mark.parametrize("pos,d", [((0, 0), 32), ((3, 50), 32),
                                   ((100, 112), 32), ((3, 50), 128)],
                         ids=["pos0", "pos1", "pos2", "d128"])
def test_cached_attention_matches_jax(pos, d, dtype):
    """K5's plain version vs the JAX reference and the Pallas kernel in
    interpret mode: B=2 H=2 T=16 S=128, D=32 (and D=128, the widest head
    dim the CUDA kernel takes), block_s=128, runtime base positions per
    batch row."""
    (q, k, v, ks, vs), (jq, jk, jv, jks, jvs) = _inputs(
        1, (2, 2, 16, d), (2, 2, 128, d), dtype)
    got = tca.cached_attention(q, k, v, torch.tensor(pos, dtype=torch.int32),
                               ks=ks, vs=vs)
    jpos = jnp.asarray(pos, jnp.int32)
    ref = np.asarray(jca.reference_cached_attention(jq, jk, jv, jpos,
                                                    ks=jks, vs=jvs))
    pallas = np.asarray(jca.cached_attention(jq, jk, jv, jpos, ks=jks,
                                             vs=jvs, block_s=128,
                                             interpret=True))
    assert got.dtype == torch.float32 and got.shape == (2, 2, 16, d)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", KV_DTYPES)
@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("pos", [(0, 17, 127), (64, 128, 5)])
def test_decode_attention_matches_jax(pos, rows, dtype):
    """K6's plain version vs the JAX reference and the Pallas kernel in
    interpret mode: 3 slots, 2 KV heads, R query rows per head, S=128,
    block_s=128; positions at the first column, mid-cache, the last
    column, a block edge, and a stale slot at pos = S."""
    (q, k, v, ks, vs), (jq, jk, jv, jks, jvs) = _inputs(
        5, (3, 2, rows, 32), (3, 2, 128, 32), dtype)
    got = tca.decode_attention(q, k, v, torch.tensor(pos, dtype=torch.int32),
                               ks=ks, vs=vs)
    jpos = jnp.asarray(pos, jnp.int32)
    ref = np.asarray(jca.reference_decode_attention(jq, jk, jv, jpos,
                                                    ks=jks, vs=jvs))
    pallas = np.asarray(jca.decode_attention(jq, jk, jv, jpos, ks=jks,
                                             vs=jvs, block_s=128,
                                             interpret=True))
    assert got.dtype == torch.float32 and got.shape == (3, 2, rows, 32)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", KV_DTYPES)
@pytest.mark.parametrize("rows", [1, 2])
def test_paged_decode_attention_matches_jax(rows, dtype):
    """K7's plain version vs the JAX reference and the Pallas kernel in
    interpret mode: 3 slots, 2 KV heads, R query rows per head, block 16,
    8 logical blocks (S=128) through a permuted table over 25 blocks;
    positions at a block start, mid-block and the last column. An int8
    pool's (n_blocks, Hk, bp) scale blocks go through the same table."""
    (q, kp, vp, ks, vs), (jq, jkp, jvp, jks, jvs) = _inputs(
        2, (3, 2, rows, 32), (25, 2, 16, 32), dtype)
    perm = np.random.default_rng(3).permutation(24)[:24] + 1
    tables = perm.reshape(3, 8).astype(np.int32)
    pos = np.array([16, 37, 127], np.int32)
    got = tca.paged_decode_attention(q, kp, vp, torch.from_numpy(tables),
                                     torch.from_numpy(pos), ks=ks, vs=vs)
    jt, jp = jnp.asarray(tables), jnp.asarray(pos)
    ref = np.asarray(jca.reference_paged_decode_attention(
        jq, jkp, jvp, jt, jp, ks=jks, vs=jvs))
    pallas = np.asarray(jca.paged_decode_attention(
        jq, jkp, jvp, jt, jp, ks=jks, vs=jvs, interpret=True))
    assert got.dtype == torch.float32 and got.shape == (3, 2, rows, 32)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL, rtol=0)


@pytest.mark.parametrize("bh,t,s,plan", [
    (12, 64, 1024, (2, 8)),   # the serving chunk: two 64-key tiles a split
    (12, 300, 316, (2, 3)),   # the solo 300-token prompt
    (24, 128, 1024, (6, 3)),  # six tiles a split, the last split of four
    (96, 256, 300, (5, 1)),   # the query tiles fill the grid: no merge
    (2, 1, 1, (1, 1)),
])
def test_k5_split_plan(bh, t, s, plan):
    """K5's split-KV plan from the shapes alone: (tiles a split, splits).
    Every 64-key tile of the cache falls in exactly one split, none is
    empty, and the grid (splits x query tiles) stays within one row of
    query tiles of K5_TARGET_BLOCKS."""
    split_tiles, n_split = tca.k5_split(bh, t, s)
    assert (split_tiles, n_split) == plan
    n_tiles = -(-s // tca.K5_TILE)
    assert (n_split - 1) * split_tiles < n_tiles <= n_split * split_tiles
    query_tiles = bh * -(-t // tca.K5_TILE)
    assert n_split * query_tiles < tca.K5_TARGET_BLOCKS + query_tiles


@pytest.mark.parametrize("bh,s,unit,plan", [
    (48, 1024, 1, (256, 4)),   # K6 serving: B=4 Hk=12, the 1024 bucket
    (48, 1024, 16, (256, 4)),  # K7 serving: nb_max=64 blocks of 16
    (12, 316, 1, (64, 5)),     # K6 solo: B=1, 300-token prompt + 16
    (48, 64, 1, (64, 1)),      # the smallest bucket: one split, no merge
    (96, 96, 8, (64, 2)),      # block_len 8: eight blocks a split
    (36, 300, 10, (70, 5)),    # bp=10: 7 blocks a split, the last of 2
    (768, 1024, 1, (1024, 1)),  # B=64: the slots alone fill the grid
    (48, 32768, 16, (8192, 4)),  # a long pool: long splits
    (2, 1, 1, (1, 1)),
])
def test_decode_split_plan(bh, s, unit, plan):
    """K6/K7's split-KV plan from the shapes alone: (keys a split,
    splits). A split is a whole number of units (K7's blocks); every
    column of S (every logical block) falls in exactly one split, none is
    empty; a split holds DECODE_MIN_SPLIT_KEYS keys or more, or the whole
    row; and the grid (splits x bh) stays within one row of blocks of
    DECODE_TARGET_BLOCKS, or is one split."""
    split_keys, n_split = tca.decode_split(bh, s, unit)
    assert (split_keys, n_split) == plan
    assert split_keys % unit == 0
    units, per = -(-s // unit), split_keys // unit
    assert (n_split - 1) * per < units <= n_split * per
    assert split_keys >= min(tca.DECODE_MIN_SPLIT_KEYS, units * unit)
    assert n_split == 1 or n_split * bh < tca.DECODE_TARGET_BLOCKS + bh


def test_cpu_path_launches_no_kernel():
    """CPU tensors take the plain version: no kernel launch is counted,
    in total or by cache type, and nothing is built."""
    wrappers = (tca.cached_attention, tca.decode_attention,
                tca.paged_decode_attention)

    def counts():
        return [(w.launches, dict(w.launches_by_dtype)) for w in wrappers]
    before = counts()
    (q, k, v, _, _), _ = _inputs(4, (1, 2, 4, 32), (1, 2, 64, 32), "f32")
    tca.cached_attention(q, k, v, torch.zeros(1, dtype=torch.int32))
    tca.decode_attention(q[:, :, :1], k, v, torch.zeros(1, dtype=torch.int32))
    tables = torch.arange(1, 5, dtype=torch.int32).reshape(1, 4)
    pool = torch.zeros(5, 2, 16, 32)
    tca.paged_decode_attention(q[:, :, :1], pool, pool, tables,
                               torch.tensor([20], dtype=torch.int32))
    assert counts() == before


@pytest.mark.parametrize("bad", ["q_dtype", "pos_dtype", "kv_mismatch",
                                 "pos_shape", "cache_shape",
                                 "int8_without_scales", "scales_on_float",
                                 "scale_shape"])
def test_wrappers_reject_bad_inputs(bad):
    """Device, dtype and shape checks raise instead of computing; an
    int8 cache is admitted only together with both scale tensors."""
    q = torch.zeros(1, 2, 4, 32)
    k = torch.zeros(1, 2, 64, 32)
    v = torch.zeros(1, 2, 64, 32)
    pos = torch.zeros(1, dtype=torch.int32)
    scales = {}
    if bad == "q_dtype":
        q = q.double()
    elif bad == "pos_dtype":
        pos = pos.long()
    elif bad == "kv_mismatch":
        v = v.to(torch.bfloat16)
    elif bad == "pos_shape":
        pos = torch.zeros(2, dtype=torch.int32)
    elif bad == "cache_shape":
        k = v = torch.zeros(1, 3, 64, 32)
    elif bad == "int8_without_scales":
        k = v = torch.zeros(1, 2, 64, 32, dtype=torch.int8)
        scales = {"ks": torch.ones(1, 2, 64)}
    elif bad == "scales_on_float":
        scales = {"ks": torch.ones(1, 2, 64), "vs": torch.ones(1, 2, 64)}
    elif bad == "scale_shape":
        k = v = torch.zeros(1, 2, 64, 32, dtype=torch.int8)
        scales = {"ks": torch.ones(1, 2, 63), "vs": torch.ones(1, 2, 63)}
    for fn, qq in ((tca.cached_attention, q),
                   (tca.decode_attention, q[:, :, :1])):
        with pytest.raises((TypeError, ValueError)):
            fn(qq, k, v, pos, **scales)


def test_build_fails_loudly_without_nvcc(monkeypatch):
    """The kernel build never falls back: with no nvcc it raises."""
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    # library names are content-addressed and stable, one per source
    assert _build.lib_path("paged_decode") == _build.lib_path("paged_decode")
    assert _build.lib_path("cached_attention").name.startswith(
        "libcached_attention-")
    assert _build.lib_path("decode_attention").name.startswith(
        "libdecode_attention-")
    assert set(_build.KERNELS) == {"cached_attention", "decode_attention",
                                   "paged_decode", "flash_attention",
                                   "flash_bwd_dq", "flash_bwd_dkv"}
    # K3 and K4 come from one source, hence one library
    assert _build.lib_path("flash_bwd_dq") == _build.lib_path("flash_bwd_dkv")
    assert _build.lib_path("flash_bwd_dq").name.startswith("libflash_backward-")


@pytest.mark.parametrize("dtype", KV_DTYPES)
@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (8, 2), (7, 1), (4, 4)],
                         ids=["G2", "G4", "G7", "G1"])
def test_cached_attention_grouped_heads_match_jax(heads, kv_heads, dtype):
    """K5's plain version with grouped query heads (query head h reads
    KV head h / G) against the JAX LLaMA path's two formulas on the same
    inputs: the codecs' folded einsum (FloatKV / Int8KV .attend without
    `base`: q folded to (B, Hk, G * T, D), row limits tiled G times) and
    models/llama._gqa_scores_attend. B=2 T=9 S=40 D=32, base positions
    (0, 23).

    Tolerances: 1e-5, except bf16 against FloatKV.attend at 2e-2: that
    codec rounds the probabilities and the output to bf16, where K5 keeps
    them in f32 (the kernels' contract: f32 out). Against
    _gqa_scores_attend (f32 math on the bf16-rounded cache) bf16 holds at
    1e-5 too. _gqa_scores_attend has no scales, so int8 is held against
    Int8KV.attend alone."""
    from dnn_tpu.models import llama as jllama
    from dnn_tpu.runtime import kvcache as jkv

    b, t, s, d, pos = 2, 9, 40, 32, (0, 23)
    g = heads // kv_heads
    (q, k, v, ks, vs), (jq, jk, jv, jks, jvs) = _inputs(
        5, (b, heads, t, d), (b, kv_heads, s, d), dtype)
    got = tca.cached_attention(q, k, v, torch.tensor(pos, dtype=torch.int32),
                               ks=ks, vs=vs).numpy()
    limit = jnp.asarray(pos)[:, None] + jnp.arange(t)[None, :]  # (B, T)
    qg = jq.reshape(b, kv_heads, g * t, d)
    # the codecs take one limit row for the batch: one call per batch row
    codec = jkv.Int8KV() if dtype == "int8" else jkv.FloatKV(jk.dtype)
    folded = []
    for i in range(b):
        c = {"k": jk[i:i + 1], "v": jv[i:i + 1]}
        if dtype == "int8":
            c.update(ks=jks[i:i + 1], vs=jvs[i:i + 1])
        folded.append(np.asarray(codec.attend(
            qg[i:i + 1], c, jnp.tile(limit[i], g)), np.float32))
    folded = np.concatenate(folded).reshape(b, heads, t, d)
    np.testing.assert_allclose(got, folded, rtol=0,
                               atol=2e-2 if dtype == "bf16" else ATOL)
    if dtype != "int8":
        cols = jnp.arange(s)

        def mask(scores):
            keep = cols[None, None, None, None, :] <= \
                limit[:, None, None, :, None]
            return jnp.where(keep, scores, -1e30)

        ref = np.asarray(jllama._gqa_scores_attend(jq, jk, jv, mask))
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
