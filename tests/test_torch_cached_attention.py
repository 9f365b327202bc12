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
@pytest.mark.parametrize("pos", [(0, 0), (3, 50), (100, 112)])
def test_cached_attention_matches_jax(pos, dtype):
    """K5's plain version vs the JAX reference and the Pallas kernel in
    interpret mode: B=2 H=2 T=16 S=128 D=32, block_s=128, runtime base
    positions per batch row."""
    (q, k, v, ks, vs), (jq, jk, jv, jks, jvs) = _inputs(
        1, (2, 2, 16, 32), (2, 2, 128, 32), dtype)
    got = tca.cached_attention(q, k, v, torch.tensor(pos, dtype=torch.int32),
                               ks=ks, vs=vs)
    jpos = jnp.asarray(pos, jnp.int32)
    ref = np.asarray(jca.reference_cached_attention(jq, jk, jv, jpos,
                                                    ks=jks, vs=jvs))
    pallas = np.asarray(jca.cached_attention(jq, jk, jv, jpos, ks=jks,
                                             vs=jvs, block_s=128,
                                             interpret=True))
    assert got.dtype == torch.float32 and got.shape == (2, 2, 16, 32)
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
