"""The port's cache-attention wrappers on the CPU (their plain versions)
against the JAX package: its reference math and its Pallas kernels run
in interpret mode, on the same numpy inputs.

Tolerance: atol 1e-5 everywhere. Both sides read the same (f32 or
bf16-rounded) K/V values and accumulate in f32; only the summation
order differs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dnn_tpu.ops.pallas import cached_attention as jca
from dnn_tpu_torch.ops.cuda import _build
from dnn_tpu_torch.ops.cuda import cached_attention as tca

ATOL = 1e-5
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, q_shape, kv_shape, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(q_shape).astype(np.float32)
    k = rng.standard_normal(kv_shape).astype(np.float32)
    v = rng.standard_normal(kv_shape).astype(np.float32)
    t_dt, j_dt = DTYPES[dtype]
    kt, vt = torch.from_numpy(k).to(t_dt), torch.from_numpy(v).to(t_dt)
    return (torch.from_numpy(q), kt, vt), (jnp.asarray(q), jnp.asarray(k, j_dt),
                                           jnp.asarray(v, j_dt))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [(0, 0), (3, 50), (100, 112)])
def test_cached_attention_matches_jax(pos, dtype):
    """K5's plain version vs the JAX reference and the Pallas kernel in
    interpret mode: B=2 H=2 T=16 S=128 D=32, block_s=128, runtime base
    positions per batch row."""
    (q, k, v), (jq, jk, jv) = _inputs(1, (2, 2, 16, 32), (2, 2, 128, 32),
                                      dtype)
    got = tca.cached_attention(q, k, v, torch.tensor(pos, dtype=torch.int32))
    jpos = jnp.asarray(pos, jnp.int32)
    ref = np.asarray(jca.reference_cached_attention(jq, jk, jv, jpos))
    pallas = np.asarray(jca.cached_attention(jq, jk, jv, jpos, block_s=128,
                                             interpret=True))
    assert got.dtype == torch.float32 and got.shape == (2, 2, 16, 32)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rows", [1, 2])
def test_paged_decode_attention_matches_jax(rows, dtype):
    """K7's plain version vs the JAX reference and the Pallas kernel in
    interpret mode: 3 slots, 2 KV heads, R query rows per head, block 16,
    8 logical blocks (S=128) through a permuted table over 25 blocks;
    positions at a block start, mid-block and the last column."""
    (q, kp, vp), (jq, jkp, jvp) = _inputs(2, (3, 2, rows, 32),
                                          (25, 2, 16, 32), dtype)
    perm = np.random.default_rng(3).permutation(24)[:24] + 1
    tables = perm.reshape(3, 8).astype(np.int32)
    pos = np.array([16, 37, 127], np.int32)
    got = tca.paged_decode_attention(q, kp, vp, torch.from_numpy(tables),
                                     torch.from_numpy(pos))
    jt, jp = jnp.asarray(tables), jnp.asarray(pos)
    ref = np.asarray(jca.reference_paged_decode_attention(jq, jkp, jvp, jt, jp))
    pallas = np.asarray(jca.paged_decode_attention(jq, jkp, jvp, jt, jp,
                                                   interpret=True))
    assert got.dtype == torch.float32 and got.shape == (3, 2, rows, 32)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL, rtol=0)


def test_cpu_path_launches_no_kernel():
    """CPU tensors take the plain version: no kernel launch is counted
    and nothing is built."""
    before = (tca.cached_attention.launches,
              tca.paged_decode_attention.launches)
    (q, k, v), _ = _inputs(4, (1, 2, 4, 32), (1, 2, 64, 32), "f32")
    tca.cached_attention(q, k, v, torch.zeros(1, dtype=torch.int32))
    tables = torch.arange(1, 5, dtype=torch.int32).reshape(1, 4)
    pool = torch.zeros(5, 2, 16, 32)
    tca.paged_decode_attention(q[:, :, :1], pool, pool, tables,
                               torch.tensor([20], dtype=torch.int32))
    assert (tca.cached_attention.launches,
            tca.paged_decode_attention.launches) == before


@pytest.mark.parametrize("bad", ["q_dtype", "pos_dtype", "kv_mismatch",
                                 "pos_shape", "cache_shape"])
def test_wrappers_reject_bad_inputs(bad):
    """Device, dtype and shape checks raise instead of computing."""
    q = torch.zeros(1, 2, 4, 32)
    k = torch.zeros(1, 2, 64, 32)
    v = torch.zeros(1, 2, 64, 32)
    pos = torch.zeros(1, dtype=torch.int32)
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
    with pytest.raises((TypeError, ValueError)):
        tca.cached_attention(q, k, v, pos)


def test_build_fails_loudly_without_nvcc(monkeypatch):
    """The kernel build never falls back: with no nvcc it raises."""
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    # library names are content-addressed and stable
    assert _build.lib_path("paged_decode") == _build.lib_path("paged_decode")
    assert _build.lib_path("cached_attention").name.startswith(
        "libcached_attention-")
