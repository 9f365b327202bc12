"""The port's prefix cache on the CPU against the JAX batcher's on the
same weights and the same submit/step script: the dense pool's
exact-prefix LRU and the paged pool's radix store, in f32, bf16 and int8
KV. Greedy streams must be identical, and so must the pool's counts:
prompt chunks run, hits, misses and evictions. The scripts cover a
shared system prefix with copy-on-write of the boundary block, a
block-aligned full hit (zero chunks), retire-time insertion serving a
chat follow-up, the capacity backoff near a full row, eviction under a
small capacity and to make room for an admission, and the LLaMA family.

Weights: the JAX init with every matrix scaled by 15 (as
test_torch_serving), so that greedy decoding produces varied tokens.
Under bf16 KV the plain attention rounds its probabilities as JAX's
codec does (test_torch_llama.round_probs_like_jax)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.models import gpt as jgpt
from dnn_tpu.models import llama as jllama
from dnn_tpu.runtime.serving import ContinuousBatcher as JaxBatcher
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.models import llama as tllama
from dnn_tpu_torch.runtime.serving import ContinuousBatcher

from test_torch_llama import (  # one_torch_thread: the autouse fixture
    drawn_tree,
    jax_prepared,
    one_torch_thread,  # noqa: F401
    round_probs_like_jax,
)

CFG_J = jgpt.PRESETS["gpt2-test"]
CFG_T = tgpt.PRESETS["gpt2-test"]
POOL = dict(slots=3, max_len=64, prompt_pad=16, block_len=8)
JKV = {"f32": None, "bf16": jnp.bfloat16, "int8": "int8"}


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(
        lambda a: np.asarray(a) * (15.0 if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(0), CFG_J))
    jprep = jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), CFG_J)
    return jprep, from_jax_params(tree, CFG_T, "cpu")


def _prompt(seed, n, vocab=CFG_T.vocab_size):
    return np.random.default_rng(seed).integers(0, vocab, n)


def _stats(b):
    return (b.prefix_hits, b.prefix_misses, b.prefix_evictions,
            b.prefill_chunks_run)


def _chat_script(b, vocab=CFG_T.vocab_size):
    """A 21-token system prefix shared by two requests (the second
    admitted mid-decode: a copy-on-write of block 2, positions 16-23, on
    a paged pool); a block- and chunk-aligned 16-token prompt and its
    repeat (a full hit); a prompt that leaves a cached one mid-block;
    and a chat follow-up whose prompt is a finished request's transcript
    plus a new message (retire-time insertion)."""
    base = _prompt(10, 21, vocab)
    a = np.concatenate([base, _prompt(1, 5, vocab)])
    r0 = b.submit(a, 8)
    r1 = b.submit(np.concatenate([base, _prompt(2, 11, vocab)]), 9)
    for _ in range(3):
        b.step()
    r2 = b.submit(base[:16], 6)
    res = b.drain()
    r3 = b.submit(base[:16], 5)
    r4 = b.submit(np.concatenate([base, _prompt(2, 11, vocab)])[:27], 5)
    follow = np.concatenate([a, res[r0][:-1], _prompt(3, 4, vocab)])
    r5 = b.submit(follow[:45], 5)
    res = b.drain()
    return [np.asarray(res[r]).tolist() for r in (r0, r1, r2, r3, r4, r5)]


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("kv,cap", [("paged", 12), ("dense", 4)],
                         ids=["radix", "dense-lru"])
def test_prefix_cache_matches_jax(weights, monkeypatch, kv, cap, kv_dtype):
    jprep, tprep = weights
    if kv_dtype == "bf16":
        round_probs_like_jax(monkeypatch)
    jb = JaxBatcher(CFG_J, jprep, kv=kv, prefix_cache=cap,
                    kv_dtype=JKV[kv_dtype], **POOL)
    want = _chat_script(jb)
    b = ContinuousBatcher(CFG_T, tprep, kv=kv, prefix_cache=cap,
                          kv_dtype=kv_dtype, device="cpu", **POOL)
    got = _chat_script(b)
    assert got == want
    assert _stats(b) == _stats(jb)
    assert b.prefix_hits >= 4 and b.prefix_misses >= 1
    plain = ContinuousBatcher(CFG_T, tprep, kv=kv, kv_dtype=kv_dtype,
                              device="cpu", **POOL)
    assert _chat_script(plain) == got  # the cache changes no token
    assert b.prefill_chunks_run < plain.prefill_chunks_run


def test_full_hit_runs_zero_chunks(weights):
    """A block-aligned prompt that is wholly cached, with the logit row
    of its last block: its admission runs no chunk (radix), as does a
    chunk-aligned one on the dense LRU."""
    _, tprep = weights
    for kv in ("paged", "dense"):
        b = ContinuousBatcher(CFG_T, tprep, kv=kv, prefix_cache=8,
                              device="cpu", **POOL)
        p = _prompt(4, 32)
        r1 = b.submit(p, 4)
        b.drain()
        c0 = b.prefill_chunks_run
        r2 = b.submit(p, 4)
        b.drain()
        assert b.prefill_chunks_run == c0
        np.testing.assert_array_equal(b.results[r1], b.results[r2])


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_capacity_backoff_and_eviction_match_jax(weights, kv):
    """Long prompts near max_len whose radix resume is unaligned (the
    chunk loop backs off to its chunk boundary so as not to overhang the
    row), then a run of distinct prompts through a small cache and a
    small pool: entries evicted at insertion and, on the paged pool, to
    make room for an admission. Streams and counts equal JAX's."""
    jprep, tprep = weights
    kw = dict(slots=1, max_len=64, prompt_pad=16, block_len=8, kv=kv,
              prefix_cache=6 if kv == "paged" else 2)
    if kv == "paged":
        kw["paged_blocks"] = 12

    def script(b):
        base = _prompt(20, 21)
        out = []
        for p in (np.concatenate([base, _prompt(21, 34)]),   # 55 tokens
                  np.concatenate([base, _prompt(22, 37)]),   # 58 tokens
                  *[_prompt(30 + i, 17 + 5 * i) for i in range(4)],
                  np.concatenate([base, _prompt(23, 10)])):
            rid = b.submit(p, 3)
            out.append(np.asarray(b.drain()[rid]).tolist())
        return out

    jb = JaxBatcher(CFG_J, jprep, **kw)
    want = script(jb)
    b = ContinuousBatcher(CFG_T, tprep, device="cpu", **kw)
    assert script(b) == want
    assert _stats(b) == _stats(jb)
    assert b.prefix_evictions > 0
    if kv == "paged":
        # every block is the store's or free: nothing leaked
        assert b.allocator.n_used == b._prefix_store.n_blocks


def test_radix_admission_evicts_to_fit(weights):
    """A pool too small for the resident prefix and a new request: the
    admission evicts LRU leaves until its tail fits, and a request the
    pool cannot hold even empty fails for good (ValueError)."""
    _, tprep = weights
    b = ContinuousBatcher(CFG_T, tprep, kv="paged", paged_blocks=7,
                          prefix_cache=8, device="cpu", slots=1,
                          max_len=64, prompt_pad=16, block_len=8)
    r = b.submit(_prompt(40, 40), 8)   # 6 blocks; 5 stay resident
    b.drain()
    assert b._prefix_store.n_blocks == 5 and b.allocator.n_free == 1
    r2 = b.submit(_prompt(41, 40), 8)  # 6 more: 5 evicted to fit
    b.drain()
    assert b.prefix_evictions == 5 and len(b.results[r2]) == 8
    assert len(b.results[r]) == 8
    with pytest.raises(ValueError, match="allocatable"):
        b.submit(_prompt(42, 60), 4)


def test_prefix_cache_options_are_checked(weights):
    _, tprep = weights
    with pytest.raises(ValueError, match="prefix_cache"):
        ContinuousBatcher(CFG_T, tprep, prefix_cache=-1, device="cpu",
                          **POOL)


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_llama_prefix_cache_matches_jax(kv):
    """The LLaMA family (llama-test, grouped KV heads, RoPE at each
    chunk's absolute positions, a mid-block resume): streams and counts
    equal JAX's batcher with LlamaFamilyRows."""
    name = "llama-test"
    cfg_j, cfg_t = jllama.PRESETS[name], tllama.PRESETS[name]
    tree = drawn_tree(name, 1, 0.3)
    jb = JaxBatcher(cfg_j, jax_prepared(name, tree),
                    family=jllama.LlamaFamilyRows(cfg_j), kv=kv,
                    prefix_cache=12, **POOL)
    want = _chat_script(jb, cfg_t.vocab_size)
    b = ContinuousBatcher(cfg_t, from_jax_params(tree, cfg_t, "cpu"),
                          kv=kv, prefix_cache=12, device="cpu", **POOL)
    assert _chat_script(b, cfg_t.vocab_size) == want
    assert _stats(b) == _stats(jb)
    assert b.prefix_hits >= 4
