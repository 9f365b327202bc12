"""The port's ContinuousBatcher on the CPU against the JAX package's on
the same weights and the same submit/step script — the paged pool, the
dense pool (plain and bucketed), int8 KV on both, and the kv="auto"
dense fallback — plus the pool's block accounting, back-pressure and the
options this slice leaves out.

Weights: the JAX init with every matrix scaled by 15, so that greedy
decoding on a 4-layer random model produces varied tokens instead of
one repeated id — the identity check then means something. Greedy
tokens must be IDENTICAL."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.models import gpt as jgpt
from dnn_tpu.runtime.serving import ContinuousBatcher as JaxBatcher
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.runtime.paged_kvcache import (
    BlockAllocator,
    InsufficientBlocks,
)
from dnn_tpu_torch.runtime.serving import ContinuousBatcher

from test_torch_llama import one_torch_thread  # noqa: F401,E402 — autouse:
# one intra-op thread; the suite's parallel workers oversubscribe the cores

CFG_J = jgpt.PRESETS["gpt2-test"]
CFG_T = tgpt.PRESETS["gpt2-test"]
POOL = dict(slots=3, max_len=64, prompt_pad=16, block_len=8)


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(
        lambda a: np.asarray(a) * (15.0 if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(0), CFG_J))
    jprep = jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), CFG_J)
    return jprep, from_jax_params(tree, CFG_T, "cpu")


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, CFG_T.vocab_size, n)


def _script(b):
    """Three requests of lengths 5 / 20 / 37 (one chunk, two, three with
    a padded tail); the third is admitted mid-decode."""
    r0 = b.submit(_prompt(0, 5), 10)
    r1 = b.submit(_prompt(1, 20), 12)
    for _ in range(3):
        b.step()
    r2 = b.submit(_prompt(2, 37), 9)
    res = b.drain()
    return [np.asarray(res[r]) for r in (r0, r1, r2)]


def test_greedy_tokens_identical_to_jax(weights):
    jprep, tprep = weights
    want = _script(JaxBatcher(CFG_J, jprep, kv="paged", **POOL))
    got = _script(ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert len(set(got[1].tolist())) > 3  # varied tokens, not one id


@pytest.mark.parametrize("kwargs", [
    {"kv": "dense"},
    {"kv": "dense", "decode_buckets": (16, 32)},
    {"kv": "paged", "kv_dtype": "int8"},
    {"kv": "dense", "kv_dtype": "int8"},
    {"kv": "auto", "prompt_pad": 12},
    {"kv": "paged", "kv_dtype": "int4"},
    {"kv": "dense", "kv_dtype": "int4", "decode_buckets": (16, 32)},
], ids=["dense", "dense-buckets", "paged-int8", "dense-int8",
        "auto-dense-fallback", "paged-int4", "dense-buckets-int4"])
def test_layout_greedy_tokens_identical_to_jax(weights, kwargs, caplog):
    """The same script through every other cache layout/dtype the JAX
    batcher serves. The bucketed pool starts at 16 positions and grows
    twice (a 37-token prompt needs 38 columns); prompt_pad 12 does not
    tile block_len 8, so kv="auto" falls back to the dense pool — the
    shape the first slice refused — and logs why. The int4 pools run
    K6/K7's plain versions on the packed payload, against JAX's int4
    einsum."""
    jprep, tprep = weights
    pool = {**POOL, **kwargs}
    want = _script(JaxBatcher(CFG_J, jprep, **pool))
    with caplog.at_level("WARNING", logger="dnn_tpu_torch.serving"):
        b = ContinuousBatcher(CFG_T, tprep, device="cpu", **pool)
    got = _script(b)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert b.paged == (kwargs["kv"] == "paged")
    if kwargs.get("kv_dtype") == "int8":
        assert b.cache["k"].dtype == torch.int8 and "ks" in b.cache
    if kwargs.get("kv_dtype") == "int4":
        assert b.cache["k"].dtype == torch.uint8 and "ks" in b.cache
        assert b.cache["k"].shape[-1] == CFG_T.n_embd // CFG_T.n_head // 2
    if "decode_buckets" in kwargs:
        assert b.bucket_grows == 2 and b.cache["k"].shape[3] == 64
    fell_back = "kv_fallback_dense" in caplog.text
    assert fell_back == (kwargs["kv"] == "auto")


@pytest.mark.parametrize("kwargs", [
    {"kv": "paged", "prompt_pad": 12},
    {"kv": "paged", "decode_buckets": True},
    {"kv": "dense", "paged_blocks": 9},
    {"kv": "auto", "prompt_pad": 12, "paged_blocks": 9},
    {"kv": "pool"},
])
def test_layout_validation(weights, kwargs):
    """Contradictory or impossible layouts fail loud instead of serving
    a layout the caller did not ask for."""
    _, tprep = weights
    with pytest.raises(ValueError):
        ContinuousBatcher(CFG_T, tprep, device="cpu", **{**POOL, **kwargs})


def test_bf16_pool_serves(weights):
    """A bf16 pool runs the same path (the JAX package rounds bf16 at
    other places, so tokens are only checked for shape and range)."""
    _, tprep = weights
    b = ContinuousBatcher(CFG_T, tprep, device="cpu", kv_dtype="bf16", **POOL)
    assert b.cache["k"].dtype == torch.bfloat16
    for out in _script(b):
        assert out.dtype == np.int32 and out.min() >= 0
        assert out.max() < CFG_T.vocab_size


def test_block_accounting(weights):
    """Admission holds ceil((prompt + budget) / block_len) blocks for
    the request's lifetime; retirement returns them; high water stays."""
    _, tprep = weights
    b = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    alloc = b.allocator
    assert alloc.n_blocks == 3 * (64 // 8) + 1  # auto-sized + junk block
    total = alloc.n_blocks - 1
    r0 = b.submit(_prompt(0, 5), 10)    # 15 positions -> 2 blocks
    r1 = b.submit(_prompt(1, 20), 12)   # 32 positions -> 4 blocks
    assert (alloc.n_used, alloc.n_free) == (6, total - 6)
    tables = b.cache["tables"]
    assert (tables[0, :2] > 0).all() and (tables[0, 2:] == 0).all()
    assert (tables[1, :4] > 0).all() and (tables[1, 4:] == 0).all()
    b.drain()
    assert set(b.results) == {r0, r1}
    assert (alloc.n_used, alloc.n_free, alloc.high_water) == (0, total, 6)


def test_insufficient_blocks_back_pressure(weights):
    """A pool short of blocks raises the TRANSIENT InsufficientBlocks
    (nothing leaks); once a request retires the same submit fits. A
    request larger than the whole pool is a permanent ValueError."""
    _, tprep = weights
    b = ContinuousBatcher(CFG_T, tprep, device="cpu", paged_blocks=9, **POOL)
    r0 = b.submit(_prompt(0, 30), 30)          # 60 positions -> 8 blocks
    with pytest.raises(InsufficientBlocks):
        b.submit(_prompt(1, 5), 3)
    assert b.allocator.n_used == 8 and b.free_slots() == 2
    b.drain()
    r1 = b.submit(_prompt(1, 5), 3)
    assert r1 == r0 + 1
    with pytest.raises(ValueError, match="allocatable"):
        ContinuousBatcher(CFG_T, tprep, device="cpu", paged_blocks=4,
                          **POOL).submit(_prompt(2, 30), 30)


def test_allocator_refcounts():
    a = BlockAllocator(4)
    blocks = a.alloc(2)
    a.ref(blocks[:1])
    a.free(blocks)
    assert a.n_used == 1          # the extra reference keeps one alive
    with pytest.raises(ValueError):
        a.free([0])               # the junk block is never owned
    a.free(blocks[:1])
    assert a.n_used == 0 and a.high_water == 2
    assert a.alloc(4) is None     # only 3 allocatable


def test_cancel_stop_and_sampling(weights):
    """cancel frees the slot and blocks; a stop sequence trims the
    match; a seeded sampled request reproduces itself across pools."""
    _, tprep = weights
    b = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    greedy = b.submit(_prompt(3, 9), 8)
    b.drain()
    toks = b.claim(greedy)[0].tolist()
    stop_at = b.submit(_prompt(3, 9), 8, stop=[toks[2:4]])
    victim = b.submit(_prompt(4, 9), 8)
    assert b.cancel(victim) and b.allocator.n_used == 3
    b.drain()
    stop = toks[2:4]
    end = next(n for n in range(2, 5) if toks[n - 2:n] == stop)
    tokens, reason, lps = b.claim(stop_at)
    assert (tokens.tolist(), reason, lps) == (toks[:end - 2], "stop", None)
    assert b.claim(victim) == (None, "cancelled", None)

    def sampled():
        p = ContinuousBatcher(CFG_T, tprep, device="cpu", seed=7, **POOL)
        p.submit(_prompt(5, 6), 4)  # a different neighbour each time
        rid = p.submit(_prompt(3, 9), 10, seed=11, temperature=0.9, top_k=20,
                       top_p=0.9)
        return p.drain()[rid]

    np.testing.assert_array_equal(sampled(), sampled())


# allow_constraints, lora_adapters (tests/test_torch_constrain.py,
# tests/test_torch_serving_lora.py), the MoE switch `ffn`
# (test_moe_ffn_pools_match_jax below) and int4 KV are ported
@pytest.mark.parametrize("kwargs", [
    {"kv_dtype": "int4"}, {"kv": "paged", "kv_dtype": "int4"},
    {"kv": "dense", "kv_dtype": "int4"}])
def test_out_of_scope_options_raise(weights, kwargs):
    """int4 KV, once refused here, builds its pool (the port's default
    kv="auto" pages) with JAX's int4 K/V (packed two a byte here, uint8 of
    D / 2) and f32 scales of JAX's shape; its streams are held to JAX's in
    test_layout_greedy_tokens_identical_to_jax."""
    jprep, tprep = weights
    b = ContinuousBatcher(CFG_T, tprep, device="cpu", **{**POOL, **kwargs})
    jb = JaxBatcher(CFG_J, jprep, **{**POOL, **kwargs})
    assert b.paged == (kwargs.get("kv") != "dense")
    jk = jb.cache["k"]
    assert str(jk.dtype) == "int4" and b.cache["k"].dtype == torch.uint8
    assert b.cache["k"].shape[-1] * 2 == jk.shape[-1]
    assert b.cache["ks"].shape == b.cache["k"].shape[:-1]
    assert b.cache["ks"].dtype == torch.float32
    assert str(jb.cache["ks"].dtype) == "float32"


@pytest.fixture(scope="module")
def moe_weights():
    """gpt2-moe-test, every leaf drawn from a numpy seed at 0.3: JAX's
    prepared tree and the port's."""
    from dnn_tpu.models import gpt_moe as jgm

    rng = np.random.default_rng(5)
    tree = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
        jax.eval_shape(lambda: jgm.init(jax.random.PRNGKey(0),
                                        jgm.PRESETS["gpt2-moe-test"])))
    cfg = jgm.PRESETS["gpt2-moe-test"]
    return jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), cfg), tree


@pytest.fixture(scope="module")
def moe_jax_streams(moe_weights):
    """The JAX batcher's streams of the script on gpt2-moe-test with the
    routed FFN (dense pool): one run held against every pool of the
    port's, as JAX's paged and dense pools route the same rows."""
    from dnn_tpu.models import gpt_moe as jgm
    from dnn_tpu.runtime.generate_moe import moe_cache_ffn as jffn

    jcfg = jgm.PRESETS["gpt2-moe-test"]
    return _script(JaxBatcher(jcfg, moe_weights[0], ffn=jffn(jcfg),
                              **{**POOL, "kv": "dense"}))


# the MoE switch (once kwargs1, kwargs3 and kwargs4 above, refused)
@pytest.mark.parametrize("kwargs", [
    {}, {"kv": "dense"}, {"kv": "paged"}], ids=["auto", "dense", "paged"])
def test_moe_ffn_pools_match_jax(moe_weights, moe_jax_streams, kwargs,
                                 monkeypatch):
    """The GPT-MoE family served as GPT blocks with the routed FFN (the
    batcher's `ffn=`, JAX's moe_cache_ffn) on each pool against the JAX
    batcher, at the preset's capacity factor 1.25: the script's prefill
    chunks (16 tokens, padding included) and decode steps (all 3 slots,
    idle ones included) drop selections, and drops depend on every row
    routed, so the streams agree only if the port routes exactly the
    rows JAX's batcher routes. Greedy tokens identical."""
    from dnn_tpu_torch.models import gpt_moe as tgm
    from dnn_tpu_torch.parallel import moe as tmoe
    from dnn_tpu_torch.runtime.generate_moe import moe_cache_ffn

    _, tree = moe_weights
    tcfg = tgm.PRESETS["gpt2-moe-test"]
    pool = {**POOL, **kwargs}
    want = moe_jax_streams
    dropped = []
    route = tmoe.route_topk

    def counting(logits, *, top_k, capacity, normalize=True):
        out = route(logits, top_k=top_k, capacity=capacity,
                    normalize=normalize)
        dropped.append(logits.shape[-2] * top_k - int(out[0].sum()))
        return out

    monkeypatch.setattr(tmoe, "route_topk", counting)
    b = ContinuousBatcher(tcfg, from_jax_params(tree, tcfg, "cpu"),
                          ffn=moe_cache_ffn(tcfg), device="cpu", **pool)
    got = _script(b)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert sum(dropped) > 0 and b.paged == (kwargs.get("kv") != "dense")


# json_depth (once opt2) is no batcher option: the daemon turns j= into
# a constraint (tests/test_torch_constrain.py). adapter (once opt1) is
# served (tests/test_torch_serving_lora.py). The KV handoff is served
# too (tests/test_torch_handoff.py): an empty prefilled= row is a
# malformed payload, and kv_handle is no batcher argument (the daemon
# resolves h= into prefilled=), as in JAX's batcher
@pytest.mark.parametrize("opt,exc", [({"prefilled": {"row": []}}, ValueError),
                                     ({"kv_handle": ""}, TypeError),
                                     ({"kv_handle": "h"}, TypeError)])
def test_out_of_scope_request_options_raise(weights, opt, exc):
    _, tprep = weights
    b = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    with pytest.raises(exc, match="leaves|unexpected arguments"):
        b.submit(_prompt(0, 5), 3, **opt)
    assert b.free_slots() == 3 and b.allocator.n_used == 0


def test_penalty_and_eos_match_jax(weights):
    """Greedy with a repetition penalty (both sides apply the HF rule
    over prompt + generated tokens) and retirement on eos: tokens and
    finish reasons identical to the JAX batcher's."""
    jprep, tprep = weights
    probe = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    rid = probe.submit(_prompt(6, 11), 12)
    eos = int(probe.drain()[rid][4])  # a token the greedy stream emits

    def run(b):
        r0 = b.submit(_prompt(6, 11), 12, repetition_penalty=1.3)
        r1 = b.submit(_prompt(6, 11), 12)
        res = b.drain()
        return [(res[r].tolist(), b.finish_reasons[r]) for r in (r0, r1)]

    want = run(JaxBatcher(CFG_J, jprep, kv="paged", eos_id=eos, **POOL))
    got = run(ContinuousBatcher(CFG_T, tprep, device="cpu", eos_id=eos,
                                **POOL))
    assert got == want
    assert got[1][1] == "eos" and got[1][0][-1] == eos
