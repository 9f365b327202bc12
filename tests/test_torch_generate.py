"""The port's solo decoder (runtime/generate.make_generate) on the CPU
against the JAX package's make_generate(attn_kernel=False) on the same
weights and prompts. Greedy tokens must be IDENTICAL.

Weights: the JAX init with every matrix scaled by 15, so that greedy
decoding on a 4-layer random model produces varied tokens instead of
one repeated id."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.models import gpt as jgpt
from dnn_tpu.runtime import generate as jgen
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.runtime import generate as tgen

from test_torch_llama import one_torch_thread  # noqa: F401,E402 — autouse:
# one intra-op thread; the suite's parallel workers oversubscribe the cores

CFG_J = jgpt.PRESETS["gpt2-test"]
CFG_T = tgpt.PRESETS["gpt2-test"]
N_NEW = 12


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(
        lambda a: np.asarray(a) * (15.0 if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(0), CFG_J))
    return (jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), CFG_J),
            from_jax_params(tree, CFG_T, "cpu"))


@pytest.mark.parametrize("kwargs", [
    {}, {"kv_dtype": "int8"}, {"kv_dtype": "int4"},
    {"repetition_penalty": 1.3, "logit_bias": {5: 3.0, 7: -100.0}},
    {"kv_dtype": "int8", "repetition_penalty": 1.3, "logit_bias": {9: 2.5}},
    {"kv_dtype": "int4", "repetition_penalty": 1.3, "logit_bias": {9: 2.5}},
], ids=["f32", "int8", "int4", "f32-penalty-bias", "int8-penalty-bias",
        "int4-penalty-bias"])
def test_greedy_tokens_identical_to_jax(weights, kwargs):
    """Two prompts of 11 tokens, 12 new tokens: the prefill runs K5's
    plain version, every decode step K6's (an int4 cache: on the packed
    payload, against JAX's Int4KV einsum)."""
    jprep, tprep = weights
    ids = np.random.default_rng(0).integers(0, CFG_T.vocab_size, (2, 11))
    want = jgen.make_generate(CFG_J, max_new_tokens=N_NEW, attn_kernel=False,
                              **kwargs)(jprep, jnp.asarray(ids),
                                        jax.random.PRNGKey(0))
    got = tgen.make_generate(CFG_T, max_new_tokens=N_NEW, device="cpu",
                             **kwargs)(tprep, ids)
    assert got.dtype == torch.int32 and got.shape == (2, N_NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got[0].tolist())) > 3  # varied tokens, not one id


def test_sampling_is_seeded_and_filtered(weights):
    """Sampled draws come from a torch.Generator: the same seed repeats
    the stream, and top_k=1 collapses sampling onto the greedy tokens."""
    _, tprep = weights
    ids = np.random.default_rng(1).integers(0, CFG_T.vocab_size, (1, 7))
    gen = tgen.make_generate(CFG_T, max_new_tokens=8, temperature=0.9,
                             top_p=0.9, min_p=0.01, device="cpu")
    np.testing.assert_array_equal(gen(tprep, ids, seed=3),
                                  gen(tprep, ids, seed=3))
    greedy = tgen.make_generate(CFG_T, max_new_tokens=8, device="cpu")
    top1 = tgen.make_generate(CFG_T, max_new_tokens=8, temperature=0.7,
                              top_k=1, device="cpu")
    np.testing.assert_array_equal(top1(tprep, ids, seed=5),
                                  greedy(tprep, ids))


@pytest.mark.parametrize("kwargs,exc,match", [
    ({"compute_dtype": torch.float16}, ValueError, "compute_dtype"),
    ({"kv_dtype": "fp8"}, ValueError, "kv_dtype"),
    ({"min_p": 1.5}, ValueError, "min_p"),
    ({"repetition_penalty": 0.0}, ValueError, "repetition_penalty"),
    ({"logit_bias": {CFG_T.vocab_size: 1.0}}, ValueError, "logit_bias"),
])
def test_make_generate_rejects(kwargs, exc, match):
    """Bad values raise ValueError (a compute type other than f32 or
    bf16 among them; bf16 compute is held against JAX in
    test_torch_bf16_serving.py)."""
    with pytest.raises(exc, match=match):
        tgen.make_generate(CFG_T, max_new_tokens=4, device="cpu", **kwargs)


@pytest.mark.parametrize("kv_dtype", [None, "int4"])
def test_bucketed_generate_matches_jax_and_make_generate(weights, kv_dtype):
    """make_bucketed_generate over the ladder (16, 32, 48) from an
    11-token prompt and 24 new tokens: the cache starts at 16 and grows
    twice; its greedy tokens equal JAX's make_bucketed_generate on the
    same ladder, the port's make_generate, and its own unbucketed program
    (buckets=(max_len,), which never grows)."""
    from dnn_tpu.runtime import decode_buckets as jdb
    from dnn_tpu_torch.runtime import decode_buckets as tdb

    jprep, tprep = weights
    ids = np.random.default_rng(4).integers(0, CFG_T.vocab_size, (2, 11))
    kw = {"kv_dtype": kv_dtype} if kv_dtype else {}
    gen = tdb.make_bucketed_generate(CFG_T, max_len=48, max_new_tokens=24,
                                     buckets=(16, 32), device="cpu", **kw)
    got = gen(tprep, ids)
    assert gen.buckets == (16, 32, 48) and gen.bucket_grows == 2
    want = jdb.make_bucketed_generate(
        CFG_J, max_len=48, max_new_tokens=24, buckets=(16, 32), **kw)(
            jprep, jnp.asarray(ids), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    solo = tgen.make_generate(CFG_T, max_new_tokens=24, device="cpu",
                              **kw)(tprep, ids)
    np.testing.assert_array_equal(got.numpy(), solo.numpy())
    flat = tdb.make_bucketed_generate(CFG_T, max_len=48, max_new_tokens=24,
                                      buckets=(48,), device="cpu", **kw)
    np.testing.assert_array_equal(flat(tprep, ids).numpy(), got.numpy())
    assert flat.bucket_grows == 0


def test_ffn_hook_matches_jax():
    """The `ffn` hook (once refused, ROADMAP item 7) on JAX's GPT-MoE
    family: gpt2-moe-test's routed FFN through make_generate (the prompt
    routed as one group, each step's B tokens as one) gives JAX's
    greedy tokens at the preset's capacity factor 1.25 (selections
    drop); the engine's generator takes the MoE branch and refuses
    kv_dtype, as JAX's engine does."""
    from dnn_tpu.models import gpt_moe as jgm
    from dnn_tpu.runtime.generate_moe import moe_cache_ffn as jffn
    from dnn_tpu_torch.config import TopologyConfig
    from dnn_tpu_torch.models import gpt_moe as tgm
    from dnn_tpu_torch.runtime.engine import PipelineEngine
    from dnn_tpu_torch.runtime.generate_moe import (make_generate_moe,
                                                    moe_cache_ffn)

    jcfg, tcfg = jgm.PRESETS["gpt2-moe-test"], tgm.PRESETS["gpt2-moe-test"]
    rng = np.random.default_rng(3)
    tree = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
        jax.eval_shape(lambda: jgm.init(jax.random.PRNGKey(0), jcfg)))
    jprep = jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), jcfg)
    tprep = from_jax_params(tree, tcfg, "cpu")
    ids = np.random.default_rng(4).integers(0, tcfg.vocab_size, (3, 9))
    want = np.asarray(jgen.make_generate(
        jcfg, max_new_tokens=N_NEW, ffn=jffn(jcfg))(
            jprep, jnp.asarray(ids), jax.random.PRNGKey(0)))
    got = tgen.make_generate(tcfg, max_new_tokens=N_NEW, device="cpu",
                             ffn=moe_cache_ffn(tcfg))(tprep, ids)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(make_generate_moe(
        tcfg, max_new_tokens=N_NEW, device="cpu")(tprep, ids).numpy(), want)
    eng = PipelineEngine(TopologyConfig.from_dict({
        "model": "gpt2-moe-test", "device_type": "cpu",
        "nodes": [{"id": "n1", "part_index": 0}]}), params=tree)
    np.testing.assert_array_equal(
        eng.generate(ids, max_new_tokens=N_NEW).numpy(), want)
    with pytest.raises(ValueError, match="kv_dtype"):
        eng.make_generator(max_new_tokens=4, kv_dtype="int8")


def test_prompt_past_block_size_raises(weights):
    _, tprep = weights
    gen = tgen.make_generate(CFG_T, max_new_tokens=8, device="cpu")
    with pytest.raises(ValueError, match="block_size"):
        gen(tprep, np.zeros((1, CFG_T.block_size - 4), np.int64))
