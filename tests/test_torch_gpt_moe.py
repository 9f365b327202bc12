"""The port's GPT-MoE family (models/gpt_moe.py, runtime/generate_moe.py)
on the CPU against the JAX package's, on the same weights
(gpt2-moe-test, every leaf drawn from a numpy seed, crossing through
convert.from_jax_params).

Logits: 1e-5 absolute in f32, as tests/test_torch_llama.py holds the
LLaMA family (both sides f32; only the order of the sums differs).
Greedy tokens identical. The preset routes at capacity factor 1.25, so
selections drop and the outputs depend on the tokens routed together:
the stateless forward routes its B*T tokens in `groups` groups, the
cached prefill its prompt, each decode step its B tokens. The batcher's
streams on every pool are held in tests/test_torch_serving.py
(test_moe_ffn_pools_match_jax), make_generate and the engine's MoE
branch in tests/test_torch_generate.py (test_ffn_hook_matches_jax)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.models import gpt as jgpt
from dnn_tpu.models import gpt_moe as jgm
from dnn_tpu_torch.convert import from_jax_params, to_jax_params
from dnn_tpu_torch.models import gpt_moe as tgm
from dnn_tpu_torch.registry import get_model
from test_torch_llama import one_torch_thread  # noqa: F401 (autouse)

JCFG, TCFG = jgm.PRESETS["gpt2-moe-test"], tgm.PRESETS["gpt2-moe-test"]
ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    """(numpy tree, JAX prepared, port prepared) of gpt2-moe-test."""
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
        jax.eval_shape(lambda: jgm.init(jax.random.PRNGKey(0), JCFG)))
    return (tree, jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), JCFG),
            from_jax_params(tree, TCFG, "cpu"))


def _ids(b, t, seed):
    return np.random.default_rng(seed).integers(0, TCFG.vocab_size, (b, t))


def test_port_init_has_the_jax_tree(weights):
    """init(seed) (numpy) and init(seed, device="cpu") (tensors) have
    JAX's tree: the same leaves and shapes; the weights cross both ways
    through convert, expert stacks included."""
    want = weights[0]  # JAX's init tree, redrawn
    for tree in (tgm.init(0, TCFG), tgm.init(0, TCFG, device="cpu")):
        assert jax.tree.structure(tree) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
            assert tuple(a.shape) == b.shape
    tree = want
    back = to_jax_params(from_jax_params(tree, TCFG, "cpu"), TCFG)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    bad = dataclasses.replace(TCFG, n_experts=8)
    with pytest.raises(ValueError, match="moe"):
        from_jax_params(tree, bad, "cpu")


@pytest.mark.parametrize("groups", [1, 2])
def test_logits_match_jax(weights, groups):
    """The stateless forward (per-layer and stacked trees) against JAX's,
    the B*T = 2 x 16 tokens routed in `groups` groups, and (groups 1)
    the cached prefill, forward_with_cache_moe."""
    from dnn_tpu.runtime import generate_moe as jgen
    from dnn_tpu_torch.runtime import generate_moe as tgen

    tree, jprep, tprep = weights
    ids = _ids(2, 16, 1)
    want = np.asarray(jax.jit(jgm.make_apply(JCFG, groups=groups))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(ids)))
    per_layer = jax.tree.map(torch.from_numpy, tree)
    for got in (tgm.make_apply(TCFG, groups=groups)(per_layer,
                                                     torch.from_numpy(ids)),
                tgm.make_apply_stacked(TCFG, groups=groups)(
                    tprep, torch.from_numpy(ids))):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    if groups != 1:
        return
    jl, _ = jax.jit(lambda p, i, c: jgen.forward_with_cache_moe(
        p, i, c, 0, cfg=JCFG))(
            jprep, jnp.asarray(ids), jgen.init_cache(JCFG, 2, 24))
    from dnn_tpu_torch.runtime.generate import init_cache

    tl, _ = tgen.forward_with_cache_moe(
        tprep, torch.from_numpy(ids),
        init_cache(TCFG, 2, 24, torch.float32, "cpu"), 0, cfg=TCFG)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)


def test_partition_stages_match_jax(weights):
    """make_partition's stages (1 and 2 parts) have JAX's names and
    parameter keys, and chained they equal the whole forward (itself
    held to JAX's above); the registry builds the family."""
    tree, _, _ = weights
    from dnn_tpu.registry import get_model as jax_get_model

    ids = _ids(1, 8, 2)
    per_layer = jax.tree.map(torch.from_numpy, tree)
    whole = tgm.make_apply(TCFG)(per_layer, torch.from_numpy(ids)).numpy()
    for parts in (1, 2):
        x = torch.from_numpy(ids)
        for st, jst in zip(get_model("gpt2-moe-test").partition(parts),
                           jax_get_model("gpt2-moe-test").partition(parts)):
            assert st.param_keys == jst.param_keys and st.name == jst.name
            x = st.apply(st.slice_params(per_layer), x)
        np.testing.assert_allclose(x.numpy(), whole, rtol=0, atol=ATOL)


def test_speculative_greedy_parity(weights):
    """JAX tests/test_generate_moe.py:130: a gpt2-moe-test target at a
    capacity that cannot drop (routing then does not depend on the chunk)
    drafted by gpt2-test: the speculative decoder's greedy tokens equal
    the target-only make_generate_moe's (held to JAX's in
    tests/test_torch_generate.py)."""
    from dnn_tpu_torch.models import gpt as tgpt
    from dnn_tpu_torch.runtime.generate_moe import make_generate_moe
    from dnn_tpu_torch.runtime.speculative import make_speculative_generate

    _, _, tprep = weights
    thi = dataclasses.replace(TCFG, capacity_factor=float(TCFG.n_experts))
    ids = _ids(1, 8, 3)
    want = make_generate_moe(thi, max_new_tokens=8, device="cpu")(
        tprep, ids).numpy()
    dcfg = tgpt.PRESETS["gpt2-test"]
    dprep = from_jax_params(tgpt.init(4, dcfg), dcfg, "cpu")
    got = make_speculative_generate(thi, dcfg, max_new_tokens=8, k=3,
                                    device="cpu")(tprep, dprep, ids)
    np.testing.assert_array_equal(got.numpy(), want)


def test_refusals_match_jax(weights):
    """JAX's refusals stand: the speculative batcher takes no live `ffn`
    (JAX serving_spec.py:124), and the daemon's embedding endpoint
    refuses a family whose ffn sits on the adapter only (the GPT-MoE
    daemon; JAX lm_server.py:1561-1572)."""
    from dnn_tpu_torch.models import gpt as tgpt
    from dnn_tpu_torch.runtime.generate_moe import moe_cache_ffn
    from dnn_tpu_torch.runtime.lm_server import LMServer
    from dnn_tpu_torch.runtime.serving_spec import SpeculativeBatcher

    _, _, tprep = weights
    dcfg = tgpt.PRESETS["gpt2-test"]
    dprep = from_jax_params(tgpt.init(4, dcfg), dcfg, "cpu")
    with pytest.raises(ValueError, match="ffn"):
        SpeculativeBatcher(TCFG, tprep, dcfg, dprep, ffn=moe_cache_ffn(TCFG),
                           device="cpu", slots=2, max_len=32, prompt_pad=8)
    srv = LMServer(TCFG, tprep, ffn=moe_cache_ffn(TCFG), device="cpu",
                   slots=2, max_len=32, prompt_pad=8, block_len=8)
    try:
        with pytest.raises(ValueError, match="GPT-MoE daemon"):
            srv._embed_prompt(np.arange(5), "mean")
    finally:
        srv.close()
