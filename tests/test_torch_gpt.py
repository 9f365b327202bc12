"""The port's GPT forward on the CPU against the JAX package, on the
same weights (carried across by dnn_tpu_torch.convert.from_jax_params).

Tolerance: atol 1e-4 on f32 logits — two frameworks' f32 matmuls and
softmaxes summed in different orders over 4 layers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.models import gpt as jgpt
from dnn_tpu.runtime import generate as jgen
from dnn_tpu_torch.convert import from_jax_params, load_npz
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.runtime import generate as tgen

from test_torch_llama import one_torch_thread  # noqa: F401,E402 — autouse:
# one intra-op thread; the suite's parallel workers oversubscribe the cores

ATOL = 1e-4
CFG_J = jgpt.PRESETS["gpt2-test"]
CFG_T = tgpt.PRESETS["gpt2-test"]


@pytest.fixture(scope="module")
def weights():
    params = jgpt.init(jax.random.PRNGKey(0), CFG_J)
    tree = jax.tree.map(np.asarray, params)
    return (jgpt.prepare_stacked(params, CFG_J),
            from_jax_params(tree, CFG_T, "cpu"))


def _ids(seed, n):
    return np.random.default_rng(seed).integers(0, CFG_T.vocab_size, (1, n))


def test_presets_match_jax():
    for name in ("gpt2", "gpt2-test"):
        j, t = jgpt.PRESETS[name], tgpt.PRESETS[name]
        assert (j.block_size, j.vocab_size, j.n_layer, j.n_head, j.n_embd,
                j.ln_eps) == (t.block_size, t.vocab_size, t.n_layer,
                              t.n_head, t.n_embd, t.ln_eps)


def test_init_matches_jax_shapes_and_scales():
    """numpy init: the JAX tree's structure and shapes; stds 0.02 /
    0.01 (wpe) / 0.02/sqrt(2L) (residual projections); tied head."""
    cfg = tgpt.GPTConfig(block_size=128, vocab_size=512, n_layer=2,
                         n_head=2, n_embd=64)
    t = tgpt.init(0, cfg)
    j = jax.tree.map(np.asarray, jgpt.init(jax.random.PRNGKey(0), jgpt.GPTConfig(
        block_size=128, vocab_size=512, n_layer=2, n_head=2, n_embd=64)))
    flat_t = jax.tree_util.tree_flatten_with_path(t)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(j)[0]
    assert [(p, a.shape) for p, a in flat_t] == [(p, a.shape) for p, a in flat_j]
    assert abs(t["wte"]["embedding"].std() - 0.02) < 2e-3
    assert abs(t["wpe"]["embedding"].std() - 0.01) < 1e-3
    proj = t["h_0"]["attn"]["proj"]["kernel"].std()
    assert abs(proj - 0.02 / 2.0) < 1e-3
    np.testing.assert_array_equal(t["lm_head"]["kernel"], t["wte"]["embedding"].T)
    assert tgpt.init(0, cfg)["h_1"]["mlp"]["fc"]["kernel"].tobytes() == \
        t["h_1"]["mlp"]["fc"]["kernel"].tobytes()  # seeded


@pytest.mark.parametrize("n", [5, 16, 29])
def test_prefill_logits_match_jax(weights, n):
    """forward_with_cache over a fresh cache: logits vs JAX's."""
    jprep, tprep = weights
    ids = _ids(n, n)
    jcache = jgen.init_cache(CFG_J, 1, 64)
    jlog, _ = jgen.forward_with_cache(jprep, jnp.asarray(ids), jcache, 0,
                                      cfg=CFG_J)
    tcache = tgen.init_cache(CFG_T, 1, 64, torch.float32, "cpu")
    tlog, _ = tgen.forward_with_cache(tprep, torch.from_numpy(ids), tcache, 0,
                                      cfg=CFG_T)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=0)


def test_chunked_prefill_matches_jax_and_no_cache(weights):
    """Two 16-token chunks at start 0 and 16 (the second attends the
    first through the cache) vs JAX's same two calls, and vs the plain
    no-cache forward over all 32 tokens."""
    jprep, tprep = weights
    ids = _ids(7, 32)
    jcache = jgen.init_cache(CFG_J, 1, 64)
    tcache = tgen.init_cache(CFG_T, 1, 64, torch.float32, "cpu")
    for start in (0, 16):
        chunk = ids[:, start:start + 16]
        jlog, jcache = jgen.forward_with_cache(jprep, jnp.asarray(chunk),
                                               jcache, start, cfg=CFG_J)
        tlog, tcache = tgen.forward_with_cache(
            tprep, torch.from_numpy(chunk), tcache, start, cfg=CFG_T)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL, rtol=0)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=ATOL, rtol=0)
    full = tgen.forward_no_cache(tprep, torch.from_numpy(ids), cfg=CFG_T)
    np.testing.assert_allclose(full[:, 16:].numpy(), tlog.numpy(),
                               atol=ATOL, rtol=0)


def test_cache_write_overhang_raises(weights):
    """The JAX codec clamps an overhanging write back onto real
    positions; the port refuses it."""
    _, tprep = weights
    tcache = tgen.init_cache(CFG_T, 1, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="overhangs"):
        tgen.forward_with_cache(tprep, torch.zeros(1, 8, dtype=torch.int64),
                                tcache, 12, cfg=CFG_T)


def test_load_npz_roundtrip(tmp_path, weights):
    """A flat "/"-keyed .npz of the JAX tree loads to the same weights."""
    params = jax.tree.map(np.asarray, jgpt.init(jax.random.PRNGKey(0), CFG_J))
    flat = {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "w.npz", **flat)
    prep = from_jax_params(load_npz(str(tmp_path / "w.npz")), CFG_T, "cpu")
    _, tprep = weights
    for a, b in zip(jax.tree_util.tree_leaves(prep),
                    jax.tree_util.tree_leaves(tprep)):
        assert torch.equal(a, b)
