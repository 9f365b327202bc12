"""The port's solo speculative decoder (runtime/speculative.py) on the
CPU; mirrors tests/test_speculative.py.

  * greedy speculative tokens equal JAX's make_speculative_generate and
    the port's own make_generate, across prompt lengths, for the GPT
    family, a LLaMA pair and a GPT draft for a LLaMA target;
  * a draft that is the target accepts every proposal, greedy and
    sampled; the acceptance statistics are sane;
  * sampled output follows the target's distribution: the first token's
    histogram over 2000 seeded draws within total variation 0.12 of the
    target's softmax row, and visibly away from the draft's (JAX's tests
    and tolerances); the draws come from a torch.Generator, so a seed
    gives the same stream every time but not JAX's;
  * the shape checks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.models import gpt as jgpt
from dnn_tpu.models import llama as jllama
from dnn_tpu.runtime.speculative import (
    make_speculative_generate as jax_speculative,
)
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.models import llama as tllama
from dnn_tpu_torch.runtime.generate import make_generate
from dnn_tpu_torch.runtime.speculative import (
    _probs,
    make_speculative_generate,
)

from test_torch_llama import one_torch_thread  # noqa: F401 (autouse)

T_J = jgpt.PRESETS["gpt2-test"]  # block_size 64, vocab 256, 4 layers
D_J = jgpt.GPTConfig(block_size=64, vocab_size=256, n_layer=1, n_head=2,
                     n_embd=32)
ST_TJ = jgpt.GPTConfig(block_size=64, vocab_size=32, n_layer=2, n_head=2,
                       n_embd=32)
ST_DJ = jgpt.GPTConfig(block_size=64, vocab_size=32, n_layer=1, n_head=2,
                       n_embd=16)


def _t(cfg):
    """The port's config of a JAX GPTConfig."""
    return tgpt.GPTConfig(**dataclasses.asdict(cfg))


def _gpt(cfg, seed, scale=1.0, head_scale=1.0):
    """(JAX prepared, port prepared) of a JAX init, matrices x `scale`
    (x15: decisive greedy argmaxes) and the head x `head_scale`."""
    tree = jax.tree.map(
        lambda a: np.asarray(a) * np.float32(scale if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(seed), cfg))
    if head_scale != 1.0:
        tree["lm_head"]["kernel"] = tree["lm_head"]["kernel"] * np.float32(
            head_scale)
    return (jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), cfg),
            from_jax_params(tree, _t(cfg), "cpu"))


def _ids(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (1, n))


@pytest.mark.parametrize("scale", [1.0, 15.0], ids=["jax-init", "x15"])
def test_greedy_token_parity_vs_plain_generate(scale):
    """Greedy speculative tokens are the port's make_generate's; with
    decisive weights (x15) they are JAX's speculative decoder's too."""
    (tj, tt), (dj, dt) = _gpt(T_J, 0, scale), _gpt(D_J, 1, scale)
    ids = _ids(2, 8, 256)
    spec = make_speculative_generate(_t(T_J), _t(D_J), max_new_tokens=16,
                                     k=4, device="cpu")
    plain = make_generate(_t(T_J), max_new_tokens=16, device="cpu")
    got = spec(tt, dt, ids)
    assert got.dtype == torch.int32 and got.shape == (1, 16)
    np.testing.assert_array_equal(got.numpy(), plain(tt, ids).numpy())
    if scale != 1.0:
        want = jax_speculative(T_J, D_J, max_new_tokens=16, k=4)(
            tj, dj, jnp.asarray(ids), jax.random.PRNGKey(0))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_parity_across_prompt_lengths():
    (tj, tt), (dj, dt) = _gpt(T_J, 3, 15.0), _gpt(D_J, 4, 15.0)
    spec = make_speculative_generate(_t(T_J), _t(D_J), max_new_tokens=8,
                                     k=3, device="cpu")
    jspec = jax_speculative(T_J, D_J, max_new_tokens=8, k=3)
    plain = make_generate(_t(T_J), max_new_tokens=8, device="cpu")
    for p in (6, 11):
        ids = _ids(p, p, 256)
        got = spec(tt, dt, ids).numpy()
        np.testing.assert_array_equal(got, plain(tt, ids).numpy())
        np.testing.assert_array_equal(got, np.asarray(jspec(
            tj, dj, jnp.asarray(ids), jax.random.PRNGKey(1))))


def test_llama_pairs_greedy_parity():
    """A LLaMA target verifying a LLaMA draft and a GPT draft (gpt2-test
    and llama-test share vocab 256): greedy tokens equal JAX's and the
    target's own make_generate."""
    from test_torch_llama import drawn_tree, jax_prepared

    cfg_t, cfg_j = tllama.PRESETS["llama-test"], jllama.PRESETS["llama-test"]
    tree = drawn_tree("llama-test", 21, 0.3)
    tt, tj = from_jax_params(tree, cfg_t, "cpu"), jax_prepared("llama-test",
                                                               tree)
    d_tj = dataclasses.replace(cfg_j, n_layer=1)
    d_tt = dataclasses.replace(cfg_t, n_layer=1)
    d_tree = jax.tree.map(np.asarray, jllama.init(jax.random.PRNGKey(22),
                                                  d_tj))
    d_j = jgpt.prepare_stacked(jax.tree.map(jnp.asarray, d_tree), d_tj)
    d_t = from_jax_params(d_tree, d_tt, "cpu")
    (gj, gt) = _gpt(T_J, 24, 15.0)
    ids = _ids(9, 8, 256)
    want = make_generate(cfg_t, max_new_tokens=9, device="cpu")(tt, ids)
    for dcfg_t, dcfg_j, dp_t, dp_j in ((d_tt, d_tj, d_t, d_j),
                                       (_t(T_J), T_J, gt, gj)):
        got = make_speculative_generate(cfg_t, dcfg_t, max_new_tokens=9, k=3,
                                        device="cpu")(tt, dp_t, ids)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jax_speculative(cfg_j, dcfg_j, max_new_tokens=9, k=3)(
                tj, dp_j, jnp.asarray(ids), jax.random.PRNGKey(0))))


def test_draft_equals_target_accepts_everything():
    _, tt = _gpt(T_J, 0)
    ids = _ids(5, 8, 256)
    for temp in (0.0, 1.0):
        spec = make_speculative_generate(_t(T_J), _t(T_J), max_new_tokens=12,
                                         k=4, temperature=temp,
                                         return_stats=True, device="cpu")
        _, stats = spec(tt, tt, ids)
        assert stats["accepted"] == stats["proposed"], (temp, stats)


def test_acceptance_stats_sane_and_seeded():
    (_, tt), (_, dt) = _gpt(T_J, 7), _gpt(D_J, 8)
    ids = _ids(8, 8, 256)
    spec = make_speculative_generate(_t(T_J), _t(D_J), max_new_tokens=16,
                                     k=4, temperature=1.0, return_stats=True,
                                     device="cpu")
    toks, stats = spec(tt, dt, ids, seed=0)
    it, prop, acc = (stats[x] for x in ("iterations", "proposed", "accepted"))
    assert prop == it * 4 and 0 <= acc <= prop and it <= 16
    t = toks.numpy()
    assert t.shape == (1, 16) and (t >= 0).all() and (t < 256).all()
    again, _ = spec(tt, dt, ids, seed=0)
    np.testing.assert_array_equal(again.numpy(), t)


def _first_token_hist(spec_fn, tp, dp, ids, n_draws, vocab):
    toks = [int(spec_fn(tp, dp, ids, seed=s)[0, 0]) for s in range(n_draws)]
    return np.bincount(toks, minlength=vocab) / n_draws


def _exact_row(prep, cfg, ids):
    from dnn_tpu_torch.runtime.generate import forward_no_cache

    logits = forward_no_cache(prep, torch.from_numpy(ids), cfg=cfg)
    return _probs(logits[0, -1], temperature=1.0, top_k=None).numpy()


_DIST = {}  # same_draft -> (the target's prepared, the draft's, ids,
# the 2000-draw histogram): the draws are seeded, so the distribution
# tests share one set instead of drawing it twice


def _dist_draws(same_draft):
    if same_draft not in _DIST:
        (_, tt), (_, dt) = _gpt(ST_TJ, 11, head_scale=6.0), _gpt(ST_DJ, 12)
        d_cfg, d_prep = (ST_TJ, tt) if same_draft else (ST_DJ, dt)
        ids = _ids(12, 8, 32)
        spec = make_speculative_generate(_t(ST_TJ), _t(d_cfg),
                                         max_new_tokens=1, k=2,
                                         temperature=1.0, device="cpu")
        _DIST[same_draft] = (tt, dt, ids, _first_token_hist(
            spec, tt, d_prep, ids, 2000, 32))
    return _DIST[same_draft]


@pytest.mark.parametrize("same_draft", [False, True])
def test_sampled_matches_target_distribution(same_draft):
    """The first token's histogram over 2000 seeded draws against the
    target's exact softmax row: within total variation 0.12 (E[TV] for
    2000 draws over 32 bins is about 0.05). same_draft=False runs the
    rejection and residual resample, True pure acceptance and the bonus
    row. One new token a draw: the first token's distribution is the
    same whatever follows it."""
    tt, _, ids, hist = _dist_draws(same_draft)
    tv = 0.5 * np.abs(hist - _exact_row(tt, _t(ST_TJ), ids)).sum()
    assert tv < 0.12, f"TV(spec, target) = {tv:.3f}"


def test_sampled_distribution_differs_from_draft():
    """The negative control: the histogram tracks the TARGET, not the
    draft, on models whose distributions differ (the draws of
    test_sampled_matches_target_distribution[False], shared)."""
    tt, dt, ids, hist = _dist_draws(False)
    t_exact = _exact_row(tt, _t(ST_TJ), ids)
    d_exact = _exact_row(dt, _t(ST_DJ), ids)
    tv_models = 0.5 * np.abs(t_exact - d_exact).sum()
    assert tv_models > 0.2, "fixture degenerate: the models agree"
    assert 0.5 * np.abs(hist - d_exact).sum() > 0.5 * tv_models


def test_rejects_bad_shapes():
    (_, tt), (_, dt) = _gpt(T_J, 0), _gpt(D_J, 1)
    spec = make_speculative_generate(_t(T_J), _t(D_J), max_new_tokens=4,
                                     k=4, device="cpu")
    with pytest.raises(ValueError):  # batch != 1
        spec(tt, dt, np.zeros((2, 8), np.int32))
    with pytest.raises(ValueError):  # prompt < k + 2
        spec(tt, dt, np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError, match="block_size"):
        make_speculative_generate(_t(T_J), _t(D_J), max_new_tokens=60, k=4,
                                  device="cpu")(tt, dt, np.zeros((1, 8),
                                                                 np.int32))
    with pytest.raises(ValueError, match="vocab"):
        make_speculative_generate(_t(T_J), tgpt.GPTConfig(vocab_size=128),
                                  max_new_tokens=4, device="cpu")
