"""The port's training path on the CPU against the JAX package, on the
same gpt2-test weights (carried across by convert.from_jax_params and
back by convert.to_jax_params) and the same numpy token batches.

Tolerances: logits atol 1e-4 (test_torch_gpt.py's: two frameworks' f32
matmuls summed in other orders over 4 layers); losses rtol 1e-5;
gradients atol 1e-5 + rtol 1e-3 per leaf (the same f32 sums, through
the backward); sgd steps atol 1e-6 on the weights (lr 0.1 times a
gradient agreeing to ~1e-6); adamw steps atol 2e-5 per step taken: one
adam update is lr * m / (sqrt(v) + eps), of size ~lr for any gradient
well above eps, so a gradient that differs by rounding can move its
element by up to lr * 1e-2 where |g| is near eps — the bound covers 3
steps at lr 1e-3 with room."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnn_tpu import train as jtrain
from dnn_tpu.data.tokens import TokenDataset as JTokenDataset
from dnn_tpu.data.tokens import write_tokens as jwrite_tokens
from dnn_tpu.models import gpt as jgpt
from dnn_tpu_torch import optim as topt
from dnn_tpu_torch import train as ttrain
from dnn_tpu_torch.convert import from_jax_params, to_jax_params
from dnn_tpu_torch.data.tokens import TokenDataset, write_tokens
from dnn_tpu_torch.io import train_ckpt as tckpt
from dnn_tpu_torch.models import gpt as tgpt

from test_torch_llama import one_torch_thread  # noqa: F401,E402 — autouse:
# one intra-op thread; the suite's parallel workers oversubscribe the cores

CFG_J = jgpt.PRESETS["gpt2-test"]
CFG_T = tgpt.PRESETS["gpt2-test"]
LOGIT_ATOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3


@pytest.fixture(scope="module")
def tree():
    """The JAX init as a numpy tree (both packages start from it)."""
    return jax.tree.map(np.asarray, jgpt.init(jax.random.PRNGKey(0), CFG_J))


def _tokens(seed, b=4, t=17):
    return np.random.default_rng(seed).integers(
        0, CFG_T.vocab_size, (b, t)).astype(np.int32)


def _prepared(tree):
    return from_jax_params(tree, CFG_T, "cpu")


def _assert_trees_close(got, want, atol, rtol=0.0):
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, a), (_, b) in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                                   rtol=rtol, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("use_flash,remat", [(False, False), (True, False),
                                             (True, True), ("auto", False)])
def test_logits_match_jax_make_apply(tree, use_flash, remat):
    ids = _tokens(1, b=2, t=16)
    want = np.asarray(jgpt.make_apply(CFG_J)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(ids)))
    stacked = tgpt.make_apply_stacked(CFG_T, use_flash=use_flash, remat=remat)
    per_layer = tgpt.make_apply(CFG_T, use_flash=use_flash, remat=remat)
    tids = torch.from_numpy(ids)
    for got in (stacked(_prepared(tree), tids),
                per_layer(tgpt.tensors(tree, "cpu"), tids)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   atol=LOGIT_ATOL, rtol=0)


def test_bf16_compute_follows_jax(tree):
    """compute_dtype=bf16: f32 logits that differ from the f32 forward
    (bf16 engaged) and stay near JAX's bf16 forward."""
    ids = _tokens(2, b=2, t=16)
    jparams = jax.tree.map(jnp.asarray, tree)
    want = np.asarray(jgpt.make_apply(CFG_J, compute_dtype=jnp.bfloat16)(
        jparams, jnp.asarray(ids)))
    got = tgpt.make_apply_stacked(CFG_T, use_flash=True,
                                  compute_dtype=torch.bfloat16)(
        _prepared(tree), torch.from_numpy(ids))
    f32 = tgpt.make_apply_stacked(CFG_T)(_prepared(tree), torch.from_numpy(ids))
    assert got.dtype == torch.float32
    assert 0 < (got - f32).abs().max().item() < 0.15
    # bf16 rounds at other places in the two frameworks (gelu, softmax
    # probabilities): the two bf16 forwards agree to bf16 precision
    np.testing.assert_allclose(got.numpy(), want, atol=0.05, rtol=0)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    targets[0, 1] = targets[1, 4] = -1
    for ignore in (None, -1, int(targets[0, 0])):
        tgt = targets if ignore == -1 else np.abs(targets)
        want = float(jtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(tgt),
                                          ignore_index=ignore))
        got = ttrain.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(tgt), ignore_index=ignore)
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_distill_loss_matches_jax(tree):
    tokens = _tokens(9, b=2, t=9)
    teacher = np.random.default_rng(9).standard_normal(
        (2, 8, CFG_T.vocab_size)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    for ignore in (None, int(tokens[0, 3])):
        want = jtrain.distill_loss(jgpt.make_apply(CFG_J), jnp.asarray(teacher),
                                   jparams, jnp.asarray(tokens),
                                   temperature=1.5, alpha=0.3,
                                   ignore_index=ignore)
        got = ttrain.distill_loss(tgpt.make_apply(CFG_T),
                                  torch.from_numpy(teacher),
                                  tgpt.tensors(tree, "cpu"),
                                  torch.from_numpy(tokens), temperature=1.5,
                                  alpha=0.3, ignore_index=ignore)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    with pytest.raises(ValueError, match="alpha"):
        ttrain.distill_loss(None, None, None, tokens, alpha=2.0)


def test_next_token_loss_evaluate_and_grads_match_jax(tree):
    tokens = _tokens(4)
    jprep = jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), CFG_J)
    japply = jgpt.make_apply_stacked(CFG_J)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtrain.next_token_loss(japply, p, jnp.asarray(tokens)))(jprep)
    prep = _prepared(tree)
    topt.sgd(0.1).init(prep)  # sets requires_grad on every leaf
    tapply = tgpt.make_apply_stacked(CFG_T, use_flash=True)
    loss = ttrain.next_token_loss(tapply, prep, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = {k: tgpt._map(lambda t: t.grad, v) for k, v in prep.items()}
    jg = {k: jax.tree.map(np.asarray, v) for k, v in jgrads.items()}
    _assert_trees_close(
        tgpt._map(lambda t: t.numpy(), grads), jg, GRAD_ATOL, GRAD_RTOL)
    # lm_head is its own leaf, not tied to wte: both get a gradient
    assert np.abs(jg["wte"]["embedding"]).max() > 0
    assert np.abs(jg["lm_head"]["kernel"]).max() > 0
    # evaluate: token-weighted mean over two batches of other sizes
    batches = [_tokens(5, b=2, t=9), _tokens(6, b=3, t=13)]
    want = jtrain.evaluate(japply, jprep, iter(batches))
    got = ttrain.evaluate(tapply, prep, iter(batches), device="cpu")
    assert (got["batches"], got["tokens"]) == (want["batches"], want["tokens"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"],
                               rtol=1e-5)


def _jax_steps(tree, opt, batches):
    jprep = jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), CFG_J)
    japply = jgpt.make_apply_stacked(CFG_J)
    step = jtrain.make_train_step(
        lambda p, b: jtrain.next_token_loss(japply, p, b), opt)
    state = opt.init(jprep)
    losses = []
    for b in batches:
        jprep, state, loss = step(jprep, state, jnp.asarray(b))
        losses.append(float(loss))
    return jprep, losses


def _torch_steps(tree, opt, batches, accum_steps=1):
    prep = _prepared(tree)
    state = opt.init(prep)
    apply = tgpt.make_apply_stacked(CFG_T, use_flash=True)
    step = ttrain.make_train_step(
        lambda p, b: ttrain.next_token_loss(apply, p, b), opt,
        accum_steps=accum_steps, device="cpu")
    losses = []
    for b in batches:
        prep, state, loss = step(prep, state, b)
        losses.append(loss.item())
    return prep, losses


def _unstacked(jprep):
    """JAX's stacked tree -> the per-layer layout to_jax_params gives."""
    out = {k: jax.tree.map(np.asarray, v) for k, v in jprep.items()
           if k != "blocks"}
    for i in range(CFG_J.n_layer):
        out[f"h_{i}"] = jax.tree.map(lambda a: np.asarray(a[i]),
                                     jprep["blocks"])
    return out


@pytest.mark.parametrize("name,jopt,topt_,atol", [
    ("sgd", optax.sgd(0.1), topt.sgd(0.1), 1e-6),
    ("adamw", optax.adamw(1e-3), topt.adamw(1e-3), 3 * 2e-5),
])
def test_train_steps_match_jax(tree, name, jopt, topt_, atol):
    batches = [_tokens(10)] * 3  # one batch, so the loss must fall
    jprep, jlosses = _jax_steps(tree, jopt, batches)
    prep, losses = _torch_steps(tree, topt_, batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _assert_trees_close(to_jax_params(prep, CFG_T), _unstacked(jprep), atol)
    assert losses[-1] < losses[0]


def test_accum_steps_equal_full_batch_under_sgd(tree):
    batches = [_tokens(20)]
    full, lf = _torch_steps(tree, topt.sgd(0.1), batches)
    acc, la = _torch_steps(tree, topt.sgd(0.1), batches, accum_steps=2)
    np.testing.assert_allclose(la, lf, rtol=1e-6)
    _assert_trees_close(to_jax_params(acc, CFG_T), to_jax_params(full, CFG_T),
                        1e-7)
    with pytest.raises(ValueError, match="accum_steps"):
        _torch_steps(tree, topt.sgd(0.1), [_tokens(20, b=3)], accum_steps=2)


def test_adamw_defaults_are_optax_defaults():
    hyper = topt.adamw(1e-3).hyper
    assert hyper == {"lr": 1e-3, "betas": (0.9, 0.999), "eps": 1e-8,
                     "weight_decay": 1e-4}
    # an element with a zero gradient moves by the decay alone
    p = torch.ones(3)
    state = topt.adamw(0.5).init({"p": p})
    p.grad = torch.tensor([0.0, 1.0, -1.0])
    state.step()
    np.testing.assert_allclose(p.detach().numpy()[0], 1.0 - 0.5 * 1e-4,
                               rtol=1e-7)


def test_token_dataset_windows_match_jax(tmp_path):
    toks = np.random.default_rng(7).integers(0, 50257, 5000)
    write_tokens(str(tmp_path / "t.bin"), toks)
    jwrite_tokens(str(tmp_path / "j.bin"), toks)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    mine = TokenDataset(str(tmp_path / "t.bin")).batches(4, 32, seed=3)
    theirs = JTokenDataset(str(tmp_path / "j.bin")).batches(4, 32, seed=3)
    for _ in range(3):
        a, b = next(mine), next(theirs)
        assert a.dtype == np.int32 and a.shape == (4, 33)
        np.testing.assert_array_equal(a, b)


def _train_state(tree, opt):
    prep = _prepared(tree)
    return prep, opt.init(prep)


def _fit_fn(opt):
    apply = tgpt.make_apply_stacked(CFG_T, use_flash=True)
    step = ttrain.make_train_step(
        lambda p, b: ttrain.next_token_loss(apply, p, b), opt, device="cpu")

    def fn(state, batch):
        params, opt_state, loss = step(*state, batch)
        return (params, opt_state), loss

    return fn


def test_checkpoint_roundtrip_and_layout(tmp_path, tree):
    opt = topt.adamw(1e-3)
    state = _train_state(tree, opt)
    fn = _fit_fn(opt)
    state, _ = fn(state, _tokens(30))
    bf = {"x": torch.randn(5).bfloat16()}
    path = tckpt.save_train_state(str(tmp_path), 7, (*state, bf))
    assert path.endswith("step_00000007.npz")
    assert (tmp_path / "step_00000007.npz.manifest.json").exists()
    fresh = _train_state(tree, opt)
    fresh_bf = {"x": torch.zeros(5, dtype=torch.bfloat16)}
    (params, opt_state, got_bf), step = tckpt.restore_train_state(
        str(tmp_path), (*fresh, fresh_bf))
    assert step == 7 and torch.equal(got_bf["x"], bf["x"])
    for a, b in zip(topt.tree_leaves(params), topt.tree_leaves(state[0])):
        assert torch.equal(a, b)
    sa, sb = opt_state.state_dict()["state"], state[1].state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for name in sa[i]:
            assert torch.equal(sa[i][name], sb[i][name])
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore_train_state(str(tmp_path),
                                  (*fresh, {"x": torch.zeros(4)}))
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.restore_train_state(str(tmp_path),
                                  (*fresh, {"y": torch.zeros(5)}))
    with pytest.raises(NotImplementedError, match="compress_bf16"):
        tckpt.save_train_state(str(tmp_path), 8, state, compress_bf16=True)
    tckpt.save_train_state(str(tmp_path), 9, (*state, bf))
    tckpt.save_train_state(str(tmp_path), 10, (*state, bf))
    assert tckpt.cleanup_old_checkpoints(str(tmp_path), keep=2) == 2
    assert tckpt.latest_checkpoint(str(tmp_path))[1] == 10


def test_fit_resume_matches_uninterrupted(tmp_path, tree):
    """fit 4 steps == fit 2 steps with a checkpoint, resume_or_init into
    a fresh state, fit 2 more (the deterministic batch iterator restarts
    from scratch and advance_batches skips the first two)."""
    toks = np.random.default_rng(8).integers(0, CFG_T.vocab_size, 4000)
    write_tokens(str(tmp_path / "t.bin"), toks)
    ds = TokenDataset(str(tmp_path / "t.bin"))
    opt = topt.adamw(1e-3)
    fn = _fit_fn(opt)
    seen, evals = [], []
    whole, last = ttrain.fit(fn, _train_state(tree, opt), ds.batches(4, 16),
                             num_steps=4, on_step=lambda s, l: seen.append(s),
                             eval_every=2,
                             eval_fn=lambda s, st: evals.append(s))
    assert seen == [1, 2, 3, 4] and evals == [2, 4] and torch.isfinite(last)
    ck = str(tmp_path / "ck")
    ttrain.fit(fn, _train_state(tree, opt), ds.batches(4, 16), num_steps=2,
               ckpt_dir=ck, ckpt_every=2)
    state, start = ttrain.resume_or_init(ck, _train_state(tree, opt))
    assert start == 2
    resumed, _ = ttrain.fit(fn, state, ds.batches(4, 16), num_steps=4,
                            start_step=start)
    for a, b in zip(topt.tree_leaves(resumed[0]), topt.tree_leaves(whole[0])):
        assert torch.equal(a, b)
    fresh, start = ttrain.resume_or_init(str(tmp_path / "none"),
                                         _train_state(tree, opt))
    assert start == 0


def test_fit_and_step_refuse_unported_hooks(tree):
    opt = topt.sgd(0.1)
    for kw in ({"clock": object()}, {"sentinel": object()}):
        with pytest.raises(NotImplementedError, match="items 11/12"):
            ttrain.fit(_fit_fn(opt), _train_state(tree, opt),
                       iter([_tokens(0)]), num_steps=1, **kw)
    with pytest.raises(NotImplementedError, match="items 11/12"):
        ttrain.make_train_step(lambda p, b: 0, opt, grad_stats=True,
                               device="cpu")
