"""Sliding windows, logit softcapping and head dim 256 served by the
port, on the CPU, against the JAX package on the same weights (the
models, codecs and kernels' plain versions are in test_torch_window.py;
this file is split from it so that the two run on separate test
workers): the dense and paged batchers' streams with the paged
allocator's free count after every step equal to JAX's (the reclaimed
blocks), the refusals with JAX's messages, the entry points' default
device, beam search and the embeddings on gemma2-test, the pipeline
stages, from_jax_params both ways, a head-dim-256 config on the paged
pool and the solo speculative decoder on a windowed pair (HF Mistral and
Gemma-2 checkpoints are among test_torch_llama.py's HF families).

Weights and tolerances as test_torch_window.py's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.models import gpt as jgpt
from dnn_tpu.models import llama as jllama
from dnn_tpu.runtime.serving import ContinuousBatcher as JaxBatcher
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import llama as tllama
from dnn_tpu_torch.runtime.generate import make_generate
from dnn_tpu_torch.runtime.serving import ContinuousBatcher

from test_torch_llama import one_torch_thread  # noqa: F401 (autouse)
from test_torch_window import ATOL, NAMES, _ids, models  # noqa: F401


def _batch_script(b, cfg, free, constraint=None):
    """Requests of 5 / 20 / 30 tokens with 24 / 20 / 14 new ones (every
    stream crosses the window), the third admitted mid-decode, the second
    under `constraint` where one is given. Returns (the streams, the
    allocator's free count (or None) after each submit and step, every
    step()'s return and the final flush_overlap()'s)."""
    prompts = [np.random.default_rng(s).integers(0, cfg.vocab_size, n)
               for s, n in ((0, 5), (1, 20), (2, 30))]
    counts, steps = [], []
    r0 = b.submit(prompts[0], 24)
    r1 = b.submit(prompts[1], 20, **({} if constraint is None
                                     else {"constraint": constraint}))
    counts.append(free(b))
    for _ in range(4):
        steps.append(b.step())
        counts.append(free(b))
    r2 = b.submit(prompts[2], 14)
    counts.append(free(b))
    while b.n_active:
        steps.append(b.step())
        counts.append(free(b))
    steps.append(b.flush_overlap())
    counts.append(free(b))
    return [np.asarray(b.results[r]) for r in (r0, r1, r2)], counts, steps


@pytest.mark.parametrize("name,kv", [("mistral-test", "paged"),
                                     ("mistral-test", "dense"),
                                     ("gemma2-test", "auto")])
def test_batcher_streams_and_reclaimed_blocks_match_jax(models, name, kv):
    """The port's batcher against JAX's on the same script: identical
    streams; on mistral-test's paged pool the allocator's free count after
    every submit and step equal to JAX's (blocks the band left behind
    reclaimed at install and after each token); gemma2-test with
    kv="auto" falls back to the dense pool as JAX's does."""
    cfg, jcfg, _, jprep, tprep = models[name]
    pool = dict(slots=3, max_len=64, prompt_pad=16, block_len=8)
    jb = JaxBatcher(jcfg, jprep, family=jllama.LlamaFamilyRows(jcfg), kv=kv,
                    **pool)
    tb = ContinuousBatcher(cfg, tprep, kv=kv, device="cpu", **pool)
    assert tb.paged == jb._paged == (kv == "paged")
    want, jfree, jsteps = _batch_script(
        jb, cfg, lambda b: b._allocator.n_free if b._paged else None)
    got, tfree, tsteps = _batch_script(
        tb, cfg, lambda b: b.allocator.n_free if b.paged else None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tfree == jfree and tsteps == jsteps
    if kv == "paged":
        assert min(tfree) > 0 and tfree[-1] == tb.allocator.n_blocks - 1


def test_windowed_paged_pool_mixed_overlap_constrained_match_jax(models):
    """mistral-test's windowed paged pool through the mixed step
    (prefill_chunk_tokens 8: prompts admitted in chunks beside the decode
    rows) with the overlap pipe on and one request under a grammar
    ([0-9]+ over the byte vocabulary): every step()'s return, the streams
    and the allocator's free count after every submit and step equal the
    JAX batcher's (the band's blocks reclaimed after each committed token
    on these paths too)."""
    from dnn_tpu.runtime import constrain as jcon
    from dnn_tpu_torch.runtime.constrain import TokenConstraint, byte_vocab

    cfg, jcfg, _, jprep, tprep = models["mistral-test"]
    pool = dict(slots=3, max_len=64, prompt_pad=16, block_len=8, kv="paged",
                prefill_chunk_tokens=8, overlap=True, allow_constraints=True,
                constraint_rows=16)
    jb = JaxBatcher(jcfg, jprep, family=jllama.LlamaFamilyRows(jcfg), **pool)
    tb = ContinuousBatcher(cfg, tprep, device="cpu", **pool)
    want, jfree, jsteps = _batch_script(
        jb, cfg, lambda b: b._allocator.n_free,
        jcon.TokenConstraint.from_regex(r"[0-9]+", jcon.byte_vocab(256)))
    got, tfree, tsteps = _batch_script(
        tb, cfg, lambda b: b.allocator.n_free,
        TokenConstraint.from_regex(r"[0-9]+", byte_vocab(256)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert all(48 <= t <= 57 for t in got[1])  # the grammar held
    assert tsteps == jsteps and tfree == jfree
    assert min(tfree) > 0 and tfree[-1] == tb.allocator.n_blocks - 1
    assert tb.prefill_chunks_run == sum(-(-n // 8) for n in (5, 20, 30))


def test_refusals_raise_jax_messages(models):
    """A softcapped / alternating family on a paged pool, a windowed paged
    pool with a prefix cache, and a windowed or softcapped speculative
    pair raise JAX's ValueErrors; kv="auto" falls back to dense where the
    paged pool is refused."""
    from dnn_tpu_torch.models import gpt as tgpt
    from dnn_tpu_torch.runtime.serving_spec import SpeculativeBatcher

    pool = dict(slots=2, max_len=32, prompt_pad=8, block_len=8,
                device="cpu")
    g2, m = models["gemma2-test"], models["mistral-test"]
    with pytest.raises(ValueError, match="softcapped / alternating-window "
                       "families have no paged channel"):
        ContinuousBatcher(g2[0], g2[4], kv="paged", **pool)
    with pytest.raises(ValueError, match="are not supported with the paged "
                       "pool"):
        ContinuousBatcher(g2[0], g2[4], kv=None, paged_blocks=9, **pool)
    with pytest.raises(ValueError, match="do not compose with the prefix"):
        ContinuousBatcher(m[0], m[4], kv="paged", prefix_cache=4, **pool)
    with pytest.raises(ValueError, match="rolled-out blocks are reclaimed"):
        ContinuousBatcher(m[0], m[4], kv=None, paged_blocks=9,
                          prefix_cache=4, **pool)
    assert not ContinuousBatcher(m[0], m[4], prefix_cache=4, **pool).paged
    for cfg, prep in ((m[0], m[4]), (g2[0], g2[4])):
        with pytest.raises(ValueError, match="dense-attention families"):
            SpeculativeBatcher(cfg, prep, cfg, prep, spec_k=2,
                               draft_family=tllama.LlamaFamilyRows(cfg),
                               **{k: v for k, v in pool.items()
                                  if k != "block_len"})
    gcfg = tgpt.PRESETS["gpt2-test"]
    with pytest.raises(ValueError, match="sliding window / softcap"):
        tllama.LlamaFamilyRows(m[0]).verify_rows(None, None, None, None,
                                                 None, None)
    assert gcfg.vocab_size  # the GPT family carries no paged_ok: dense


def test_entry_points_default_to_the_card():
    """Without device= the new paths run on the card and raise where there
    is none: the batcher and make_generate on a windowed preset, and the
    kernel wrappers never fall back (a CPU tensor runs the plain
    version only because it lies on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    cfg = tllama.PRESETS["mistral-test"]
    prep = from_jax_params(tllama.init(0, cfg), cfg, "cpu")
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        ContinuousBatcher(cfg, prep, max_len=32, prompt_pad=8)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        make_generate(cfg, max_new_tokens=4)
    g2 = tllama.PRESETS["gemma2-test"]
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        make_generate(g2, max_new_tokens=4)


@pytest.mark.parametrize("pooling", ["mean", "none"])
def test_beam_and_embed_on_gemma2_match_jax(models, pooling):
    """make_beam_generate (K=3, return_all) and make_embed on gemma2-test
    against JAX's: beams identical, scores and embeddings within 1e-5
    (Gemma-2's per-layer windows and softcaps ride both)."""
    from dnn_tpu.runtime.beam import make_beam_generate as jbeam
    from dnn_tpu.runtime.embeddings import make_embed as jembed
    from dnn_tpu_torch.runtime.beam import make_beam_generate
    from dnn_tpu_torch.runtime.embeddings import make_embed

    cfg, jcfg, _, jprep, tprep = models["gemma2-test"]
    ids = _ids(cfg, 2, 20, seed=9)
    lengths = np.asarray([12, 20])
    want = np.asarray(jembed(jcfg, pooling=pooling)(
        jprep, jnp.asarray(ids), jnp.asarray(lengths)))
    got = make_embed(cfg, pooling=pooling)(tprep, ids, lengths).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    if pooling == "mean":
        kw = dict(max_new_tokens=6, beam_size=3, return_all=True)
        jt, js = jbeam(jcfg, **kw)(jprep, jnp.asarray(ids))
        tt, ts = make_beam_generate(cfg, device="cpu", **kw)(tprep, ids)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)


@pytest.mark.parametrize("name,parts", [("gemma2-test", 3),
                                        ("mistral-test", 2)])
def test_pipeline_stages_match_jax(models, name, parts):
    """The registry's llama stages of a windowed / softcapped preset
    (make_partition, each layer's own window) compose to JAX's stages'
    output within 1e-5 of the logits' scale, on ids past the window."""
    from dnn_tpu_torch.registry import get_model

    cfg, jcfg, tree, _, _ = models[name]
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    ids = _ids(cfg, 1, 30, seed=10)
    x = torch.from_numpy(ids)
    for st in get_model(name).extras["make_partition"]()(parts):
        x = st.apply(st.slice_params(params), x)
    jx = jnp.asarray(ids)
    jtree = jax.tree.map(jnp.asarray, tree)
    for st in jllama.make_partition(jcfg)(parts):
        jx = st.apply(st.slice_params(jtree), jx)
    want = np.asarray(jx)
    np.testing.assert_allclose(x.numpy(), want,
                               atol=ATOL * max(1.0, np.abs(want).max()))


def test_from_jax_params_carries_gemma2_and_mistral(models):
    """from_jax_params carries gemma2-test's post norms and tied head and
    mistral-test's untied one: the port's tree back out (to_jax_params)
    equals the JAX tree leaf for leaf."""
    from dnn_tpu_torch.convert import to_jax_params

    for name in NAMES:
        cfg, _, tree, _, tprep = models[name]
        back = to_jax_params(tprep, cfg)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(g, w)
    assert "post_ln_2" in models["gemma2-test"][2]["h_0"]


def test_head_dim_256_config_decodes_on_the_cpu(models):
    """gemma-test at head dim 256 (its preset widened: n_embd 64, 2 heads
    of 256 over one KV head): the batcher's paged pool and make_generate
    equal JAX's make_generate (JAX's dense pool: its paged pool sizes
    heads by n_embd / n_head)."""
    jcfg = dataclasses.replace(jllama.PRESETS["gemma-test"], n_head=2,
                               head_dim_override=256)
    cfg = dataclasses.replace(tllama.PRESETS["gemma-test"], n_head=2,
                              head_dim_override=256)
    tree = jax.tree.map(np.asarray, jllama.init(jax.random.PRNGKey(4), jcfg))
    tree = jax.tree.map(lambda a: a * (6.0 if a.ndim >= 2 else 1.0), tree)
    jprep = jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), jcfg)
    tprep = from_jax_params(tree, cfg, "cpu")
    ids = _ids(cfg, 1, 9, seed=11)
    want = np.asarray(jllama.make_generate(jcfg, max_new_tokens=8,
                                           attn_kernel=False)(
        jprep, jnp.asarray(ids), jax.random.PRNGKey(0)))
    got = make_generate(cfg, max_new_tokens=8, device="cpu")(tprep, ids)
    np.testing.assert_array_equal(got.numpy(), want)
    b = ContinuousBatcher(cfg, tprep, kv="paged", slots=2, max_len=32,
                          prompt_pad=8, block_len=8, device="cpu")
    rid = b.submit(ids[0], 8)
    np.testing.assert_array_equal(b.drain()[rid], want[0])


def test_solo_speculative_decoder_runs_windowed_pairs(models):
    """The solo speculative decoder, as JAX's (whose make_speculative_
    generate takes any LLaMA-family pair; only the speculative batcher
    refuses windowed or softcapped families), verifies with the band:
    mistral-test drafting itself emits make_generate's greedy stream
    across the window (which equals JAX's, test above)."""
    from dnn_tpu_torch.runtime.speculative import make_speculative_generate

    cfg, _, _, _, tprep = models["mistral-test"]
    ids = _ids(cfg, 1, 12, seed=8)
    want = make_generate(cfg, max_new_tokens=20, device="cpu")(tprep, ids)
    got = make_speculative_generate(cfg, cfg, max_new_tokens=20, k=3,
                                    device="cpu")(tprep, tprep, ids)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
