"""The port's speculative batcher (runtime/serving_spec.py), its verify
block (kvcache write_rows over T rows, attend_rows_causal, the families'
verify_rows) and the daemon's speculative path, on the CPU; mirrors
tests/test_serving_spec.py and tests/test_spec_buckets.py against the
JAX package on the same weights and the same submit/step script.

  * the verify block: T-row writes at per-slot bases (the start clamped,
    inactive slots untouched) bit-equal to JAX's _rows_write, the causal
    rows' attention and both families' verify logits within 1e-5 of
    JAX's;
  * greedy streams identical to JAX's SpeculativeBatcher and to the
    port's plain batcher: GPT, LLaMA, a GPT draft for a LLaMA target, a
    noisy self-draft that accepts part of its proposals, through bucket
    rungs (the draft pool growing in lockstep), with interleaved prefill
    and overlap; in bf16 compute equal to the plain bf16 batcher and to
    JAX's up to its top-2 gap (TIE, test_torch_bf16_serving), with the
    plain versions rounding the probabilities as JAX does;
  * the budget, a stop mid-chunk, a self-draft accepting everything,
    sampled streams deterministic per seed and draw-for-draw the same
    bucketed and interleaved;
  * the restrictions, as JAX's; the captured-step bookkeeping with a
    stand-in capture; the daemon over gRPC and `node --serve_lm
    --draft_model` as a process.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.models import gpt as jgpt
from dnn_tpu.models import llama as jllama
from dnn_tpu.runtime import kvcache as jkv
from dnn_tpu.runtime.serving import ContinuousBatcher as JaxBatcher
from dnn_tpu.runtime.serving import GPTFamilyRows as JaxGPTRows
from dnn_tpu.runtime.serving_spec import SpeculativeBatcher as JaxSpec
from dnn_tpu_torch.comm.client import NodeClient
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.models import llama as tllama
from dnn_tpu_torch.ops.cuda import cached_attention as tca
from dnn_tpu_torch.runtime import kvcache as tkv
from dnn_tpu_torch.runtime.serving import (
    CapturedDecode,
    ContinuousBatcher,
    GPTFamilyRows,
)
from dnn_tpu_torch.runtime.serving_spec import SpeculativeBatcher

from test_torch_bf16_serving import _gap_fn, assert_streams_match
from test_torch_llama import (  # one_torch_thread: the autouse fixture
    drawn_tree,
    jax_prepared,
    one_torch_thread,  # noqa: F401
    round_probs_like_jax,
)
from test_torch_lm_server import _free_port

T_J = jgpt.GPTConfig(block_size=128, vocab_size=128, n_layer=3, n_head=4,
                     n_embd=64)
D_J = jgpt.GPTConfig(block_size=128, vocab_size=128, n_layer=1, n_head=2,
                     n_embd=32)
BF16 = torch.bfloat16
BF16_SPEC_TIE = 0.2  # see test_bf16_parts_only_at_stated_gap


def _t(cfg):
    return tgpt.GPTConfig(**dataclasses.asdict(cfg))


def _tree(cfg, seed, scale=15.0):
    return jax.tree.map(
        lambda a: np.asarray(a) * np.float32(scale if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(seed), cfg))


def _both(cfg, tree):
    return (jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), cfg),
            from_jax_params(tree, _t(cfg), "cpu"))


@pytest.fixture(scope="module")
def models():
    """(JAX target, port target, JAX draft, port draft, JAX noisy
    self-draft, port noisy self-draft): the JAX init x15 (decisive
    greedy argmaxes), and the target with noise on every matrix, a draft
    that agrees with it often but not always."""
    t_tree, d_tree = _tree(T_J, 0), _tree(D_J, 1)
    rng = np.random.default_rng(5)
    noisy = jax.tree.map(
        lambda a: a + (0.25 * np.abs(a).mean() * rng.standard_normal(
            a.shape)).astype(np.float32) if a.ndim >= 2 else a, t_tree)
    return (*_both(T_J, t_tree), *_both(D_J, d_tree), *_both(T_J, noisy))


def _one(srv, *args, **kw):
    """One request through `srv` to its end: its tokens."""
    rid = srv.submit(*args, **kw)
    return srv.drain()[rid]


def _prompt(seed, n, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, n)


# ----------------------------------------------------------------------
# the verify block
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_write_rows_over_t_rows_matches_jax(dtype):
    """write_rows of (B, H, T, D) at per-slot bases: JAX's _rows_write bit
    for bit (its start clamps to S - T; a gated-off row rewrites what it
    holds), and the T = 1 decode write unchanged."""
    cfg_t, cfg_j = _t(T_J), T_J
    rng = np.random.default_rng(0)
    b, s = 3, 16
    tc = tkv.Int8KV().init(cfg_t, b, s, "cpu") if dtype == "int8" else \
        tkv.FloatKV().init(cfg_t, b, s, "cpu")
    jc = (jkv.Int8KV().init(cfg_j, b, s) if dtype == "int8"
          else jkv.FloatKV().init(cfg_j, b, s))
    tcodec = tkv.codec_for_cache(tc)
    jcodec = jkv.codec_for_cache(jc)
    for t, pos, act in ((5, [0, 9, 14], [True, True, False]),
                        (5, [13, 3, 15], [True, False, True]),
                        (1, [2, 15, 7], [True, True, False])):
        k = rng.standard_normal((b, 4, t, 16)).astype(np.float32)
        v = rng.standard_normal((b, 4, t, 16)).astype(np.float32)
        lt = {n: leaf[0] for n, leaf in tc.items()}
        tcodec.write_rows(lt, torch.from_numpy(k), torch.from_numpy(v),
                          torch.tensor(pos, dtype=torch.int32),
                          torch.tensor(act))
        lj = jcodec.write_rows({n: leaf[0] for n, leaf in jc.items()},
                               jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos, jnp.int32),
                               jnp.asarray(act))
        jc = {n: jc[n].at[0].set(lj[n]) for n in jc}
        for n in tc:
            np.testing.assert_array_equal(tc[n][0].numpy(),
                                          np.asarray(jc[n][0]))


def test_attend_rows_causal_matches_jax():
    """Row t of slot b attends columns <= pos[b] + t (K5's contract; on
    the CPU its plain version), bases near and past the cache's end
    included, grouped heads included; within 1e-5 of JAX's
    attend_rows_causal."""
    rng = np.random.default_rng(1)
    b, s, t, d = 3, 24, 5, 16
    for h, hk in ((4, 4), (8, 2)):
        q = rng.standard_normal((b, h, t, d)).astype(np.float32)
        c = {n: rng.standard_normal((b, hk, s, d)).astype(np.float32)
             for n in ("k", "v")}
        pos = np.array([0, 17, 22], np.int32)
        got = tkv.FloatKV().attend_rows_causal(
            torch.from_numpy(q), {n: torch.from_numpy(a) for n, a in
                                  c.items()}, torch.from_numpy(pos))
        # JAX's codec takes one cache head per query head: repeat the KV
        # heads for the grouped case
        jc = {n: jnp.asarray(np.repeat(a, h // hk, axis=1))
              for n, a in c.items()}
        want = jkv.FloatKV().attend_rows_causal(jnp.asarray(q), jc,
                                                jnp.asarray(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _verify_case(name):
    if name == "gpt2-test":
        cfg_j, tree = jgpt.PRESETS["gpt2-test"], _tree(
            jgpt.PRESETS["gpt2-test"], 2, 1.0)
        jprep, tprep = _both(cfg_j, tree)
        return (tgpt.PRESETS["gpt2-test"], cfg_j, tprep, jprep,
                GPTFamilyRows(tgpt.PRESETS["gpt2-test"]), JaxGPTRows(cfg_j))
    tree = drawn_tree(name, 3, 0.05)
    cfg_t, cfg_j = tllama.PRESETS[name], jllama.PRESETS[name]
    return (cfg_t, cfg_j, from_jax_params(tree, cfg_t, "cpu"),
            jax_prepared(name, tree), tllama.LlamaFamilyRows(cfg_t),
            jllama.LlamaFamilyRows(cfg_j))


@pytest.mark.parametrize("name", ["gpt2-test", "llama-test", "qwen2-test"])
def test_verify_rows_logits_match_jax(name):
    """Each family's verify_rows over a dense f32 cache prefilled by the
    same forward: three slots at their own bases (one inactive, its base
    near the end), a (3, 5) block; logits within 1e-5 of JAX's (scaled
    by the largest |logit|), the cache rows written equal, the inactive
    slot's rows untouched."""
    cfg_t, cfg_j, tprep, jprep, tfam, jfam = _verify_case(name)
    ids = np.random.default_rng(4).integers(0, cfg_t.vocab_size, (3, 12))
    tc = tfam.init_cache(3, 32, torch.float32, "cpu")
    jc = jfam.init_cache(3, 32, jnp.float32)
    for i in range(3):
        row_t = {n: leaf[:, i:i + 1] for n, leaf in tc.items()}
        tfam.prefill(tprep, torch.from_numpy(ids[i:i + 1]), row_t, 0)
        _, row_j = jfam.prefill(jprep, jnp.asarray(ids[i:i + 1]),
                                {n: leaf[:, i:i + 1] for n, leaf in
                                 jc.items()}, 0)
        jc = {n: jc[n].at[:, i:i + 1].set(row_j[n]) for n in jc}
    chunk = np.random.default_rng(5).integers(0, cfg_t.vocab_size, (3, 5))
    pos = np.array([12, 7, 30], np.int32)
    act = np.array([True, True, False])
    before = {n: leaf[:, 2].clone() for n, leaf in tc.items()}
    got = tfam.verify_rows(tprep, tc, torch.from_numpy(chunk),
                           torch.from_numpy(pos), torch.from_numpy(act),
                           tkv.codec_for_cache(tc))
    want, jc = jfam.verify_rows(jprep, jc, jnp.asarray(chunk),
                                jnp.asarray(pos), jnp.asarray(act),
                                jkv.codec_for_cache(jc))
    assert got.shape == (3, 5, cfg_t.vocab_size)
    want = np.asarray(want)
    np.testing.assert_allclose(got[:2].numpy(), want[:2],
                               atol=1e-5 * np.abs(want[:2]).max())
    for n in tc:
        np.testing.assert_allclose(tc[n][:, :2].numpy(),
                                   np.asarray(jc[n])[:, :2], atol=1e-5)
        assert torch.equal(tc[n][:, 2], before[n])


# ----------------------------------------------------------------------
# the batcher against JAX's and against the plain batcher
# ----------------------------------------------------------------------

REQS = [(_prompt(1, 9), 10), (_prompt(2, 17), 7), (_prompt(3, 6), 12)]


def _staggered(srv):
    """Two requests, a step, the third once a slot frees: JAX's
    test_greedy_spec_matches_plain_batcher schedule."""
    r1 = srv.submit(REQS[0][0], max_new_tokens=REQS[0][1])
    r2 = srv.submit(REQS[1][0], max_new_tokens=REQS[1][1])
    srv.step()
    while srv.free_slots() == 0:
        srv.step()
    r3 = srv.submit(REQS[2][0], max_new_tokens=REQS[2][1])
    out = srv.drain()
    return [np.asarray(out[r]).tolist() for r in (r1, r2, r3)]


POOL = dict(slots=2, max_len=64, prompt_pad=16)


@pytest.mark.parametrize("draft", ["small", "noisy-self"])
def test_greedy_spec_matches_plain_and_jax(models, draft):
    """A mixed-length pool with staggered arrival: every greedy stream
    equals JAX's SpeculativeBatcher's and the port's plain batcher's;
    the noisy self-draft accepts part of its proposals (the acceptance
    counts equal JAX's)."""
    tj, tt, dj, dt, nj, nt = models
    d_cfg = D_J if draft == "small" else T_J
    d_j, d_t = (dj, dt) if draft == "small" else (nj, nt)
    plain = _staggered(ContinuousBatcher(_t(T_J), tt, kv="dense",
                                         device="cpu", **POOL))
    js = JaxSpec(T_J, tj, d_cfg, d_j, spec_k=3, **POOL)
    want = _staggered(js)
    ts = SpeculativeBatcher(_t(T_J), tt, _t(d_cfg), d_t, spec_k=3,
                            device="cpu", **POOL)
    got = _staggered(ts)
    assert got == want == plain
    assert (ts.spec_steps, ts.spec_proposed, ts.spec_accepted) == \
        (js.spec_steps, js.spec_proposed, js.spec_accepted)
    if draft == "noisy-self":
        assert 0 < ts.spec_accepted < ts.spec_proposed


def test_greedy_spec_interleaved_and_overlapped(models):
    """prefill_chunk_tokens and overlap: every greedy stream equals the
    convoy speculative batcher's (and so the plain one's); sampled
    streams equal the convoy ones draw for draw; each step() returns
    what JAX's returns."""
    tj, tt, _, _, nj, nt = models
    conv = _staggered(SpeculativeBatcher(_t(T_J), tt, _t(T_J), nt, spec_k=3,
                                         device="cpu", **POOL))
    for extra in ({"prefill_chunk_tokens": 16},
                  {"prefill_chunk_tokens": 16, "overlap": True},
                  {"overlap": True}):
        got = _staggered(SpeculativeBatcher(_t(T_J), tt, _t(T_J), nt,
                                            spec_k=3, device="cpu", **POOL,
                                            **extra))
        assert got == conv, extra
        jsrv = JaxSpec(T_J, tj, T_J, nj, spec_k=3, **POOL, **extra)
        tsrv = SpeculativeBatcher(_t(T_J), tt, _t(T_J), nt, spec_k=3,
                                  device="cpu", **POOL, **extra)
        for srv in (jsrv, tsrv):
            srv.submit(REQS[0][0], max_new_tokens=9)
            srv.submit(REQS[1][0], max_new_tokens=6)
        while jsrv.n_active or tsrv.n_active:
            assert tsrv.step() == jsrv.step()
        assert tsrv.flush_overlap() == jsrv.flush_overlap()

    def sampled(**kw):
        srv = SpeculativeBatcher(_t(T_J), tt, _t(T_J), nt, spec_k=3,
                                 temperature=0.9, top_k=20, device="cpu",
                                 **POOL, **kw)
        rids = [srv.submit(p, max_new_tokens=n, seed=i)
                for i, (p, n) in enumerate(REQS[:2])]
        return [srv.drain()[r].tolist() for r in rids]

    assert sampled(prefill_chunk_tokens=16, overlap=True) == sampled()


def test_greedy_spec_matches_plain_bf16(models, monkeypatch):
    """bf16 compute (bf16 caches): the speculative streams equal the
    port's plain bf16 batcher's token for token, and JAX's speculative
    batcher's up to TIE (the plain versions rounding the attention
    probabilities to bf16 as JAX's codec does)."""
    round_probs_like_jax(monkeypatch)
    tj, tt, dj, dt, _, _ = models
    kw = dict(slots=1, max_len=64, prompt_pad=16)
    prompts = [_prompt(15, 9), _prompt(16, 20)]

    def run(srv):
        return [_one(srv, p, max_new_tokens=8).tolist()
                for p in prompts]

    got = run(SpeculativeBatcher(_t(T_J), tt, _t(D_J), dt, spec_k=3,
                                 compute_dtype=BF16, device="cpu", **kw))
    plain = run(ContinuousBatcher(_t(T_J), tt, kv="dense", compute_dtype=BF16,
                                  device="cpu", **kw))
    assert got == plain
    want = run(JaxSpec(T_J, tj, D_J, dj, spec_k=3,
                       compute_dtype=jnp.bfloat16, **kw))
    assert_streams_match(got, want, prompts, _spec_gap(tj))


def _spec_gap(jprep):
    """JAX's top-2 gap after a sequence, T_J in bf16 compute over a bf16
    cache (test_torch_bf16_serving's _gap_fn for this config)."""
    from dnn_tpu.runtime import generate as jgen

    @jax.jit
    def last(ids):
        cache = jgen.init_cache(T_J, 1, ids.shape[1], jnp.bfloat16)
        return jgen.forward_with_cache(jprep, ids, cache, 0, cfg=T_J,
                                       compute_dtype=jnp.bfloat16)[0][0, -1]

    def gap(seq):
        lg = np.sort(np.asarray(last(jnp.asarray([seq]))))
        return float(lg[-1] - lg[-2])
    return gap


def test_bf16_parts_only_at_stated_gap(monkeypatch):
    """gpt2-test drafted by itself in bf16 compute, three streams of 9
    tokens: the port's speculative streams equal its plain bf16
    batcher's token for token, JAX's speculative streams equal JAX's
    plain ones, and the port's part from JAX's only where JAX's top-2
    gap is below BF16_SPEC_TIE. They do part here, at gaps 0.063 and
    0.137 (logits of |max| 5-9): the plain batchers already part there,
    through JAX's CPU silu/gelu rounding every intermediate op to bf16
    (test_torch_bf16_serving), so the tie is the chip smoke's BF16_TIE,
    0.2, and not that file's 0.1, whose scripts never met a gap this
    wide."""
    from test_torch_bf16_serving import _gpt_tree, _jax_gpt_prepared

    round_probs_like_jax(monkeypatch)
    tree = _gpt_tree(15.0)
    jprep = _jax_gpt_prepared(tree)
    cfg_j, cfg_t = jgpt.PRESETS["gpt2-test"], tgpt.PRESETS["gpt2-test"]
    prep = from_jax_params(tree, cfg_t, "cpu")
    prompts = [np.random.default_rng(s).integers(0, 256, n)
               for s, n in ((0, 5), (1, 20), (2, 37))]
    kw = dict(slots=3, max_len=64, prompt_pad=16)

    def run(srv):
        rids = [srv.submit(p, max_new_tokens=9) for p in prompts]
        out = srv.drain()
        return [out[r].tolist() for r in rids]

    got = run(SpeculativeBatcher(cfg_t, prep, cfg_t, prep, spec_k=3,
                                 compute_dtype=BF16, device="cpu", **kw))
    assert got == run(ContinuousBatcher(cfg_t, prep, kv="dense",
                                        compute_dtype=BF16, device="cpu",
                                        **kw))
    want = run(JaxSpec(cfg_j, jprep, cfg_j, jprep, spec_k=3,
                       compute_dtype=jnp.bfloat16, **kw))
    assert want == run(JaxBatcher(cfg_j, jprep, compute_dtype=jnp.bfloat16,
                                  **kw))
    partings = assert_streams_match(got, want, prompts,
                                    _gap_fn("gpt2-test", jprep, "bf16"),
                                    tie=BF16_SPEC_TIE)
    print(f"bf16 speculative partings from JAX (step, gap): {partings}")


def test_budget_exact_and_reasons(models):
    _, tt, _, dt, _, _ = models
    srv = SpeculativeBatcher(_t(T_J), tt, _t(D_J), dt, spec_k=4,
                             device="cpu", **POOL)
    rid = srv.submit(_prompt(4, 8), max_new_tokens=6)
    assert len(srv.drain()[rid]) == 6
    assert srv.finish_reasons[rid] == "length"


def test_stop_sequence_mid_chunk(models):
    """A stop inside a committed chunk retires the slot and trims as the
    plain batcher does; the self-draft commits whole chunks, so the stop
    lands mid-chunk."""
    _, tt, _, _, _, _ = models
    plain = ContinuousBatcher(_t(T_J), tt, kv="dense", device="cpu",
                              slots=1, max_len=64, prompt_pad=16)
    full = _one(plain, _prompt(5, 8), 12)
    stop = full[2:4].tolist()
    end = next(i for i in range(1, len(full))
               if full[i - 1:i + 1].tolist() == stop)
    srv = SpeculativeBatcher(_t(T_J), tt, _t(T_J), tt, spec_k=4,
                             device="cpu", slots=1, max_len=64,
                             prompt_pad=16)
    rid = srv.submit(_prompt(5, 8), max_new_tokens=12, stop=[stop])
    assert srv.drain()[rid].tolist() == full[:end - 1].tolist()
    assert srv.finish_reasons[rid] == "stop"


def test_self_draft_accepts_everything(models):
    _, tt, _, _, _, _ = models
    srv = SpeculativeBatcher(_t(T_J), tt, _t(T_J), tt, spec_k=3,
                             device="cpu", slots=1, max_len=64,
                             prompt_pad=16)
    rid = srv.submit(_prompt(6, 8), max_new_tokens=12)
    assert len(srv.drain()[rid]) == 12
    assert srv.spec_accepted == srv.spec_proposed
    assert srv.spec_steps == 3  # 11 tokens after the first, 4 a step


def test_sampled_seeded_deterministic(models):
    _, tt, _, dt, _, _ = models

    def run():
        srv = SpeculativeBatcher(_t(T_J), tt, _t(D_J), dt, spec_k=3,
                                 temperature=0.9, top_k=20, device="cpu",
                                 **POOL)
        r1 = srv.submit(_prompt(7, 9), max_new_tokens=8, seed=11)
        r2 = srv.submit(_prompt(8, 7), max_new_tokens=6, seed=12)
        out = srv.drain()
        return out[r1], out[r2]

    a, b = run(), run()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert len(a[0]) == 8 and len(a[1]) == 6
    assert (a[0] >= 0).all() and (a[0] < 128).all()


def test_validation(models):
    _, tt, _, dt, _, _ = models
    bad = tgpt.GPTConfig(block_size=64, vocab_size=99, n_layer=1, n_head=2,
                         n_embd=32)
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeBatcher(_t(T_J), tt, bad, dt, device="cpu", slots=1,
                           max_len=64)
    with pytest.raises(ValueError, match="int8"):
        SpeculativeBatcher(_t(T_J), tt, _t(D_J), dt, device="cpu", slots=1,
                           max_len=64, kv_dtype="int8")
    for opt in ({"top_p": 0.9}, {"min_p": 0.1}, {"repetition_penalty": 1.2},
                {"logprobs_k": 2}, {"allow_constraints": True}):
        with pytest.raises(ValueError, match="does not support"):
            SpeculativeBatcher(_t(T_J), tt, _t(D_J), dt, device="cpu",
                               slots=1, max_len=64, **opt)
    with pytest.raises(ValueError, match="block_size"):
        SpeculativeBatcher(_t(T_J), tt, dataclasses.replace(
            _t(D_J), block_size=32), dt, device="cpu", slots=1, max_len=64)
    with pytest.raises(ValueError, match="spec_k"):
        SpeculativeBatcher(_t(T_J), tt, _t(D_J), dt, spec_k=0, device="cpu",
                           slots=1, max_len=64)
    srv = SpeculativeBatcher(_t(T_J), tt, _t(D_J), dt, spec_k=4,
                             device="cpu", slots=1, max_len=32,
                             prompt_pad=16)
    with pytest.raises(ValueError, match="spec_k"):
        srv.submit(_prompt(9, 3), max_new_tokens=4)
    with pytest.raises(ValueError, match="exceeds max_len"):
        srv.submit(_prompt(9, 16), max_new_tokens=16)
    with pytest.raises(ValueError, match="per-request"):
        srv.submit(_prompt(9, 8), max_new_tokens=4, temperature=0.5)
    assert srv.free_slots() == 1


# ----------------------------------------------------------------------
# the LLaMA family
# ----------------------------------------------------------------------

def _llama(seed, n_layer=None):
    cfg_j, cfg_t = jllama.PRESETS["llama-test"], tllama.PRESETS["llama-test"]
    if n_layer is not None:
        cfg_j = dataclasses.replace(cfg_j, n_layer=n_layer)
        cfg_t = dataclasses.replace(cfg_t, n_layer=n_layer)
    tree = jax.tree.map(np.asarray, jllama.init(jax.random.PRNGKey(seed),
                                                cfg_j))
    if n_layer is None:
        tree = drawn_tree("llama-test", seed, 0.3)
    return (cfg_j, cfg_t,
            jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), cfg_j),
            from_jax_params(tree, cfg_t, "cpu"))


def test_llama_family_speculative_greedy_parity():
    """A LLaMA target verifying a one-layer LLaMA draft (K5 with grouped
    heads over the KV-width cache): the plain batcher's tokens and JAX's
    speculative batcher's."""
    cfg_j, cfg_t, tj, tt = _llama(21)
    dcfg_j, dcfg_t, dj, dt = _llama(22, n_layer=1)
    prompts = [np.arange(5, 13) % 256, np.asarray([3, 1, 4, 1, 5, 9, 2, 6])]
    kw = dict(slots=2, max_len=64, prompt_pad=8)

    def run(srv):
        rids = [srv.submit(p, max_new_tokens=9) for p in prompts]
        srv.drain()
        return [srv.results[r].tolist() for r in rids]

    plain = run(ContinuousBatcher(cfg_t, tt, kv="dense", device="cpu", **kw))
    got = run(SpeculativeBatcher(cfg_t, tt, dcfg_t, dt, spec_k=3,
                                 draft_family=tllama.LlamaFamilyRows(dcfg_t),
                                 device="cpu", **kw))
    want = run(JaxSpec(cfg_j, tj, dcfg_j, dj, spec_k=3,
                       family=jllama.LlamaFamilyRows(cfg_j),
                       draft_family=jllama.LlamaFamilyRows(dcfg_j), **kw))
    assert got == plain == want


def test_cross_family_gpt_draft_llama_target():
    """A GPT-2 draft proposes for a LLaMA target (gpt2-test and
    llama-test share vocab 256): the target-only tokens, and JAX's."""
    cfg_j, cfg_t, tj, tt = _llama(23)
    g_tree = _tree(jgpt.PRESETS["gpt2-test"], 24)
    gj, gt = _both(jgpt.PRESETS["gpt2-test"], g_tree)
    prompt = np.asarray([7, 7, 3, 2, 9, 11])
    kw = dict(slots=1, max_len=64, prompt_pad=8)
    plain = ContinuousBatcher(cfg_t, tt, kv="dense", device="cpu", **kw)
    want = _one(plain, prompt, max_new_tokens=8).tolist()
    spec = SpeculativeBatcher(cfg_t, tt, tgpt.PRESETS["gpt2-test"], gt,
                              spec_k=2, device="cpu", **kw)
    got = _one(spec, prompt, max_new_tokens=8).tolist()
    js = JaxSpec(cfg_j, tj, jgpt.PRESETS["gpt2-test"], gj, spec_k=2,
                 family=jllama.LlamaFamilyRows(cfg_j), **kw)
    assert got == want == _one(js, prompt,
                                               max_new_tokens=8).tolist()


def test_spec_rejects_windowed_family():
    """A windowed preset never reaches the verify: the speculative batcher
    refuses it at construction with JAX's ValueError (its paged_ok flag,
    serving_spec.py:180), as target and as draft."""
    cfg = tllama.PRESETS["mistral-test"]
    prep = from_jax_params(tllama.init(0, cfg), cfg, "cpu")
    lcfg = tllama.PRESETS["llama-test"]
    lprep = from_jax_params(tllama.init(1, lcfg), lcfg, "cpu")
    kw = dict(slots=1, max_len=32, prompt_pad=8, device="cpu")
    for which, target in (("target", (cfg, prep)), ("draft", (lcfg, lprep))):
        with pytest.raises(ValueError, match=f"the {which} family has a "
                           "sliding window"):
            SpeculativeBatcher(*target, cfg, prep, spec_k=2,
                               draft_family=tllama.LlamaFamilyRows(cfg),
                               **kw)


def test_spec_requires_explicit_draft_family_for_non_gpt_draft():
    cfg_j, cfg_t, _, tt = _llama(26)
    with pytest.raises(ValueError, match="draft_family"):
        SpeculativeBatcher(cfg_t, tt, cfg_t, tt, spec_k=2, slots=1,
                           max_len=48, prompt_pad=8, device="cpu")


# ----------------------------------------------------------------------
# decode buckets (tests/test_spec_buckets.py)
# ----------------------------------------------------------------------

B_J = jgpt.GPTConfig(vocab_size=89, block_size=256, n_layer=2, n_head=2,
                     n_embd=32)
BD_J = jgpt.GPTConfig(vocab_size=89, block_size=256, n_layer=1, n_head=2,
                      n_embd=16)
PROMPT = (np.arange(1, 20) * 3) % 89


@pytest.fixture(scope="module")
def bucket_models():
    """The target x15, its noisy copy as the draft (partial acceptance)."""
    tree = _tree(B_J, 0)
    rng = np.random.default_rng(9)
    noisy = jax.tree.map(
        lambda a: a + (0.25 * np.abs(a).mean() * rng.standard_normal(
            a.shape)).astype(np.float32) if a.ndim >= 2 else a, tree)
    return (*_both(B_J, tree), *_both(B_J, noisy))


def test_spec_bucketed_greedy_parity_through_rungs(bucket_models):
    tj, tt, nj, nt = bucket_models
    cfg = _t(B_J)
    ref = ContinuousBatcher(cfg, tt, kv="dense", device="cpu", slots=2,
                            max_len=192, prompt_pad=16)
    want = _one(ref, PROMPT, max_new_tokens=120).tolist()
    sp = SpeculativeBatcher(cfg, tt, cfg, nt, spec_k=3, slots=2,
                            max_len=192, prompt_pad=16, decode_buckets=True,
                            device="cpu")
    first = sp._cache_len
    got = _one(sp, PROMPT, max_new_tokens=120).tolist()
    assert got == want
    assert sp._buckets == (64, 128, 192) and sp._cache_len > first
    assert sp.d_cache["k"].shape[3] == sp._cache_len  # lockstep
    assert sp.spec_accepted > 0
    js = JaxSpec(B_J, tj, B_J, nj, spec_k=3, slots=2, max_len=192,
                 prompt_pad=16, decode_buckets=True)
    assert got == _one(js, PROMPT, max_new_tokens=120).tolist()
    assert sp.spec_accepted == js.spec_accepted
    assert sp._cache_len == js._cache_len


def test_spec_bucketed_matches_spec_unbucketed_sampled(bucket_models):
    _, tt, _, nt = bucket_models

    def run(**kw):
        sp = SpeculativeBatcher(_t(B_J), tt, _t(B_J), nt, spec_k=2, slots=2,
                                max_len=192, prompt_pad=16, temperature=0.8,
                                top_k=11, device="cpu", **kw)
        return _one(sp, PROMPT, max_new_tokens=90,
                                    seed=7).tolist()

    assert run(decode_buckets=True) == run()


def test_spec_bucketed_multi_slot_mixed_retirement(bucket_models):
    _, tt, _, nt = bucket_models
    sp = SpeculativeBatcher(_t(B_J), tt, _t(B_J), nt, spec_k=3, slots=2,
                            max_len=192, prompt_pad=16, decode_buckets=True,
                            prefill_chunk_tokens=16, overlap=True,
                            device="cpu")
    ra = sp.submit(PROMPT, max_new_tokens=100)
    rb = sp.submit((PROMPT + 7) % 89, max_new_tokens=30)
    out = sp.drain()
    assert len(out[ra]) == 100 and len(out[rb]) == 30
    for rid, prompt, budget in ((ra, PROMPT, 100),
                                (rb, (PROMPT + 7) % 89, 30)):
        ref = ContinuousBatcher(_t(B_J), tt, kv="dense", device="cpu",
                                slots=1, max_len=192, prompt_pad=16)
        assert _one(ref, prompt, budget).tolist() == \
            out[rid].tolist()


def test_spec_rejects_paged_resolves_auto_dense(bucket_models):
    _, tt, _, nt = bucket_models
    with pytest.raises(ValueError, match="paged"):
        SpeculativeBatcher(_t(B_J), tt, _t(B_J), nt, slots=2, max_len=192,
                           prompt_pad=16, kv="paged", device="cpu")
    for kv in ({"kv": "auto"}, {}):
        assert not SpeculativeBatcher(_t(B_J), tt, _t(B_J), nt, slots=2,
                                      max_len=192, prompt_pad=16,
                                      device="cpu", **kv).paged


# ----------------------------------------------------------------------
# the captured step's bookkeeping, with a stand-in capture
# ----------------------------------------------------------------------

class _Graph:
    """A stand-in CUDA graph: a replay runs the captured function and
    copies its outputs into the static ones."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        for o, n in zip(self.out, self.fn()):
            o.copy_(n)


def _capture_over(b):
    """A stand-in capture for batcher `b`: a real capture records and
    does not run, so the stand-in runs fn once for the static outputs
    and then puts back every tensor the step writes."""
    def capture(fn):
        state = [b._tok_d, b._pos_d, b._prev_chunk, b._prev_pos,
                 *b.cache.values(), *b.d_cache.values(), *b._row.values(),
                 *b._d_row.values()]
        saved = [t.clone() for t in state]
        out = tuple(t.clone() for t in fn())
        for t, s in zip(state, saved):
            t.copy_(s)
        return _Graph(fn, out), out, tca.LaunchLog()
    return capture


@pytest.mark.parametrize("extra", [{}, {"prefill_chunk_tokens": 16,
                                        "overlap": True}],
                         ids=["convoy", "interleaved-overlap"])
def test_captured_spec_steps(bucket_models, extra):
    """The greedy spec step through CapturedDecode ("spec", and
    "spec_mixed" for an interleaved chunk): captured at its first call
    and after each bucket grow (the key is both caches), replayed
    otherwise; the streams equal the eager batcher's."""
    _, tt, _, nt = bucket_models
    kw = dict(slots=2, max_len=192, prompt_pad=16, decode_buckets=True,
              spec_k=3, device="cpu", **extra)

    def run(b):
        ra = b.submit(PROMPT, max_new_tokens=100)
        rb = b.submit((PROMPT + 7) % 89, max_new_tokens=30)
        out = b.drain()
        return [out[ra].tolist(), out[rb].tolist()]

    want = run(SpeculativeBatcher(_t(B_J), tt, _t(B_J), nt, **kw))
    b = SpeculativeBatcher(_t(B_J), tt, _t(B_J), nt, **kw)
    g = b._graph_step = CapturedDecode(2, "cpu", capture=_capture_over(b),
                                       chunk_tokens=extra.get(
                                           "prefill_chunk_tokens", 0))
    assert run(b) == want
    spec, mixed = g.counts["spec"], g.counts.get("spec_mixed", [0, 0])
    assert spec[0] == b.bucket_grows + 1 and spec[1] > 0
    assert (mixed[0] > 0) == bool(extra)
    assert b.spec_steps == spec[0] + spec[1] + mixed[0] + mixed[1]


def test_sampled_spec_steps_are_never_captured(bucket_models):
    _, tt, _, nt = bucket_models
    b = SpeculativeBatcher(_t(B_J), tt, _t(B_J), nt, spec_k=2, slots=1,
                           max_len=64, prompt_pad=16, temperature=0.7,
                           device="cpu")
    g = b._graph_step = CapturedDecode(1, "cpu", capture=_capture_over(b))
    b.drain()
    b.submit(PROMPT, max_new_tokens=8, seed=1)
    b.drain()
    assert g.captures == g.replays == 0


# ----------------------------------------------------------------------
# the daemon
# ----------------------------------------------------------------------

def test_spec_daemon_matches_dense_daemon(models):
    """serve_lm with draft_cfg serves through the SpeculativeBatcher
    (neither biases nor constraints allowed): greedy unary and streamed
    tokens over gRPC equal the plain daemon's; JSON mode is refused."""
    import grpc

    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background

    _, tt, _, dt, _, _ = models
    prompt = _prompt(20, 10)
    p1, p2 = _free_port(), _free_port()
    _, stop1 = start_lm_server_in_background(
        _t(T_J), tt, port=p1, slots=2, max_len=64, prompt_pad=16,
        device="cpu")
    _, stop2 = start_lm_server_in_background(
        _t(T_J), tt, port=p2, slots=2, max_len=64, prompt_pad=16,
        draft_cfg=_t(D_J), draft_prepared=dt, spec_k=3, device="cpu")
    try:
        b = stop2.servicer.batcher
        assert isinstance(b, SpeculativeBatcher) and not b._allow_constraints
        assert b._bias is None and not b.paged
        c1, c2 = NodeClient(f"127.0.0.1:{p1}"), NodeClient(f"127.0.0.1:{p2}")
        want = c1.generate(prompt, max_new_tokens=8)
        np.testing.assert_array_equal(c2.generate(prompt, max_new_tokens=8),
                                      want)
        streamed = list(c2.generate_stream(prompt, max_new_tokens=8))
        np.testing.assert_array_equal(np.asarray(streamed, np.int32), want)
        with pytest.raises(grpc.RpcError) as e:
            c2.send_tensor(prompt, request_id="gen:4:j=0")
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        c1.close()
        c2.close()
    finally:
        stop1()
        stop2()


def test_node_serve_lm_draft_model(tmp_path, caplog):
    """`node --serve_lm --draft_model gpt2-test --spec_k 3` as a process
    serves speculatively (random draft weights, logged) with the plain
    batcher's greedy tokens, and SIGTERM stops it with rc 0; a draft of
    another family or vocabulary exits 1."""
    import json
    import pathlib
    import signal
    import subprocess
    import sys

    from dnn_tpu_torch.node import main

    port = _free_port()
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model": "gpt2-test", "nodes": [
        {"id": "node1", "part_index": 0, "address": f"127.0.0.1:{port}"}]}))
    pool = ["--slots", "2", "--max_len", "64", "--prompt_pad", "16",
            "--seed", "3"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dnn_tpu_torch.node", "--node_id", "node1",
         "--config", str(cfg), "--serve_lm", "--device", "cpu", *pool,
         "--draft_model", "gpt2-test", "--spec_k", "3"],
        cwd=pathlib.Path(__file__).resolve().parents[1],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        assert client.wait_healthy(deadline=90)
        prompt = _prompt(30, 9, 256)
        got = client.generate(prompt, max_new_tokens=10)
        client.close()
        t_cfg = tgpt.PRESETS["gpt2-test"]
        b = ContinuousBatcher(t_cfg, from_jax_params(tgpt.init(3, t_cfg),
                                                      t_cfg, "cpu"),
                              kv="dense", device="cpu", slots=2, max_len=64,
                              prompt_pad=16)
        np.testing.assert_array_equal(got, _one(b, prompt, 10))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert "no --draft_weights" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    with caplog.at_level("ERROR", logger="dnn_tpu_torch.node"):
        assert main(["--node_id", "node1", "--config", str(cfg),
                     "--serve_lm", "--device", "cpu", "--draft_model",
                     "llama-test"]) == 1
    assert "dense GPT-family" in caplog.text
