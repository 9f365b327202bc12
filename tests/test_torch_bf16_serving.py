"""bf16 compute on the port's serving path against the JAX package on the
CPU, on the same numpy weights and inputs: the logits of the cached
forward (make_generate's path)
and of the batcher's decode step, greedy streams of the batcher (paged,
dense, bucketed; bf16 and int8 KV), of make_generate and of
`node --serve_lm` with a `"dtype": "bfloat16"` config, the weights held
in bf16 once, and the rule that a family's compute type wins.

K5/K6/K7's plain versions with a bf16 q are held against JAX's in
test_torch_cached_attention.py.

Tolerances, stated:
  * logits: LOGIT_TOL = 3e-2 of JAX's largest |logit|. The products
    agree bit for bit (a bf16 matmul rounds once in both), but JAX's CPU
    silu and tanh-gelu on bf16 round every intermediate op to bf16 (40%
    of their outputs differ from the correctly rounded value, which
    torch's give), and the layers carry that on: measured 0.4-0.6% on
    gpt2-test at JAX's init, 1.1-1.2% on the LLaMA presets drawn at 0.05.
  * greedy streams (weights x15 / drawn at 0.3, so that the argmaxes are
    mostly decisive): equal to JAX's, except from a step where JAX's
    top-2 logit gap (its cached forward over the sequence, into a cache
    of the stream's type) is below TIE = 0.1, with at least one stream
    of each script identical. Measured partings: gaps 0.002-0.054
    (logits of |max| 5-9); the JAX batcher's own paged and dense pools
    part from each other on gpt2-test too.
"""

import json
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.models import gpt as jgpt
from dnn_tpu.models import llama as jllama
from dnn_tpu.runtime import generate as jgen
from dnn_tpu.runtime import kvcache as jkv
from dnn_tpu.runtime.serving import ContinuousBatcher as JaxBatcher
from dnn_tpu.runtime.serving import GPTFamilyRows as JaxGPTRows
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.models import llama as tllama
from dnn_tpu_torch.runtime import generate as tgen
from dnn_tpu_torch.runtime.kvcache import codec_for_cache
from dnn_tpu_torch.runtime.serving import ContinuousBatcher, GPTFamilyRows

from test_torch_llama import (  # one_torch_thread: the autouse fixture
    drawn_tree,
    jax_prepared,
    one_torch_thread,  # noqa: F401
)

BF16 = torch.bfloat16
LOGIT_TOL = 3e-2
TIE = 0.1
POOL = dict(slots=3, max_len=64, prompt_pad=16, block_len=8)
GPT_J, GPT_T = jgpt.PRESETS["gpt2-test"], tgpt.PRESETS["gpt2-test"]


def _gpt_tree(scale):
    return jax.tree.map(
        lambda a: np.asarray(a) * np.float32(scale if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(0), GPT_J))


def _jax_gpt_prepared(tree):
    return jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), GPT_J)


# --- logits: the cached forward and the batcher's decode step -----------

def _model(name):
    """(port cfg, JAX cfg, port weights prepared in bf16, JAX prepared,
    JAX's cached forward, the port's) at LOGIT_TOL's weights."""
    if name == "gpt2-test":
        tree = _gpt_tree(1.0)
        return (GPT_T, GPT_J, from_jax_params(tree, GPT_T, "cpu", BF16),
                _jax_gpt_prepared(tree), jgen.forward_with_cache,
                tgen.forward_with_cache)
    tree = drawn_tree(name, 1, 0.05)
    cfg = tllama.PRESETS[name]
    return (cfg, jllama.PRESETS[name], from_jax_params(tree, cfg, "cpu", BF16),
            jax_prepared(name, tree), jllama.forward_with_cache,
            tllama.forward_with_cache)


def _close(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= LOGIT_TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("name", ["gpt2-test", "llama-test", "qwen3-test"])
def test_cached_forward_logits_match_jax(name, kv):
    """make_generate's path in bf16 compute: a 12-token prefill (K5 with a
    bf16 q) and two one-token steps (K6 at G rows) over a bf16 or int8
    cache, f32 logits within LOGIT_TOL of JAX's forward_with_cache with
    compute_dtype=bf16 at every call."""
    cfg, jcfg, prep, jprep, jfwd, tfwd = _model(name)
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 14))
    tkv, jkvd = (BF16, jnp.bfloat16) if kv == "bf16" else ("int8", "int8")
    init_t = tgen.init_cache if name == "gpt2-test" else tllama.init_cache
    init_j = jgen.init_cache if name == "gpt2-test" else jllama.init_cache
    tc = init_t(cfg, 2, 16, tkv, "cpu")
    jc = init_j(jcfg, 2, 16, jkvd)
    for start, stop in ((0, 12), (12, 13), (13, 14)):
        got, tc = tfwd(prep, torch.from_numpy(ids[:, start:stop]), tc, start,
                       cfg=cfg, compute_dtype=BF16)
        want, jc = jfwd(jprep, jnp.asarray(ids[:, start:stop]), jc, start,
                        cfg=jcfg, compute_dtype=jnp.bfloat16)
        assert got.dtype == torch.float32
        _close(got.numpy(), want)


@pytest.mark.parametrize("name", ["gpt2-test", "llama-test"])
def test_decode_rows_logits_match_jax(name):
    """The batcher's family decode step in bf16 compute over a dense bf16
    cache prefilled by each package's own forward: two active slots and
    an inactive one at their own positions, logits (B, V) within
    LOGIT_TOL of JAX's family decode_rows."""
    cfg, jcfg, prep, jprep, jfwd, tfwd = _model(name)
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 9))
    init_t = tgen.init_cache if name == "gpt2-test" else tllama.init_cache
    init_j = jgen.init_cache if name == "gpt2-test" else jllama.init_cache
    tc = init_t(cfg, 3, 16, BF16, "cpu")
    jc = init_j(jcfg, 3, 16, jnp.bfloat16)
    _, tc = tfwd(prep, torch.from_numpy(ids), tc, 0, cfg=cfg,
                 compute_dtype=BF16)
    _, jc = jfwd(jprep, jnp.asarray(ids), jc, 0, cfg=jcfg,
                 compute_dtype=jnp.bfloat16)
    if name == "gpt2-test":
        tfam = GPTFamilyRows(cfg, compute_dtype=BF16)
        jfam = JaxGPTRows(jcfg, compute_dtype=jnp.bfloat16)
    else:
        tfam = tllama.LlamaFamilyRows(cfg, compute_dtype=BF16)
        jfam = jllama.LlamaFamilyRows(jcfg, compute_dtype=jnp.bfloat16)
    tok = np.array([5, 17, 3])
    pos = np.array([9, 7, 9], np.int32)
    active = np.array([True, True, False])
    got = tfam.decode_rows(prep, tc, torch.from_numpy(tok),
                           torch.from_numpy(pos), torch.from_numpy(active),
                           codec_for_cache(tc))
    want, _ = jfam.decode_rows(jprep, jc, jnp.asarray(tok), jnp.asarray(pos),
                               jnp.asarray(active), jkv.codec_for_cache(jc))
    assert got.shape == (3, cfg.vocab_size) and got.dtype == torch.float32
    _close(got[:2].numpy(), np.asarray(want)[:2])


# --- greedy streams -----------------------------------------------------

def _gap_fn(name, jprep, kv_dtype):
    """JAX's top-2 logit gap after a token sequence: its cached forward
    in bf16 compute over the whole sequence at once, into a cache of
    the stream's type (an int8 cache quantizes every position the last
    one attends, as in the served stream)."""
    jkv_dtype = jnp.bfloat16 if kv_dtype == "bf16" else "int8"
    if name == "gpt2-test":
        cfg, fwd, init = GPT_J, jgen.forward_with_cache, jgen.init_cache
    else:
        cfg = jllama.PRESETS[name]
        fwd, init = jllama.forward_with_cache, jllama.init_cache

    @jax.jit
    def last_logits(ids):
        cache = init(cfg, 1, ids.shape[1], jkv_dtype)
        return fwd(jprep, ids, cache, 0, cfg=cfg,
                   compute_dtype=jnp.bfloat16)[0][0, -1]

    def gap(seq):
        lg = np.sort(np.asarray(last_logits(jnp.asarray([seq]))))
        return float(lg[-1] - lg[-2])
    return gap


def assert_streams_match(got, want, prompts, gap, tie=TIE):
    """Each stream equals JAX's, or parts from it at a step where JAX's
    top-2 gap is below `tie` (the rest is then not compared); at least
    one stream is identical. Returns the partings (step, gap)."""
    partings = []
    for prompt, g, w in zip(prompts, got, want):
        g, w = list(map(int, g)), list(map(int, w))
        assert len(g) == len(w)
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            continue
        gp = gap([int(x) for x in prompt] + w[:j])
        assert gp < tie, (f"stream parted at step {j} where JAX's top-2 gap "
                          f"is {gp:.4f} >= {tie}: {g} vs {w}")
        partings.append((j, gp))
    assert len(partings) < len(got), partings
    return partings


def _script(b, vocab):
    """Three requests of 5 / 20 / 37 tokens (one chunk, two, three with a
    padded tail); the third admitted mid-decode."""
    rng = np.random.default_rng
    prompts = [rng(s).integers(0, vocab, n) for s, n in
               ((0, 5), (1, 20), (2, 37))]
    r0 = b.submit(prompts[0], 10)
    r1 = b.submit(prompts[1], 12)
    for _ in range(3):
        b.step()
    r2 = b.submit(prompts[2], 9)
    res = b.drain()
    return prompts, [np.asarray(res[r]) for r in (r0, r1, r2)]


_STREAMS: dict = {}


def _streams_model(name):
    if name not in _STREAMS:
        if name == "gpt2-test":
            tree = _gpt_tree(15.0)
            jprep, cfg, jcfg = _jax_gpt_prepared(tree), GPT_T, GPT_J
        else:
            tree = drawn_tree(name, 1, 0.3)
            jprep = jax_prepared(name, tree)
            cfg, jcfg = tllama.PRESETS[name], jllama.PRESETS[name]
        _STREAMS[name] = (cfg, jcfg, tree, jprep, {
            kv: _gap_fn(name, jprep, kv) for kv in ("bf16", "int8")}, {})
    return _STREAMS[name]


def _jax_family(name, jcfg):
    if name == "gpt2-test":
        return JaxGPTRows(jcfg, compute_dtype=jnp.bfloat16)
    return jllama.LlamaFamilyRows(jcfg, compute_dtype=jnp.bfloat16)


LAYOUTS = {"paged": {"kv": "paged"}, "dense": {"kv": "dense"},
           "buckets": {"kv": "dense", "decode_buckets": (16, 32)}}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", ["gpt2-test", "llama-test"])
def test_batcher_bf16_streams_match_jax(name, layout, kv_dtype):
    """The batcher in bf16 compute (compute_dtype=torch.bfloat16, weights
    prepared at f32 and cast once by the batcher) on each pool, over a
    bf16 cache (the default under bf16 compute) or int8, gives the JAX
    batcher's greedy tokens in bf16 compute (its dense pool), up to
    TIE."""
    cfg, jcfg, tree, jprep, gap, jax_cache = _streams_model(name)
    jkv_dtype = None if kv_dtype == "bf16" else "int8"
    if kv_dtype not in jax_cache:
        jax_cache[kv_dtype] = _script(JaxBatcher(
            jcfg, jprep, family=_jax_family(name, jcfg), kv="dense",
            kv_dtype=jkv_dtype, **POOL), cfg.vocab_size)[1]
    b = ContinuousBatcher(cfg, from_jax_params(tree, cfg, "cpu"),
                          compute_dtype=BF16, device="cpu",
                          kv_dtype=None if kv_dtype == "bf16" else "int8",
                          **{**POOL, **LAYOUTS[layout]})
    assert b.compute_dtype == BF16
    assert b.cache["k"].dtype == (BF16 if kv_dtype == "bf16" else torch.int8)
    prompts, got = _script(b, cfg.vocab_size)
    assert len(set(got[1].tolist())) > 2  # varied tokens, not one id
    assert_streams_match(got, jax_cache[kv_dtype], prompts, gap[kv_dtype])


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", ["gpt2-test", "llama-test"])
def test_make_generate_bf16_matches_jax(name, kv_dtype):
    """make_generate with compute_dtype=bf16 (the cache bf16 by default,
    or int8) on a 2-row batch of 11-token prompts, 9 new tokens, equals
    JAX's make_generate in bf16 compute, up to TIE; weights prepared in
    bf16 and in f32 give the same tokens."""
    cfg, jcfg, tree, jprep, gap, _ = _streams_model(name)
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 11))
    jmake = jgen.make_generate if name == "gpt2-test" else \
        jllama.make_generate
    want = np.asarray(jmake(jcfg, max_new_tokens=9, kv_dtype=kv_dtype,
                            compute_dtype=jnp.bfloat16)(
        jprep, jnp.asarray(ids), jax.random.PRNGKey(0)))
    gen = tgen.make_generate(cfg, max_new_tokens=9, kv_dtype=kv_dtype,
                             compute_dtype=BF16, device="cpu")
    got = gen(from_jax_params(tree, cfg, "cpu", BF16), ids).numpy()
    np.testing.assert_array_equal(
        gen(from_jax_params(tree, cfg, "cpu"), ids).numpy(), got)
    assert_streams_match(got, want, ids, gap[kv_dtype or "bf16"])


# --- the daemon's dtype, the weights, the family rule --------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_lm_serves_the_config_dtype(tmp_path, monkeypatch):
    """`node --serve_lm` with a `"dtype": "bfloat16"` gpt2-test config
    serves in bf16 compute, as JAX's daemon does: the batcher gets
    compute_dtype=bf16 and weights held in bf16, and a request's greedy
    tokens equal the JAX batcher's in bf16 compute (up to TIE). (Before
    the fix the daemon never read the dtype and served f32 silently.)"""
    from dnn_tpu_torch import node
    from dnn_tpu_torch.runtime import lm_server

    tree = _gpt_tree(15.0)
    flat = {}

    def flatten(node_, prefix):
        for k, v in node_.items():
            if isinstance(v, dict):
                flatten(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = v
    flatten(tree, "")
    npz = tmp_path / "params.npz"
    np.savez(npz, **flat)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({
        "model": "gpt2-test", "dtype": "bfloat16", "nodes": [
            {"id": "node1", "part_index": 0,
             "address": f"127.0.0.1:{_free_port()}"}]}))
    prompt = np.random.default_rng(7).integers(0, 256, 19)
    seen = {}

    async def fake_serve_lm(cfg, prepared, *, port, tokenizer=None,
                            role=None, kv_handoff_ttl_s=None,
                            kv_lease_ttl_s=None, **batcher_kwargs):
        # the LMServer's own arguments (the KV handoff's role and TTLs)
        # stay out of the batcher's, as serve_lm's LMServer keeps them
        b = ContinuousBatcher(cfg, prepared, **batcher_kwargs)
        seen["batcher"] = b
        rid = b.submit(prompt, 10)
        seen["tokens"] = b.drain()[rid]
        return 0

    monkeypatch.setattr(lm_server, "serve_lm", fake_serve_lm)
    assert node.main(["--node_id", "node1", "--config", str(cfg_path),
                      "--serve_lm", "--device", "cpu", "--slots", "3",
                      "--max_len", "64", "--prompt_pad", "16", "--block_len",
                      "8", "--weights_npz", str(npz)]) == 0
    b = seen["batcher"]
    assert b.compute_dtype == BF16 and b.cache["k"].dtype == BF16
    assert b.prepared["blocks"]["attn"]["qkv"]["kernel"].dtype == BF16
    jb = JaxBatcher(GPT_J, _jax_gpt_prepared(tree),
                    compute_dtype=jnp.bfloat16, kv="paged", **POOL)
    rid = jb.submit(prompt, 10)
    want = np.asarray(jb.drain()[rid])
    assert_streams_match([seen["tokens"]], [want], [prompt],
                         _gap_fn("gpt2-test", _jax_gpt_prepared(tree), "bf16"))


def test_family_compute_dtype_wins_and_a_mismatch_raises():
    """JAX's rule (dnn_tpu/runtime/serving.py:303-329): beside an
    explicit family the batcher runs at the family's compute type, its
    cache following it, and a different batcher-level type raises; an
    unknown type raises too."""
    prep = from_jax_params(_gpt_tree(1.0), GPT_T, "cpu")
    fam = GPTFamilyRows(GPT_T, compute_dtype=BF16)
    b = ContinuousBatcher(GPT_T, prep, family=fam, device="cpu", **POOL)
    assert b.compute_dtype == BF16 and b.cache["k"].dtype == BF16
    assert ContinuousBatcher(GPT_T, prep, family=fam, compute_dtype=BF16,
                             device="cpu", **POOL).compute_dtype == BF16
    with pytest.raises(ValueError, match="compute_dtype mismatch"):
        ContinuousBatcher(GPT_T, prep, family=GPTFamilyRows(GPT_T),
                          compute_dtype=BF16, device="cpu", **POOL)
    with pytest.raises(ValueError, match="compute_dtype"):
        ContinuousBatcher(GPT_T, prep, compute_dtype=torch.float16,
                          device="cpu", **POOL)
    llama = tllama.PRESETS["llama-test"]
    lprep = from_jax_params(tllama.init(0, llama), llama, "cpu")
    with pytest.raises(ValueError, match="compute_dtype mismatch"):
        ContinuousBatcher(llama, lprep, family=tllama.LlamaFamilyRows(llama),
                          compute_dtype=BF16, device="cpu", **POOL)
    lb = ContinuousBatcher(llama, lprep, compute_dtype=BF16, kv_dtype="int8",
                           device="cpu", **POOL)
    assert lb.family.compute_dtype == BF16 and lb.cache["k"].dtype == \
        torch.int8


@pytest.mark.parametrize("name", ["gpt2-test", "llama-test", "gemma-test",
                                  "phi-test"])
def test_weights_held_in_bf16_once(name):
    """from_jax_params(..., compute_dtype=bf16) holds every block
    linear's kernel and bias and the lm_head's kernel in bf16 (a tied
    config gets wte.T as its lm_head); embeddings, norm scales and the
    lm_head's bias stay f32; preparing prepared weights again copies
    nothing; compute_dtype=None leaves every leaf f32."""
    if name == "gpt2-test":
        cfg, tree = GPT_T, _gpt_tree(1.0)
    else:
        cfg, tree = tllama.PRESETS[name], drawn_tree(name, 0)
    prep = from_jax_params(tree, cfg, "cpu", BF16)
    blocks = prep["blocks"]

    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
            else:
                yield path + (k,), node, v
    for path, parent, leaf in walk(blocks):
        linear = "kernel" in parent
        assert leaf.dtype == (BF16 if linear else torch.float32), path
    assert prep["lm_head"]["kernel"].dtype == BF16
    if "bias" in prep["lm_head"]:
        assert prep["lm_head"]["bias"].dtype == torch.float32
    if getattr(cfg, "tie_word_embeddings", False):
        assert "lm_head" not in tree
        torch.testing.assert_close(prep["lm_head"]["kernel"],
                                   prep["wte"]["embedding"].T.to(BF16))
    assert prep["wte"]["embedding"].dtype == torch.float32
    again = tgpt.for_compute(prep, BF16)
    for (_, _, a), (_, _, b) in zip(walk(again), walk(prep)):
        assert a.data_ptr() == b.data_ptr()
    f32 = from_jax_params(tree, cfg, "cpu")
    assert all(leaf.dtype == torch.float32 for _, _, leaf in walk(f32))
