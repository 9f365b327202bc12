"""The port's LLaMA family (models/llama.py) on the CPU against the JAX
package's, on the same weights: the stateless forward, the cached
forward, the solo decoder, the pipeline stages, the HF checkpoint
converters and exporters, and the switches this port leaves out.

Weights: the JAX tree of each preset with EVERY leaf drawn from a numpy
seed — norm scales and biases too, which JAX's init leaves at 0 or 1 —
so that each switch (q/k/v biases, (1 + w) norms, LayerNorm biases, q/k
norms, post norms) acts. Logit tolerance: 1e-5 absolute in f32 (both
sides compute in f32; only the order of the sums differs), unless a
test says why not. Greedy tokens must be identical; those tests scale
the matrices up so that a random 4-layer model emits varied tokens."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.models import gpt as jgpt
from dnn_tpu.models import llama as jllama
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import llama as tllama
from dnn_tpu_torch.registry import get_model

PRESETS = ["llama-test", "qwen2-test", "gemma-test", "phi-test",
           "qwen3-test", "olmo2-test"]
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These models are tiny: one intra-op thread runs them faster than
    many, and parallel test workers then do not oversubscribe the cores
    (spinning OpenMP threads made each test 10x slower under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def drawn_tree(name, seed=0, scale=0.05):
    """JAX's init tree for preset `name` with every leaf redrawn: matrices
    N(0, scale), norm scales their identity (1, or 0 under
    norm_plus_one) plus N(0, 0.1), biases N(0, 0.1). numpy leaves."""
    cfg = jllama.PRESETS[name]
    tree = jax.tree.map(np.asarray, jllama.init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim >= 2:
            return noise * np.float32(scale)
        # a norm scale's identity: 1, or 0 for Gemma's (1 + w) norms
        # (its q/k norms, where a config has them, are plain)
        plus_one = cfg.norm_plus_one and path[-2].key not in ("q_norm",
                                                              "k_norm")
        ident = 1.0 if path[-1].key == "scale" and not plus_one else 0.0
        return (ident + 0.1 * noise).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def jax_prepared(name, tree):
    cfg = jllama.PRESETS[name]
    return jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), cfg)


def _ids(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t))


def test_port_init_has_the_jax_tree():
    """The port's numpy init has JAX's tree for every *-test preset (the
    windowed and softcapped ones too): the same leaves, shapes, dtypes
    and identity values (norm scales, biases)."""
    for name in [n for n in tllama.PRESETS if n.endswith("-test")]:
        want = jax.tree.map(np.asarray, jllama.init(
            jax.random.PRNGKey(0), jllama.PRESETS[name]))
        got = tllama.init(0, tllama.PRESETS[name])
        assert jax.tree.structure(got) == jax.tree.structure(want), name
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            if w.ndim == 1:
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", PRESETS)
def test_make_apply_matches_jax(name):
    """make_apply's logits (the per-layer tree) and make_apply_stacked's
    (the served form) equal JAX's make_apply within 1e-5."""
    cfg = tllama.PRESETS[name]
    tree = drawn_tree(name, seed=1)
    ids = _ids(cfg, 2, 20)
    want = np.asarray(jllama.make_apply(jllama.PRESETS[name])(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(ids)))
    per_layer = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    got = tllama.make_apply(cfg)(per_layer, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    stacked = tllama.make_apply_stacked(cfg)(
        from_jax_params(tree, cfg, "cpu"), torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(stacked, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("scaling,tol", [(None, 1.2e-7), ("linear", 1.2e-7),
                                         ("ntk", 5e-5)])
def test_rope_tables_match_jax_at_long_positions(scaling, tol):
    """RoPE cos/sin at positions up to 1100 with llama3-8b's theta 500000
    and D=128 equal JAX's: both compute the inverse frequencies and the
    angles in f32 in the same order, to 1 ulp of f32 in [-1, 1] (1.2e-7)
    unscaled and under linear scaling. Under NTK scaling theta is not an
    f32 value, and XLA's f32 pow and torch's differ in the last bit for
    one of the 64 frequencies; at position 1100 that moves its angle by
    about 1100 ulps of the frequency, so cos/sin within 5e-5."""
    cfg = jllama.PRESETS["llama3-8b"]
    if scaling is not None:
        cfg = dataclasses.replace(cfg, rope_scaling=scaling, rope_scale=2.0)
    pos = np.arange(1100)
    jc, js = jllama._rope_tables(cfg, jnp.asarray(pos))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(cfg))
    tc, ts = tllama._rope_tables(tcfg, torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=tol)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=tol)


@pytest.mark.parametrize("name", PRESETS)
def test_forward_with_cache_decodes_incrementally(name):
    """A 12-token prompt then 4 one-token steps through
    forward_with_cache (dense f32 cache at KV heads): every step's logits
    equal the full recompute's last row and JAX's forward_with_cache on
    the same steps, within 1e-5."""
    cfg, jcfg = tllama.PRESETS[name], jllama.PRESETS[name]
    tree = drawn_tree(name, seed=2)
    prep = from_jax_params(tree, cfg, "cpu")
    jprep = jax_prepared(name, tree)
    ids = _ids(cfg, 2, 16, seed=3)
    cache = tllama.init_cache(cfg, 2, 16, torch.float32, "cpu")
    assert cache["k"].shape == (cfg.n_layer, 2, cfg.n_kv_head, 16,
                                cfg.head_dim)
    jcache = jllama.init_cache(jcfg, 2, 16)
    full = tllama.make_apply_stacked(cfg)(prep, torch.from_numpy(ids))
    # one JAX program per chunk width, the start a traced argument
    jfwd = jax.jit(jllama.forward_with_cache, static_argnames=("cfg",))
    for start, stop in [(0, 12)] + [(t, t + 1) for t in range(12, 16)]:
        got, cache = tllama.forward_with_cache(
            prep, torch.from_numpy(ids[:, start:stop]), cache, start, cfg=cfg)
        want, jcache = jfwd(jprep, jnp.asarray(ids[:, start:stop]), jcache,
                            jnp.int32(start), cfg=jcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(got[:, -1].numpy(),
                                   full[:, stop - 1].numpy(), rtol=0,
                                   atol=ATOL)


def round_probs_like_jax(monkeypatch):
    """JAX's float codec rounds the attention probabilities to a bf16
    cache's type before P.V (dnn_tpu/runtime/kvcache.py FloatKV.attend,
    attend_rows); the port's kernels keep them in f32, and so do their
    plain versions, which the CPU runs. Patches the plain versions to
    round as JAX does, so that a bf16 stream can be held identical to
    JAX's: the one place the two are meant to differ."""
    from dnn_tpu_torch.ops.cuda import cached_attention as tca

    plain = tca._scaled_softmax_attend

    def rounded(q, k, v, keep, ks, vs, softcap=None):
        if v.dtype != torch.bfloat16:
            return plain(q, k, v, keep, ks, vs, softcap)
        s = tca.soft_cap(torch.einsum("bhtd,bhsd->bhts", q.float(),
                                      k.float()) / np.sqrt(q.shape[-1]),
                         softcap)
        p = torch.softmax(torch.where(keep, s, -1e30), dim=-1)
        return torch.einsum("bhts,bhsd->bhtd",
                            p.to(torch.bfloat16).float(), v.float())

    monkeypatch.setattr(tca, "_scaled_softmax_attend", rounded)


@pytest.mark.parametrize("name,kv_dtype", [
    *[(n, "f32") for n in PRESETS], ("llama-test", "bf16"),
    ("gemma-test", "bf16"), ("llama-test", "int8"), ("qwen3-test", "int8")])
def test_make_generate_greedy_matches_jax(name, kv_dtype, monkeypatch):
    """Greedy tokens of the solo decoder equal JAX's llama.make_generate
    (f32, bf16 and int8 caches) on a 2-row batch of 11-token prompts, 9
    new tokens; the runtime/generate entry point dispatches the same.
    bf16: the port's own stream equals its plain bf16 cache loop
    (chip_smoke.reference_greedy_cache); with the probabilities rounded
    to bf16 as JAX rounds them (round_probs_like_jax) it equals JAX's."""
    import chip_smoke
    from dnn_tpu_torch.runtime.generate import make_generate

    cfg = tllama.PRESETS[name]
    tree = drawn_tree(name, seed=4, scale=0.3)
    ids = _ids(cfg, 2, 11, seed=5)
    jkv = {"f32": None, "bf16": jnp.bfloat16, "int8": "int8"}[kv_dtype]
    want = np.asarray(jllama.make_generate(
        jllama.PRESETS[name], max_new_tokens=9, kv_dtype=jkv)(
        jax_prepared(name, tree), jnp.asarray(ids), jax.random.PRNGKey(0)))
    prep = from_jax_params(tree, cfg, "cpu")

    def generate():
        return tllama.make_generate(cfg, max_new_tokens=9, kv_dtype=kv_dtype,
                                    device="cpu")(prep, ids).numpy()

    got = generate()
    via = make_generate(cfg, max_new_tokens=9, kv_dtype=kv_dtype,
                        device="cpu")(prep, ids).numpy()
    np.testing.assert_array_equal(via, got)
    assert len(set(got[0].tolist())) > 2  # varied tokens, not one id
    if kv_dtype == "bf16":
        for row in range(2):
            toks, _ = chip_smoke.reference_greedy_cache(
                prep, cfg, ids[row].tolist(), 9, torch.device("cpu"), "bf16")
            assert toks == got[row].tolist()
        round_probs_like_jax(monkeypatch)
        got = generate()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["llama-test", "gemma-test", "phi-test"])
@pytest.mark.parametrize("parts", [2, 4])
def test_partition_stages_compose_to_the_model(name, parts):
    """make_partition's stages, run in turn on their slices of the
    per-layer tree, give make_apply's logits bit for bit, and JAX's
    stages' within 1e-5 (gemma-test is tied: its last stage holds
    wte)."""
    cfg = tllama.PRESETS[name]
    tree = drawn_tree(name, seed=6)
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    spec = get_model(name)
    ids = torch.from_numpy(_ids(cfg, 1, 10, seed=7))
    x = ids
    stages = spec.extras["make_partition"]()(parts)
    for st in stages:
        x = st.apply(st.slice_params(params), x)
    np.testing.assert_array_equal(
        x.numpy(), tllama.make_apply(cfg)(params, ids).numpy())
    jx = jnp.asarray(ids.numpy())
    jtree = jax.tree.map(jnp.asarray, tree)
    for st in jllama.make_partition(jllama.PRESETS[name])(parts):
        jx = st.apply(st.slice_params(jtree), jx)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=ATOL)
    if cfg.tie_word_embeddings:
        assert "wte" in stages[-1].param_keys
        assert "lm_head" not in stages[-1].param_keys


@pytest.mark.parametrize("name,item", [
    ("mistral-test", "item 2"), ("gemma2-test", "item 2"),
    ("softcap", "item 7, logit softcapping"),
    ("ffn", "item 7, the MoE families")])
def test_unported_switches_raise_naming_their_item(name, item):
    """An ffn override (the MoE hook, ROADMAP item 7's MoE families)
    raises NotImplementedError naming its item when the model is built or
    served, not when get_model returns it. Sliding windows (Mistral,
    Gemma-2; item 2) and softcapping (item 7's softcapping) are ported:
    for them every entry point builds and runs, and LlamaFamilyRows
    carries JAX's adapter attributes (window, alt_window, softcap,
    paged_ok) for the batcher."""
    from dnn_tpu.models import llama as jl
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    ffn = None
    if name == "softcap":
        cfg = dataclasses.replace(tllama.PRESETS["llama-test"],
                                  attn_softcap=50.0)
    elif name == "ffn":
        cfg, ffn = tllama.PRESETS["llama-test"], object()
    else:
        cfg = get_model(name).config
    params = tllama.init(0, cfg)
    prep = from_jax_params(params, cfg, "cpu")
    ids = torch.zeros((1, 4), dtype=torch.long)
    if ffn is not None:
        with pytest.raises(NotImplementedError, match=item):
            tllama.LlamaFamilyRows(cfg, ffn=ffn)
        with pytest.raises(NotImplementedError, match=item):
            tllama.check_ported(cfg, ffn)
        # the batcher refuses an ffn beside a family adapter, as JAX's
        with pytest.raises(ValueError, match="family adapter"):
            ContinuousBatcher(cfg, prep, family=tllama.LlamaFamilyRows(cfg),
                              ffn=ffn, device="cpu")
        return
    tllama.check_ported(cfg)
    fam = tllama.LlamaFamilyRows(cfg)
    jcfg = dataclasses.replace(jl.PRESETS["llama-test"], attn_softcap=50.0) \
        if name == "softcap" else jl.PRESETS[name]
    jfam = jl.LlamaFamilyRows(jcfg)
    for attr in ("window", "alt_window", "softcap", "paged_ok"):
        assert getattr(fam, attr) == getattr(jfam, attr), attr
    tensors = jax.tree.map(torch.from_numpy, params)
    tllama.make_generate(cfg, max_new_tokens=2, device="cpu")(prep, ids)
    assert tllama.make_apply(cfg)(tensors, ids).shape == (1, 4,
                                                           cfg.vocab_size)
    assert len(tllama.make_partition(cfg)(2)) == 2
    tllama.forward_with_cache(
        prep, ids, tllama.init_cache(cfg, 1, 8, torch.float32, "cpu"), 0,
        cfg=cfg)
    b = ContinuousBatcher(cfg, prep, device="cpu", max_len=16,
                          prompt_pad=8, block_len=8)
    rid = b.submit(np.arange(1, 5), 3)
    assert len(b.drain()[rid]) == 3


HF_FAMILIES = [("llama-test", "LlamaForCausalLM"),
               ("qwen2-test", "Qwen2ForCausalLM"),
               ("phi-test", "PhiForCausalLM"),
               ("mistral-test", "MistralForCausalLM")]
# loaded, not exported: the exporters omit a tied lm_head, as JAX's do,
# and transformers' strict load wants one
HF_TIED_FAMILIES = [("gemma2-test", "Gemma2ForCausalLM")]


def _hf_model(name, cls_name, seed):
    """A tiny random HF model of preset `name` (JAX's to_hf_config), every
    parameter redrawn (biases and norm weights too) so that each one
    acts."""
    import transformers

    hf = getattr(transformers, cls_name)(jllama.to_hf_config(
        jllama.PRESETS[name], attn_implementation="eager")).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for pname, p in hf.named_parameters():
            noise = torch.randn(p.shape, generator=g)
            if p.dim() >= 2:
                p.copy_(noise * 0.05)
            else:  # norm weights about one, biases about zero
                p.copy_(noise * 0.1 + (1.0 if pname.endswith("norm.weight")
                                       or "layernorm.weight" in pname
                                       else 0.0))
    return hf


@pytest.mark.parametrize("fmt", ["safetensors", "pth"])
@pytest.mark.parametrize("name,cls_name", HF_FAMILIES + HF_TIED_FAMILIES)
def test_hf_checkpoint_loads_through_the_registry(tmp_path, name, cls_name,
                                                  fmt):
    """A tiny random HF LLaMA (GQA), Qwen2 (q/k/v biases), Phi (parallel
    block, partial rotary, LayerNorms), Mistral (a sliding window) or
    Gemma-2 (four norms, softcaps, the window on even layers) checkpoint,
    saved as safetensors and as .pth, loads through the port's
    load_checkpoint and the registry's convert_state_dict: the tree
    equals the JAX converter's bit for bit, and the port's logits on 24
    tokens (past the windows of 16) equal the HF model's within 1e-4 (two
    f32 implementations, different sum orders)."""
    from dnn_tpu.io import checkpoint as jckpt
    from dnn_tpu.registry import get_model as jax_get_model
    from dnn_tpu_torch.io.checkpoint import load_checkpoint

    hf = _hf_model(name, cls_name, seed=8)
    if fmt == "safetensors":
        hf.save_pretrained(tmp_path, safe_serialization=True)
        path = str(tmp_path / "model.safetensors")
    else:
        path = str(tmp_path / "model.pth")
        torch.save(hf.state_dict(), path)
    cfg = tllama.PRESETS[name]
    tree = get_model(name).convert_state_dict(load_checkpoint(path))
    want = jax_get_model(name).convert_state_dict(jckpt.load_checkpoint(path))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    ids = _ids(cfg, 2, 24, seed=9)
    got = tllama.make_apply_stacked(cfg)(from_jax_params(tree, cfg, "cpu"),
                                         torch.from_numpy(ids)).numpy()
    with torch.no_grad():
        theirs = hf(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(got, theirs, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", PRESETS + ["gemma2-test"])
def test_exporter_equals_jax_bit_for_bit(name):
    """llama_state_dict_from_params (phi_state_dict_from_params for the
    parallel block) on a port tree — per-layer and the stacked served
    form — equals JAX's exporter's state dict bit for bit, and
    llama_params_from_state_dict inverts it."""
    from dnn_tpu.io import torch_export as jexport
    from dnn_tpu_torch.io import torch_export as texport

    cfg = tllama.PRESETS[name]
    tree = drawn_tree(name, seed=10)
    want = jexport.llama_state_dict_from_params(tree)
    for params in (tree, from_jax_params(tree, cfg, "cpu")):
        got = texport.llama_state_dict_from_params(params)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)
    back = get_model(name).convert_state_dict(
        {k: v.numpy() for k, v in got.items()})
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(g, w)
    if cfg.parallel_block:
        np.testing.assert_array_equal(
            texport.phi_state_dict_from_params(tree)["lm_head.bias"],
            want["lm_head.bias"])


@pytest.mark.parametrize("name,cls_name", HF_FAMILIES)
def test_exported_checkpoint_loads_into_transformers(tmp_path, name,
                                                     cls_name):
    """The hand-back loop: a port tree exported with save_pth loads into
    the matching transformers class (strict), whose logits equal the
    port's within 1e-4."""
    import transformers

    from dnn_tpu_torch.io.torch_export import (
        llama_state_dict_from_params,
        save_pth,
    )

    cfg = tllama.PRESETS[name]
    tree = drawn_tree(name, seed=11)
    path = str(tmp_path / f"{name}.pth")
    save_pth(path, llama_state_dict_from_params(tree))
    hf = getattr(transformers, cls_name)(jllama.to_hf_config(
        jllama.PRESETS[name], attn_implementation="eager")).eval()
    hf.load_state_dict(torch.load(path, map_location="cpu",
                                  weights_only=True), strict=True)
    ids = _ids(cfg, 2, 12, seed=12)
    ours = tllama.make_apply_stacked(cfg)(from_jax_params(tree, cfg, "cpu"),
                                          torch.from_numpy(ids)).numpy()
    with torch.no_grad():
        theirs = hf(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)


def test_layer_windows_match_jax():
    """layer_windows, the port's copy: the window on even layers and
    block_size on odd ones for gemma2-test, None for uniform attention,
    and the same ValueError for an alternating config without a window."""
    g2 = tllama.PRESETS["gemma2-test"]
    assert tllama.layer_windows(g2) == np.asarray(
        jllama.layer_windows(jllama.PRESETS["gemma2-test"])).tolist()
    assert tllama.layer_windows(tllama.PRESETS["llama-test"]) is None
    with pytest.raises(ValueError, match="sliding_window"):
        tllama.layer_windows(dataclasses.replace(g2, sliding_window=None))


def test_gemma_head_dim_256_refused_on_the_card_only():
    """Gemma-1's head dim 256 (gemma-2b) is past the kernels' D <= 128:
    the wrappers' kernel check names the head dims they take (checked
    here without a card by handing them a tensor of that shape through
    the check itself); on the CPU the plain version runs."""
    from dnn_tpu_torch.ops.cuda import cached_attention as tca

    q = torch.zeros(1, 8, 2, 256)
    k = torch.zeros(1, 1, 16, 256)
    with pytest.raises(ValueError, match=r"head dim in \(32, 64, 128\)"):
        tca._check_kernel_args((q, k), d=256, dims=(32, 64, 128))
    out = tca.cached_attention(q, k, k, torch.zeros(1, dtype=torch.int32))
    assert out.shape == q.shape
    assert tllama.PRESETS["gemma-2b"].head_dim == 256
