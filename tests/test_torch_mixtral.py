"""The port's llama-MoE family (models/llama_moe.py: Mixtral, Qwen2-MoE)
on the CPU against the JAX package's, on the same weights
(mixtral-test, qwen2moe-test: every leaf drawn from a numpy seed, biases
and norm scales too, crossing through convert.from_jax_params).

Logits: 1e-5 absolute in f32, as tests/test_torch_llama.py holds the
LLaMA family. Greedy tokens identical. The presets route at capacity
factor n_expert (no drop), as JAX's parity configs do; drops are held
on the GPT-MoE family (tests/test_torch_serving.py). The HF Mixtral and
Qwen2-MoE checkpoints are read in tests/test_torch_llama.py
(test_hf_checkpoint_loads_through_the_registry)."""

import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.models import gpt as jgpt
from dnn_tpu.models import llama_moe as jlm
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import llama as tllama
from dnn_tpu_torch.models import llama_moe as tlm
from dnn_tpu_torch.runtime.generate import make_generate
from dnn_tpu_torch.runtime.serving import ContinuousBatcher
from test_torch_llama import one_torch_thread  # noqa: F401 (autouse)

PRESETS = ["mixtral-test", "qwen2moe-test"]
ATOL = 1e-5
POOL = dict(slots=3, max_len=64, prompt_pad=16, block_len=8)


def drawn(name, seed=0):
    """JAX's init tree of preset `name`, matrices redrawn N(0, 0.1),
    norm scales 1 + N(0, 0.1), biases N(0, 0.1): numpy leaves."""
    tree = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(seed),
                                           jlm.PRESETS[name]))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim >= 2:
            return noise * np.float32(0.1)
        ident = 1.0 if path[-1].key == "scale" else 0.0
        return (ident + 0.1 * noise).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module", params=PRESETS)
def model(request):
    """(name, numpy tree, JAX prepared, port prepared)."""
    name = request.param
    tree = drawn(name)
    cfg = jlm.PRESETS[name]
    return (name, tree, jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree),
                                             cfg),
            from_jax_params(tree, tlm.PRESETS[name], "cpu"))


def _ids(cfg, b, t, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t))


# the script's (prompt length, new tokens), prompt i drawn from seed i
SCRIPT = ((5, 10), (20, 12), (37, 9))


def _script(b):
    """tests/test_torch_serving.py's script: prompts of 5 / 20 / 37
    tokens, the third admitted mid-decode."""
    rng = np.random.default_rng
    (n0, k0), (n1, k1), (n2, k2) = SCRIPT
    r0 = b.submit(rng(0).integers(0, 256, n0), k0)
    r1 = b.submit(rng(1).integers(0, 256, n1), k1)
    for _ in range(3):
        b.step()
    r2 = b.submit(rng(2).integers(0, 256, n2), k2)
    res = b.drain()
    return [np.asarray(res[r]) for r in (r0, r1, r2)]


def test_logits_and_dispatchers_match_jax(model):
    """The stateless forward through llama_moe.make_apply, plain
    llama.make_apply and the stacked form (the config resolves the
    experts: JAX tests/test_mixtral.py:129) against JAX's; the pipeline
    stages (1 and 3 parts) chained; beam search at beam 1 equals greedy;
    make_embed's mean-pooled vectors (rows of 16 and 9 real tokens) within
    1e-5 of JAX's make_embed, which also routes through the experts."""
    from dnn_tpu.runtime.embeddings import make_embed as jembed
    from dnn_tpu_torch.registry import get_model
    from dnn_tpu_torch.runtime.beam import make_beam_generate
    from dnn_tpu_torch.runtime.embeddings import make_embed

    name, tree, jprep, tprep = model
    cfg = tlm.PRESETS[name]
    ids = _ids(cfg, 2, 16, 1)
    want = np.asarray(jax.jit(jlm.make_apply(jlm.PRESETS[name]))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(ids)))
    per_layer = jax.tree.map(torch.from_numpy, tree)
    t_ids = torch.from_numpy(ids)
    with torch.no_grad():
        for got in (tlm.make_apply(cfg)(per_layer, t_ids),
                    tllama.make_apply(cfg)(per_layer, t_ids),
                    tllama.make_apply_stacked(cfg)(tprep, t_ids)):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
        for parts in (1, 3):
            x = t_ids
            for st in get_model(name).partition(parts):
                x = st.apply(st.slice_params(per_layer), x)
            np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=ATOL)
    greedy = make_generate(cfg, max_new_tokens=5, device="cpu")(
        tprep, ids[:1, :8])
    beam = make_beam_generate(cfg, max_new_tokens=5, beam_size=1,
                              device="cpu")(tprep, ids[:1, :8])
    np.testing.assert_array_equal(beam.numpy(), greedy.numpy())
    lengths = np.asarray([16, 9])
    vec = make_embed(cfg, pooling="mean")(tprep, ids, lengths)
    jvec = np.asarray(jembed(jlm.PRESETS[name], pooling="mean")(
        jprep, jnp.asarray(ids), jnp.asarray(lengths)))
    assert vec.shape == jvec.shape == (2, cfg.n_embd)
    np.testing.assert_allclose(vec.numpy(), jvec, rtol=1e-5, atol=1e-5)


def test_generate_and_batcher_match_jax(model):
    """Greedy streams against JAX's cached decode, its LlamaFamilyRows
    batcher on the dense pool running the script: the port's batcher on
    the paged and the dense pool, and make_generate (the solo decoder) on
    each of the script's prompts alone -- the presets cannot drop a
    selection, so a prompt's stream does not depend on its batch-mates.
    The int8 stacks' quantizer is held bit for bit in test_torch_moe.py
    and their serving in test_node_serve_lm_serves_mixtral_int8."""
    from dnn_tpu.models import llama as jl
    from dnn_tpu.runtime.serving import ContinuousBatcher as JaxBatcher

    name, tree, jprep, tprep = model
    jcfg, cfg = jlm.PRESETS[name], tlm.PRESETS[name]
    jwant = _script(JaxBatcher(jcfg, jprep, kv="dense",
                               family=jl.LlamaFamilyRows(jcfg), **POOL))
    for kv in ("paged", "dense"):
        b = ContinuousBatcher(cfg, tprep, kv=kv, device="cpu", **POOL)
        assert b.paged == (kv == "paged")
        for w, g in zip(jwant, _script(b)):
            np.testing.assert_array_equal(g, w)
    for seed, (n, new), w in zip(range(3), SCRIPT, jwant):
        prompt = np.random.default_rng(seed).integers(0, 256, n)
        got = make_generate(cfg, max_new_tokens=new, device="cpu")(
            tprep, prompt[None])
        np.testing.assert_array_equal(got.numpy()[0], w)


def test_speculative_paths_route_through_the_experts(model):
    """A MoE target drafted by gpt2-test: the solo speculative decoder's
    greedy tokens equal the target's make_generate, and the speculative
    batcher (its verify rows routed through the experts) serves the
    plain batcher's streams."""
    from dnn_tpu_torch.models import gpt as tgpt
    from dnn_tpu_torch.runtime.serving_spec import SpeculativeBatcher
    from dnn_tpu_torch.runtime.speculative import make_speculative_generate

    name, _, _, tprep = model
    cfg = tlm.PRESETS[name]
    dcfg = tgpt.PRESETS["gpt2-test"]
    dprep = from_jax_params(tgpt.init(4, dcfg), dcfg, "cpu")
    ids = _ids(cfg, 1, 8, 3)
    want = make_generate(cfg, max_new_tokens=8, device="cpu")(tprep, ids)
    got = make_speculative_generate(cfg, dcfg, max_new_tokens=8, k=3,
                                    device="cpu")(tprep, dprep, ids)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    pool = dict(slots=2, max_len=64, prompt_pad=16)
    prompts = [_ids(cfg, 1, n, 5 + n)[0] for n in (6, 19)]

    def serve(b):
        rids = [b.submit(p, 7) for p in prompts]
        res = b.drain()
        return [np.asarray(res[r]) for r in rids]

    plain = serve(ContinuousBatcher(cfg, tprep, kv="dense", device="cpu",
                                    **pool))
    spec = serve(SpeculativeBatcher(cfg, tprep, dcfg, dprep, spec_k=3,
                                    device="cpu", **pool))
    for a, b in zip(spec, plain):
        np.testing.assert_array_equal(a, b)


def test_init_prepared_is_the_quantized_served_tree():
    """init_prepared draws, quantizes and stacks block by block: its
    result equals quantize_gpt(from_jax_params(init(seed, device=...)))
    bit for bit (int8), and from_jax_params at bf16 compute of the f32
    draw and of the bf16 draw (`dtype`, what `node --serve_lm` draws in
    bf16 compute); init's tree is JAX's (leaves, shapes)."""
    from dnn_tpu_torch.quant import quantize_gpt

    for name in PRESETS:
        cfg = tlm.PRESETS[name]
        want_tree = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0),
                                                    jlm.PRESETS[name]))
        tree = tlm.init(2, cfg, device="cpu")
        assert jax.tree.structure(tree) == jax.tree.structure(want_tree)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want_tree)):
            assert tuple(a.shape) == b.shape
        bf16 = torch.bfloat16
        for weights, cdt, dt in (("int8", None, None), ("f32", bf16, None),
                                 ("f32", bf16, bf16)):
            got = tlm.init_prepared(2, cfg, "cpu", compute_dtype=cdt,
                                    weights=weights, dtype=dt)
            want = from_jax_params(
                tree if dt is None else tlm.init(2, cfg, device="cpu",
                                                 dtype=dt), cfg, "cpu", cdt)
            if weights == "int8":
                want = quantize_gpt(want)
            assert jax.tree.structure(got) == jax.tree.structure(want)
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                assert a.dtype == b.dtype and torch.equal(a, b)


def test_node_serve_lm_serves_mixtral_int8(tmp_path):
    """`python -m dnn_tpu_torch.node --serve_lm --weights int8` on
    mixtral-test (a real process; its random weights drawn, quantized and
    stacked block by block on its device, engine.served_params through the
    spec's init_prepared, expert stacks included)
    answers make_generate's tokens over init_prepared(weights="int8") of
    the same seed, and drains on SIGTERM."""
    from dnn_tpu_torch.comm.client import NodeClient

    with __import__("socket").socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"model": "mixtral-test", "nodes": [
        {"id": "node1", "part_index": 0, "address": f"127.0.0.1:{port}"}]}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dnn_tpu_torch.node", "--node_id", "node1",
         "--config", str(cfg_path), "--serve_lm", "--device", "cpu",
         "--weights", "int8", "--slots", "2", "--max_len", "64",
         "--prompt_pad", "16", "--block_len", "8", "--seed", "3"],
        cwd=pathlib.Path(__file__).resolve().parents[1],
        env={**os.environ, "OMP_NUM_THREADS": "1"},
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        assert client.wait_healthy(deadline=90)
        cfg = tlm.PRESETS["mixtral-test"]
        prompt = _ids(cfg, 1, 21, 7)[0].astype(np.int32)
        got = client.generate(prompt, max_new_tokens=6)
        client.close()
        prep = tlm.init_prepared(3, cfg, "cpu", weights="int8")
        want = make_generate(cfg, max_new_tokens=6, device="cpu")(
            prep, prompt[None])
        np.testing.assert_array_equal(got, want.numpy()[0])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
