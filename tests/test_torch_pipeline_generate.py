"""Pipeline-parallel decode of the port against the JAX package on the
CPU: `make_pipeline_generate` (GPT at 2, 4 and 8 stages, f32 and int8
cache shards), `llama.make_pipeline_generate` (llama-test, 2 and 4
stages), `generate_moe.make_pipeline_generate_moe` (gpt2-moe-test, 2
stages), the sampled case against the port's `make_generate`, the
engine's spmd decoder, and the refusals.

The port runs on `["cpu"] * S`, JAX on its virtual CPU mesh; one JAX run
a family (at 2 stages) is shared by the port's stage counts (the ring's
arithmetic does not depend on S). Greedy tokens must be identical to
JAX's and to the port's solo decoder; a sampled stream equals the port's
`make_generate` for the same seed (torch.Generator draws, not threefry).
Weights are redrawn at N(0, 0.3) so that streams vary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_tpu.config import TopologyConfig as JaxConfig
from dnn_tpu.models import gpt as jgpt
from dnn_tpu.models import gpt_moe as jgm
from dnn_tpu.models import llama as jllama
from dnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from dnn_tpu.runtime import generate as jgen
from dnn_tpu.runtime import generate_moe as jgen_moe
from dnn_tpu.runtime.engine import PipelineEngine as JaxEngine
from dnn_tpu_torch.config import TopologyConfig
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.models import gpt_moe as tgm
from dnn_tpu_torch.models import llama as tllama
from dnn_tpu_torch.runtime import generate as tgen
from dnn_tpu_torch.runtime.engine import PipelineEngine
from dnn_tpu_torch.runtime.generate_moe import (
    make_generate_moe,
    make_pipeline_generate_moe,
)

from test_torch_llama import drawn_tree, jax_prepared  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: F401,E402 — autouse

NEW = 7
CFG8 = dict(block_size=64, vocab_size=256, n_layer=8, n_head=4, n_embd=64)
JCFG8, TCFG8 = jgpt.GPTConfig(**CFG8), tgpt.GPTConfig(**CFG8)


def _drawn(init, cfg, seed):
    """JAX's init tree for `cfg` with every matrix redrawn N(0, 0.3)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32)
        if a.ndim >= 2 else np.asarray(a),
        init(jax.random.PRNGKey(seed), cfg))


def _ids(b, t, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(
        np.int32)


def _jmesh(n):
    return jmake_mesh({"stage": n}, jax.devices()[:n])


def _jax_ring(prepared, cfg, ids, **kw):
    """JAX's make_pipeline_generate at 2 stages, greedy."""
    mesh = _jmesh(2)
    sb, aux = jgen.prepare_pipeline_stacked(prepared, cfg, mesh)
    return np.asarray(jgen.make_pipeline_generate(
        cfg, mesh, max_new_tokens=NEW, **kw)(sb, aux, jnp.asarray(ids),
                                             jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def gpt8():
    """(port prepared, ids, {kv: JAX tokens}) for the 8-layer GPT."""
    tree = _drawn(jgpt.init, JCFG8, 3)
    ids = _ids(2, 6, 1)
    jprep = jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), JCFG8)
    want = {None: _jax_ring(jprep, JCFG8, ids),
            "int8": _jax_ring(jprep, JCFG8, ids,
                              family=jgen.GPTPipelineFamily(
                                  JCFG8, kv_dtype="int8"))}
    return from_jax_params(tree, TCFG8, "cpu"), ids, want


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("stages", [2, 4, 8])
def test_gpt_ring_matches_jax_and_make_generate(gpt8, stages, kv):
    """Greedy tokens at 2, 4 and 8 stages equal JAX's ring and the port's
    make_generate over the same cache type; each stage's shard holds its
    L / S layers at the cache type."""
    prep, ids, want = gpt8
    mesh = ["cpu"] * stages
    sb, aux = tgen.prepare_pipeline_stacked(prep, TCFG8, mesh)
    assert len(sb) == stages and \
        sb[0]["attn"]["qkv"]["kernel"].shape[0] == 8 // stages
    got = tgen.make_pipeline_generate(TCFG8, mesh, max_new_tokens=NEW,
                                      kv_dtype=kv)(sb, aux, ids)
    solo = tgen.make_generate(TCFG8, max_new_tokens=NEW, kv_dtype=kv,
                              device="cpu")(prep, ids)
    assert got.dtype == torch.int32 and got.shape == (2, NEW)
    np.testing.assert_array_equal(got.numpy(), want[kv])
    assert torch.equal(got, solo)
    assert len(set(got[0].tolist())) > 2  # varied tokens
    fam = tgen.GPTPipelineFamily(TCFG8, kv_dtype=kv)
    shard = fam.stage_cache(8 // stages, 2, 13, torch.device("cpu"))
    assert shard["k"].shape[0] == 8 // stages
    assert shard["k"].dtype == (torch.int8 if kv else torch.float32)


def test_gpt_ring_sampled_and_bf16_equal_make_generate(gpt8):
    """A sampled request equals the port's make_generate draw for draw
    (one torch.Generator on stage 0's device, the same seed); bf16
    compute equals the solo bf16 decoder token for token."""
    prep, ids, _ = gpt8
    mesh = ["cpu"] * 2
    sb, aux = tgen.prepare_pipeline_stacked(prep, TCFG8, mesh)
    kw = dict(max_new_tokens=NEW, temperature=0.8, top_k=40, top_p=0.9)
    got = tgen.make_pipeline_generate(TCFG8, mesh, **kw)(sb, aux, ids, 5)
    want = tgen.make_generate(TCFG8, device="cpu", **kw)(prep, ids, 5)
    assert torch.equal(got, want)
    other = tgen.make_pipeline_generate(TCFG8, mesh, **kw)(sb, aux, ids, 6)
    assert not torch.equal(other, got)
    bf = tgen.make_pipeline_generate(TCFG8, mesh, max_new_tokens=NEW,
                                     compute_dtype=torch.bfloat16)
    solo = tgen.make_generate(TCFG8, max_new_tokens=NEW, device="cpu",
                              compute_dtype=torch.bfloat16)
    assert torch.equal(bf(sb, aux, ids), solo(prep, ids))


def test_llama_ring_matches_jax():
    """llama-test (GQA 4/2) at 2 and 4 stages: JAX's ring's greedy tokens,
    equal to the port's llama.make_generate; shards at KV-head width."""
    name = "llama-test"
    cfg, jcfg = tllama.PRESETS[name], jllama.PRESETS[name]
    tree = drawn_tree(name, seed=4, scale=0.3)
    ids = _ids(2, 6, 2)
    mesh = _jmesh(2)
    sb, aux = jgen.prepare_pipeline_stacked(jax_prepared(name, tree), jcfg,
                                            mesh)
    want = np.asarray(jllama.make_pipeline_generate(
        jcfg, mesh, max_new_tokens=NEW)(sb, aux, jnp.asarray(ids),
                                        jax.random.PRNGKey(0)))
    prep = from_jax_params(tree, cfg, "cpu")
    solo = tllama.make_generate(cfg, max_new_tokens=NEW, device="cpu")(
        prep, ids)
    for stages in (2, 4):
        tsb, taux = tgen.prepare_pipeline_stacked(prep, cfg, ["cpu"] * stages)
        got = tllama.make_pipeline_generate(
            cfg, ["cpu"] * stages, max_new_tokens=NEW)(tsb, taux, ids)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, solo)
    shard = tllama.LlamaPipelineFamily(cfg).stage_cache(
        2, 2, 13, torch.device("cpu"))
    assert shard["k"].shape == (2, 2, cfg.n_kv_head, 13, cfg.head_dim)


def test_moe_ring_matches_jax():
    """gpt2-moe-test on 2 stages (each stage keeps its layers' experts):
    JAX's make_pipeline_generate_moe's greedy tokens, equal to the port's
    make_generate_moe."""
    jcfg, cfg = jgm.PRESETS["gpt2-moe-test"], tgm.PRESETS["gpt2-moe-test"]
    tree = _drawn(jgm.init, jcfg, 6)
    ids = _ids(2, 5, 3)
    mesh = _jmesh(2)
    sb, aux = jgen.prepare_pipeline_stacked(
        jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), jcfg), jcfg,
        mesh)
    want = np.asarray(jgen_moe.make_pipeline_generate_moe(
        jcfg, mesh, max_new_tokens=NEW)(sb, aux, jnp.asarray(ids),
                                        jax.random.PRNGKey(0)))
    prep = from_jax_params(tree, cfg, "cpu")
    tsb, taux = tgen.prepare_pipeline_stacked(prep, cfg, ["cpu"] * 2)
    got = make_pipeline_generate_moe(cfg, ["cpu"] * 2,
                                     max_new_tokens=NEW)(tsb, taux, ids)
    np.testing.assert_array_equal(got.numpy(), want)
    solo = make_generate_moe(cfg, max_new_tokens=NEW, device="cpu")(prep,
                                                                    ids)
    assert torch.equal(got, solo)


def _raw(model, n, **kw):
    return {"nodes": [{"id": f"node{i + 1}", "part_index": i,
                       "address": f"127.0.0.1:{50200 + i}"}
                      for i in range(n)],
            "model": model, "num_parts": n, "device_type": "cpu", **kw}


def test_engine_spmd_decoder_and_refusals():
    """engine.make_generator on spmd decodes through the ring, equal to
    the relay engine's generate; kv_dtype on that path is refused with
    JAX's message; indivisible stages and an overlong request raise as in
    JAX; LlamaPipelineFamily refuses alternating windows and MoE configs
    with JAX's messages."""
    spec_params = tgpt.init(0, tgpt.PRESETS["gpt2-test"])
    raw = _raw("gpt2-test", 2, runtime="spmd")
    eng = PipelineEngine(TopologyConfig.from_dict(raw), params=spec_params,
                         devices=["cpu"] * 2)
    relay = PipelineEngine(TopologyConfig.from_dict({**raw,
                                                     "runtime": "relay"}),
                           params=spec_params)
    ids = _ids(2, 5, 4)
    assert torch.equal(eng.make_generator(max_new_tokens=4)(ids),
                       relay.generate(ids, max_new_tokens=4))
    jeng = JaxEngine(JaxConfig.from_dict(raw), devices=jax.devices()[:2],
                     params=jax.tree.map(jnp.asarray, spec_params))
    with pytest.raises(ValueError) as jerr:
        jeng.make_generator(max_new_tokens=4, kv_dtype="int8")
    with pytest.raises(ValueError) as terr:
        eng.make_generator(max_new_tokens=4, kv_dtype="int8")
    assert str(terr.value) == str(jerr.value)
    tcfg, jcfg = tgpt.PRESETS["gpt2-test"], jgpt.PRESETS["gpt2-test"]
    with pytest.raises(ValueError) as jerr:
        jgen.make_pipeline_generate(jcfg, _jmesh(3), max_new_tokens=2)
    with pytest.raises(ValueError) as terr:
        tgen.make_pipeline_generate(tcfg, ["cpu"] * 3, max_new_tokens=2)
    assert str(terr.value) == str(jerr.value)
    sb, aux = tgen.prepare_pipeline_stacked(spec_params, tcfg, ["cpu"] * 2)
    with pytest.raises(ValueError, match="exceeds block_size 64"):
        tgen.make_pipeline_generate(tcfg, ["cpu"] * 2, max_new_tokens=60)(
            sb, aux, _ids(1, 8, 0))
    for name in ("gemma2-test", "mixtral-test"):
        jcfg = jllama.PRESETS.get(name)
        if jcfg is None:
            from dnn_tpu.models import llama_moe as jlm

            jcfg = jlm.PRESETS[name]
        tcfg = (tllama.PRESETS.get(name)
                or __import__("dnn_tpu_torch.models.llama_moe",
                              fromlist=["PRESETS"]).PRESETS[name])
        with pytest.raises(ValueError) as jerr:
            jllama.LlamaPipelineFamily(jcfg)
        with pytest.raises(ValueError) as terr:
            tllama.LlamaPipelineFamily(tcfg)
        assert str(terr.value) == str(jerr.value)
