"""The port's staged pipeline on the CPU against the JAX package: configs,
registry, the cifar_cnn / mlp / GPT partitions, the relay executor and
the engine, on the same numpy parameters and inputs.

Tolerances: 1e-5 absolute on f32 stage outputs and probabilities (two
frameworks' f32 convolutions and matmuls summed in different orders);
2e-2 x the JAX output's max |value| with bf16 compute (bf16 operands
rounded the same, products summed in different orders). Argmaxes and
greedy tokens must be identical."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.config import TopologyConfig as JaxConfig
from dnn_tpu.registry import get_model as jax_get_model
from dnn_tpu.runtime.engine import PipelineEngine as JaxEngine
from dnn_tpu_torch.config import TopologyConfig, config_device
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.parallel.pipeline import (
    RelayExecutor,
    merge_microbatches,
    place,
    split_microbatches,
)
from dnn_tpu_torch.registry import available_models, get_model
from dnn_tpu_torch.runtime.engine import PipelineEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.json"))
F32_TOL = 1e-5
BF16_REL = 2e-2


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("distributed", None)
    return d


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_configs_parse_like_jax(path):
    """Every shipped config: the same fields in both packages; a
    `distributed` section raises NotImplementedError naming the ROADMAP
    item, and the rest of the config still matches JAX's."""
    raw = json.loads(path.read_text())
    want = _fields(JaxConfig.from_dict(raw))
    if raw.get("distributed") is not None:
        with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
            TopologyConfig.from_dict(raw)
        raw = {k: v for k, v in raw.items() if k != "distributed"}
    got = _fields(TopologyConfig.from_dict(raw))
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


@pytest.mark.parametrize("bad", [
    {"num_parts": 0},
    {"nodes": [{"id": "a", "part_index": 1}], "num_parts": 1},
    {"nodes": [{"id": "a", "part_index": 0}, {"id": "a", "part_index": 1}]},
    {"runtime": "mesh"},
    {"transport": "rdma"},
    {"nodes": [{"id": "a", "part_index": 0}], "return_to_node_id": "b"},
])
def test_config_validation_matches_jax(bad):
    with pytest.raises(ValueError) as jerr:
        JaxConfig.from_dict(bad)
    with pytest.raises(ValueError) as terr:
        TopologyConfig.from_dict(bad)
    assert str(terr.value) == str(jerr.value)


def test_config_lookups_and_device():
    cfg = TopologyConfig.from_json(str(ROOT / "configs/gpt2_8stage.json"))
    n3 = cfg.node_by_id("node3")
    assert (n3.part_index, n3.port) == (2, 50053)
    assert cfg.next_node(n3).id == "node4"
    assert cfg.next_node(cfg.node_by_part(7)) is None
    assert cfg.return_node().id == "node1"
    assert config_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        for kind in ("tpu", "gpu"):
            with pytest.raises(RuntimeError, match="CUDA"):
                config_device(kind)


def test_registry_families():
    names = available_models()
    assert {"cifar_cnn", "mlp", "gpt2", "gpt2-medium", "gpt2-test"} <= set(names)
    for name in names:
        if name.startswith("gpt2"):
            j, t = jax_get_model(name).config, get_model(name).config
            assert (j.block_size, j.vocab_size, j.n_layer, j.n_head,
                    j.n_embd) == (t.block_size, t.vocab_size, t.n_layer,
                                  t.n_head, t.n_embd)
        assert get_model(name).supported_parts == \
            jax_get_model(name).supported_parts
    # the LLaMA family is registered since slice 12 (its parity tests
    # are tests/test_torch_llama.py); the MoE families are not
    assert {"llama-test", "llama3-8b", "phi-test"} <= set(names)
    for other in ("gpt-moe-test", "mixtral-test"):
        with pytest.raises(KeyError, match="Queue 1 item 9"):
            get_model(other)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _stagewise(model, n, params, x, *, tparts=None, jparts=None):
    """Each stage's output in both packages, fed the same input."""
    jstages = jparts or jax_get_model(model).partition(n)
    tstages = tparts or get_model(model).partition(n)
    tparams = place(params, "cpu")
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    outs = []
    for js, ts in zip(jstages, tstages, strict=True):
        assert js.param_keys == ts.param_keys
        jx = js.apply(js.slice_params(params), jx)
        tx = ts.apply(ts.slice_params(tparams), tx)
        outs.append((np.asarray(jnp.asarray(jx, jnp.float32)),
                     tx.float().numpy()))
    return outs


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_cifar_stages_match_jax(n):
    params = get_model("cifar_cnn").init(3)
    x = get_model("cifar_cnn").example_input(2, seed=5)
    outs = _stagewise("cifar_cnn", n, params, x)
    for want, got in outs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    want, got = outs[-1]
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    whole = get_model("cifar_cnn").apply(place(params, "cpu"),
                                         torch.as_tensor(x))
    assert torch.equal(whole, torch.as_tensor(got))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_mlp_stages_match_jax(n):
    params = get_model("mlp").init(1)
    x = get_model("mlp").example_input(3, seed=2)
    outs = _stagewise("mlp", n, params, x)
    for want, got in outs:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    np.testing.assert_array_equal(outs[-1][1].argmax(1),
                                  outs[-1][0].argmax(1))


def test_converters_of_the_families_match_jax():
    """cifar_cnn's and mlp's convert_state_dict on one torch-layout dict."""
    rng = np.random.default_rng(0)
    sd = {"fc0.weight": rng.standard_normal((512, 784), dtype=np.float32),
          "fc0.bias": rng.standard_normal(512, dtype=np.float32),
          "fc1.weight": rng.standard_normal((256, 512), dtype=np.float32),
          "fc1.bias": rng.standard_normal(256, dtype=np.float32),
          "fc2.weight": rng.standard_normal((10, 256), dtype=np.float32),
          "fc2.bias": rng.standard_normal(10, dtype=np.float32)}
    got = get_model("mlp").convert_state_dict(sd)
    want = _np_tree(jax_get_model("mlp").convert_state_dict(sd))
    jax.tree.map(np.testing.assert_array_equal, got, want)


def _gpt_params(seed=0, scale=1.0):
    return jax.tree.map(
        lambda a: np.asarray(a) * (scale if a.ndim >= 2 else 1.0),
        jax_get_model("gpt2-test").init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_gpt_partition_matches_jax(n, dtype):
    from dnn_tpu.models import gpt as jgpt

    cfg_j, cfg_t = jgpt.PRESETS["gpt2-test"], tgpt.PRESETS["gpt2-test"]
    jcd, tcd = ((None, None) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    params = _gpt_params()
    ids = np.random.default_rng(n).integers(0, 256, (2, 24)).astype(np.int32)
    outs = _stagewise(
        "gpt2-test", n, params, ids,
        jparts=jgpt.make_partition(cfg_j, compute_dtype=jcd)(n),
        tparts=tgpt.make_partition(cfg_t, compute_dtype=tcd)(n))
    for i, (want, got) in enumerate(outs):
        assert got.shape == want.shape
        tol = F32_TOL if dtype == "f32" else BF16_REL * np.abs(want).max()
        err = np.abs(got - want).max()
        assert err <= tol, f"stage {i}: max abs err {err:.3e} > {tol:.3e}"


def _cpu_config(model, n, **kw):
    nodes = [{"id": f"node{i + 1}", "part_index": i,
              "address": f"127.0.0.1:{50600 + i}"} for i in range(n)]
    return {"nodes": nodes, "model": model, "num_parts": n,
            "device_type": "cpu", "runtime": "relay", **kw}


def test_relay_executor_equals_the_whole_model():
    for model, n, x in (
            ("cifar_cnn", 4, get_model("cifar_cnn").example_input(2)),
            ("gpt2-test", 3, np.arange(40, dtype=np.int32).reshape(2, 20))):
        spec = get_model(model)
        params = spec.init(0)
        stages = spec.partition(n)
        relay = RelayExecutor([s.apply for s in stages],
                              [s.slice_params(params) for s in stages],
                              ["cpu"])
        y = relay(x, record_timings=True)
        assert len(relay.last_stage_times) == n
        with torch.no_grad():
            want = spec.apply(place(params, "cpu"), torch.as_tensor(x))
        assert torch.equal(y, want), model
    mb = split_microbatches(torch.arange(24).reshape(6, 4), 3)
    assert mb.shape == (3, 2, 4)
    assert torch.equal(merge_microbatches(mb), torch.arange(24).reshape(6, 4))
    with pytest.raises(ValueError, match="not divisible"):
        split_microbatches(torch.zeros(5, 2), 2)


@pytest.mark.parametrize("model,n", [("cifar_cnn", 2), ("cifar_cnn", 4),
                                     ("mlp", 3), ("gpt2-test", 2),
                                     ("llama-test", 2), ("gemma-test", 3)])
def test_engine_roles_match_jax(model, n):
    """role full (relay) and a chain of role-stage engines give the same
    output, bit for bit, and JAX's engine's within F32_TOL; predict is
    JAX's."""
    raw = _cpu_config(model, n)
    spec = get_model(model)
    params = spec.init(4)
    x = (spec.example_input(1, seq_len=16)
         if model.startswith(("gpt", "llama", "gemma"))
         else spec.example_input(1, seed=6))
    full = PipelineEngine(TopologyConfig.from_dict(raw), params=params)
    assert full.runtime == "relay"
    y = full.run(x)
    staged = torch.as_tensor(x)
    for part in range(n):
        eng = PipelineEngine(TopologyConfig.from_dict(raw), params=params,
                             role="stage")
        staged = eng.run_stage(part, staged)
    assert torch.equal(staged, y)
    jeng = JaxEngine(JaxConfig.from_dict(raw), params=jax.tree.map(
        jnp.asarray, params))
    want = np.asarray(jeng.run(jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=F32_TOL)
    assert full.predict(x) == jeng.predict(jnp.asarray(x))
    with pytest.raises(RuntimeError, match="role='stage'"):
        eng.run(x)


def test_engine_spmd_on_one_device_raises_as_jax():
    raw = _cpu_config("cifar_cnn", 2, runtime="spmd")
    params = get_model("cifar_cnn").init(0)
    with pytest.raises(ValueError) as jerr:
        JaxEngine(JaxConfig.from_dict(raw), devices=jax.devices()[:1],
                  params=jax.tree.map(jnp.asarray, params))
    with pytest.raises(ValueError) as terr:
        PipelineEngine(TopologyConfig.from_dict(raw), params=params)
    assert str(terr.value) == str(jerr.value)
    assert "runtime=spmd needs >= 2 devices, have 1" in str(terr.value)


def test_engine_loads_model_weights_and_declines_lora(tmp_path):
    from dnn_tpu_torch.io import checkpoint as ckpt

    params = get_model("cifar_cnn").init(9)
    path = tmp_path / "cifar.npz"
    ckpt.save_npz(str(path), ckpt.params_to_flat(params))
    raw = _cpu_config("cifar_cnn", 2, model_weights=str(path))
    eng = PipelineEngine(TopologyConfig.from_dict(raw))
    jax.tree.map(np.testing.assert_array_equal, eng.params, params)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        PipelineEngine(TopologyConfig.from_dict(raw), lora_path="a.npz")
    with pytest.raises(ValueError, match="GPT-family"):
        eng.generate([[1, 2]], max_new_tokens=2)


def test_engine_generate_equals_jax_engine():
    """engine.generate greedy on gpt2-test (weights x15, so the argmaxes
    are decisive) equals JAX's PipelineEngine.generate token for token;
    bf16 compute surfaces the port's NotImplementedError."""
    params = _gpt_params(seed=1, scale=15.0)
    raw = _cpu_config("gpt2-test", 2)
    prompt = np.random.default_rng(3).integers(0, 256, (1, 11)).astype(
        np.int32)
    jeng = JaxEngine(JaxConfig.from_dict(raw),
                     params=jax.tree.map(jnp.asarray, params))
    want = np.asarray(jeng.generate(prompt, max_new_tokens=12))
    eng = PipelineEngine(TopologyConfig.from_dict(raw), params=params)
    got = eng.generate(prompt, max_new_tokens=12)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want[0].tolist())) > 1
    bf16 = PipelineEngine(TopologyConfig.from_dict(
        {**raw, "dtype": "bfloat16"}), params=params)
    with pytest.raises(NotImplementedError, match="item 4"):
        bf16.generate(prompt, max_new_tokens=2)


def test_engine_generate_llama_equals_jax_engine():
    """engine.generate greedy on llama-test in 2 parts (matrices x15, as
    for gpt2-test) equals JAX's PipelineEngine.generate token for token:
    the port's make_generate over a KV-head cache (K5 with grouped
    heads, K6 at 2 rows a KV head, on the card)."""
    params = jax.tree.map(
        lambda a: a * np.float32(15.0 if a.ndim >= 2 else 1.0),
        get_model("llama-test").init(2))
    raw = _cpu_config("llama-test", 2)
    prompt = np.random.default_rng(4).integers(0, 256, (1, 9)).astype(
        np.int32)
    jeng = JaxEngine(JaxConfig.from_dict(raw),
                     params=jax.tree.map(jnp.asarray, params))
    want = np.asarray(jeng.generate(prompt, max_new_tokens=10))
    eng = PipelineEngine(TopologyConfig.from_dict(raw), params=params)
    got = eng.generate(prompt, max_new_tokens=10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want[0].tolist())) > 1
