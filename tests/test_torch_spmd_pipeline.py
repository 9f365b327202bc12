"""The port's spmd pipeline runtime against the JAX package's on the CPU:
`spmd_pipeline` (the CIFAR CNN, 2 and 4 stages, 1/2/4 microbatches, the
"stage" and "replicated" placements), `spmd_pipeline_stacked` and
`spmd_pipeline_interleaved` (gpt2-test-width block stacks), the engine's
runtime choice (`_pick_runtime`) case by case, and the engine's spmd
runs against the port's relay engine.

The port runs on `devices=["cpu"] * S`, JAX on its 8-device virtual CPU
mesh (tests/conftest.py). One JAX run per case is shared by the port's
variants (JAX's result does not depend on the placement or the split).
Tolerances: CIFAR probabilities within 1e-5 of JAX's (two frameworks'
f32 convolutions); block stacks within 1e-4 (f32 layer norms and
products over 8 layers); against the port's own relay run of the same
microbatch split, bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_tpu.config import TopologyConfig as JaxConfig
from dnn_tpu.models import gpt as jgpt
from dnn_tpu.parallel import pipeline as jpipe
from dnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from dnn_tpu.registry import get_model as jget_model
from dnn_tpu.runtime.engine import PipelineEngine as JaxEngine
from dnn_tpu_torch.config import TopologyConfig
from dnn_tpu_torch.models import gpt
from dnn_tpu_torch.parallel import mesh as tmesh
from dnn_tpu_torch.parallel import pipeline as tpipe
from dnn_tpu_torch.registry import get_model
from dnn_tpu_torch.runtime.engine import PipelineEngine

from test_torch_llama import one_torch_thread  # noqa: F401,E402 — autouse:
# one intra-op thread; the suite's parallel workers oversubscribe the cores

F32_TOL = 1e-5
BLOCK_TOL = 1e-4
# gpt2-test's widths at 8 layers: 2 or 4 stages, 2 virtual stages
CFG8 = dict(block_size=64, vocab_size=256, n_layer=8, n_head=4, n_embd=64)


def _raw(model, n, **kw):
    return {"nodes": [{"id": f"node{i + 1}", "part_index": i,
                       "address": f"127.0.0.1:{50100 + i}"}
                      for i in range(n)],
            "model": model, "num_parts": n, "device_type": "cpu", **kw}


def _jmesh(n):
    return jmake_mesh({"stage": n}, jax.devices()[:n])


@pytest.fixture(scope="module")
def cifar():
    params = get_model("cifar_cnn").init(3)
    x = np.random.default_rng(0).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    return params, x


@pytest.fixture(scope="module")
def cifar_jax(cifar):
    """JAX's spmd_pipeline output per stage count (2 microbatches, auto
    placement)."""
    params, x = cifar
    jp = jax.tree.map(jnp.asarray, params)
    out = {}
    for parts in (2, 4):
        stages = jget_model("cifar_cnn").partition(parts)
        out[parts] = np.asarray(jpipe.spmd_pipeline(
            [s.apply for s in stages], [s.slice_params(jp) for s in stages],
            jnp.asarray(x), mesh=_jmesh(parts), num_microbatches=2))
    return out


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("placement", ["stage", "replicated"])
def test_spmd_pipeline_cifar_matches_jax(cifar, cifar_jax, parts, placement):
    """Every split (1, 2, 4 microbatches) in both placements: within
    1e-5 of JAX's spmd_pipeline, the relay's dtype and shape, and bit for
    bit the port's relay run of the same split."""
    params, x = cifar
    stages = get_model("cifar_cnn").partition(parts)
    fns = [s.apply for s in stages]
    sp = [s.slice_params(params) for s in stages]
    relay = tpipe.RelayExecutor(fns, sp, ["cpu"])
    for m in (1, 2, 4):
        got = tpipe.spmd_pipeline(fns, sp, x, mesh=["cpu"] * parts,
                                  num_microbatches=m,
                                  param_placement=placement)
        assert got.dtype == torch.float32 and got.shape == (4, 10)
        np.testing.assert_allclose(got.numpy(), cifar_jax[parts], rtol=0,
                                   atol=F32_TOL)
        mb = 4 // m
        want = torch.cat([relay(torch.from_numpy(x[i:i + mb]))
                          for i in range(0, 4, mb)])
        assert torch.equal(got, want)


def test_pack_stage_params_round_trip_and_refusals(cifar):
    """pack_stage_params: one row a stage, padded to the widest; each
    stage's tree unpacks to its own values; integer and f64-mixed leaves
    are refused as JAX refuses them."""
    params, _ = cifar
    stages = get_model("cifar_cnn").partition(4)
    sp = [s.slice_params(params) for s in stages]
    packed, metas = tpipe.pack_stage_params(sp)
    jpacked, _ = jpipe.pack_stage_params(sp)
    assert packed.shape == jpacked.shape and packed.dtype == np.float32
    np.testing.assert_array_equal(packed, jpacked)
    rows, metas = tpipe.place_packed((packed, metas), ["cpu"] * 4)
    for tree, row, meta in zip(sp, rows, metas):
        back = tpipe._unpack_stage(row, meta)
        for k, node in tree.items():
            for leaf, v in node.items():
                np.testing.assert_array_equal(back[k][leaf].numpy(), v)
    with pytest.raises(ValueError, match="float leaves only"):
        tpipe.pack_stage_params([{"a": np.zeros(3, np.int32)}])
    with pytest.raises(ValueError, match="silently truncate"):
        tpipe.pack_stage_params([{"a": np.zeros(3, np.float64)},
                                 {"b": np.zeros(3, np.float32)}])
    grad = [{"w": torch.zeros(3, requires_grad=True)}]
    with pytest.raises(ValueError, match="require grad"):
        tpipe.spmd_pipeline([lambda p, h: h], grad, np.zeros((2, 3)),
                            mesh=["cpu"], param_placement="stage")


@pytest.fixture(scope="module")
def blocks8():
    """An 8-layer gpt2-test-width block stack (numpy, JAX's layout) and an
    embedded input (B=4, T=8, C=64)."""
    jcfg = jgpt.GPTConfig(**CFG8)
    params = jax.tree.map(np.asarray, jgpt.init(jax.random.PRNGKey(4), jcfg))
    blocks = jax.tree.map(np.asarray,
                          jgpt.prepare_stacked(params, jcfg)["blocks"])
    x = np.random.default_rng(2).standard_normal((4, 8, 64)).astype(
        np.float32)
    return jcfg, blocks, x


def _torch_block_fn(layers):
    cfg = gpt.GPTConfig(**{**CFG8, "n_layer": layers})
    return lambda p, h: gpt.blocks_scan(p, h, cfg=cfg)


def test_spmd_pipeline_stacked_matches_jax(blocks8):
    """2 stages of 4 blocks, 4 microbatches: JAX's spmd_pipeline_stacked
    within 1e-4, the port's stacked placement one slice a stage."""
    jcfg, blocks, x = blocks8
    s = 2
    stacked = jax.tree.map(lambda p: p.reshape(s, 4, *p.shape[1:]), blocks)
    want = np.asarray(jpipe.spmd_pipeline_stacked(
        lambda p, h: jgpt.blocks_scan(p, h, cfg=dataclasses.replace(
            jcfg, n_layer=4)),
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(x),
        mesh=_jmesh(s), num_microbatches=4))
    got = tpipe.spmd_pipeline_stacked(_torch_block_fn(4), stacked, x,
                                      mesh=["cpu"] * s, num_microbatches=4)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BLOCK_TOL)
    placement = tpipe.stacked_param_placement(stacked)
    assert set(jax.tree.leaves(placement)) == {"stage"}
    for name in ("data_axis", "param_specs"):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP Queue 1 item 10"):
            tpipe.spmd_pipeline_stacked(_torch_block_fn(4), stacked, x,
                                        mesh=["cpu"] * s,
                                        **{name: "data"})


def test_spmd_pipeline_interleaved_matches_jax(blocks8):
    """2 stages x 2 virtual stages (4 chunks of 2 blocks), 4 microbatches:
    JAX's interleaved schedule within 1e-4; the sub-step count is
    V*M + S - 1 in both packages; V = 1 equals the stacked GPipe run."""
    jcfg, blocks, x = blocks8
    s, v = 2, 2
    chunks = jax.tree.map(lambda p: p.reshape(s * v, 2, *p.shape[1:]),
                          blocks)
    want = np.asarray(jpipe.spmd_pipeline_interleaved(
        lambda p, h: jgpt.blocks_scan(p, h, cfg=dataclasses.replace(
            jcfg, n_layer=2)),
        jax.tree.map(jnp.asarray, chunks), jnp.asarray(x),
        mesh=_jmesh(s), num_microbatches=4, virtual_stages=v))
    got = tpipe.spmd_pipeline_interleaved(
        _torch_block_fn(2), chunks, x, mesh=["cpu"] * s,
        num_microbatches=4, virtual_stages=v)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BLOCK_TOL)
    for sv in ((2, 2, 4), (4, 3, 8), (8, 1, 2)):
        assert tpipe.interleaved_schedule_steps(*sv) == \
            jpipe.interleaved_schedule_steps(*sv)
    halves = jax.tree.map(lambda p: p.reshape(s, 4, *p.shape[1:]), blocks)
    gpipe = tpipe.spmd_pipeline_stacked(_torch_block_fn(4), halves, x,
                                        mesh=["cpu"] * s, num_microbatches=2)
    once = tpipe.spmd_pipeline_interleaved(
        _torch_block_fn(4), halves, x, mesh=["cpu"] * s, num_microbatches=2,
        virtual_stages=1)
    assert torch.equal(once, gpipe)
    with pytest.raises(ValueError, match="must divide by the stage count"):
        tpipe.spmd_pipeline_interleaved(
            _torch_block_fn(2), chunks, x, mesh=["cpu"] * s,
            num_microbatches=1, virtual_stages=v)


@pytest.mark.parametrize("parts,n_dev,runtime", [
    (1, 1, "auto"), (2, 1, "auto"), (2, 2, "auto"), (2, 1, "spmd"),
    (2, 2, "relay")], ids=["1part", "2parts-1dev", "2parts-2dev",
                           "spmd-short", "relay-2dev"])
def test_pick_runtime_matches_jax(cifar, parts, n_dev, runtime):
    """The engine's runtime choice equals JAX's in each case, and an
    explicit spmd short of devices raises JAX's message."""
    params, _ = cifar
    raw = _raw("cifar_cnn", parts, runtime=runtime)
    jp = jax.tree.map(jnp.asarray, params)
    try:
        want = JaxEngine(JaxConfig.from_dict(raw), params=jp,
                         devices=jax.devices()[:n_dev]).runtime
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            PipelineEngine(TopologyConfig.from_dict(raw), params=params,
                           devices=["cpu"] * n_dev)
        assert str(err.value) == str(e)
        return
    got = PipelineEngine(TopologyConfig.from_dict(raw), params=params,
                         devices=["cpu"] * n_dev)
    assert got.runtime == want


@pytest.mark.parametrize("placement", ["auto", "stage", "replicated"])
def test_engine_spmd_cifar_equals_relay(cifar, placement):
    """engine.run on spmd (the generic packed or replicated path) equals
    the relay engine's run of the same microbatch split bit for bit; the
    resolved placement is JAX's rule (auto: replicated below 32 MiB)."""
    params, x = cifar
    eng = PipelineEngine(TopologyConfig.from_dict(_raw(
        "cifar_cnn", 2, runtime="spmd", microbatches=2,
        param_placement=placement)), params=params, devices=["cpu"] * 2)
    relay = PipelineEngine(TopologyConfig.from_dict(_raw(
        "cifar_cnn", 2, runtime="relay")), params=params)
    assert eng.runtime == "spmd"
    assert eng.param_placement == ("replicated" if placement == "auto"
                                   else placement)
    want = torch.cat([relay.run(x[:2]), relay.run(x[2:])])
    assert torch.equal(eng.run(x), want)
    assert eng.predict(x[:2]) == relay.predict(x[:2])


def test_engine_spmd_gpt_stacked_equals_relay():
    """gpt2-test on 2 stages, microbatches 0 (auto: 4 for B=4): the
    stacked path (embed on stage 0, the head on the last) gives the relay
    engine's logits of each microbatch bit for bit; its `mesh` is the
    config's stage mesh; a data axis is Queue 1 item 10's."""
    spec = get_model("gpt2-test")
    params = spec.init(0)
    ids = np.random.default_rng(1).integers(0, 256, (4, 16)).astype(np.int32)
    eng = PipelineEngine(TopologyConfig.from_dict(_raw(
        "gpt2-test", 2, runtime="spmd")), params=params, devices=["cpu"] * 2)
    relay = PipelineEngine(TopologyConfig.from_dict(_raw(
        "gpt2-test", 2, runtime="relay")), params=params)
    assert (eng.param_placement, eng._effective_microbatches(4)) == \
        ("stage", 4)
    assert eng.mesh.shape == {"stage": 2}
    want = torch.cat([relay.run(ids[i:i + 1]) for i in range(4)])
    got = eng.run(ids)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
        tmesh.make_mesh({"stage": 2, "data": 2}, ["cpu"] * 4)
    cfg = TopologyConfig.from_dict(_raw("gpt2-test", 2, mesh={"stage": 4}))
    with pytest.raises(ValueError, match="conflicts with num_parts=2"):
        tmesh.mesh_from_config(cfg, ["cpu"] * 4)
