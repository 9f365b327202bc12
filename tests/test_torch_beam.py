"""The port's beam search (dnn_tpu_torch/runtime/beam.py) and embedding
extraction (runtime/embeddings.py) on the CPU against the JAX package's
(dnn_tpu/runtime/beam.py, dnn_tpu/runtime/embeddings.py), from the same
seeded weights: make_beam_generate's return_all tokens identical to
JAX's on gpt2-test and llama-test, with and without eos_id and the
length penalty, its scores within 1e-5; beam_size 1 equal to greedy
make_generate; `node --generate --beam` (and with --lora) as a process
printing what `python -m dnn_tpu.node` prints; make_embed's mean, last
and none within 1e-5 of JAX's and unchanged by padding; and the LM
daemon's embed endpoint answering as JAX's daemon does.

Weights: gpt2-test with every matrix x15 (decisive argmaxes), llama-test
redrawn at scale 0.3 (test_torch_llama.drawn_tree)."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu.models import gpt as jgpt
from dnn_tpu.runtime.beam import make_beam_generate as jbeam
from dnn_tpu.runtime.embeddings import make_embed as jembed
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.models import llama as tllama
from dnn_tpu_torch.runtime.beam import make_beam_generate
from dnn_tpu_torch.runtime.embeddings import make_embed
from dnn_tpu_torch.runtime.generate import make_generate

from test_torch_llama import drawn_tree, jax_prepared
from test_torch_llama import one_torch_thread  # noqa: F401 (autouse)

N_NEW = 7


@pytest.fixture(scope="module")
def models():
    """{name: (port cfg, JAX prepared, port prepared, ids (2, 9))}."""
    out = {}
    tree = jax.tree.map(
        lambda a: np.asarray(a) * (15.0 if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(2), jgpt.PRESETS["gpt2-test"]))
    cfg = tgpt.PRESETS["gpt2-test"]
    out["gpt2-test"] = (cfg, jgpt.prepare_stacked(
        jax.tree.map(jnp.asarray, tree), jgpt.PRESETS["gpt2-test"]),
        from_jax_params(tree, cfg, "cpu"))
    ltree = drawn_tree("llama-test", 1, 0.3)
    lcfg = tllama.PRESETS["llama-test"]
    out["llama-test"] = (lcfg, jax_prepared("llama-test", ltree),
                         from_jax_params(ltree, lcfg, "cpu"))
    return {k: v + (np.random.default_rng(4).integers(
        0, v[0].vocab_size, (2, 9)),) for k, v in out.items()}


def _jcfg(name):
    from dnn_tpu.models import llama as jllama

    return (jgpt.PRESETS if name.startswith("gpt2") else
            jllama.PRESETS)[name]


@pytest.mark.parametrize("name", ["gpt2-test", "llama-test"])
@pytest.mark.parametrize("opts", ["plain", "eos", "eos+penalty"])
def test_beam_return_all_matches_jax(models, name, opts):
    """Every beam's tokens identical to JAX's, best first; the scores
    within 1e-5. The eos is a token JAX's plain search emits, so beams
    reach it and freeze."""
    cfg, jprep, tprep, ids = models[name]
    kw = dict(max_new_tokens=N_NEW, beam_size=3, return_all=True)
    if opts != "plain":
        plain, _ = jbeam(_jcfg(name), **kw)(jprep, jnp.asarray(ids))
        kw["eos_id"] = int(np.asarray(plain)[0, 0, 2])
    if opts == "eos+penalty":
        kw["length_penalty"] = 0.6
    jt, js = jbeam(_jcfg(name), **kw)(jprep, jnp.asarray(ids))
    tt, ts = make_beam_generate(cfg, device="cpu", **kw)(tprep, ids)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    if opts != "plain":
        assert (np.asarray(jt) == kw["eos_id"]).any()


@pytest.mark.parametrize("name", ["gpt2-test", "llama-test"])
def test_beam_one_is_greedy(models, name):
    cfg, _, tprep, ids = models[name]
    got = make_beam_generate(cfg, max_new_tokens=N_NEW, beam_size=1,
                             device="cpu")(tprep, ids)
    want = make_generate(cfg, max_new_tokens=N_NEW, device="cpu")(tprep, ids)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="beam_size"):
        make_beam_generate(cfg, max_new_tokens=2, beam_size=0, device="cpu")


@pytest.mark.parametrize("case", ["beam", "beam+lora"])
def test_node_generate_beam_equals_the_jax_cli(models, tmp_path, capsys,
                                               case):
    """`node --generate --beam K --eos_id E --length_penalty A` (and with
    --lora, an artifact JAX's save_lora wrote) as a process prints the
    tokens of `python -m dnn_tpu.node` with the same flags on the same
    model_weights .npz."""
    from dnn_tpu import lora as jlora
    from dnn_tpu import node as jnode
    from dnn_tpu_torch.io import checkpoint as ckpt
    from test_torch_stage_server import ROOT, _node, _raw

    _, jprep, _, _ = models["gpt2-test"]
    params = jax.tree.map(
        lambda a: np.asarray(a) * (15.0 if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(2), jgpt.PRESETS["gpt2-test"]))
    weights = tmp_path / "gpt.npz"
    ckpt.save_npz(str(weights), ckpt.params_to_flat(params))
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(_raw("gpt2-test", 1,
                                   model_weights=str(weights))))
    args = ["--node_id", "node1", "--config", str(cfg), "--generate", "8",
            "--prompt_ids", "5,17,200,3", "--beam", "3", "--eos_id", "9",
            "--length_penalty", "0.6"]
    if case == "beam+lora":
        rng = np.random.default_rng(3)
        ad = {f"h_{i}/attn/qkv/kernel": {
            "a": jnp.asarray(rng.standard_normal((64, 4)) * 0.3, jnp.float32),
            "b": jnp.asarray(rng.standard_normal((4, 192)) * 0.3,
                             jnp.float32)} for i in range(4)}
        jlora.save_lora(str(tmp_path / "ad.npz"), ad, alpha=2.0)
        args += ["--lora", str(tmp_path / "ad.npz")]
    proc = subprocess.run(_node(*args), cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert jnode.main(args) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if "GENERATED TOKENS" in ln]
    got = [ln for ln in proc.stdout.splitlines() if "GENERATED TOKENS" in ln]
    assert got == want and len(want) == 1
    from dnn_tpu_torch.node import main

    assert main(["--node_id", "node1", "--config", str(cfg),
                 "--eos_id", "3", "--generate", "2"]) == 1
    assert main(["--node_id", "node1", "--config", str(cfg),
                 "--beam", "2"]) == 1


@pytest.mark.parametrize("name", ["gpt2-test", "llama-test"])
@pytest.mark.parametrize("pooling", ["mean", "last", "none"])
def test_embed_matches_jax_and_ignores_padding(models, name, pooling):
    """make_embed within 1e-5 of JAX's on rows of 5 and 9 real tokens;
    the pooled vectors unchanged when the ids are padded to 16 with
    other tokens."""
    cfg, jprep, tprep, ids = models[name]
    lengths = np.asarray([5, 9])
    want = np.asarray(jembed(_jcfg(name), pooling=pooling)(
        jprep, jnp.asarray(ids), jnp.asarray(lengths)))
    fn = make_embed(cfg, pooling=pooling)
    got = fn(tprep, ids, lengths).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    padded = np.concatenate([ids, np.full((2, 7), 3)], axis=1)
    padded[0, 5:9] = 11
    again = fn(tprep, padded, lengths).numpy()
    if pooling == "none":
        np.testing.assert_allclose(again[1, :9], got[1], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(again[0, :5], got[0, :5], rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(again, got, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="pooling"):
        make_embed(cfg, pooling="max")


def test_daemon_embed_endpoint_answers_as_jax(models):
    """The port's daemon and JAX's on the same weights: embed, embed:last
    and embed:mean replies (status and vector within 1e-5), embed:max
    INVALID_ARGUMENT on both; generation still served beside it."""
    import grpc

    from dnn_tpu.runtime.lm_server import (
        start_lm_server_in_background as jax_start_lm,
    )
    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background
    from test_torch_lm_server import POOL, _free_port

    cfg, jprep, tprep, _ = models["gpt2-test"]
    prompt = np.random.default_rng(8).integers(0, 256, 21).astype(np.int32)
    pj, pt = _free_port(), _free_port()
    _, stop_j = jax_start_lm(jgpt.PRESETS["gpt2-test"], jprep, port=pj,
                             **POOL)
    replies = {}
    try:
        _, stop_t = start_lm_server_in_background(cfg, tprep, port=pt,
                                                  device="cpu", **POOL)
        try:
            for side, addr in (("jax", pj), ("torch", pt)):
                c = NodeClient(f"127.0.0.1:{addr}")
                assert c.wait_healthy(deadline=60)
                for rid in ("embed", "embed:last", "embed:mean"):
                    replies[side, rid] = c.send_tensor(prompt,
                                                       request_id=rid,
                                                       timeout=60)
                with pytest.raises(grpc.RpcError) as e:
                    c.send_tensor(prompt, request_id="embed:max", timeout=60)
                assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
                replies[side, "gen"] = c.generate(prompt, max_new_tokens=4,
                                                  timeout=60).tolist()
                c.close()
        finally:
            stop_t()
    finally:
        stop_j()
    assert replies["torch", "gen"] == replies["jax", "gen"]
    for rid in ("embed", "embed:last", "embed:mean"):
        (ts, tv), (js, jv) = replies["torch", rid], replies["jax", rid]
        assert ts == js == "[lm] ok: embedding dim 64"
        tv = tv.numpy() if isinstance(tv, torch.Tensor) else np.asarray(tv)
        assert tv.dtype == np.float32 and tv.shape == (64,)
        np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(replies["torch", "embed"][1]),
        np.asarray(replies["torch", "embed:mean"][1]))
