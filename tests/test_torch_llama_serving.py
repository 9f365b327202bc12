"""The LLaMA family served by the port on the CPU: the ContinuousBatcher
with LlamaFamilyRows against the JAX batcher with its LlamaFamilyRows on
the same weights and the same submit/step script, on the paged, dense
and bucketed pools with f32 KV for every preset and bf16 and int8 KV for
two (the rest against the port's plain cache loops); the LM daemon over gRPC
and `node --serve_lm` with a llama config; and chip_smoke's [llama]
phase rehearsed at a small size.

Weights: tests/test_torch_llama.drawn_tree (every leaf drawn, matrices
at std 0.3 so that a random 4-layer model emits varied tokens). Greedy
tokens must be identical (under bf16 KV with the probabilities rounded
as JAX rounds them: test_torch_llama.round_probs_like_jax)."""

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dnn_tpu.models import llama as jllama
from dnn_tpu.runtime.serving import ContinuousBatcher as JaxBatcher
from dnn_tpu_torch.comm.client import NodeClient
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import llama as tllama
from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background
from dnn_tpu_torch.runtime.serving import ContinuousBatcher

from test_torch_llama import (  # one_torch_thread: the autouse fixture
    PRESETS,
    drawn_tree,
    jax_prepared,
    one_torch_thread,  # noqa: F401
    round_probs_like_jax,
)

POOL = dict(slots=3, max_len=64, prompt_pad=16, block_len=8)
LAYOUTS = {"paged": {"kv": "paged"}, "dense": {"kv": "dense"},
           "buckets": {"kv": "dense", "decode_buckets": (16, 32)}}
_JAX_TOKENS: dict = {}


def _prompt(cfg, seed, n):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, n)


def _script(b, cfg):
    """Three requests of 5 / 20 / 37 tokens (one chunk, two, three with a
    padded tail); the third is admitted mid-decode. Returns the prompts
    and each request's tokens."""
    prompts = [_prompt(cfg, s, n) for s, n in ((0, 5), (1, 20), (2, 37))]
    r0 = b.submit(prompts[0], 10)
    r1 = b.submit(prompts[1], 12)
    for _ in range(3):
        b.step()
    r2 = b.submit(prompts[2], 9)
    res = b.drain()
    return prompts, [np.asarray(res[r]) for r in (r0, r1, r2)]


def _jax_tokens(name, kv_dtype):
    """The JAX batcher's tokens on its dense pool, once per (preset, KV
    type). JAX's paged and bucketed pools give the same tokens (its own
    tests hold that); its paged pool refuses a head dim decoupled from
    n_embd / n_head (gemma-test, qwen3-test: dnn_tpu/runtime/
    paged_kvcache.py:160 sizes the pool by n_embd // n_head)."""
    key = (name, kv_dtype)
    if key not in _JAX_TOKENS:
        cfg = jllama.PRESETS[name]
        jkv = {"f32": None, "bf16": jnp.bfloat16, "int8": "int8"}[kv_dtype]
        b = JaxBatcher(cfg, jax_prepared(name, drawn_tree(name, 1, 0.3)),
                       family=jllama.LlamaFamilyRows(cfg), kv="dense",
                       kv_dtype=jkv, **POOL)
        _JAX_TOKENS[key] = _script(b, cfg)[1]
    return _JAX_TOKENS[key]


# held to the JAX batcher in every KV type; the other presets in f32
# (each JAX batcher costs a compile), their bf16 and int8 streams held to
# the port's plain cache loops
JAX_EVERY_KV = ("llama-test", "qwen3-test")


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", PRESETS)
def test_batcher_greedy_tokens_match_jax(name, layout, kv_dtype, monkeypatch):
    """The port's batcher with LlamaFamilyRows on each pool and KV type
    gives the JAX batcher's tokens: every preset in f32, JAX_EVERY_KV's in
    bf16 and int8 too. Under bf16 and int8 KV the port's streams first
    equal its plain cache loop's (chip_smoke.reference_greedy_cache,
    prefilled in the batcher's chunks), for every preset. Under bf16 KV,
    with the probabilities rounded to bf16 as JAX's codec rounds them
    (the one place the two differ by design: the kernels keep them in
    f32), they then equal JAX's. The pool is sized at the KV heads and
    the head dim."""
    import chip_smoke

    cfg = tllama.PRESETS[name]
    prep = from_jax_params(drawn_tree(name, 1, 0.3), cfg, "cpu")

    def serve():
        b = ContinuousBatcher(cfg, prep, family=tllama.LlamaFamilyRows(cfg),
                              kv_dtype=kv_dtype, device="cpu",
                              **{**POOL, **LAYOUTS[layout]})
        assert b.cache["k"].shape[2] == cfg.n_kv_head
        assert b.cache["k"].shape[-1] == cfg.head_dim
        prompts, got = _script(b, cfg)
        if layout == "buckets":
            assert b.bucket_grows == 2 and b.cache["k"].shape[3] == 64
        return prompts, got

    prompts, got = serve()
    assert len(set(got[1].tolist())) > 2  # varied tokens, not one id
    if kv_dtype != "f32":
        for prompt, g in zip(prompts, got):
            toks, _ = chip_smoke.reference_greedy_cache(
                prep, cfg, prompt.tolist(), len(g), torch.device("cpu"),
                kv_dtype, chunk=POOL["prompt_pad"])
            assert toks == g.tolist()
        if name not in JAX_EVERY_KV:
            return
    if kv_dtype == "bf16":
        round_probs_like_jax(monkeypatch)
        got = serve()[1]
    for g, w in zip(got, _jax_tokens(name, kv_dtype)):
        np.testing.assert_array_equal(g, w)


def test_paged_pool_matches_jax_paged_pool():
    """Where the JAX batcher can page (head dim n_embd / n_head), the
    port's paged pool gives its paged pool's tokens: llama-test, f32 and
    int8 KV."""
    cfg = tllama.PRESETS["llama-test"]
    tree = drawn_tree("llama-test", 1, 0.3)
    prep = from_jax_params(tree, cfg, "cpu")
    for kv_dtype in (None, "int8"):
        want = _script(JaxBatcher(
            jllama.PRESETS["llama-test"], jax_prepared("llama-test", tree),
            family=jllama.LlamaFamilyRows(jllama.PRESETS["llama-test"]),
            kv="paged", kv_dtype=kv_dtype, **POOL), cfg)[1]
        got = _script(ContinuousBatcher(
            cfg, prep, family=tllama.LlamaFamilyRows(cfg), kv="paged",
            kv_dtype=kv_dtype, device="cpu", **POOL), cfg)[1]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_batcher_family_validation():
    """family= as the JAX batcher takes it: an ffn beside it is a
    ValueError; the family's pool (auto-sized paged blocks) is at its KV
    heads; without a family a LlamaConfig gets LlamaFamilyRows, and a GPT
    config GPTFamilyRows and a pool of every query head."""
    from dnn_tpu_torch.runtime.serving import GPTFamilyRows

    cfg = tllama.PRESETS["llama-test"]
    prep = from_jax_params(tllama.init(0, cfg), cfg, "cpu")
    fam = tllama.LlamaFamilyRows(cfg)
    with pytest.raises(ValueError, match="family adapter"):
        ContinuousBatcher(cfg, prep, family=fam, ffn=object(), device="cpu")
    b = ContinuousBatcher(cfg, prep, family=fam, device="cpu", **POOL)
    assert b.family is fam and b.cache["k"].shape[2] == cfg.n_kv_head
    assert b.allocator.n_blocks == 3 * 64 // 8 + 1
    # without family=, a LlamaConfig is served through LlamaFamilyRows
    assert isinstance(ContinuousBatcher(cfg, prep, device="cpu", **POOL)
                      .family, tllama.LlamaFamilyRows)
    from dnn_tpu_torch.models import gpt as tgpt

    g = ContinuousBatcher(tgpt.PRESETS["gpt2-test"], from_jax_params(
        tgpt.init(0, tgpt.PRESETS["gpt2-test"]), tgpt.PRESETS["gpt2-test"],
        "cpu"), device="cpu", **POOL)
    assert isinstance(g.family, GPTFamilyRows)
    assert g.cache["k"].shape[2] == tgpt.PRESETS["gpt2-test"].n_head


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_daemon_serves_llama_as_make_generate():
    """serve_lm with a LlamaConfig builds LlamaFamilyRows itself: three
    concurrent gRPC generate calls on llama-test give make_generate's
    tokens."""
    cfg = tllama.PRESETS["llama-test"]
    prep = from_jax_params(drawn_tree("llama-test", 1, 0.3), cfg, "cpu")
    prompts = [_prompt(cfg, s, n).astype(np.int32)
               for s, n in ((3, 6), (4, 19), (5, 33))]
    gen = tllama.make_generate(cfg, max_new_tokens=8, device="cpu")
    want = [gen(prep, p[None])[0].numpy() for p in prompts]
    port = _free_port()
    thread, stop = start_lm_server_in_background(
        cfg, prep, port=port, device="cpu", **POOL)
    got = {}
    try:
        assert isinstance(stop.servicer.batcher.family,
                          tllama.LlamaFamilyRows)
        client = NodeClient(f"127.0.0.1:{port}")
        assert client.wait_healthy(deadline=60)

        def call(i):
            got[i] = client.generate(prompts[i], max_new_tokens=8)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        client.close()
    finally:
        stop()
    assert not thread.is_alive()
    for i in range(3):
        np.testing.assert_array_equal(got[i], want[i])


def test_node_serve_lm_accepts_a_llama_config(tmp_path, caplog):
    """`python -m dnn_tpu_torch.node --serve_lm` with a llama config (a
    real process; seeded random weights) answers a solo batcher's tokens
    on the same weights and drains on SIGTERM. The config is mistral-test,
    a sliding-window preset: the daemon serves it on its windowed paged
    pool, a stream past the window; an int4 KV cache, still unported,
    exits 2 naming its ROADMAP item."""
    from dnn_tpu_torch.node import main

    port = _free_port()
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"model": "mistral-test", "nodes": [
        {"id": "node1", "part_index": 0, "address": f"127.0.0.1:{port}"}]}))
    pool = ["--slots", "2", "--max_len", "64", "--prompt_pad", "16",
            "--block_len", "8", "--seed", "3"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dnn_tpu_torch.node", "--node_id", "node1",
         "--config", str(cfg_path), "--serve_lm", "--device", "cpu", *pool],
        cwd=pathlib.Path(__file__).resolve().parents[1],
        env={**os.environ, "OMP_NUM_THREADS": "1"},  # as one_torch_thread
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        assert client.wait_healthy(deadline=90)
        cfg = tllama.PRESETS["mistral-test"]
        prompt = _prompt(cfg, 7, 21).astype(np.int32)
        got = client.generate(prompt, max_new_tokens=6)
        client.close()
        b = ContinuousBatcher(cfg, from_jax_params(tllama.init(3, cfg), cfg,
                                                   "cpu"),
                              family=tllama.LlamaFamilyRows(cfg),
                              device="cpu", slots=2, max_len=64,
                              prompt_pad=16, block_len=8)
        assert b.paged
        rid = b.submit(prompt, 6)
        np.testing.assert_array_equal(got, b.drain()[rid])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    cfg_path.write_text(json.dumps({"model": "mistral-test", "nodes": [
        {"id": "node1", "part_index": 0,
         "address": f"127.0.0.1:{_free_port()}"}]}))
    with caplog.at_level("ERROR", logger="dnn_tpu_torch.node"):
        assert main(["--node_id", "node1", "--config", str(cfg_path),
                     "--serve_lm", "--device", "cpu",
                     "--kv_dtype", "int4"]) == 2
    assert "item 2" in caplog.text


def test_llama_phase_rehearsed_on_the_cpu(capsys):
    """chip_smoke's [llama] phase on the CPU with a 2-layer GQA model of
    block_size 1024 (32 query heads' layout shrunk to 4 over 1 KV head,
    theta 500000, vocab 512): L-A, L-C and L-solo run and every stream
    equals its reference; [quant]'s Q8-L (the tree quantized to int8,
    bf16 compute) serves its four streams and, fed its plain loop's
    tokens, emits them (teacher forcing); the launch counts are the
    card's (a CPU call launches no kernel)."""
    import chip_smoke

    cfg = tllama.LlamaConfig(block_size=1024, vocab_size=512, n_layer=2,
                             n_head=4, n_kv_head=1, n_embd=64, d_ff=128,
                             rope_theta=500000.0)
    counts, q8l, q8l_forced = chip_smoke.phase_llama(torch.device("cpu"),
                                                     "cpu", cfg)
    out = capsys.readouterr().out
    for i, n in enumerate(chip_smoke.LLAMA_PROMPTS):
        assert f"[main] run Q8-L request {i} (prompt {n}): " in out, out
        assert f"[quant] Q8-L teacher-forced, prompt {n}: " in out, out
    assert set(q8l) == set(chip_smoke.CACHE_KERNELS)
    assert set(q8l_forced) == {"served", "loop"}
    for run in ("L-A", "L-C"):
        for i, n in enumerate(chip_smoke.LLAMA_PROMPTS):
            assert (f"[main] run {run} request {i} (prompt {n}): "
                    in out), out
    assert "[main] [llama] L-solo make_generate f32: " in out
    assert "matches the reference" in out
    assert set(counts) == set(chip_smoke.CACHE_KERNELS)


def test_llama_bf16_phase_rehearsed_on_the_cpu(capsys):
    """chip_smoke's L-B on the CPU with the 2-layer GQA model of the
    [llama] rehearsal in bf16 compute: the weights prepared with their
    matmul weights in bf16, the daemon's four streams each equal to the
    plain bf16-compute loop up to BF16_TIE, and the teacher-forced run
    emitting the loop's tokens; LH (the four prompts exported by one
    batcher and adopted by another through pack/unpack) and LK (the
    300-token prompt's blocks pulled between two daemons), each stream
    against the same loop."""
    import chip_smoke

    cfg = tllama.LlamaConfig(block_size=1024, vocab_size=512, n_layer=2,
                             n_head=4, n_kv_head=1, n_embd=64, d_ff=128,
                             rope_theta=500000.0)
    counts, forced = chip_smoke.phase_llama_bf16(torch.device("cpu"), "cpu",
                                                 cfg)
    out = capsys.readouterr().out
    assert "GB of bf16 matmul weights) drawn on cpu" in out, out
    for i, n in enumerate(chip_smoke.LLAMA_PROMPTS):
        assert f"[main] run L-B request {i} (prompt {n}): " in out, out
        assert f"[llama] L-B teacher-forced, prompt {n}: " in out, out
        assert f"[handoff] LH request {i} (prompt {n}): " in out, out
    assert "[kvtier] LK adopted prefix, prompt 300: " in out, out
    assert "[kvtier] LK llama3-8b bf16: kvstage " in out, out
    assert set(forced) == {"served", "loop"}
    assert set(counts) == set(chip_smoke.CACHE_KERNELS)
