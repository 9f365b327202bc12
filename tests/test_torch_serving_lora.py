"""The port's LoRA (dnn_tpu_torch/lora.py) and multi-LoRA serving on the
CPU against the JAX package's (dnn_tpu/lora.py, the JAX batcher's
lora_adapters): merge, stack, restack and the adapted loss's gradients
against JAX's; the .npz artifact across packages both ways; the
multi-LoRA ContinuousBatcher's greedy streams identical to JAX's on the
same submit/step script on the paged pool, the dense pool with the
prefix LRU keyed by adapter (hits/misses equal to JAX's), the paged
radix store (adapted requests uncached, as in JAX) and interleaved
prefill with overlap; each adapted stream equal to make_generate over
merge_lora(base, adapter), through a stand-in capture of the step;
`node --serve_lm --serve_adapter` as a process answering a= as JAX's
batcher, and `--weights int8` beside it refused as JAX's node refuses it.

Weights: JAX's gpt2-test init with every matrix scaled by 15 (as
test_torch_serving); adapters of rank 4 drawn from numpy seeds, a and
b N(0, 0.2), so that each changes the greedy stream."""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu import lora as jlora
from dnn_tpu.models import gpt as jgpt
from dnn_tpu.runtime.serving import ContinuousBatcher as JaxBatcher
from dnn_tpu_torch import lora
from dnn_tpu_torch.convert import from_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.runtime.generate import make_generate
from dnn_tpu_torch.runtime.serving import CapturedDecode, ContinuousBatcher

from test_torch_cuda_graph import fake_capture
from test_torch_llama import one_torch_thread  # noqa: F401 (autouse)


ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG_J = jgpt.PRESETS["gpt2-test"]
CFG_T = tgpt.PRESETS["gpt2-test"]
POOL = dict(slots=3, max_len=64, prompt_pad=16, block_len=8)
ALPHAS = [None, 8.0]


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, CFG_T.vocab_size, n)


def numpy_adapters(prepared, seed, rank=4, scale=0.2):
    """Adapters for every default target of a port tree, a and b drawn
    from numpy (b nonzero): {path: {"a", "b"}} of numpy arrays."""
    shapes = lora.init_lora(0, prepared, rank=rank)
    rng = np.random.default_rng(seed)
    return {p: {k: (rng.standard_normal(tuple(v.shape)).astype(np.float32)
                    * np.float32(scale)) for k, v in ab.items()}
            for p, ab in sorted(shapes.items())}


def save_tree_npz(tree, path):
    """A JAX-layout tree of numpy leaves as a flat .npz ("/"-joined
    keys, convert.load_npz's format)."""
    flat = {}

    def walk(node, keys):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, keys + [k])
        else:
            flat["/".join(keys)] = np.asarray(node)

    walk(tree, [])
    np.savez(path, **flat)
    return path


def daemon_env():
    return {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}


def wait_daemon(client, proc, deadline=120.0):
    """Until the daemon answers its health check; fails with its output
    if the process exits first."""
    t_end = time.monotonic() + deadline
    while time.monotonic() < t_end:
        if proc.poll() is not None:
            raise AssertionError(f"daemon exited {proc.returncode}:\n"
                                 f"{proc.stdout.read()}")
        try:
            if client.wait_healthy(deadline=1.0):
                return
        except Exception:  # noqa: BLE001 — not up yet
            pass
        time.sleep(0.2)
    raise AssertionError("daemon did not come up")


@pytest.fixture(scope="module")
def setup():
    """(JAX prepared, port prepared, two numpy adapter sets)."""
    tree = jax.tree.map(
        lambda a: np.asarray(a) * (15.0 if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(0), CFG_J))
    jprep = jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), CFG_J)
    tprep = from_jax_params(tree, CFG_T, "cpu")
    ads = [numpy_adapters(tprep, s) for s in (1, 2)]
    return jprep, tprep, ads, tree


def _jax(ad):
    return jax.tree.map(jnp.asarray, ad)


def _torch(ad):
    return {p: {k: torch.from_numpy(v) for k, v in ab.items()}
            for p, ab in ad.items()}


def test_lora_module_matches_jax(setup):
    """merge_lora on the stacked tensors and on the per-layer numpy tree,
    stack_loras (scales folded into b, the zero base adapter) and
    adapters_to_stacked equal JAX's; the embedding table is refused by
    lora_view; an adapter matching nothing is refused by merge_lora."""
    jprep, tprep, ads, tree = setup
    got = lora.merge_lora(tprep, _torch(ads[1]), alpha=8.0)
    want = jlora.merge_lora(jprep, _jax(ads[1]), alpha=8.0)
    for p in ads[1]:
        keys = p.split("/")
        g, w = got, want
        for k in keys:
            g, w = g[k], w[k]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    per_layer = {f"h_{i}/{p.split('/', 1)[1]}": {k: v[i] for k, v in
                                                  ab.items()}
                 for p, ab in ads[0].items() for i in range(CFG_T.n_layer)}
    merged = lora.merge_lora(tree, per_layer)
    jmerged = jlora.merge_lora(jax.tree.map(jnp.asarray, tree),
                               _jax(per_layer))
    np.testing.assert_allclose(merged["h_1"]["mlp"]["fc"]["kernel"],
                               np.asarray(jmerged["h_1"]["mlp"]["fc"]
                                          ["kernel"]), rtol=1e-6, atol=1e-6)
    restacked = lora.adapters_to_stacked(_torch(per_layer), CFG_T.n_layer)
    for p, ab in jlora.adapters_to_stacked(_jax(per_layer),
                                           CFG_T.n_layer).items():
        for k in ("a", "b"):
            np.testing.assert_array_equal(restacked[p][k].numpy(),
                                          np.asarray(ab[k]))
    st = lora.stack_loras([_torch(a) for a in ads], alphas=ALPHAS)
    jst = jlora.stack_loras([_jax(a) for a in ads], alphas=ALPHAS)
    for p in jst:
        for k in ("a", "b"):
            np.testing.assert_allclose(st[p][k].numpy(),
                                       np.asarray(jst[p][k]), rtol=1e-7)
    with pytest.raises(ValueError, match="embedding"):
        lora.lora_view(tprep, {"wte/embedding": st[p]},
                       torch.zeros(1, 3))
    with pytest.raises(ValueError, match="matched no param"):
        lora.merge_lora(tprep, {"blocks/nope/kernel": st[p]})


def test_artifacts_cross_packages(setup, tmp_path):
    """An .npz saved by either package loads in the other, alpha kept."""
    _, _, ads, _ = setup
    lora.save_lora(str(tmp_path / "t.npz"), _torch(ads[0]), alpha=6.0)
    jad, jalpha = jlora.load_lora(str(tmp_path / "t.npz"))
    assert jalpha == 6.0 and set(jad) == set(ads[0])
    jlora.save_lora(str(tmp_path / "j.npz"), _jax(ads[1]))
    tad, talpha = lora.load_lora(str(tmp_path / "j.npz"))
    assert talpha is None and set(tad) == set(ads[1])
    for p in ads[0]:
        for k in ("a", "b"):
            np.testing.assert_array_equal(np.asarray(jad[p][k]),
                                          ads[0][p][k])
            np.testing.assert_array_equal(tad[p][k].numpy(), ads[1][p][k])


def test_lora_loss_gradients_match_jax(setup):
    """make_lora_loss through autograd: the loss and every adapter
    gradient within 1e-5 (relative to the largest) of jax.grad's."""
    from dnn_tpu.train import next_token_loss as jloss
    from dnn_tpu_torch.train import next_token_loss

    jprep, tprep, ads, _ = setup
    tokens = _prompt(5, 2 * 17).reshape(2, 17)
    japply = jgpt.make_apply_stacked(CFG_J)
    tapply = tgpt.make_apply_stacked(CFG_T)
    jfn = jlora.make_lora_loss(lambda p, b: jloss(japply, p, b), jprep)
    jl, jg = jax.value_and_grad(jfn)(_jax(ads[0]), jnp.asarray(tokens))
    tad = {p: {k: v.clone().requires_grad_(True) for k, v in ab.items()}
           for p, ab in _torch(ads[0]).items()}
    tl = lora.make_lora_loss(lambda p, b: next_token_loss(tapply, p, b),
                             tprep)(tad, torch.from_numpy(tokens))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for p in tad:
        for k in ("a", "b"):
            w = np.asarray(jg[p][k])
            np.testing.assert_allclose(tad[p][k].grad.numpy(), w,
                                       atol=1e-5 * np.abs(w).max())


def _script(b):
    """Mixed adapters in one pool, admissions mid-decode, slots reused by
    other adapters, a repeated adapted prompt (a dense LRU hit keyed by
    adapter; the same prompt for the base model misses)."""
    shared = _prompt(10, 32)
    r = [b.submit(_prompt(1, 9), 7, adapter=0),
         b.submit(shared, 6, adapter=1),
         b.submit(_prompt(2, 20), 8)]
    for _ in range(3):
        b.step()
    res = b.drain()
    r += [b.submit(shared, 5, adapter=1), b.submit(shared, 5),
          b.submit(_prompt(3, 17), 6, adapter=0)]
    b.step()
    res = b.drain()
    r.append(b.submit(_prompt(4, 12), 4, adapter=1))
    res = b.drain()
    return [np.asarray(res[i]).tolist() for i in r]


LAYOUTS = {
    "paged": dict(kv="paged"),
    "dense-prefix": dict(kv="dense", prefix_cache=4),
    "paged-radix": dict(kv="paged", prefix_cache=16),
    "interleaved-overlap": dict(kv="paged", prefill_chunk_tokens=8,
                                overlap=True),
}


@pytest.mark.parametrize("layout", LAYOUTS, ids=list(LAYOUTS))
def test_multilora_batcher_matches_jax(setup, layout):
    """The same script on JAX's multi-LoRA batcher and the port's: every
    greedy stream identical, and the prefix counts equal."""
    jprep, tprep, ads, _ = setup
    kw = {**POOL, **LAYOUTS[layout]}
    jb = JaxBatcher(CFG_J, jprep, lora_adapters=[_jax(a) for a in ads],
                    lora_alphas=ALPHAS, **kw)
    tb = ContinuousBatcher(CFG_T, tprep, device="cpu",
                           lora_adapters=[_torch(a) for a in ads],
                           lora_alphas=ALPHAS, **kw)
    got = _script(tb)
    assert got == _script(jb)
    assert got[3] != got[4], "an adapter changes the stream"
    assert (tb.prefix_hits, tb.prefix_misses) == (jb.prefix_hits,
                                                  jb.prefix_misses)
    assert tb.prefill_chunks_run == jb.prefill_chunks_run


def test_adapted_streams_equal_merged_solo_through_a_capture(setup):
    """Each adapter's stream equals make_generate over merge_lora(base,
    adapter) (its alpha), the base request the plain model's; the step
    runs through a stand-in capture taken once while adapters change
    slot by slot (the views read the one-hot buffer written in place)."""
    _, tprep, ads, _ = setup
    b = ContinuousBatcher(CFG_T, tprep, device="cpu",
                          lora_adapters=[_torch(a) for a in ads],
                          lora_alphas=ALPHAS, **POOL)
    step = b._graph_step = CapturedDecode(POOL["slots"], "cpu",
                                          capture=fake_capture)
    prompts = [_prompt(20 + i, 7 + 5 * i) for i in range(4)]
    which = [1, None, 0, 1]
    rids = [b.submit(prompts[i], 6, adapter=which[i]) for i in range(3)]
    b.step()
    res = b.drain()
    rids.append(b.submit(prompts[3], 6, adapter=which[3]))
    res = b.drain()
    assert step.captures == 1 and step.replays > 4
    for p, a, r in zip(prompts, which, rids):
        params = tprep if a is None else lora.merge_lora(
            tprep, _torch(ads[a]), alpha=ALPHAS[a])
        want = make_generate(CFG_T, max_new_tokens=6, device="cpu")(
            params, p[None])[0].numpy()
        np.testing.assert_array_equal(res[r], want)
    with pytest.raises(ValueError, match="out of range"):
        b.submit(prompts[0], 2, adapter=2)
    plain = ContinuousBatcher(CFG_T, tprep, device="cpu", **POOL)
    with pytest.raises(ValueError, match="lora_adapters"):
        plain.submit(prompts[0], 2, adapter=0)


def test_node_serve_adapter_process(setup, tmp_path):
    """`node --serve_lm --serve_adapter A --serve_adapter B` as a process
    (per-layer artifacts, B with alpha 8): a=0, a=1 and base requests
    over gRPC equal JAX's multi-LoRA batcher; `--weights int8` beside
    --serve_adapter exits 1, as JAX's node (its LMServer refuses the
    pair)."""
    from dnn_tpu_torch.comm.client import NodeClient
    from test_torch_lm_server import _free_port

    jprep, _, ads, tree = setup
    paths = []
    for i, (ad, alpha) in enumerate(zip(ads, ALPHAS)):
        per_layer = {f"h_{li}/{p.split('/', 1)[1]}": {k: v[li] for k, v in
                                                       ab.items()}
                     for p, ab in ad.items() for li in range(CFG_T.n_layer)}
        paths.append(str(tmp_path / f"ad{i}.npz"))
        jlora.save_lora(paths[-1], _jax(per_layer), alpha=alpha)
    npz = save_tree_npz(tree, tmp_path / "w.npz")
    port = _free_port()
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "model": "gpt2-test", "num_parts": 1, "device_type": "cpu",
        "nodes": [{"id": "node1", "address": f"127.0.0.1:{port}",
                   "part_index": 0}]}))
    base = [sys.executable, "-m", "dnn_tpu_torch.node", "--node_id",
            "node1", "--config", str(cfg), "--serve_lm", "--device", "cpu",
            "--weights_npz", str(npz), "--slots", "3", "--max_len", "64",
            "--prompt_pad", "16", "--block_len", "8",
            "--serve_adapter", paths[0], "--serve_adapter", paths[1]]
    proc = subprocess.Popen(base, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=daemon_env())
    prompts = [_prompt(30 + i, 9 + 4 * i).astype(np.int32) for i in range(3)]
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        wait_daemon(client, proc)
        got = [client.send_tensor(p, request_id=f"gen:6{opt}",
                                  timeout=60)[1].tolist()
               for p, opt in zip(prompts, (":a=0", ":a=1", ""))]
        client.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    jb = JaxBatcher(CFG_J, jprep, lora_adapters=[_jax(a) for a in ads],
                    lora_alphas=ALPHAS, kv="paged", **POOL)
    rids = [jb.submit(p, 6, adapter=a)
            for p, a in zip(prompts, (0, 1, None))]
    res = jb.drain()
    assert got == [np.asarray(res[r]).tolist() for r in rids]
    from dnn_tpu_torch.node import main

    assert main(base[3:] + ["--weights", "int8"]) == 1
