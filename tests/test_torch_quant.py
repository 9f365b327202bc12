"""The port's weight-only quantization (dnn_tpu_torch/quant.py and the
quantized linears of ops/nn.py) on the CPU against the JAX package's
(dnn_tpu/quant.py, dnn_tpu/ops/nn.py): int8 q and scale bit-equal
(a zero column included), int4 values and group scales bit-equal with
the port's packing two to a byte, `param_bytes` equal, the int8, int4
and LoRA linears (over a float and an int8 base) within 1e-5, JAX's
quantized trees carried both ways by convert.py, and greedy decoding on
int8 and int4 trees identical to JAX's make_generate; the LM daemon's
weights="int8" serves JAX's LMServer(weights="int8") streams, and
`node --serve_lm --weights int8` as a process answers as JAX's batcher
over the same quantized tree.

Weights: JAX's gpt2-test init with every matrix scaled by 15 (as
test_torch_serving), so that greedy decoding produces varied tokens."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dnn_tpu import quant as jquant
from dnn_tpu.models import gpt as jgpt
from dnn_tpu.ops.nn import linear as jlinear
from dnn_tpu.runtime.generate import make_generate as jmake_generate
from dnn_tpu.runtime.serving import ContinuousBatcher as JaxBatcher
from dnn_tpu_torch import quant
from dnn_tpu_torch.convert import from_jax_params, to_jax_params
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.ops.nn import linear
from dnn_tpu_torch.runtime.generate import make_generate
from dnn_tpu_torch.runtime.serving import ContinuousBatcher

from test_torch_llama import one_torch_thread  # noqa: F401 (autouse)

CFG_J = jgpt.PRESETS["gpt2-test"]
CFG_T = tgpt.PRESETS["gpt2-test"]
POOL = dict(slots=3, max_len=64, prompt_pad=16, block_len=8)
PROMPTS = [np.random.default_rng(i).integers(0, 256, n).astype(np.int32)
           for i, n in enumerate((6, 19, 33))]


def _rng_w(seed, shape, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * np.float32(scale))


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(
        lambda a: np.asarray(a) * (15.0 if a.ndim >= 2 else 1.0),
        jgpt.init(jax.random.PRNGKey(0), CFG_J))


def _jprep(tree):
    return jgpt.prepare_stacked(jax.tree.map(jnp.asarray, tree), CFG_J)


@pytest.mark.parametrize("shape", [(64, 48), (3, 96, 40)])
def test_int8_quantizer_bit_equal(shape):
    """q and scale bit-equal to JAX's, per layer for a stacked kernel;
    an all-zero output column gets scale 1 on both sides."""
    w = _rng_w(1, shape)
    w[..., 1] = 0.0
    jq, js = jquant.quantize_tensor(jnp.asarray(w))
    q, s = quant.quantize_tensor(torch.from_numpy(w))
    assert q.dtype == torch.int8 and tuple(s.shape) == js.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (s.numpy()[..., 1] == 1.0).all()
    np.testing.assert_array_equal(
        quant.dequantize_tensor(q, s).numpy(),
        np.asarray(jquant.dequantize_tensor(jq, js)))


@pytest.mark.parametrize("group", [32, 64])
def test_int4_quantizer_bit_equal_and_packed(group):
    """int4 values and group scales bit-equal to JAX's; the port stores
    them two to a byte, (in/2, out) uint8, and unpacks them exactly."""
    w = _rng_w(2, (2, 128, 40))
    w[:, :, 3] = 0.0
    jq, js = jquant.quantize_tensor_int4(jnp.asarray(w), group=group)
    q, s = quant.quantize_tensor_int4(torch.from_numpy(w), group=group)
    assert q.dtype == torch.uint8 and tuple(q.shape) == (2, 64, 40)
    np.testing.assert_array_equal(quant.unpack_int4(q).numpy(),
                                  np.asarray(jq).astype(np.int8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    vals = torch.randint(-8, 8, (6, 5), dtype=torch.int8)
    assert torch.equal(quant.unpack_int4(quant.pack_int4(vals)), vals)
    with pytest.raises(ValueError, match="divisible"):
        quant.quantize_tensor_int4(torch.zeros(96, 8), group=64)


def _lora(n, c, r, o, b_rows, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, c, r)).astype(np.float32) * 0.1
    b = rng.standard_normal((n, r, o)).astype(np.float32) * 0.1
    sel = np.eye(n, dtype=np.float32)[np.arange(b_rows) % n]
    return {"a": a, "b": b, "sel": sel}


@pytest.mark.parametrize("kind", ["int8", "int4", "float+lora",
                                  "int8+lora", "int4+lora", "int8 bf16",
                                  "int8 head"])
def test_linears_match_jax(kind):
    """The quantized linears, and the LoRA delta over a float or a
    quantized base, within 1e-5 of JAX's on the same values (bf16
    compute at bf16's own tolerance; the head: bf16 operands into f32)."""
    c, o = 128, 48
    params = {"kernel": _rng_w(3, (c, o)), "bias": _rng_w(4, (o,), 0.01)}
    x = _rng_w(5, (3, 4, c), 1.0)
    jp = jax.tree.map(jnp.asarray, params)
    if kind.startswith("int8"):
        jp = jquant.quantize_linear(jp)
    elif kind.startswith("int4"):
        jp = jquant.quantize_linear(jp, bits=4)
    tp = {"kernel": torch.from_numpy(params["kernel"]),
          "bias": torch.from_numpy(params["bias"])}
    if "q" in jp:
        tp = quant.quantize_linear(tp, bits=4 if kind.startswith("int4")
                                   else 8)
    if "lora" in kind:
        ad = _lora(3, c, 4, o, 3, 6)
        jp = {**jp, "lora": jax.tree.map(jnp.asarray, ad)}
        tp = {**tp, "lora": {k: torch.from_numpy(v) for k, v in ad.items()}}
    kw, tol = {}, 1e-5
    if kind == "int8 bf16":
        kw, tol = {"compute_dtype": jnp.bfloat16}, 2e-2
    if kind == "int8 head":
        kw, tol = {"compute_dtype": jnp.bfloat16,
                   "accum_dtype": jnp.float32}, 1e-4
    tkw = {k: {jnp.bfloat16: torch.bfloat16,
               jnp.float32: torch.float32}[v] for k, v in kw.items()}
    want = np.asarray(jlinear(jp, jnp.asarray(x), **kw)).astype(np.float32)
    got = linear(tp, torch.from_numpy(x), **tkw).float().numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("bits", [8, 4])
def test_trees_cross_and_price_as_jax(tree, bits):
    """JAX's quantize_gpt of the per-layer tree, carried in by
    from_jax_params, equals the port's quantize_gpt of the prepared tree
    leaf for leaf (quantization commutes with stacking); param_bytes
    equals JAX's at f32 and quantized; to_jax_params gives JAX's
    quantized leaves back (int4 as ml_dtypes int4)."""
    jq = jquant.quantize_gpt(jax.tree.map(jnp.asarray, tree), bits=bits)
    carried = from_jax_params(jax.tree.map(np.asarray, jq), CFG_T, "cpu")
    mine = quant.quantize_gpt(from_jax_params(tree, CFG_T, "cpu"),
                              bits=bits)
    flat_c, flat_m = [], []

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            assert a.dtype == b.dtype, path
            flat_c.append(a)
            flat_m.append(b)
            assert torch.equal(a, b), path

    walk(carried, mine)
    assert quant.param_bytes(mine) == jquant.param_bytes(
        jquant.quantize_gpt(_jprep(tree), bits=bits))
    assert quant.param_bytes(from_jax_params(tree, CFG_T, "cpu")) == \
        jquant.param_bytes(_jprep(tree))
    back = to_jax_params(mine, CFG_T)
    jleaves = jax.tree.leaves(jq)
    bleaves = jax.tree.leaves(back)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jq))
    for g, w in zip(bleaves, jleaves):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("bits", [8, 4])
def test_greedy_on_quantized_trees_matches_jax(tree, bits):
    """make_generate and the paged batcher over a quantized tree give
    JAX's make_generate tokens on JAX's quantized tree."""
    jq = jquant.quantize_gpt(_jprep(tree), bits=bits)
    tq = quant.quantize_gpt(from_jax_params(tree, CFG_T, "cpu"), bits=bits)
    ids = np.stack([PROMPTS[2][:12], PROMPTS[1][:12]])
    want = np.asarray(jmake_generate(CFG_J, max_new_tokens=8)(
        jq, jnp.asarray(ids), jax.random.PRNGKey(0)))
    got = make_generate(CFG_T, max_new_tokens=8, device="cpu")(tq, ids)
    np.testing.assert_array_equal(got.numpy(), want)
    b = ContinuousBatcher(CFG_T, tq, device="cpu", kv="paged", **POOL)
    rids = [b.submit(p, 8) for p in ids]
    res = b.drain()
    for r, w in zip(rids, want):
        np.testing.assert_array_equal(res[r], w)


def test_daemon_int8_weights_serve_jax_streams(tree):
    """The port's LMServer(weights="int8") over gRPC serves the streams
    of JAX's LMServer(weights="int8"): JAX's batcher over
    quantize_gpt(prepared, bits=8), what that constructor builds
    (dnn_tpu/runtime/lm_server.py:831-839); the served tree's q leaves
    are JAX's; weights="int8" with LoRA is refused."""
    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.runtime.lm_server import (
        LMServer,
        start_lm_server_in_background,
    )
    from test_torch_lm_server import _free_port

    jq = jquant.quantize_gpt(_jprep(tree), bits=8)
    jb = JaxBatcher(CFG_J, jq, kv="paged", **POOL)
    rids = [jb.submit(p, 8) for p in PROMPTS]
    res = jb.drain()
    port = _free_port()
    _, stop = start_lm_server_in_background(
        CFG_T, from_jax_params(tree, CFG_T, "cpu"), port=port,
        device="cpu", weights="int8", **POOL)
    try:
        served = stop.servicer.batcher.prepared
        np.testing.assert_array_equal(
            served["blocks"]["attn"]["qkv"]["q"].numpy(),
            np.asarray(jq["blocks"]["attn"]["qkv"]["q"]))
        client = NodeClient(f"127.0.0.1:{port}")
        for p, r in zip(PROMPTS, rids):
            np.testing.assert_array_equal(
                client.generate(p, max_new_tokens=8, timeout=60), res[r])
        client.close()
    finally:
        stop()
    with pytest.raises(ValueError, match="LoRA"):
        LMServer(CFG_T, from_jax_params(tree, CFG_T, "cpu"), device="cpu",
                 weights="int8", lora_adapters=[{}], **POOL)
    with pytest.raises(ValueError, match="weights"):
        LMServer(CFG_T, from_jax_params(tree, CFG_T, "cpu"), device="cpu",
                 weights="int4", **POOL)


def test_node_serve_lm_weights_int8_process(tree, tmp_path):
    """`node --serve_lm --weights int8` as a process (gpt2-test, CPU):
    the JAX batcher's streams over the same quantized tree."""
    from dnn_tpu_torch.comm.client import NodeClient
    from test_torch_lm_server import _free_port
    from test_torch_serving_lora import daemon_env, save_tree_npz, wait_daemon

    npz = save_tree_npz(tree, tmp_path / "w.npz")
    port = _free_port()
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "model": "gpt2-test", "num_parts": 1, "device_type": "cpu",
        "nodes": [{"id": "node1", "address": f"127.0.0.1:{port}",
                   "part_index": 0}]}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dnn_tpu_torch.node", "--node_id", "node1",
         "--config", str(cfg), "--serve_lm", "--device", "cpu",
         "--weights_npz", str(npz), "--weights", "int8", "--slots", "3",
         "--max_len", "64", "--prompt_pad", "16", "--block_len", "8"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=daemon_env())
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        wait_daemon(client, proc)
        got = [client.generate(p, max_new_tokens=8, timeout=60)
               for p in PROMPTS]
        client.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    jb = JaxBatcher(CFG_J, jquant.quantize_gpt(_jprep(tree), bits=8),
                    kv="paged", **POOL)
    rids = [jb.submit(p, 8) for p in PROMPTS]
    res = jb.drain()
    for g, r in zip(got, rids):
        np.testing.assert_array_equal(g, res[r])
