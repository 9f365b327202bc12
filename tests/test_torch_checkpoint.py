"""The port's checkpoint readers and converters on the CPU: the `.pth`
reader against torch.save, the hand-written safetensors reader against
the `safetensors` package, the converters bit-equal to the JAX
package's, a random HF GPT2LMHeadModel loaded through the registry and
the engine (logits within 1e-4 of HF's: two frameworks' f32 matmuls
over 4 layers), the native flat .npz round trip, and the LM daemon
serving that HF checkpoint with the JAX batcher's greedy tokens."""

import json
import pathlib
import pickle
import signal
import socket
import subprocess
import sys
import zipfile

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from dnn_tpu.io import checkpoint as jckpt
from dnn_tpu_torch.config import TopologyConfig
from dnn_tpu_torch.io import checkpoint as ckpt
from dnn_tpu_torch.registry import get_model
from dnn_tpu_torch.runtime.engine import PipelineEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cifar_module():
    torch.manual_seed(0)
    m = nn.Sequential()
    m.add_module("conv1", nn.Conv2d(3, 32, 3, 1, 1))
    m.add_module("conv2", nn.Conv2d(32, 64, 3, 1, 1))
    m.add_module("fc1", nn.Linear(64 * 8 * 8, 512))
    m.add_module("fc2", nn.Linear(512, 10))
    return m


@pytest.fixture(scope="module")
def cifar_pth(tmp_path_factory):
    m = _cifar_module()
    path = tmp_path_factory.mktemp("ckpt") / "cifar10_model.pth"
    torch.save(m.state_dict(), str(path))
    return str(path), {k: v.numpy() for k, v in m.state_dict().items()}


def test_pth_reader_matches_torch_and_jax(cifar_pth):
    path, want = cifar_pth
    got = ckpt.load_pth_state_dict(path)
    jgot = jckpt.load_pth_state_dict(path)
    assert sorted(got) == sorted(want) == sorted(jgot)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], jgot[k])
    assert ckpt.load_checkpoint(path).keys() == got.keys()


class _Payload:
    def __reduce__(self):
        return (eval, ("1 + 1",))


@pytest.mark.parametrize("how", ["zip_of_eval", "torch_save_of_object"])
def test_pth_reader_rejects_code(tmp_path, how):
    """Only tensors and plain containers unpickle: a pickled builtin or
    object raises instead of running."""
    evil = tmp_path / "evil.pth"
    if how == "zip_of_eval":
        with zipfile.ZipFile(evil, "w") as zf:
            zf.writestr("archive/data.pkl", pickle.dumps(eval))
    else:
        torch.save({"w": torch.ones(2), "x": _Payload()}, str(evil))
    with pytest.raises(Exception):
        ckpt.load_pth_state_dict(str(evil))


def test_pth_reader_keeps_scalar_tensors_and_bf16(tmp_path):
    p = tmp_path / "scalars.pth"
    w = torch.randn(3, 5).to(torch.bfloat16)
    torch.save({"step": torch.tensor(7), "scale": torch.tensor(0.5),
                "w": w, "meta": "dropped", "nested": {"b": torch.ones(2)}},
               str(p))
    got = ckpt.load_pth_state_dict(str(p))
    assert set(got) == {"step", "scale", "w", "nested.b"}
    assert got["step"].shape == () and int(got["step"]) == 7
    assert float(got["scale"]) == 0.5
    assert got["w"].dtype == np.float32
    np.testing.assert_array_equal(got["w"], w.float().numpy())


def test_pth_reader_refuses_a_zip_that_is_not_torch(tmp_path):
    p = tmp_path / "notatorch.pth"
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("hello.txt", "hi")
    with pytest.raises(ValueError, match="data.pkl"):
        ckpt.load_pth_state_dict(str(p))


def _st_dict():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((4, 6), dtype=np.float32),
        "bf16": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
        "f16": rng.standard_normal(7).astype(np.float16),
        "i64": rng.integers(-9, 9, (2, 2)),
        "u8": rng.integers(0, 255, 5).astype(np.uint8),
        "scalar": np.array(2.5, np.float32),
    }


@pytest.mark.parametrize("keys", [None, {"bf16", "i64"}])
def test_safetensors_reader_equals_the_package(tmp_path, keys):
    """The format read by hand: f32/f16/int values as stored, bf16
    widened to f32, a key subset; equal to safetensors.numpy's load."""
    st = pytest.importorskip("safetensors.numpy")
    sd = _st_dict()
    path = tmp_path / "m.safetensors"
    st.save_file(sd, str(path), metadata={"format": "np"})
    want = st.load_file(str(path))
    got = ckpt.load_safetensors(str(path), keys=keys)
    assert set(got) == (set(want) if keys is None else keys)
    for k, v in got.items():
        ref = want[k]
        if ref.dtype == ml_dtypes.bfloat16:
            assert v.dtype == np.float32
            ref = ref.astype(np.float32)
        else:
            assert v.dtype == ref.dtype
        assert v.shape == ref.shape
        np.testing.assert_array_equal(v, ref)


def test_safetensors_reader_refuses_a_short_payload(tmp_path):
    header = json.dumps({"w": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 12]}}).encode()
    path = tmp_path / "bad.safetensors"
    path.write_bytes(len(header).to_bytes(8, "little") + header + bytes(12))
    with pytest.raises(ValueError, match="holds 3 values"):
        ckpt.load_safetensors(str(path))


def test_cifar_converter_bit_equal_to_jax(cifar_pth):
    _, sd = cifar_pth
    got = ckpt.cifar_params_from_torch_state_dict(sd)
    want = jckpt.cifar_params_from_torch_state_dict(sd)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    assert got["conv1"]["kernel"].shape == (3, 3, 3, 32)
    # the converted module predicts as the torch module does
    m = _cifar_module()
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3),
                                                 dtype=np.float32)
    with torch.no_grad():
        h = torch.from_numpy(x).permute(0, 3, 1, 2)
        h = torch.max_pool2d(torch.relu(m.conv1(h)), 2)
        h = torch.max_pool2d(torch.relu(m.conv2(h)), 2).flatten(1)
        ref = torch.softmax(m.fc2(torch.relu(m.fc1(h))), dim=1)
    from dnn_tpu_torch.parallel.pipeline import place

    out = get_model("cifar_cnn").apply(place(got, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-5)


def _hf_model(n_layer=4, scale=1.0):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.GPT2Config(vocab_size=256, n_positions=64, n_embd=64,
                                  n_layer=n_layer, n_head=4, resid_pdrop=0.0,
                                  embd_pdrop=0.0, attn_pdrop=0.0)
    model = transformers.GPT2LMHeadModel(cfg).eval()
    if scale != 1.0:
        with torch.no_grad():
            for p in model.parameters():
                if p.ndim >= 2:
                    p.mul_(scale)
    return model


@pytest.mark.parametrize("layout", ["hf", "nanogpt"])
def test_gpt_converter_bit_equal_to_jax(layout):
    sd = {k: v.numpy() for k, v in _hf_model(n_layer=2).state_dict().items()}
    if layout == "nanogpt":  # nn.Linear (out, in) weights, no prefix
        sd = {k[len("transformer."):] if k.startswith("transformer.") else k:
              (v.T.copy() if k.endswith(("c_attn.weight", "c_proj.weight",
                                         "c_fc.weight")) else v)
              for k, v in sd.items()}
    got = ckpt.gpt_params_from_state_dict(sd)
    want = jckpt.gpt_params_from_state_dict(sd)
    assert sorted(got) == sorted(want)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    assert ckpt._detect_gpt_layout(sd) == jckpt._detect_gpt_layout(
        ckpt._strip_prefix(sd))


@pytest.fixture(scope="module")
def hf_files(tmp_path_factory):
    """A random gpt2-test-shaped GPT2LMHeadModel saved by HF
    (model.safetensors) and by torch.save (.bin)."""
    model = _hf_model()
    d = tmp_path_factory.mktemp("hf")
    model.save_pretrained(str(d))
    torch.save(model.state_dict(), str(d / "pytorch_model.bin"))
    return model, d


@pytest.mark.parametrize("name", ["model.safetensors", "pytorch_model.bin"])
def test_hf_checkpoint_through_the_engine_matches_hf(hf_files, name):
    model, d = hf_files
    raw = {"model": "gpt2-test", "num_parts": 2, "device_type": "cpu",
           "runtime": "relay", "model_weights": str(d / name)}
    engine = PipelineEngine(TopologyConfig.from_dict(raw))
    ids = np.array([[3, 17, 9, 100, 42, 7, 250, 0]], dtype=np.int32)
    with torch.no_grad():
        want = model(torch.from_numpy(ids).long()).logits.numpy()
    got = engine.run(ids).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_native_flat_npz_round_trip(tmp_path):
    params = get_model("cifar_cnn").init(2)
    flat = ckpt.params_to_flat(params)
    assert ckpt.is_native_flat(flat)
    assert not ckpt.is_native_flat({"conv1.weight": np.zeros(1)})
    assert flat.keys() == jckpt.params_to_flat(params).keys()
    path = tmp_path / "p.npz"
    ckpt.save_npz(str(path), flat)
    back = ckpt.flat_to_params(ckpt.load_checkpoint(str(path)))
    jax.tree.map(np.testing.assert_array_equal, back, params)
    # the JAX package reads the port's file, and the port reads JAX's
    jback = jckpt.flat_to_params(jckpt.load_checkpoint(str(path)))
    jax.tree.map(np.testing.assert_array_equal, jback, params)
    jpath = tmp_path / "j.npz"
    jckpt.save_npz(str(jpath), jckpt.params_to_flat(params))
    jax.tree.map(np.testing.assert_array_equal,
                 ckpt.flat_to_params(ckpt.load_npz(str(jpath))), params)
    with pytest.raises(ValueError, match="Unsupported"):
        ckpt.load_checkpoint(str(tmp_path / "p.h5"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_lm_daemon_serves_an_hf_checkpoint_like_jax(tmp_path):
    """`node --serve_lm` with `model_weights` naming a GPT2LMHeadModel
    safetensors file (weights x15, so the argmaxes are decisive): its
    greedy tokens equal the JAX batcher's on the weights the JAX engine
    loads from the same file."""
    from dnn_tpu.config import TopologyConfig as JaxConfig
    from dnn_tpu.models import gpt as jgpt
    from dnn_tpu.runtime.engine import PipelineEngine as JaxEngine
    from dnn_tpu.runtime.serving import ContinuousBatcher as JaxBatcher
    from dnn_tpu_torch.comm.client import NodeClient

    model = _hf_model(scale=15.0)
    model.save_pretrained(str(tmp_path))
    port = _free_port()
    raw = {"model": "gpt2-test", "device_type": "cpu",
           "model_weights": str(tmp_path / "model.safetensors"),
           "nodes": [{"id": "node1", "part_index": 0,
                      "address": f"127.0.0.1:{port}"}]}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(raw))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dnn_tpu_torch.node", "--node_id", "node1",
         "--config", str(cfg_path), "--serve_lm", "--slots", "2",
         "--max_len", "64", "--prompt_pad", "16", "--block_len", "8"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        jeng = JaxEngine(JaxConfig.from_dict({**raw, "runtime": "relay"}))
        cfg = jgpt.PRESETS["gpt2-test"]
        jb = JaxBatcher(cfg, jgpt.prepare_stacked(
            jax.tree.map(jnp.asarray, jeng.params), cfg), slots=2,
            max_len=64, prompt_pad=16, block_len=8, kv="paged")
        prompts = [np.random.default_rng(i).integers(0, 256, n).astype(
            np.int32) for i, n in enumerate((5, 21))]
        rids = [jb.submit(p, 8) for p in prompts]
        res = jb.drain()
        client = NodeClient(f"127.0.0.1:{port}")
        assert client.wait_healthy(deadline=90)
        for p, rid in zip(prompts, rids):
            got = client.generate(p, max_new_tokens=8)
            np.testing.assert_array_equal(got, np.asarray(res[rid]))
        client.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
