"""Torch-layout export tests: the hand-written .pth writer must satisfy
BOTH readers — real torch.load (torch is installed in this env) and this
package's torch-free parser — and the layout converters must invert the
import path exactly."""

import numpy as np
import pytest

import jax

from dnn_tpu.io.checkpoint import (
    cifar_params_from_torch_state_dict,
    gpt_params_from_state_dict,
    load_pth_state_dict,
)
from dnn_tpu.io.torch_export import (
    cifar_state_dict_from_params,
    gpt_state_dict_from_params,
    save_pth,
)

from test_torch_llama import one_torch_thread  # noqa: F401,E402 — autouse:
# one intra-op thread; the suite's parallel workers oversubscribe the cores

torch = pytest.importorskip("torch")


def _tree_equal(a, b):
    ja, jb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(ja) == len(jb)
    for x, y in zip(ja, jb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_save_pth_roundtrips_through_torch_load(tmp_path):
    rng = np.random.default_rng(0)
    sd = {
        "a.weight": rng.normal(size=(4, 3)).astype(np.float32),
        "a.bias": rng.normal(size=(300,)).astype(np.float32),  # numel > 255
        "b.ids": np.arange(6, dtype=np.int64).reshape(2, 3),
        "c.flag": np.array([True, False]),
        "d.scalar": np.float32(2.5).reshape(()),
    }
    path = str(tmp_path / "export.pth")
    save_pth(path, sd)

    loaded = torch.load(path, map_location="cpu", weights_only=True)
    assert set(loaded) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(loaded[k].numpy(), v)


def test_save_pth_roundtrips_through_own_reader(tmp_path):
    rng = np.random.default_rng(1)
    sd = {"x": rng.normal(size=(5, 7)).astype(np.float32),
          "y": rng.integers(0, 100, (3,)).astype(np.int32)}
    path = str(tmp_path / "own.pth")
    save_pth(path, sd)
    back = load_pth_state_dict(path)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v)


def test_cifar_export_import_is_identity():
    from dnn_tpu.models import cifar

    params = cifar.init(jax.random.PRNGKey(0))
    sd = cifar_state_dict_from_params(params)
    assert sd["conv1.weight"].shape == (32, 3, 3, 3)   # OIHW
    assert sd["fc1.weight"].shape == (512, 4096)
    back = cifar_params_from_torch_state_dict(sd)
    _tree_equal(params, back)


def test_cifar_export_matches_torch_forward(tmp_path):
    """The exported state dict, loaded into an equivalent torch model, must
    predict exactly like our NHWC model on the same image — the numerical
    basis of the reference-node interop."""
    import torch.nn as tnn
    import torch.nn.functional as tF

    from dnn_tpu.models import cifar

    class TorchCifar(tnn.Module):
        # same architecture as the reference NeuralNetwork
        # (cifar_model_parts.py:6-26), re-declared here for the test
        def __init__(self):
            super().__init__()
            self.conv1 = tnn.Conv2d(3, 32, 3, padding=1)
            self.conv2 = tnn.Conv2d(32, 64, 3, padding=1)
            self.fc1 = tnn.Linear(64 * 8 * 8, 512)
            self.fc2 = tnn.Linear(512, 10)

        def forward(self, x):
            x = tF.max_pool2d(tF.relu(self.conv1(x)), 2)
            x = tF.max_pool2d(tF.relu(self.conv2(x)), 2)
            x = x.reshape(-1, 64 * 8 * 8)
            x = tF.relu(self.fc1(x))
            return tF.softmax(self.fc2(x), dim=1)

    params = cifar.init(jax.random.PRNGKey(3))
    path = str(tmp_path / "cifar_export.pth")
    save_pth(path, cifar_state_dict_from_params(params))

    tm = TorchCifar()
    tm.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    tm.eval()

    x_nhwc = np.asarray(cifar.example_input(batch_size=4, rng=jax.random.PRNGKey(9)))
    ours = np.asarray(cifar.apply(params, x_nhwc))
    with torch.no_grad():
        theirs = tm(torch.from_numpy(x_nhwc.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-5, rtol=1e-4)
    np.testing.assert_array_equal(ours.argmax(1), theirs.argmax(1))


def test_gpt_export_import_is_identity():
    from dnn_tpu.models import gpt

    cfg = gpt.PRESETS["gpt2-test"]
    params = gpt.init(jax.random.PRNGKey(0), cfg)
    for layout in ("conv1d", "linear"):
        sd = gpt_state_dict_from_params(params, layout=layout)
        back = gpt_params_from_state_dict(sd, n_layer=cfg.n_layer)
        _tree_equal(params, back)


def test_gpt_export_loads_into_transformers(tmp_path):
    """HF-layout export must load into a real GPT2LMHeadModel and agree on
    logits."""
    from transformers import GPT2Config, GPT2LMHeadModel

    from dnn_tpu.models import gpt

    cfg = gpt.PRESETS["gpt2-test"]
    params = gpt.init(jax.random.PRNGKey(1), cfg)
    sd = {f"transformer.{k}" if not k.startswith("lm_head") else k: v
          for k, v in gpt_state_dict_from_params(params, layout="conv1d").items()}
    path = str(tmp_path / "gpt_export.pth")
    save_pth(path, sd)

    hf_cfg = GPT2Config(
        vocab_size=cfg.vocab_size, n_positions=cfg.block_size,
        n_embd=cfg.n_embd, n_layer=cfg.n_layer, n_head=cfg.n_head,
        attn_pdrop=0.0, embd_pdrop=0.0, resid_pdrop=0.0,
    )
    hf = GPT2LMHeadModel(hf_cfg)
    missing, unexpected = hf.load_state_dict(
        torch.load(path, map_location="cpu", weights_only=True), strict=False
    )
    # HF registers attn.bias/masked_bias buffers we don't export; nothing
    # else may be missing, and nothing may be unexpected.
    assert not unexpected
    assert all(".attn." in m or m.endswith(".bias") for m in missing), missing
    hf.eval()

    ids = np.asarray([[1, 2, 3, 4, 5]], np.int64)
    ours = np.asarray(gpt.make_apply(cfg)(params, ids.astype(np.int32)))
    with torch.no_grad():
        theirs = hf(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-3, rtol=1e-3)


def test_llama_family_export_import_is_identity():
    """llama_state_dict_from_params must invert
    llama_params_from_state_dict for every block variant: plain GQA,
    Qwen2 biases, Gemma-2 post-norms + tied head."""
    from dnn_tpu.io.checkpoint import llama_params_from_state_dict
    from dnn_tpu.io.torch_export import llama_state_dict_from_params
    from dnn_tpu.models import llama

    for name in ("llama-test", "qwen2-test", "gemma2-test"):
        cfg = llama.PRESETS[name]
        params = llama.init(jax.random.PRNGKey(3), cfg)
        sd = llama_state_dict_from_params(params)
        if cfg.tie_word_embeddings:
            assert "lm_head.weight" not in sd, name
        if cfg.attn_bias:
            assert "model.layers.0.self_attn.q_proj.bias" in sd, name
        back = llama_params_from_state_dict(
            sd, n_layer=cfg.n_layer, post_norms=cfg.post_norms,
            tied_head="omit" if cfg.tie_word_embeddings
            else "materialize")
        _tree_equal(params, back)


def test_llama_family_export_loads_into_transformers(tmp_path):
    """The fine-tune-and-hand-back loop: export framework params to a
    .pth, torch.load into the matching HF class, logits must agree —
    including the Gemma-2 tied head (HF reties in-place on load) and
    Qwen2 biases."""
    import transformers

    from dnn_tpu.io.torch_export import (
        llama_state_dict_from_params,
        save_pth,
    )
    from dnn_tpu.models import gpt as _gpt  # noqa: F401 (family helpers)
    from dnn_tpu.models import llama

    for name, cls_name in (("qwen2-test", "Qwen2ForCausalLM"),
                           ("gemma2-test", "Gemma2ForCausalLM")):
        cfg = llama.PRESETS[name]
        params = llama.init(jax.random.PRNGKey(4), cfg)
        sd = llama_state_dict_from_params(params)
        path = str(tmp_path / f"{name}.pth")
        save_pth(path, sd)

        hf = getattr(transformers, cls_name)(
            llama.to_hf_config(cfg, attn_implementation="eager")).eval()
        missing, unexpected = hf.load_state_dict(
            torch.load(path, map_location="cpu", weights_only=True),
            strict=False)
        assert not unexpected, (name, unexpected)
        # tied models may report lm_head missing; it shares the
        # embedding's storage, which the load just overwrote in place
        assert all("lm_head" in m or "rotary" in m for m in missing), \
            (name, missing)

        ids = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 12))
        ours = np.asarray(llama.make_apply(cfg)(params,
                                                ids.astype(np.int32)))
        with torch.no_grad():
            theirs = hf(torch.from_numpy(ids)).logits.numpy()
        np.testing.assert_allclose(ours, theirs, atol=3e-3, rtol=3e-3)
