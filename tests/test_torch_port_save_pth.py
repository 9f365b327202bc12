"""The port's `.pth` export read back by the JAX package's torch-free
reader (dnn_tpu/io/checkpoint.load_pth_state_dict) bit for bit: GPT-2
parameters in both layouts, from the stacked form training uses and from
the per-layer tree, and the cifar CNN; the JAX converters then give the
original parameters back exactly."""

import numpy as np
import pytest
import torch

import jax

from dnn_tpu.io.checkpoint import (
    cifar_params_from_torch_state_dict,
    gpt_params_from_state_dict,
    load_pth_state_dict,
)
from dnn_tpu.io.torch_export import (
    gpt_state_dict_from_params as jax_gpt_state_dict,
)
from dnn_tpu.models import gpt as jgpt
from dnn_tpu_torch.io.torch_export import (
    cifar_state_dict_from_params,
    gpt_state_dict_from_params,
    save_pth,
)
from dnn_tpu_torch.models import gpt as tgpt
from dnn_tpu_torch.registry import get_model

SHAPE = dict(block_size=32, vocab_size=96, n_layer=3, n_head=2, n_embd=16)


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jgpt.init(jax.random.PRNGKey(6),
                                               jgpt.GPTConfig(**SHAPE)))


def _leaves(t, prefix=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], np.asarray(t)


def _read_back(tmp_path, sd):
    path = tmp_path / "model.pth"
    save_pth(str(path), sd)
    back = load_pth_state_dict(str(path))
    assert list(back) == list(sd)
    for k, v in sd.items():
        assert back[k].dtype == np.float32 and back[k].shape == v.shape, k
        assert back[k].tobytes() == v.numpy().tobytes(), k
    return back


@pytest.mark.parametrize("form", ["stacked", "per_layer"])
@pytest.mark.parametrize("layout", ["conv1d", "linear"])
def test_gpt_export_reads_back_bit_for_bit(tmp_path, tree, layout, form):
    cfg = tgpt.GPTConfig(**SHAPE)
    prepared = (tgpt.prepare_stacked(tree, cfg, "cpu") if form == "stacked"
                else tgpt.tensors(tree, "cpu"))
    sd = gpt_state_dict_from_params(prepared, layout=layout)
    want = jax_gpt_state_dict(tree, layout=layout)
    assert list(sd) == list(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k])
    back = _read_back(tmp_path, sd)
    got = gpt_params_from_state_dict(back, SHAPE["n_layer"])
    mine, theirs = dict(_leaves(got)), dict(_leaves(tree))
    assert mine.keys() == theirs.keys()
    for k in theirs:
        assert np.array_equal(mine[k], theirs[k]), k


def test_cifar_export_reads_back_bit_for_bit(tmp_path):
    params = get_model("cifar_cnn").init(3)
    sd = cifar_state_dict_from_params(
        {k: {n: torch.from_numpy(a) for n, a in v.items()}
         for k, v in params.items()})
    back = _read_back(tmp_path, sd)
    assert back["conv1.weight"].shape == (32, 3, 3, 3)
    assert back["fc1.weight"].shape == (512, 8 * 8 * 64)
    got = cifar_params_from_torch_state_dict(back)
    for k, v in dict(_leaves(params)).items():
        assert np.array_equal(dict(_leaves(got))[k], v), k


def test_torch_load_reads_the_same_tensors(tmp_path, tree):
    sd = gpt_state_dict_from_params(
        tgpt.prepare_stacked(tree, tgpt.GPTConfig(**SHAPE), "cpu"))
    path = tmp_path / "m.pth"
    save_pth(str(path), sd)
    loaded = torch.load(path, weights_only=True)
    assert list(loaded) == list(sd)
    for k in sd:
        assert torch.equal(loaded[k], sd[k])
        assert loaded[k].untyped_storage().nbytes() == sd[k].nbytes


def test_layout_is_checked(tree):
    with pytest.raises(ValueError, match="layout"):
        gpt_state_dict_from_params(tree, layout="fused")
