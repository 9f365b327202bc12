"""Export the port's parameters as torch-layout `.pth` checkpoints (port
of dnn_tpu/io/torch_export.py, the cifar and GPT-2 converters).

The inverse of io/checkpoint.py's readers: a model trained by the port
goes back out as the state dict a reference node, HuggingFace's
`GPT2LMHeadModel` (layout "conv1d") or nanoGPT (layout "linear") loads,
and the JAX package's `load_pth_state_dict` reads it bit for bit.
`save_pth` is `torch.save` of a dict of CPU tensors, each with a storage
of its own.

Parameters may be numpy arrays or torch tensors on any device; GPT
parameters may be the per-layer tree ("h_0".."h_{L-1}") or the stacked
form `prepare_stacked` and training use ("blocks", a leading layer
axis). The llama and phi exporters wait for those model families
(ROADMAP PyTorch/CUDA port item 7).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dnn_tpu_torch.models.gpt import _map, layer_params


def _t(x) -> torch.Tensor:
    """A leaf -> a CPU tensor (a view where it can be)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.asarray(x))


def save_pth(path: str, flat_state_dict: Dict[str, object]):
    """Write {name: array or tensor} as a torch zipfile checkpoint, each
    tensor contiguous on the CPU with a storage of its own."""
    torch.save({k: _t(v).contiguous().clone()
                for k, v in flat_state_dict.items()}, path)


def cifar_state_dict_from_params(params) -> Dict[str, torch.Tensor]:
    """The port's cifar parameters (NHWC/HWIO, models/cifar.py) -> the
    reference CNN's state dict (conv1/conv2/fc1/fc2 .weight/.bias,
    OIHW and (out, in)); the inverse of
    cifar_params_from_torch_state_dict."""
    sd = {}
    for name in ("conv1", "conv2"):
        sd[f"{name}.weight"] = _t(params[name]["kernel"]).permute(3, 2, 0, 1)
        sd[f"{name}.bias"] = _t(params[name]["bias"])
    for name in ("fc1", "fc2"):
        sd[f"{name}.weight"] = _t(params[name]["kernel"]).T
        sd[f"{name}.bias"] = _t(params[name]["bias"])
    return {k: v.contiguous() for k, v in sd.items()}


def _gpt_layers(params):
    if "blocks" in params:
        n_layer = _t(params["blocks"]["ln_1"]["scale"]).shape[0]
        return [layer_params(_map(_t, params["blocks"]), i)
                for i in range(n_layer)]
    n_layer = sum(1 for k in params if k.startswith("h_"))
    return [params[f"h_{i}"] for i in range(n_layer)]


def gpt_state_dict_from_params(params, *, layout: str = "conv1d"
                               ) -> Dict[str, torch.Tensor]:
    """The port's GPT parameters -> an HF-GPT-2-style state dict:
    `layout="conv1d"` keeps projection weights (in, out) as HF's Conv1D
    does, `layout="linear"` stores them (out, in) as nanoGPT does; the
    inverse of gpt_params_from_state_dict. lm_head.weight is (out, in)
    in both."""
    if layout not in ("conv1d", "linear"):
        raise ValueError(f"layout must be conv1d|linear, got {layout}")

    def w(x):
        return _t(x) if layout == "conv1d" else _t(x).T

    sd = {
        "wte.weight": _t(params["wte"]["embedding"]),
        "wpe.weight": _t(params["wpe"]["embedding"]),
        "ln_f.weight": _t(params["ln_f"]["scale"]),
        "ln_f.bias": _t(params["ln_f"]["bias"]),
    }
    for i, bp in enumerate(_gpt_layers(params)):
        p = f"h.{i}."
        sd[p + "ln_1.weight"] = _t(bp["ln_1"]["scale"])
        sd[p + "ln_1.bias"] = _t(bp["ln_1"]["bias"])
        sd[p + "attn.c_attn.weight"] = w(bp["attn"]["qkv"]["kernel"])
        sd[p + "attn.c_attn.bias"] = _t(bp["attn"]["qkv"]["bias"])
        sd[p + "attn.c_proj.weight"] = w(bp["attn"]["proj"]["kernel"])
        sd[p + "attn.c_proj.bias"] = _t(bp["attn"]["proj"]["bias"])
        sd[p + "ln_2.weight"] = _t(bp["ln_2"]["scale"])
        sd[p + "ln_2.bias"] = _t(bp["ln_2"]["bias"])
        sd[p + "mlp.c_fc.weight"] = w(bp["mlp"]["fc"]["kernel"])
        sd[p + "mlp.c_fc.bias"] = _t(bp["mlp"]["fc"]["bias"])
        sd[p + "mlp.c_proj.weight"] = w(bp["mlp"]["proj"]["kernel"])
        sd[p + "mlp.c_proj.bias"] = _t(bp["mlp"]["proj"]["bias"])
    sd["lm_head.weight"] = _t(params["lm_head"]["kernel"]).T
    return {k: v.contiguous() for k, v in sd.items()}
