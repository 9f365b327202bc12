"""Export the port's parameters as torch-layout `.pth` checkpoints (port
of dnn_tpu/io/torch_export.py: the cifar, GPT-2, LLaMA-family and Phi
converters).

The inverse of io/checkpoint.py's readers: a model trained by the port
goes back out as the state dict a reference node, HuggingFace's
`GPT2LMHeadModel` (layout "conv1d") or nanoGPT (layout "linear") loads,
or HF's `LlamaForCausalLM` / `Qwen2ForCausalLM` / `PhiForCausalLM` (and
the other families sharing the LLaMA layout) load, and the JAX package's
`load_pth_state_dict` reads it bit for bit.
`save_pth` is `torch.save` of a dict of CPU tensors, each with a storage
of its own.

Parameters may be numpy arrays or torch tensors on any device; GPT and
LLaMA-family parameters may be the per-layer tree ("h_0".."h_{L-1}") or
the stacked form `prepare_stacked` and training use ("blocks", a leading
layer axis).
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
    """Every layer's parameters, from the per-layer or the stacked tree
    (of either family)."""
    if "blocks" in params:
        blocks = _map(_t, params["blocks"])
        n_layer = blocks["attn"][next(iter(blocks["attn"]))]["kernel"] \
            .shape[0]
        return [layer_params(blocks, i) for i in range(n_layer)]
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


def _export_lin(sd: Dict[str, torch.Tensor], name: str, leaf):
    """A linear leaf -> torch's (out, in) weight and its bias, if any."""
    sd[name + ".weight"] = _t(leaf["kernel"]).T
    if "bias" in leaf:
        sd[name + ".bias"] = _t(leaf["bias"])


def llama_state_dict_from_params(params) -> Dict[str, torch.Tensor]:
    """The port's LLaMA-family parameters -> an HF
    `LlamaForCausalLM`-layout state dict ("model."-prefixed), which every
    family sharing the layout loads (LLaMA, Qwen2 with its q/k/v biases,
    Qwen3 and OLMo-2 with q/k norms, Gemma); JAX's
    llama_state_dict_from_params (:198), the inverse of
    llama_params_from_state_dict. A tree with "post_ln_1" exports
    Gemma-2's norm names (OLMo-2's without pre-norms); a tied tree (no
    "lm_head") exports no lm_head.weight; a Phi tree (one norm a layer,
    no post norms) goes to phi_state_dict_from_params."""
    layers = _gpt_layers(params)
    if layers and "ln_2" not in layers[0] and "post_ln_1" not in layers[0]:
        return phi_state_dict_from_params(params)
    sd = {"model.embed_tokens.weight": _t(params["wte"]["embedding"]),
          "model.norm.weight": _t(params["ln_f"]["scale"])}
    for i, bp in enumerate(layers):
        p = f"model.layers.{i}."
        if "ln_1" in bp:
            sd[p + "input_layernorm.weight"] = _t(bp["ln_1"]["scale"])
        for n in ("q", "k", "v", "o"):
            _export_lin(sd, p + f"self_attn.{n}_proj", bp["attn"][n])
        if "q_norm" in bp["attn"]:
            sd[p + "self_attn.q_norm.weight"] = _t(bp["attn"]["q_norm"]["scale"])
            sd[p + "self_attn.k_norm.weight"] = _t(bp["attn"]["k_norm"]["scale"])
        for n in ("gate", "up", "down"):
            _export_lin(sd, p + f"mlp.{n}_proj", bp["mlp"][n])
        if "post_ln_1" in bp:
            sd[p + "post_attention_layernorm.weight"] = \
                _t(bp["post_ln_1"]["scale"])
            if "ln_1" in bp:  # Gemma-2; OLMo-2 has no pre-norms
                sd[p + "pre_feedforward_layernorm.weight"] = \
                    _t(bp["ln_2"]["scale"])
            sd[p + "post_feedforward_layernorm.weight"] = \
                _t(bp["post_ln_2"]["scale"])
        else:
            sd[p + "post_attention_layernorm.weight"] = _t(bp["ln_2"]["scale"])
    if "lm_head" in params:
        sd["lm_head.weight"] = _t(params["lm_head"]["kernel"]).T
    return {k: v.contiguous() for k, v in sd.items()}


def phi_state_dict_from_params(params) -> Dict[str, torch.Tensor]:
    """The port's Phi parameters (parallel block) -> an HF
    `PhiForCausalLM` state dict (JAX's phi_state_dict_from_params :270;
    the inverse of phi_params_from_state_dict): biased LayerNorms, o as
    `self_attn.dense`, the plain MLP as `mlp.fc1/fc2`, lm_head with its
    bias."""
    sd = {"model.embed_tokens.weight": _t(params["wte"]["embedding"]),
          "model.final_layernorm.weight": _t(params["ln_f"]["scale"]),
          "model.final_layernorm.bias": _t(params["ln_f"]["bias"])}
    for i, bp in enumerate(_gpt_layers(params)):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = _t(bp["ln_1"]["scale"])
        sd[p + "input_layernorm.bias"] = _t(bp["ln_1"]["bias"])
        for n in ("q", "k", "v"):
            _export_lin(sd, p + f"self_attn.{n}_proj", bp["attn"][n])
        _export_lin(sd, p + "self_attn.dense", bp["attn"]["o"])
        _export_lin(sd, p + "mlp.fc1", bp["mlp"]["up"])
        _export_lin(sd, p + "mlp.fc2", bp["mlp"]["down"])
    if "lm_head" in params:
        _export_lin(sd, "lm_head", params["lm_head"])
    return {k: v.contiguous() for k, v in sd.items()}
