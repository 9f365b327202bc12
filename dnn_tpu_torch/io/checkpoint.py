"""Checkpoint loading and torch -> JAX-layout weight conversion (port of
the weights half of dnn_tpu/io/checkpoint.py).

Readers return a flat {name: numpy array} state dict:
  * `.pth`/`.pt`/`.bin` through `torch.load(weights_only=True)`, which
    refuses pickled code; 0-d tensors stay 0-d arrays; a zip without a
    `data.pkl` member is refused as not a torch checkpoint;
  * `.safetensors` through a small reader of the format (an 8-byte
    little-endian header length, a JSON header, then raw little-endian
    buffers), so no `safetensors` package is needed;
  * `.npz`.
numpy has no bfloat16: a bf16 tensor comes back widened to float32,
which is exact.

The converters (cifar, GPT-2, and the LLaMA and Phi families' HF
layouts) turn torch layouts (NCHW/OIHW convolutions, (out, in) linears,
HF Conv1D) into the JAX package's tree (HWIO convolutions,
(in, out) kernels). `params_to_flat`/`flat_to_params` are the native
flat layout ("/"-joined keys), which `save_npz` writes.
"""

from __future__ import annotations

import json
import os
import struct
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

# ----------------------------------------------------------------------
# .pth
# ----------------------------------------------------------------------


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _flatten_state_dict(obj, prefix="") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                out.update(_flatten_state_dict(v, key))
            elif isinstance(v, torch.Tensor):
                out[key] = _to_numpy(v)
            # non-tensor metadata entries are dropped
    return out


def load_pth_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch-saved state dict -> {name: numpy array}. Only tensors and
    plain containers are unpickled (`weights_only=True`); anything else
    raises."""
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            if not any(n.endswith("data.pkl") for n in zf.namelist()):
                raise ValueError(f"{path} is a zip archive but not a torch "
                                 "checkpoint (no data.pkl member)")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return _flatten_state_dict(obj)


# ----------------------------------------------------------------------
# .safetensors
# ----------------------------------------------------------------------

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}


def _bf16_to_f32(words: np.ndarray) -> np.ndarray:
    return (words.astype(np.uint32) << 16).view(np.float32)


def load_safetensors(path: str, keys=None) -> Dict[str, np.ndarray]:
    """A .safetensors file -> {name: numpy array} (only `keys` when
    given). BF16 tensors are widened to float32."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__" or (keys is not None and name not in keys):
            continue
        dtype = info["dtype"]
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        buf = data[start:end]
        if dtype == "BF16":
            arr = _bf16_to_f32(np.frombuffer(buf, dtype="<u2"))
        elif dtype in _ST_DTYPES:
            arr = np.frombuffer(buf, dtype=np.dtype(_ST_DTYPES[dtype])
                                .newbyteorder("<"))
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported "
                             f"safetensors dtype {dtype}")
        count = int(np.prod(shape)) if shape else 1
        if arr.size != count:
            raise ValueError(f"{path}: tensor {name!r} holds {arr.size} "
                             f"values, shape {shape} needs {count}")
        out[name] = arr.astype(arr.dtype.newbyteorder("="),
                               copy=True).reshape(shape)
    return out


# ----------------------------------------------------------------------
# .npz and dispatch
# ----------------------------------------------------------------------


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def save_npz(path: str, flat_state_dict: Dict[str, np.ndarray]):
    np.savez(path, **flat_state_dict)


def load_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Dispatch on extension: .pth/.pt/.bin (torch), .npz, .safetensors."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pth", ".pt", ".bin"):
        return load_pth_state_dict(path)
    if ext == ".npz":
        return load_npz(path)
    if ext == ".safetensors":
        return load_safetensors(path)
    raise ValueError(f"Unsupported checkpoint format: {path}")


# ----------------------------------------------------------------------
# torch layout -> JAX-package layout
# ----------------------------------------------------------------------


def _t_conv(w: np.ndarray) -> np.ndarray:
    """torch OIHW conv weight -> HWIO."""
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _t_linear(w: np.ndarray) -> np.ndarray:
    """torch (out, in) linear weight -> (in, out)."""
    return np.ascontiguousarray(w.T)


def cifar_params_from_torch_state_dict(sd: Dict[str, np.ndarray]):
    """The reference CNN's state dict (conv1/conv2/fc1/fc2 .weight/.bias)
    -> the cifar_cnn tree. fc1 needs only the (out, in) transpose: the
    model's flatten emits the (C, H, W) feature order."""
    return {
        "conv1": {"kernel": _t_conv(sd["conv1.weight"]),
                  "bias": sd["conv1.bias"]},
        "conv2": {"kernel": _t_conv(sd["conv2.weight"]),
                  "bias": sd["conv2.bias"]},
        "fc1": {"kernel": _t_linear(sd["fc1.weight"]), "bias": sd["fc1.bias"]},
        "fc2": {"kernel": _t_linear(sd["fc2.weight"]), "bias": sd["fc2.bias"]},
    }


def _strip_prefix(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    if any(k.startswith("transformer.") for k in sd):
        return {k[len("transformer."):] if k.startswith("transformer.")
                else k: v for k, v in sd.items()}
    return sd


def _detect_gpt_layout(sd: Dict[str, np.ndarray]) -> str:
    """HF GPT-2's Conv1D weights are stored (in, out), nanoGPT's
    nn.Linear (out, in): told apart by the non-square c_attn shape."""
    for k, v in sd.items():
        if k.endswith("attn.c_attn.weight"):
            if v.shape[1] == 3 * v.shape[0]:
                return "conv1d"
            if v.shape[0] == 3 * v.shape[1]:
                return "linear"
    raise ValueError(
        "Cannot detect GPT checkpoint layout (no c_attn.weight found)")


def gpt_params_from_state_dict(sd: Dict[str, np.ndarray],
                               n_layer: Optional[int] = None):
    """An HF GPT-2 or nanoGPT state dict -> the GPT tree {"wte", "wpe",
    "h_i", "ln_f", "lm_head"}; lm_head is tied to wte when the dict has
    none."""
    sd = _strip_prefix(sd)
    w = (np.ascontiguousarray if _detect_gpt_layout(sd) == "conv1d"
         else _t_linear)
    if n_layer is None:
        n_layer = 1 + max(int(k.split(".")[1]) for k in sd
                          if k.startswith("h.") and k.split(".")[1].isdigit())

    def lin(prefix):
        return {"kernel": w(sd[prefix + ".weight"]),
                "bias": sd[prefix + ".bias"]}

    def ln(prefix):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    params = {"wte": {"embedding": sd["wte.weight"]},
              "wpe": {"embedding": sd["wpe.weight"]},
              "ln_f": ln("ln_f")}
    for i in range(n_layer):
        p = f"h.{i}."
        params[f"h_{i}"] = {
            "ln_1": ln(p + "ln_1"),
            "attn": {"qkv": lin(p + "attn.c_attn"),
                     "proj": lin(p + "attn.c_proj")},
            "ln_2": ln(p + "ln_2"),
            "mlp": {"fc": lin(p + "mlp.c_fc"), "proj": lin(p + "mlp.c_proj")},
        }
    if "lm_head.weight" in sd:
        params["lm_head"] = {"kernel": _t_linear(sd["lm_head.weight"])}
    else:
        params["lm_head"] = {"kernel": np.ascontiguousarray(
            sd["wte.weight"].T)}
    return params


def _hf_layers(sd: Dict[str, np.ndarray], n_layer: Optional[int]):
    """HF's "model."-prefixed names without the prefix, and the layer
    count (from the "layers.N." names when not given)."""
    sd = {(k[len("model."):] if k.startswith("model.") else k): v
          for k, v in sd.items()}
    if n_layer is None:
        n_layer = 1 + max(
            int(k.split(".")[1]) for k in sd
            if k.startswith("layers.") and k.split(".")[1].isdigit())
    return sd, n_layer


def _hf_proj(sd: Dict[str, np.ndarray], key: str):
    """A torch Linear -> {"kernel" (in, out)[, "bias"]}."""
    out = {"kernel": _t_linear(sd[key + ".weight"])}
    if key + ".bias" in sd:
        out["bias"] = sd[key + ".bias"]
    return out


def llama_params_from_state_dict(sd: Dict[str, np.ndarray],
                                 n_layer: Optional[int] = None,
                                 post_norms: bool = False,
                                 tied_head: str = "materialize"):
    """An HF LlamaForCausalLM-layout state dict (LLaMA, Qwen2 with q/k/v
    biases, Qwen3 / OLMo-2 with q/k norms, Gemma) -> the LLaMA-family
    tree (JAX's checkpoint.llama_params_from_state_dict :312, the same
    leaves). Projections transpose (out, in) -> (in, out); any
    `*_proj.bias` rides along. `post_norms=True` reads Gemma-2's four
    norms (or OLMo-2's two post norms where the block has no
    input_layernorm). `tied_head="omit"` leaves lm_head out (the head
    projects through wte), after checking that a stored lm_head.weight
    equals the embedding; the default keeps lm_head.weight, or
    materialises the embedding's transpose."""
    sd, n_layer = _hf_layers(sd, n_layer)
    params = {"wte": {"embedding": sd["embed_tokens.weight"]},
              "ln_f": {"scale": sd["norm.weight"]}}
    for i in range(n_layer):
        p = f"layers.{i}."
        blk = {
            "attn": {n: _hf_proj(sd, p + f"self_attn.{n}_proj")
                     for n in ("q", "k", "v", "o")},
            "mlp": {n: _hf_proj(sd, p + f"mlp.{n}_proj")
                    for n in ("gate", "up", "down")},
        }
        if p + "input_layernorm.weight" in sd:
            blk["ln_1"] = {"scale": sd[p + "input_layernorm.weight"]}
        if p + "self_attn.q_norm.weight" in sd:
            blk["attn"]["q_norm"] = {
                "scale": sd[p + "self_attn.q_norm.weight"]}
            blk["attn"]["k_norm"] = {
                "scale": sd[p + "self_attn.k_norm.weight"]}
        if post_norms:
            blk["post_ln_1"] = {
                "scale": sd[p + "post_attention_layernorm.weight"]}
            blk["post_ln_2"] = {
                "scale": sd[p + "post_feedforward_layernorm.weight"]}
            if "ln_1" in blk:  # Gemma-2; OLMo-2 has no pre-norms
                blk["ln_2"] = {
                    "scale": sd[p + "pre_feedforward_layernorm.weight"]}
        else:
            blk["ln_2"] = {"scale": sd[p + "post_attention_layernorm.weight"]}
        params[f"h_{i}"] = blk
    if tied_head == "omit":
        if "lm_head.weight" in sd and not np.array_equal(
                sd["lm_head.weight"], sd["embed_tokens.weight"]):
            raise ValueError(
                "tied_head='omit' but the checkpoint's lm_head.weight "
                "differs from embed_tokens.weight — this model is not "
                "tied; convert with tied_head='materialize'")
    elif "lm_head.weight" in sd:
        params["lm_head"] = {"kernel": _t_linear(sd["lm_head.weight"])}
    else:
        params["lm_head"] = {"kernel": _t_linear(sd["embed_tokens.weight"])}
    return params


def phi_params_from_state_dict(sd: Dict[str, np.ndarray],
                               n_layer: Optional[int] = None):
    """An HF PhiForCausalLM state dict -> the LLaMA-family tree of a
    parallel-block config (JAX's checkpoint.phi_params_from_state_dict
    :420): biased LayerNorms, `self_attn.dense` as o, `mlp.fc1/fc2` as
    up/down, a bias on every projection, one norm a layer (ln_1)."""
    sd, n_layer = _hf_layers(sd, n_layer)

    def ln(prefix):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    params = {"wte": {"embedding": sd["embed_tokens.weight"]},
              "ln_f": ln("final_layernorm"),
              "lm_head": _hf_proj(sd, "lm_head")}
    for i in range(n_layer):
        p = f"layers.{i}."
        params[f"h_{i}"] = {
            "ln_1": ln(p + "input_layernorm"),
            "attn": {"q": _hf_proj(sd, p + "self_attn.q_proj"),
                     "k": _hf_proj(sd, p + "self_attn.k_proj"),
                     "v": _hf_proj(sd, p + "self_attn.v_proj"),
                     "o": _hf_proj(sd, p + "self_attn.dense")},
            "mlp": {"up": _hf_proj(sd, p + "mlp.fc1"),
                    "down": _hf_proj(sd, p + "mlp.fc2")},
        }
    return params


# ----------------------------------------------------------------------
# native flat layout
# ----------------------------------------------------------------------

_SEP = "/"


def params_to_flat(params, prefix="") -> Dict[str, np.ndarray]:
    """Nested parameter tree -> flat {"a/b/c": array}."""
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(params_to_flat(v, f"{prefix}{_SEP}{k}" if prefix
                                      else str(k)))
    else:
        out[prefix] = np.asarray(params)
    return out


def flat_to_params(flat: Dict[str, np.ndarray]):
    """Inverse of params_to_flat."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *parents, leaf = key.split(_SEP)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def is_native_flat(sd: Dict[str, np.ndarray]) -> bool:
    return bool(sd) and all(_SEP in k or "." not in k for k in sd)
