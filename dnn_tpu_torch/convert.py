"""Carry weights between the JAX package and the port.

`from_jax_params` takes dnn_tpu's GPT param pytree — {"wte", "wpe",
"h_i", "ln_f", "lm_head"}, leaves as numpy arrays (np.asarray of the
JAX arrays) — and returns the port's prepared tensors, so both packages
run the very same weights. `load_npz` reads the same tree from a flat
.npz whose keys are the "/"-joined paths ("h_0/attn/qkv/kernel").
`to_jax_params` is the inverse of `from_jax_params`: trained weights go
back to the JAX package, and tests compare trees leaf by leaf."""

from __future__ import annotations

import numpy as np
import torch

from dnn_tpu_torch.models.gpt import GPTConfig, _map, prepare_stacked


def from_jax_params(tree, cfg: GPTConfig, device):
    """JAX-layout param tree (numpy leaves) -> prepared tensors on
    `device`. Validates the layer count and the tied-head shape."""
    missing = [f"h_{i}" for i in range(cfg.n_layer) if f"h_{i}" not in tree]
    if missing:
        raise ValueError(f"param tree lacks blocks {missing[:3]}...")
    want = (cfg.n_embd, cfg.vocab_size)
    got = tuple(np.shape(tree["lm_head"]["kernel"]))
    if got != want:
        raise ValueError(f"lm_head kernel is {got}, expected {want}")
    return prepare_stacked(tree, cfg, device)


def to_jax_params(prepared, cfg: GPTConfig):
    """Prepared tensors -> the JAX-layout tree of numpy arrays: the
    stacked (L, ...) block leaves unstacked into "h_0".."h_{L-1}", every
    leaf detached and copied to the host in its own dtype."""

    def host(t):
        t = t.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()

    tree = {k: _map(host, v) for k, v in prepared.items() if k != "blocks"}
    for i in range(cfg.n_layer):
        tree[f"h_{i}"] = _map(lambda t: host(t[i]), prepared["blocks"])
    return tree


def load_npz(path: str):
    """Flat .npz with "/"-joined keys -> the nested JAX-layout tree."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree
