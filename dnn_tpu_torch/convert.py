"""Carry weights between the JAX package and the port.

`from_jax_params` takes dnn_tpu's GPT param pytree — {"wte", "wpe",
"h_i", "ln_f", "lm_head"} — or its LLaMA-family pytree ({"wte", "h_i",
"ln_f"[, "lm_head"]}: KV-width k/v projections, optional biases, q/k
norms and post-norms, no "ln_*" under OLMo-2, no "lm_head" when tied),
leaves as numpy arrays (np.asarray of the JAX arrays) or as tensors on
any device, and returns the port's prepared tensors, so both packages
run the very same weights. `load_npz` reads the same tree from a flat
.npz whose keys are the "/"-joined paths ("h_0/attn/qkv/kernel").
`to_jax_params` is the inverse of `from_jax_params`: trained weights go
back to the JAX package, and tests compare trees leaf by leaf."""

from __future__ import annotations

import numpy as np
import torch

from dnn_tpu_torch.models.gpt import _map, prepare_stacked


def _shape(a):
    return tuple(a.shape) if isinstance(a, torch.Tensor) else np.shape(a)


def _check_llama(tree, cfg):
    """The LLaMA-family tree's shapes that a wrong config gets wrong:
    the vocabulary, the head (absent when tied) and the KV width."""
    c, d = cfg.n_embd, cfg.head_dim
    want = {"wte": ((cfg.vocab_size, c), tree["wte"]["embedding"]),
            "h_0.attn.q": ((c, cfg.n_head * d),
                           tree["h_0"]["attn"]["q"]["kernel"]),
            "h_0.attn.k": ((c, cfg.n_kv_head * d),
                           tree["h_0"]["attn"]["k"]["kernel"])}
    if cfg.tie_word_embeddings:
        if "lm_head" in tree:
            raise ValueError("a tied config's tree carries no lm_head")
    else:
        want["lm_head"] = ((c, cfg.vocab_size), tree["lm_head"]["kernel"])
    for name, (shape, leaf) in want.items():
        if _shape(leaf) != shape:
            raise ValueError(f"{name} kernel is {_shape(leaf)}, expected "
                             f"{shape}")


def from_jax_params(tree, cfg, device):
    """JAX-layout param tree (numpy or tensor leaves) of a GPTConfig or a
    LlamaConfig -> prepared tensors on `device` (gpt.prepare_stacked).
    Validates the layer count and the shapes a wrong config gets
    wrong."""
    from dnn_tpu_torch.models.llama import LlamaConfig

    missing = [f"h_{i}" for i in range(cfg.n_layer) if f"h_{i}" not in tree]
    if missing:
        raise ValueError(f"param tree lacks blocks {missing[:3]}...")
    if isinstance(cfg, LlamaConfig):
        _check_llama(tree, cfg)
    else:
        want = (cfg.n_embd, cfg.vocab_size)
        got = _shape(tree["lm_head"]["kernel"])
        if got != want:
            raise ValueError(f"lm_head kernel is {got}, expected {want}")
    return prepare_stacked(tree, cfg, device)


def to_jax_params(prepared, cfg):
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
