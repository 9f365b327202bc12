"""Embedding extraction: pooled final hidden states (port of
dnn_tpu/runtime/embeddings.py).

The hidden states are the family's `make_hidden_stacked` forward, the
logits forward without its lm_head (final norm applied, as HF's
last_hidden_state). GPT-2's runs the flash forward, K1 on the card;
the LLaMA family's its grouped einsum. Padding after each row's real
tokens changes nothing under causal attention, so a caller may pad ids
to a bucket length; `lengths` marks the real extents and pooling masks
by them: "mean" (the masked average), "last" (the last real token) or
"none" (the whole (B, T, C) sequence).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_embed"]


def _hidden_fn(cfg, compute_dtype):
    from dnn_tpu_torch.models import gpt, llama

    family = llama if isinstance(cfg, llama.LlamaConfig) else gpt
    return family.make_hidden_stacked(cfg, compute_dtype=compute_dtype)


def _on(x, dev):
    """An int64 tensor on `dev` from a tensor (any device) or a host
    array."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=dev, dtype=torch.int64)


def make_embed(cfg, *, pooling: str = "mean", compute_dtype=None):
    """embed(prepared, ids, lengths) -> (B, C) f32, or (B, T, C) for
    pooling="none". `ids` (B, T) may be padded past each row's length
    (`lengths` (B,)); ids and lengths may be host arrays or tensors, and
    they go to the weights' device."""
    if pooling not in ("mean", "last", "none"):
        raise ValueError(
            f"pooling must be mean|last|none, got {pooling!r}")
    hidden = _hidden_fn(cfg, compute_dtype)

    @torch.no_grad()
    def embed(prepared, ids, lengths):
        dev = prepared["wte"]["embedding"].device
        ids = _on(ids, dev)
        h = hidden(prepared, ids)  # (B, T, C) f32
        if pooling == "none":
            return h
        t = ids.shape[1]
        n = _on(lengths, dev)
        if pooling == "mean":
            mask = torch.arange(t, device=dev)[None, :] < n[:, None]
            s = (h * mask[..., None]).sum(dim=1)
            return s / torch.clamp(n, min=1)[:, None].to(s.dtype)
        idx = torch.clamp(n - 1, 0, t - 1)  # "last"
        return h[torch.arange(h.shape[0], device=dev), idx]

    return embed
