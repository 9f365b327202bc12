"""Beam search over the KV cache (port of dnn_tpu/runtime/beam.py).

The beams are batch rows: the prompt (B, T) prefills once (K5 on the
card), its cache is repeated K ways, and every step runs one
`forward_with_cache` over all B x K rows (K6), so the card sees one
(B*K, 1) decode a step, not K small ones. The beam reorder is a gather
on the cache's batch axis (leaves (L, B*K, H, S[, D]), float or int8).
Scores are f32 log-softmax sums; a beam that emitted `eos_id` is frozen
(its only continuation is eos at zero cost), and the final order divides
by the GNMT length penalty ((5 + len) / 6) ** alpha (alpha 0: off).

Selections break ties by index, as lax.top_k and jnp.argsort do: the
top K of each step comes from a stable descending sort (frozen rows hold
many equal -1e30 entries), and the final order from a stable argsort.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dnn_tpu_torch import resolve_device
from dnn_tpu_torch.models.gpt import for_compute
from dnn_tpu_torch.runtime.generate import (
    _cache_dtype,
    check_compute_dtype,
    forward_with_cache,
    init_cache,
)

_NEG_BIG = -1e30


def _family_fns(cfg):
    """(forward_with_cache, init_cache) of the config's family: the
    search itself is family-agnostic (every cache leaf has its batch on
    axis 1). A Mixtral config routes through its experts
    (llama.forward_with_cache resolves its default_ffn), as JAX's does."""
    from dnn_tpu_torch.models import llama

    if isinstance(cfg, llama.LlamaConfig):
        return llama.forward_with_cache, llama.init_cache
    return forward_with_cache, init_cache


def _length_penalty(lengths, alpha: float):
    if alpha == 0.0:
        return torch.ones_like(lengths, dtype=torch.float32)
    return ((5.0 + lengths.float()) / 6.0) ** alpha


def _top(values, k: int):
    """The k largest of each row of `values` and their indices, ties to
    the lower index (lax.top_k's order)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def make_beam_generate(cfg, *, max_new_tokens: int, beam_size: int,
                       eos_id: Optional[int] = None,
                       length_penalty: float = 0.0,
                       compute_dtype=None, kv_dtype=None,
                       return_all: bool = False, device=None):
    """Build beam_generate(prepared, ids) for the GPT or LLaMA family.

    Returns the best hypothesis per row, (B, max_new_tokens) int32 on the
    device (positions after an eos hold eos_id), or with `return_all`
    ((B, K, max_new_tokens) tokens, (B, K) length-penalized f32 scores),
    best first. Deterministic. `beam_size=1` is greedy `make_generate`
    token for token. `compute_dtype`/`kv_dtype` as make_generate takes
    them; runs on CUDA unless `device="cpu"`."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    compute_dtype = check_compute_dtype(compute_dtype)
    k = beam_size
    fwd, mk_cache = _family_fns(cfg)
    dev = resolve_device(device)
    cache_dtype = _cache_dtype(kv_dtype if kv_dtype is not None
                               else compute_dtype)
    if dev.type == "cuda":
        # the JAX reference computes in f32: no TF32 on the served path
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    @torch.no_grad()
    def beam_generate(prepared, ids):
        if prepared["wte"]["embedding"].device.type != dev.type:
            raise ValueError(
                f"prepared weights are on "
                f"{prepared['wte']['embedding'].device}, beam search on "
                f"{dev}")
        prepared = for_compute(prepared, compute_dtype)
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64).to(dev)
        b, t = ids.shape
        s_max = t + max_new_tokens
        if s_max > cfg.block_size:
            raise ValueError(
                f"prompt {t} + max_new_tokens {max_new_tokens} exceeds "
                f"block_size {cfg.block_size}")
        v = cfg.vocab_size
        # the prompt prefills once a row; its cache is then tiled K ways
        cache = mk_cache(cfg, b, s_max, cache_dtype, dev)
        logits, cache = fwd(prepared, ids, cache, 0, cfg=cfg,
                            compute_dtype=compute_dtype)
        cache = {name: leaf.repeat_interleave(k, dim=1)
                 for name, leaf in cache.items()}
        logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)  # (B, V)

        scores, tok = _top(logp0, k)  # (B, K) each
        finished = (tok == eos_id if eos_id is not None
                    else torch.zeros((b, k), dtype=torch.bool, device=dev))
        lengths = torch.ones((b, k), dtype=torch.int32, device=dev)
        hist = torch.zeros((b, k, max_new_tokens), dtype=torch.int64,
                           device=dev)
        hist[:, :, 0] = tok
        frozen = None
        if eos_id is not None:
            frozen = torch.full((v,), _NEG_BIG, device=dev)
            frozen[eos_id] = 0.0
        base = torch.arange(b, device=dev)[:, None] * k
        for i in range(max_new_tokens - 1):
            logits, cache = fwd(prepared, tok.reshape(b * k, 1), cache,
                                t + i, cfg=cfg, compute_dtype=compute_dtype)
            logp = torch.log_softmax(logits[:, -1].float(),
                                     dim=-1).reshape(b, k, v)
            if frozen is not None:
                # a frozen beam continues with eos only, at zero cost
                logp = torch.where(finished[:, :, None], frozen, logp)
            total = scores[:, :, None] + logp
            scores, flat_idx = _top(total.reshape(b, k * v), k)
            parent = flat_idx // v
            tok = flat_idx % v
            # every beam-indexed tensor follows its parent
            rows = (base + parent).reshape(-1)
            cache = {name: leaf.index_select(1, rows)
                     for name, leaf in cache.items()}
            hist = torch.gather(hist, 1, parent[:, :, None].expand(
                -1, -1, max_new_tokens))
            finished = torch.gather(finished, 1, parent)
            lengths = torch.gather(lengths, 1, parent)
            if eos_id is not None:
                lengths = torch.where(finished, lengths, lengths + 1)
                finished = finished | (tok == eos_id)
            else:
                lengths = lengths + 1
            hist[:, :, i + 1] = tok
        final = scores / _length_penalty(lengths, length_penalty)
        order = torch.argsort(-final, dim=1, stable=True)
        hist = torch.gather(hist, 1, order[:, :, None].expand(
            -1, -1, max_new_tokens)).to(torch.int32)
        final = torch.gather(final, 1, order)
        if return_all:
            return hist, final
        return hist[:, 0]

    return beam_generate
