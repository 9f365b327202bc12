"""Cached forward and sampling for the GPT family (port of
dnn_tpu/runtime/generate.py:50-124,149-255).

`forward_with_cache` runs one chunk of tokens at positions
[start_pos, start_pos + T) through every layer — a Python loop over the
stacked blocks — writing each layer's K/V into the cache in place and
attending through the K5 wrapper. `forward_no_cache` is the plain
full-sequence forward the cached paths are held against.

Sampling (`_sample_rows`) keeps the JAX package's filter arithmetic —
per-row temperature, top-k, min-p and nucleus over the same top-256
prefilter with the full-vocabulary denominator — but draws with one
torch.Generator per row. A sampled token therefore differs from the JAX
package's threefry stream for the same seed; greedy rows (temperature 0)
take the argmax and are identical.
"""

from __future__ import annotations

import math

import torch

from dnn_tpu_torch.models.gpt import GPTConfig, head, layer_params
from dnn_tpu_torch.ops.attention import merge_heads, split_heads
from dnn_tpu_torch.ops.nn import embedding, gelu, layer_norm, linear
from dnn_tpu_torch.runtime.kvcache import FloatKV, band_keep

_NEG_BIG = -1e30

# nucleus sampling ranks this many candidates per step (see _sample_rows)
TOP_P_PREFILTER_K = 256


def init_cache(cfg: GPTConfig, batch: int, max_len: int, dtype, device):
    """Preallocated float cache {"k","v"}: (L, B, H, S, D)."""
    return FloatKV(dtype).init(cfg, batch, max_len, device)


def _qkv_heads(bp, h, *, cfg: GPTConfig):
    q, k, v = linear(bp["attn"]["qkv"], h).chunk(3, dim=-1)
    return tuple(split_heads(t, cfg.n_head) for t in (q, k, v))


def _mlp(bp, h):
    return linear(bp["mlp"]["proj"], gelu(linear(bp["mlp"]["fc"], h)))


def _block_with_cache(bp, x, layer_cache, start_pos: int, *, cfg, codec):
    """One block over x (B, T, C) at positions [start_pos, start_pos+T):
    writes this layer's K/V, then attends everything cached so far."""
    h = layer_norm(bp["ln_1"], x, eps=cfg.ln_eps)
    q, k, v = _qkv_heads(bp, h, cfg=cfg)
    codec.write(layer_cache, k, v, start_pos)
    y = codec.attend(q, layer_cache, start_pos)
    x = x + linear(bp["attn"]["proj"], merge_heads(y.to(x.dtype)))
    h = layer_norm(bp["ln_2"], x, eps=cfg.ln_eps)
    return x + _mlp(bp, h)


def _embed_at(prepared, ids, start_pos: int):
    pos = torch.arange(start_pos, start_pos + ids.shape[1], device=ids.device)
    return embedding(prepared["wte"], ids) + embedding(prepared["wpe"], pos)


@torch.no_grad()
def forward_with_cache(prepared, ids, cache, start_pos: int, *,
                       cfg: GPTConfig):
    """ids (B, T) at positions [start_pos, start_pos + T) -> logits
    (B, T, V) f32; the cache {"k","v"} (L, B, H, S, D) is updated in
    place and returned."""
    codec = FloatKV(cache["k"].dtype)
    x = _embed_at(prepared, ids, start_pos)
    for i in range(cfg.n_layer):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        x = _block_with_cache(layer_params(prepared["blocks"], i), x,
                              layer_cache, start_pos, cfg=cfg, codec=codec)
    return head(prepared, x.float(), cfg=cfg), cache


@torch.no_grad()
def forward_no_cache(prepared, ids, *, cfg: GPTConfig):
    """Plain full-sequence causal forward, no cache and no kernel:
    ids (B, T) -> logits (B, T, V). Attention is the masked softmax
    formula (scores / sqrt(D), masked at -1e30)."""
    t = ids.shape[1]
    if t > cfg.block_size:
        raise ValueError(f"sequence length {t} > block_size {cfg.block_size}")
    pos = torch.arange(t, device=ids.device)
    keep = band_keep(pos[None, :], pos[:, None], None)  # (T, T)
    x = _embed_at(prepared, ids, 0)
    for i in range(cfg.n_layer):
        bp = layer_params(prepared["blocks"], i)
        h = layer_norm(bp["ln_1"], x, eps=cfg.ln_eps)
        q, k, v = _qkv_heads(bp, h, cfg=cfg)
        s = torch.einsum("bhtd,bhsd->bhts", q, k) / math.sqrt(q.shape[-1])
        p = torch.softmax(torch.where(keep, s, _NEG_BIG), dim=-1)
        y = torch.einsum("bhts,bhsd->bhtd", p, v)
        x = x + linear(bp["attn"]["proj"], merge_heads(y))
        h = layer_norm(bp["ln_2"], x, eps=cfg.ln_eps)
        x = x + _mlp(bp, h)
    return head(prepared, x, cfg=cfg)


def apply_repetition_penalty(logits, seen, penalty):
    """CTRL-style penalty on raw logits (HF semantics): for tokens in
    `seen` (..., V) bool, a positive logit is divided by `penalty` and a
    negative one multiplied."""
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, pen, logits)


def _sample_rows(logits, generators, *, temperature, top_k, top_p, min_p):
    """Per-row sampling for the slot pool. logits (B, V) f32;
    generators: a list of B torch.Generators (None for greedy rows);
    temperature (B,) f32 (0 = greedy); top_k (B,) int (0 = off, capped
    at TOP_P_PREFILTER_K); top_p (B,) f32 (outside (0, 1) = off); min_p
    (B,) f32 (outside (0, 1] = off). Returns (B,) int64 token ids."""
    greedy = logits.argmax(dim=-1)
    on = temperature > 0
    if not bool(on.any()):
        return greedy
    k_cap = min(TOP_P_PREFILTER_K, logits.shape[-1])
    safe_t = torch.where(on, temperature, torch.ones_like(temperature))
    lg = logits / safe_t[:, None]
    vals = torch.topk(lg, k_cap, dim=-1).values  # (B, k_cap) descending
    k_idx = top_k.clamp(1, k_cap).long() - 1
    kth = vals.gather(-1, k_idx[:, None])
    lg = torch.where((top_k[:, None] > 0) & (lg < kth), _NEG_BIG, lg)
    m_on = (min_p > 0) & (min_p <= 1.0)
    safe_mp = torch.where(m_on, min_p, torch.full_like(min_p, 0.5))
    mx = lg.max(dim=-1, keepdim=True).values
    lg = torch.where(m_on[:, None] & (lg < mx + torch.log(safe_mp)[:, None]),
                     _NEG_BIG, lg)
    pvals = torch.topk(lg, k_cap, dim=-1).values
    lse = torch.logsumexp(lg, dim=-1, keepdim=True)
    probs = torch.exp(pvals - lse)
    cum = probs.cumsum(dim=-1)
    keep = (cum - probs) < top_p[:, None]
    n_keep = keep.sum(dim=-1).clamp(min=1)
    thresh = pvals.gather(-1, (n_keep - 1)[:, None])
    p_on = (top_p > 0) & (top_p < 1.0)
    lg = torch.where(p_on[:, None] & (lg < thresh), _NEG_BIG, lg)
    out = greedy.clone()
    for i in torch.nonzero(on).flatten().tolist():
        probs_i = torch.softmax(lg[i], dim=-1)
        out[i] = torch.multinomial(probs_i, 1, generator=generators[i])[0]
    return out
