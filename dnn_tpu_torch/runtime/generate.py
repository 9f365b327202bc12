"""Cached forward, sampling and solo generation for the GPT and LLaMA
families (port of dnn_tpu/runtime/generate.py:50-255, 474-566).

`forward_with_cache` runs one chunk of tokens at positions
[start_pos, start_pos + T) through every layer — a Python loop over the
stacked blocks — writing each layer's K/V into the cache in place and
attending through the cache's codec (runtime/kvcache.py: K5 for a chunk,
K6 for a one-token step). `forward_no_cache` is the plain full-sequence
forward the cached paths are held against. `make_generate` is the solo
decoder: the prompt in one forward, then one forward per token; given a
LlamaConfig it runs the LLaMA family's cached forward (models/llama.py)
over a KV-head-width cache, as JAX's make_generate for that family does.

Sampling (`_sample`, `_sample_rows`) keeps the JAX package's filter
arithmetic — temperature, top-k, min-p and nucleus over the same top-256
prefilter with the full-vocabulary denominator — but draws from a
torch.Generator. A sampled token therefore differs from the JAX
package's threefry stream for the same seed; greedy draws (temperature
0) take the argmax and are identical.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from dnn_tpu_torch import resolve_device
from dnn_tpu_torch.models.gpt import GPTConfig, for_compute, head, layer_params
from dnn_tpu_torch.ops.attention import merge_heads, split_heads
from dnn_tpu_torch.ops.nn import embedding, gelu, layer_norm, linear
from dnn_tpu_torch.runtime.kvcache import (
    FloatKV,
    Int8KV,
    band_keep,
    codec_for_cache,
    span_positions,
)

_NEG_BIG = -1e30

# nucleus sampling ranks this many candidates per step (see _sample)
TOP_P_PREFILTER_K = 256


def init_cache(cfg, batch: int, max_len: int, dtype, device):
    """Preallocated cache, one leading layer axis: {"k","v"}
    (L, B, H, S, D) in torch.float32 / torch.bfloat16, or dtype="int8"
    for the quantized cache (int8 K/V plus (L, B, H, S) f32 scales). H
    is the config's KV heads (kvcache.cache_shape): n_head for GPT-2,
    n_kv_head for the LLaMA family."""
    if dtype == "int8":
        return Int8KV().init(cfg, batch, max_len, device)
    if dtype == "int4":
        raise NotImplementedError(
            "int4 KV caches are not ported to dnn_tpu_torch yet (ROADMAP "
            "PyTorch/CUDA port item 2)")
    return FloatKV(dtype).init(cfg, batch, max_len, device)


def _qkv_heads(bp, h, *, cfg: GPTConfig, compute_dtype=None):
    q, k, v = linear(bp["attn"]["qkv"], h,
                     compute_dtype=compute_dtype).chunk(3, dim=-1)
    return tuple(split_heads(t, cfg.n_head) for t in (q, k, v))


def _mlp(bp, h, compute_dtype=None):
    return linear(bp["mlp"]["proj"],
                  gelu(linear(bp["mlp"]["fc"], h,
                              compute_dtype=compute_dtype)),
                  compute_dtype=compute_dtype)


def _block_with_cache(bp, x, layer_cache, start_pos, *, cfg, codec,
                      compute_dtype=None):
    """One block over x (B, T, C) at positions [start_pos, start_pos+T):
    writes this layer's K/V, then attends everything cached so far.
    `start_pos` is an int or a (1,) int32 device tensor (span_positions)."""
    h = layer_norm(bp["ln_1"], x, eps=cfg.ln_eps)
    q, k, v = _qkv_heads(bp, h, cfg=cfg, compute_dtype=compute_dtype)
    codec.write(layer_cache, k, v, start_pos)
    y = codec.attend(q, layer_cache, start_pos)
    x = x + linear(bp["attn"]["proj"], merge_heads(y.to(x.dtype)),
                   compute_dtype=compute_dtype)
    h = layer_norm(bp["ln_2"], x, eps=cfg.ln_eps)
    return x + _mlp(bp, h, compute_dtype)


def _embed_at(prepared, ids, start_pos, compute_dtype=None):
    """Token + position embedding at [start_pos, start_pos + T), in f32,
    then cast to `compute_dtype` (JAX's _embed_at)."""
    pos = span_positions(start_pos, ids.shape[1], ids.device)
    x = embedding(prepared["wte"], ids) + embedding(prepared["wpe"], pos)
    return x if compute_dtype is None else x.to(compute_dtype)


@torch.no_grad()
def forward_with_cache(prepared, ids, cache, start_pos, *,
                       cfg: GPTConfig, compute_dtype=None):
    """ids (B, T) at positions [start_pos, start_pos + T) -> logits
    (B, T, V) f32; the cache — float {"k","v"} or int8 {"k","v","ks",
    "vs"}, every leaf (L, B, H, S[, D]) — is updated in place and
    returned. `start_pos` is an int, or a (1,) int32 device tensor that
    a captured CUDA graph reads at each replay (the batcher's mixed
    step): the same values either way, so the same bits.
    `compute_dtype` (bf16 compute, JAX's forward_with_cache):
    the residual stream and every block product in that type, norms in
    f32, the head's product bf16 x bf16 -> f32 logits."""
    codec = codec_for_cache(cache)
    x = _embed_at(prepared, ids, start_pos, compute_dtype)
    for i in range(cfg.n_layer):
        layer_cache = {name: leaf[i] for name, leaf in cache.items()}
        x = _block_with_cache(layer_params(prepared["blocks"], i), x,
                              layer_cache, start_pos, cfg=cfg, codec=codec,
                              compute_dtype=compute_dtype)
    return head(prepared, x.float(), cfg=cfg,
                compute_dtype=compute_dtype), cache


def _is_llama(cfg) -> bool:
    from dnn_tpu_torch.models.llama import LlamaConfig

    return isinstance(cfg, LlamaConfig)


@torch.no_grad()
def forward_no_cache(prepared, ids, *, cfg):
    """Plain full-sequence causal forward, no cache and no kernel:
    ids (B, T) -> logits (B, T, V). Attention is the masked softmax
    formula (scores / sqrt(D), masked at -1e30); a LlamaConfig runs
    llama.forward_no_cache (the grouped einsum)."""
    if _is_llama(cfg):
        from dnn_tpu_torch.models.llama import forward_no_cache as fwd

        return fwd(prepared, ids, cfg=cfg)
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


def logit_bias_row(logit_bias, vocab_size: int, device):
    """{token_id: additive bias} -> a dense (V,) f32 row on `device`
    (None -> None); ids are checked against the vocabulary and values
    must be finite."""
    row = logit_bias_array(logit_bias, vocab_size)
    return None if row is None else torch.from_numpy(row).to(device)


def logit_bias_array(logit_bias, vocab_size: int):
    """logit_bias_row's (V,) f32 row as a numpy array, or None."""
    if not logit_bias:
        return None
    row = np.zeros((vocab_size,), np.float32)
    for tok, val in logit_bias.items():
        t = int(tok)
        if not 0 <= t < vocab_size:
            raise ValueError(
                f"logit_bias token id {t} outside [0, {vocab_size})")
        v = float(val)
        if not np.isfinite(v):
            raise ValueError(f"logit_bias value for {t} not finite: {v}")
        row[t] = v
    return row


def apply_repetition_penalty(logits, seen, penalty):
    """CTRL-style penalty on raw logits (HF semantics): for tokens in
    `seen` (..., V) bool, a positive logit is divided by `penalty` and a
    negative one multiplied."""
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, pen, logits)


def _sample(logits, generator, *, temperature: float, top_k: Optional[int],
            top_p: Optional[float] = None, min_p: Optional[float] = None):
    """logits (B, V) -> token ids (B,) int64. temperature 0 is greedy;
    top_k keeps the k highest logits, min_p drops tokens below min_p x
    the top token's probability, top_p keeps the smallest set reaching
    mass p (ranked over the top-256 prefilter with the full-vocabulary
    denominator) — applied in that order, as the JAX `_sample` does; the
    draw comes from `generator`."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, _NEG_BIG, logits)
    if min_p is not None:
        mx = logits.max(dim=-1, keepdim=True).values
        logits = torch.where(logits < mx + math.log(min_p), _NEG_BIG, logits)
    if top_p is not None:
        k = min(TOP_P_PREFILTER_K, logits.shape[-1])
        vals = torch.topk(logits, k, dim=-1).values
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        probs = torch.exp(vals - lse)
        cum = probs.cumsum(dim=-1)
        n_keep = ((cum - probs) < top_p).sum(dim=-1).clamp(min=1)
        thresh = vals.gather(-1, (n_keep - 1)[..., None])
        logits = torch.where(logits < thresh, _NEG_BIG, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _sample_rows(logits, generators, *, temperature, top_k, top_p, min_p,
                 rows):
    """Per-row sampling for the slot pool. logits (B, V) f32;
    generators: a list of B torch.Generators (None for greedy rows);
    temperature (B,) f32 (0 = greedy); top_k (B,) int (0 = off, capped
    at TOP_P_PREFILTER_K); top_p (B,) f32 (outside (0, 1) = off); min_p
    (B,) f32 (outside (0, 1] = off); `rows`, the host's list of the rows
    that sample (temperature > 0): the batcher knows each slot's
    temperature on the host, so no device value is read back here, and
    a greedy pool (no rows) costs one argmax. Returns (B,) int64 token
    ids, greedy for every row not in `rows`."""
    greedy = logits.argmax(dim=-1)
    if not rows:
        return greedy
    on = temperature > 0
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
    for i in rows:
        probs_i = torch.softmax(lg[i], dim=-1)
        out[i] = torch.multinomial(probs_i, 1, generator=generators[i])[0]
    return out


def logprob_outputs(logits, chosen, k: int):
    """The logprob record of a step (JAX's _lp_outputs): the f32
    log_softmax of the raw model logits (B, V) — before the repetition
    penalty and the bias, the usual serving convention — at the chosen
    ids (B,), and its top `k` (logprobs (B, k) f32, ids (B, k) int32)."""
    lsm = torch.log_softmax(logits.float(), dim=-1)
    chosen_lp = lsm.gather(-1, chosen.long()[:, None])[:, 0]
    top_lp, top_ids = torch.topk(lsm, k, dim=-1)
    return chosen_lp, top_lp, top_ids.to(torch.int32)


def check_compute_dtype(compute_dtype):
    """The compute type a serving entry point takes: None (f32) or
    torch.bfloat16; anything else raises."""
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None (f32) or "
                         f"torch.bfloat16, got {compute_dtype!r}")
    return compute_dtype


def _cache_dtype(kv_dtype):
    """kv_dtype spec -> init_cache's dtype: None/"f32" -> torch.float32,
    "bf16" -> torch.bfloat16, "int8" as is; torch dtypes pass."""
    if kv_dtype in (None, "f32", torch.float32):
        return torch.float32
    if kv_dtype in ("bf16", torch.bfloat16):
        return torch.bfloat16
    if kv_dtype == "int8":
        return "int8"
    if kv_dtype == "int4":
        raise NotImplementedError(
            "kv_dtype 'int4': int4 KV caches are not ported to dnn_tpu_torch "
            "yet (ROADMAP PyTorch/CUDA port item 2)")
    raise ValueError(f"kv_dtype must be f32, bf16 or int8, got {kv_dtype!r}")


def make_generate(cfg, *, max_new_tokens: int,
                  temperature: float = 0.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None,
                  min_p: Optional[float] = None,
                  repetition_penalty: Optional[float] = None,
                  logit_bias=None, compute_dtype=None, ffn=None,
                  kv_dtype=None, device=None):
    """Build generate(prepared, ids, seed=0) -> (B, max_new_tokens) int32
    token ids on the device.

    The prompt ids (B, T) prefill in one forward (K5), then each token
    decodes in one forward against the cache (K6), in a Python loop.
    `compute_dtype` (torch.bfloat16, JAX's bf16 compute) runs the
    residual stream and every block product in it, K5/K6 with bf16
    queries, and the head as bf16 x bf16 -> f32 logits; weights prepared
    at that type (`from_jax_params(..., compute_dtype=)`) are used as
    they are, f32 ones are cast once per call (gpt.for_compute).
    `kv_dtype` picks the cache: "f32", "bf16", or "int8"
    (per-(position, head) scales); None follows `compute_dtype` (f32
    without it), as JAX's does. `temperature`/`top_k`/`top_p`/`min_p`
    sample as the JAX `_sample` does; `repetition_penalty` (HF/CTRL
    semantics) penalizes every token already in the sequence;
    `logit_bias` ({token_id: additive bias}) applies after the penalty,
    before the filters, binding for greedy too. Sampled draws come from a
    torch.Generator seeded with `seed` and differ from JAX's threefry
    stream; greedy draws are identical to JAX's `make_generate`.

    A LlamaConfig (JAX's llama.make_generate) decodes through
    llama.forward_with_cache: K5 with grouped heads for the prompt, K6
    at n_head / n_kv_head rows a KV head per token; its unported
    switches raise (llama.check_ported). A uniformly windowed config
    (Mistral) whose stream outgrows its window decodes on a rolling ring
    (JAX llama.py:942-990): the prompt runs banded (K5) on a transient
    prompt-length cache, the live band moves into a sliding_window-slot
    ring (llama._ring_from_prompt), and every step reads and writes only
    the ring (K6); an alternating config (Gemma-2) keeps its global
    layers, and so a full-length cache.

    Runs on CUDA unless `device="cpu"` is given (without a card the
    default raises); `prepared` must live on that device. JAX's
    `attn_kernel` (a TPU crossover knob) has no counterpart: on CUDA the
    kernels always run. `ffn` (MoE blocks, ROADMAP PyTorch/CUDA port item
    7) raises."""
    compute_dtype = check_compute_dtype(compute_dtype)
    if ffn is not None:
        raise NotImplementedError(
            "ffn: MoE block FFNs are not ported to dnn_tpu_torch yet "
            "(ROADMAP PyTorch/CUDA port item 7)")
    forward = forward_with_cache
    window = None
    if _is_llama(cfg):
        from dnn_tpu_torch.models import llama

        llama.check_ported(cfg)
        forward = llama.forward_with_cache
        if not cfg.alt_window:
            window = cfg.sliding_window
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if repetition_penalty is not None and repetition_penalty <= 0:
        raise ValueError(
            f"repetition_penalty must be > 0, got {repetition_penalty}")
    if min_p is not None and not 0.0 <= min_p <= 1.0:
        raise ValueError(f"min_p must be in [0, 1], got {min_p}")
    dev = resolve_device(device)
    cache_dtype = _cache_dtype(kv_dtype if kv_dtype is not None
                               else compute_dtype)
    bias_row = logit_bias_row(logit_bias, cfg.vocab_size, dev)
    pen_on = repetition_penalty is not None and repetition_penalty != 1.0
    if dev.type == "cuda":
        # the JAX reference computes in f32: no TF32 on the served path
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    @torch.no_grad()
    def generate(prepared, ids, seed: int = 0):
        if prepared["wte"]["embedding"].device.type != dev.type:
            raise ValueError(
                f"prepared weights are on "
                f"{prepared['wte']['embedding'].device}, generate on {dev}")
        prepared = for_compute(prepared, compute_dtype)
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64).to(dev)
        b, t = ids.shape
        if t + max_new_tokens > cfg.block_size:
            raise ValueError(
                f"prompt {t} + max_new_tokens {max_new_tokens} exceeds "
                f"block_size {cfg.block_size}")
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        rolling = window is not None and t + max_new_tokens > window
        ring = {"rolling": True} if rolling else {}
        if rolling:
            cache = init_cache(cfg, b, t, cache_dtype, dev)
            logits, cache = forward(prepared, ids, cache, 0, cfg=cfg,
                                    compute_dtype=compute_dtype)
            cache = llama._ring_from_prompt(cache, t, window)
        else:
            cache = init_cache(cfg, b, t + max_new_tokens, cache_dtype, dev)
            logits, cache = forward(prepared, ids, cache, 0, cfg=cfg,
                                    compute_dtype=compute_dtype)
        rows = torch.arange(b, device=dev)
        seen = None
        if pen_on:
            seen = torch.zeros((b, cfg.vocab_size), dtype=torch.bool,
                               device=dev)
            seen[rows[:, None], ids] = True

        def pick(lg):
            if pen_on:
                lg = apply_repetition_penalty(lg, seen, repetition_penalty)
            if bias_row is not None:
                lg = lg + bias_row
            tok = _sample(lg, gen, temperature=temperature, top_k=top_k,
                          top_p=top_p, min_p=min_p)
            if pen_on:
                seen[rows, tok] = True
            return tok

        toks = [pick(logits[:, -1])]
        for i in range(max_new_tokens - 1):
            # token i sits at sequence position t + i
            logits, cache = forward(
                prepared, toks[-1][:, None], cache, t + i, cfg=cfg,
                compute_dtype=compute_dtype, **ring)
            toks.append(pick(logits[:, -1]))
        return torch.stack(toks, dim=1).to(torch.int32)

    return generate
