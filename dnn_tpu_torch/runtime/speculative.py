"""Speculative decoding for one stream: a small draft model proposes, the
target verifies (port of dnn_tpu/runtime/speculative.py).

Each iteration the draft proposes `k` tokens one at a time, then the
target scores all k (+1 bonus) positions in ONE forward and the longest
prefix it agrees with is kept. Greedy output is token for token the
target's own greedy decode -- acceptance changes the speed, never the
content; sampled output follows the rejection-sampling construction of
Leviathan et al. 2023 (accept a proposal with min(1, p_t / p_d),
resample the first rejection from the normalized residual max(p_t - p_d,
0), a bonus sample from p_t when every proposal was accepted), which
keeps the target's distribution exactly.

Mechanics, as in the JAX loop: the caches are preallocated and written
at each iteration's positions; a rejected proposal rolls back by not
advancing the position (its stale cache rows lie past every later
query's limit and are overwritten as the sequence grows through them).
Each iteration first re-feeds the PREVIOUS (k+1)-token verify chunk to
the draft at its old positions (the draft sync): it fills the one row
the draft may lack after a full acceptance and recomputes the others.

On the card the target's (1, k+1) verify and the draft's sync chunk run
K5 (cached_attention, through the codec's attend(base=)); the draft's
one-token steps run K6 (decode_attention). The loop is Python over
eager steps, reading the accepted count back once an iteration (JAX
runs it as one while_loop program). Sampled draws come from a
torch.Generator seeded with `seed`, as make_generate's do, not from
JAX's threefry stream: a sampled stream matches JAX's in distribution
only.

Batch is 1 by design: throughput over many streams is the speculative
batcher's (runtime/serving_spec.py).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from dnn_tpu_torch import resolve_device
from dnn_tpu_torch.models.gpt import GPTConfig, for_compute
from dnn_tpu_torch.runtime.generate import (
    _NEG_BIG,
    check_compute_dtype,
    forward_with_cache,
    init_cache,
)

__all__ = ["make_speculative_generate"]


def _cached_lm(cfg, compute_dtype):
    """(init_cache_fn(batch, max_len, device), forward_fn(prepared, ids,
    cache, pos) -> logits) of whichever family `cfg` belongs to. Target
    and draft dispatch independently, so a LLaMA target can verify a GPT
    draft: the construction needs only matching vocabularies. A Mixtral
    config routes through its experts (llama.forward_with_cache resolves
    its default_ffn); a GPT-MoE config is caught before the dense GPT
    path, whose blocks index "mlp", and decodes with the routed FFN
    plugged in (JAX :78-84)."""
    from dnn_tpu_torch.models.gpt_moe import GPTMoEConfig
    from dnn_tpu_torch.models.llama import LlamaConfig

    if isinstance(cfg, LlamaConfig):
        from dnn_tpu_torch.models import llama

        fwd = llama.forward_with_cache
    elif isinstance(cfg, GPTMoEConfig):
        from dnn_tpu_torch.runtime.generate_moe import moe_cache_ffn

        fwd = functools.partial(forward_with_cache, ffn=moe_cache_ffn(
            cfg, compute_dtype=compute_dtype))
    else:
        fwd = forward_with_cache
    return (lambda b, n, dev: init_cache(cfg, b, n, torch.float32, dev),
            lambda prepared, ids, cache, pos: fwd(
                prepared, ids, cache, pos, cfg=cfg,
                compute_dtype=compute_dtype)[0])


def _probs(logits, *, temperature: float, top_k: Optional[int]):
    """Rows of logits (..., V) -> the distribution really sampled from
    (temperature, then the top-k filter), f32. Draft proposals and the
    target's accept probabilities must go through this one transform:
    rejection sampling is exact only against the distributions sampled
    from. The speculative batcher shares it."""
    logits = logits.float() / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, _NEG_BIG, logits)
    return torch.softmax(logits, dim=-1)


def _first_false(ok):
    """(..., k) bool -> the index of the first False along the last axis,
    k where every entry is True: the accepted prefix's length."""
    k = ok.shape[-1]
    return torch.where(ok.all(dim=-1), k, (~ok).to(torch.int32).argmax(dim=-1))


def make_speculative_generate(target_cfg, draft_cfg, *, max_new_tokens: int,
                              k: int = 4, temperature: float = 0.0,
                              top_k: Optional[int] = None,
                              compute_dtype=None,
                              return_stats: bool = False, device=None):
    """Build generate(target_prepared, draft_prepared, ids, seed=0).

    ids is (1, P) with P >= k + 2 (the first draft-sync chunk is the
    prompt's own tail). Returns (1, max_new_tokens) int32 tokens on the
    device; with `return_stats` also {"iterations", "proposed",
    "accepted"} (accepted / proposed is the draft's acceptance rate).
    The caches are f32; `compute_dtype` (torch.bfloat16) runs both models
    in bf16 compute. Runs on CUDA unless `device="cpu"` is given."""
    if target_cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError(f"draft vocab {draft_cfg.vocab_size} != target "
                         f"vocab {target_cfg.vocab_size}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    compute_dtype = check_compute_dtype(compute_dtype)
    greedy = temperature == 0.0
    dev = resolve_device(device)
    t_init, t_fwd = _cached_lm(target_cfg, compute_dtype)
    d_init, d_fwd = _cached_lm(draft_cfg, compute_dtype)
    if dev.type == "cuda":
        # the JAX reference computes in f32: no TF32 on the served path
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    @torch.no_grad()
    def generate(target_prepared, draft_prepared, ids, seed: int = 0):
        for which, p in (("target", target_prepared),
                         ("draft", draft_prepared)):
            if p["wte"]["embedding"].device.type != dev.type:
                raise ValueError(
                    f"{which} weights are on {p['wte']['embedding'].device},"
                    f" generate on {dev}")
        target_prepared = for_compute(target_prepared, compute_dtype)
        draft_prepared = for_compute(draft_prepared, compute_dtype)
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64).to(dev)
        b, p = ids.shape
        if b != 1:
            raise ValueError("speculative decode is single-stream (batch 1); "
                             "use the speculative batcher for many streams")
        if p < k + 2:
            raise ValueError(f"prompt length {p} < k+2 ({k + 2})")
        need = p + max_new_tokens + k
        for name, cfg in (("target", target_cfg), ("draft", draft_cfg)):
            if need > cfg.block_size:
                raise ValueError(
                    f"prompt+max_new+k = {need} exceeds {name} block_size "
                    f"{cfg.block_size}")
        gen = (None if greedy else
               torch.Generator(device=dev).manual_seed(int(seed)))
        t_cache, d_cache = t_init(1, need, dev), d_init(1, need, dev)
        # both caches take everything but the last prompt token, which
        # is the first decode input (as make_generate)
        t_fwd(target_prepared, ids[:, :-1], t_cache, 0)
        d_fwd(draft_prepared, ids[:, :-1], d_cache, 0)

        out, last, pos = [], ids[:, -1:], p - 1
        # the first sync chunk: the prompt's own tail, at its own
        # positions -- a recompute of rows the prefill wrote
        prev_chunk, prev_pos = ids[:, p - 2 - k:p - 1], p - 2 - k
        iters = accepted = 0
        while len(out) < max_new_tokens:
            d_fwd(draft_prepared, prev_chunk, d_cache, prev_pos)  # sync
            tok, props, d_rows = last, [], []
            for i in range(k):
                row = d_fwd(draft_prepared, tok, d_cache, pos + i)[0, -1]
                if greedy:
                    tok = row.argmax()[None, None]
                else:
                    dist = _probs(row, temperature=temperature, top_k=top_k)
                    tok = torch.multinomial(dist, 1, generator=gen)[None]
                    d_rows.append(dist)
                props.append(tok[0, 0])
            props = torch.stack(props)  # (k,)
            chunk = torch.cat([last[0], props])[None]  # (1, k + 1)
            rows = t_fwd(target_prepared, chunk, t_cache, pos)[0]  # (k+1, V)
            if greedy:
                w = rows.argmax(dim=-1)  # the committed tokens ARE these
                m = int(_first_false(props == w[:k]))
            else:
                t_dist = _probs(rows, temperature=temperature, top_k=top_k)
                d_dist = torch.stack(d_rows)  # (k, V)
                ar = torch.arange(k, device=dev)
                ratio = (t_dist[ar, props]
                         / torch.clamp(d_dist[ar, props], min=1e-30))
                u = torch.rand((k,), generator=gen, device=dev)
                m = int(_first_false(u < torch.clamp(ratio, max=1.0)))
                # row m: a rejection resamples from the residual; after k
                # acceptances the draft has no row there and the
                # "residual" is p_t itself -- the bonus sample
                t_row = t_dist[m]
                resid = torch.clamp(
                    t_row - (d_dist[m] if m < k else 0.0), min=0.0)
                z = resid.sum()
                # z == 0 only where p_t == p_d: a draw from p_t is right
                resid = torch.where(z > 0, resid / torch.clamp(z, min=1e-30),
                                    t_row)
                w = torch.cat([props, torch.zeros((1,), dtype=props.dtype,
                                                  device=dev)])
                w[m] = torch.multinomial(resid, 1, generator=gen)[0]
            out.extend(w[:m + 1].tolist())
            last = w[m:m + 1][None]
            prev_chunk, prev_pos = chunk, pos
            pos += m + 1
            iters += 1
            accepted += m
        tokens = torch.tensor([out[:max_new_tokens]], dtype=torch.int32,
                              device=dev)
        if return_stats:
            return tokens, {"iterations": iters, "proposed": iters * k,
                            "accepted": accepted}
        return tokens

    return generate
