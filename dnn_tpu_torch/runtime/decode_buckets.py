"""Length-aware bucketed decode for the dense slot pool and the solo
decoder (port of dnn_tpu/runtime/decode_buckets.py:44-270).

The dense pool is allocated at the smallest rung of a ladder of cache
lengths (powers of two up to `max_len`) that covers the longest live
position, and grown rung by rung as slots advance, so what a decode step
allocates tracks the live context instead of `max_len`. Growing pads
every leaf's position axis with zeros: the new columns sit beyond every
slot's position limit, so attention never sees them until a write
claims them — greedy tokens are identical to the unbucketed pool.

The solo bucketed decoder (`make_bucketed_generate`) runs the same
ladder under one stream: its cache starts at the rung that holds the
prompt and grows before each step that needs it.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["DEFAULT_MIN_BUCKET", "bucket_ladder", "bucket_for",
           "make_bucketed_generate", "normalize_ladder", "pad_cache_to"]

DEFAULT_MIN_BUCKET = 64

# every dense codec leaf carries positions at axis 3: K/V (L, B, H, S, D)
# and the int8 scales (L, B, H, S) alike (runtime/kvcache.py), H the
# model's KV heads, so a grouped-query pool grows at its own width
_POS_AXIS = 3


def bucket_ladder(max_len: int, min_bucket: int = DEFAULT_MIN_BUCKET):
    """Powers of two from `min_bucket` up, terminated at `max_len`
    (always the top rung, whatever its divisibility): e.g.
    bucket_ladder(1536) -> (64, 128, 256, 512, 1024, 1536)."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    if min_bucket < 1:
        raise ValueError(f"min_bucket must be >= 1, got {min_bucket}")
    b = 1
    while b < min_bucket:
        b *= 2
    out = []
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def normalize_ladder(buckets: Sequence[int], max_len: int):
    """Validate an explicit ladder: ascending positive ints, entries
    beyond `max_len` dropped, `max_len` appended as the top rung when
    missing (the full allocation must be reachable)."""
    out = []
    for b in buckets:
        b = int(b)
        if b < 1:
            raise ValueError(f"bucket lengths must be >= 1, got {b}")
        if out and b <= out[-1]:
            raise ValueError(f"bucket ladder must ascend, got {buckets}")
        if b < max_len:
            out.append(b)
    out.append(max_len)
    return tuple(out)


def bucket_for(ladder: Sequence[int], need: int) -> int:
    """Smallest ladder bucket holding `need` live positions."""
    for b in ladder:
        if b >= need:
            return b
    raise ValueError(
        f"{need} positions exceed the ladder's top bucket {ladder[-1]}")


def pad_cache_to(cache, n: int):
    """A new cache whose every leaf's position axis is grown to `n`
    columns with zeros (scales too, as the JAX pad does). The input's
    tensors are not modified; any view taken of them is stale after the
    call."""
    def pad(a):
        grow = n - a.shape[_POS_AXIS]
        if grow < 0:
            raise ValueError(
                f"cannot shrink a cache leaf from {a.shape[_POS_AXIS]} "
                f"to {n} positions (buckets grow only)")
        if grow == 0:
            return a
        shape = list(a.shape)
        shape[_POS_AXIS] = n
        out = torch.zeros(shape, dtype=a.dtype, device=a.device)
        out.narrow(_POS_AXIS, 0, a.shape[_POS_AXIS]).copy_(a)
        return out

    return {k: pad(v) for k, v in cache.items()}


def make_bucketed_generate(cfg, *, max_len: int, max_new_tokens: int,
                           buckets=None, temperature: float = 0.0,
                           top_k: Optional[int] = None,
                           top_p: Optional[float] = None,
                           min_p: Optional[float] = None,
                           compute_dtype=None, kv_dtype=None, ffn=None,
                           family: Optional[str] = None, device=None):
    """The solo bucketed decoder (JAX's make_bucketed_generate):
    generate(prepared, ids, seed=0) -> (B, max_new_tokens) int32 token ids
    on the device, token-identical to generate.make_generate, with the
    cache allocated at the ladder's rung for the live position: the
    prompt prefills (K5) into the rung that holds it, and the cache grows
    (`pad_cache_to`) before the step whose write position needs the next
    rung; each step is K6 over the current rung.

    `max_len` tops the ladder (prompt + max_new_tokens must fit in it);
    `buckets=None` is the power-of-two ladder, an ascending tuple
    overrides it, and `(max_len,)` is the unbucketed program. `family`
    ("gpt" or "llama") picks the cached forward; None follows the config.
    A uniformly windowed LLaMA-family config decodes on the rolling ring
    (make_generate) and is refused here, as JAX's is. `kv_dtype` is any
    of make_generate's ("f32", "bf16", "int8", "int4"; None follows
    `compute_dtype`). Sampled draws come from a torch.Generator seeded
    with `seed`, in make_generate's order, so sampled streams equal its
    draw for draw. Each call counts its grows in `generate.bucket_grows`
    and, with obs on, in serving.decode_bucket_grow_total and
    serving.decode_bucket_dispatch_total{bucket} (the batcher's names).
    Runs on CUDA unless `device="cpu"` is given."""
    from dnn_tpu_torch import obs, resolve_device
    from dnn_tpu_torch.models.gpt import for_compute
    from dnn_tpu_torch.runtime import generate as gen
    from dnn_tpu_torch.utils.metrics import labeled

    compute_dtype = gen.check_compute_dtype(compute_dtype)
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if max_len < 2:
        raise ValueError(f"max_len must be >= 2, got {max_len}")
    if max_len > cfg.block_size:
        raise ValueError(
            f"max_len {max_len} exceeds block_size {cfg.block_size}")
    ladder = (bucket_ladder(max_len) if buckets is None
              else normalize_ladder(buckets, max_len))
    if family is None:
        family = "llama" if gen._is_llama(cfg) else "gpt"
    if family == "gpt":
        forward = functools.partial(gen.forward_with_cache, ffn=ffn)
    elif family == "llama":
        from dnn_tpu_torch.models import llama

        if cfg.sliding_window is not None and not cfg.alt_window:
            raise ValueError(
                "sliding-window configs decode O(window) on the rolling "
                "ring (llama.make_generate) — bucketing targets the "
                "dense full-length cache")
        forward = functools.partial(llama.forward_with_cache, ffn=ffn)
    else:
        raise ValueError(f"unknown family {family!r} (gpt|llama)")
    dev = resolve_device(device)
    cache_dtype = gen._cache_dtype(kv_dtype if kv_dtype is not None
                                   else compute_dtype)
    sample = functools.partial(gen._sample, temperature=temperature,
                               top_k=top_k, top_p=top_p, min_p=min_p)
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
        if t + max_new_tokens > max_len:
            raise ValueError(
                f"prompt {t} + max_new_tokens {max_new_tokens} exceeds "
                f"max_len {max_len}")
        rng = torch.Generator(device=dev).manual_seed(int(seed))
        n = bucket_for(ladder, t)
        cache = gen.init_cache(cfg, b, n, cache_dtype, dev)
        logits, cache = forward(prepared, ids, cache, 0, cfg=cfg,
                                compute_dtype=compute_dtype)
        toks = [sample(logits[:, -1], rng)]
        dispatch: dict = {}
        grows = 0
        for i in range(max_new_tokens - 1):
            pos = t + i  # this step's cache-write position
            nb = bucket_for(ladder, pos + 1)
            if nb != n:
                cache = pad_cache_to(cache, nb)
                n = nb
                grows += 1
            logits, cache = forward(prepared, toks[-1][:, None], cache, pos,
                                    cfg=cfg, compute_dtype=compute_dtype)
            dispatch[n] = dispatch.get(n, 0) + 1
            toks.append(sample(logits[:, -1], rng))
        generate.bucket_grows = grows
        if (m := obs.metrics()) is not None:
            # tallied here, after the loop: no lock traffic a step
            for bk, cnt in dispatch.items():
                m.inc(labeled("serving.decode_bucket_dispatch_total",
                              bucket=bk), cnt)
            if grows:
                m.inc("serving.decode_bucket_grow_total", grows)
        return torch.stack(toks, dim=1).to(torch.int32)

    generate.buckets = ladder
    generate.bucket_grows = 0
    return generate
