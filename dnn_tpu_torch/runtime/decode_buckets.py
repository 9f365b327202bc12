"""Length-aware bucketed decode for the dense slot pool (port of
dnn_tpu/runtime/decode_buckets.py:44-114).

The dense pool is allocated at the smallest rung of a ladder of cache
lengths (powers of two up to `max_len`) that covers the longest live
position, and grown rung by rung as slots advance, so what a decode step
allocates tracks the live context instead of `max_len`. Growing pads
every leaf's position axis with zeros: the new columns sit beyond every
slot's position limit, so attention never sees them until a write
claims them — greedy tokens are identical to the unbucketed pool.

The solo bucketed decoder (`make_bucketed_generate`) is not ported yet
(ROADMAP PyTorch/CUDA port item 2).
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["DEFAULT_MIN_BUCKET", "bucket_ladder", "bucket_for",
           "normalize_ladder", "pad_cache_to"]

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
