"""The float KV cache codec (port of dnn_tpu/runtime/kvcache.py:74-85,
182-255).

A cache is {"k", "v"} of shape (L, B, H, S, D) in f32 or bf16; the layer
loop hands `write`/`attend` one layer's (B, H, S, D) views. Writes are
IN PLACE (torch has no donation; the JAX codec returns a functionally
updated cache that XLA aliases onto its input).

`attend` always runs the K5 cached-attention wrapper: on a CUDA cache
that is the kernel at every length (the TPU length crossovers,
AUTO_KERNEL_MIN_S and friends, are not carried over), on a CPU cache its
plain version. Int8/int4 caches and sliding windows are not ported
(ROADMAP, "PyTorch/CUDA port" queue).
"""

from __future__ import annotations

import torch

from dnn_tpu_torch.ops.cuda.cached_attention import cached_attention

__all__ = ["FloatKV", "band_keep"]


def band_keep(cols, limit, window):
    """The attention band predicate: causal upper bound (cols <= limit)
    plus the optional sliding-window lower bound (cols > limit -
    window). Broadcasts over whatever shapes the caller aligned."""
    keep = cols <= limit
    if window is not None:
        keep &= cols > limit - window
    return keep


class FloatKV:
    """The plain cache: K/V stored in `dtype` (f32, or bf16 for halved
    bandwidth)."""

    def __init__(self, dtype=torch.float32):
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"KV dtype {dtype}: the port stores f32 or bf16 caches; "
                "int8/int4 caches wait for their kernels (ROADMAP, "
                "PyTorch/CUDA port item 2)")
        self.dtype = dtype

    def init(self, cfg, batch: int, max_len: int, device):
        shape = (cfg.n_layer, batch, cfg.n_head, max_len,
                 cfg.n_embd // cfg.n_head)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=device),
                "v": torch.zeros(shape, dtype=self.dtype, device=device)}

    def write(self, c, k, v, start_pos: int):
        """c: one layer's {"k","v"} (B, H, S, D); k/v (B, H, T, D) land at
        positions [start_pos, start_pos + T), in place. The JAX codec's
        dynamic_update_slice clamps an overhanging write back onto real
        positions; here it is an error."""
        t, s_len = k.shape[2], c["k"].shape[2]
        if not 0 <= start_pos <= s_len - t:
            raise ValueError(f"write of {t} positions at {start_pos} "
                             f"overhangs a {s_len}-position cache")
        c["k"][:, :, start_pos:start_pos + t] = k
        c["v"][:, :, start_pos:start_pos + t] = v

    def attend(self, q, c, base: int):
        """q (B, H, T, D) at positions base + arange(T) against the whole
        cache: row t attends key positions <= base + t (the contiguous
        limit contract of the JAX codec's `base=` path). Returns
        (B, H, T, D) in the cache dtype."""
        pos = torch.full((q.shape[0],), base, dtype=torch.int32,
                         device=q.device)
        out = cached_attention(q.contiguous(), c["k"], c["v"], pos)
        return out.to(c["v"].dtype)
