"""Multi-head causal self-attention and head split/merge (port of
dnn_tpu/ops/attention.py)."""

from __future__ import annotations

import torch

from dnn_tpu_torch.ops.cuda.flash_attention import (
    flash_attention,
    reference_attention,
)
from dnn_tpu_torch.ops.nn import linear


def split_heads(x, n_head):
    """(B, T, C) -> (B, H, T, D), a view."""
    b, t, c = x.shape
    return x.reshape(b, t, n_head, c // n_head).transpose(1, 2)


def merge_heads(x):
    """(B, H, T, D) -> (B, T, H*D)."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def causal_self_attention(params, x, *, n_head, use_flash=False,
                          compute_dtype=None):
    """Fused qkv matmul -> per-head causal attention -> out projection
    (JAX's causal_self_attention :43). `use_flash=True` runs the flash
    kernels (ops/cuda/flash_attention.py: K1 without a gradient, K2-K4
    with one); False the einsum formula, as JAX's XLA path. "auto" means
    True: on CUDA the kernel always runs (JAX's FLASH_AUTO_THRESHOLD, a
    TPU crossover, is not carried over). `compute_dtype` casts the
    matmul operands."""
    qkv = linear(params["qkv"], x, compute_dtype=compute_dtype)  # (B, T, 3C)
    q, k, v = qkv.chunk(3, dim=-1)
    q, k, v = (split_heads(t, n_head) for t in (q, k, v))
    if use_flash:  # True or "auto"
        # split_heads returns a transposed view; the kernels take
        # contiguous (B, H, T, D) tensors
        y = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True)
    else:
        y = reference_attention(q, k, v, causal=True)
    return linear(params["proj"], merge_heads(y), compute_dtype=compute_dtype)


def rope_cos_sin(positions, head_dim, *, theta=10000.0):
    """cos/sin tables of the rotary position embedding at absolute
    `positions` (any shape P...), HF half-split convention (JAX's
    ops/attention.rope_cos_sin :72): inverse frequencies
    1/theta^(2i/d) and the angles in f32, in JAX's order of operations,
    tiled to the full head dim. Returns (cos, sin), each (*P, head_dim)
    f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device), exps)
    angles = positions.float()[..., None] * inv_freq  # (*P, d/2)
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x, cos, sin):
    """Rotate head vectors x (..., T, D) by per-position tables that
    broadcast against them (JAX's apply_rope :84): the two halves of the
    head dim are the rotation pairs (torch rotate_half), in f32, cast
    back to x's dtype."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)
