"""Head split/merge (port of dnn_tpu/ops/attention.py:26-40)."""

from __future__ import annotations


def split_heads(x, n_head):
    """(B, T, C) -> (B, H, T, D), a view."""
    b, t, c = x.shape
    return x.reshape(b, t, n_head, c // n_head).transpose(1, 2)


def merge_heads(x):
    """(B, H, T, D) -> (B, T, H*D)."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)
