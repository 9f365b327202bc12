"""Memory-mapped token dataset for causal-LM training (a copy of
dnn_tpu/data/tokens.py: pure numpy, so the same seed gives the same
windows in both packages).

A flat binary of token ids (uint16 for GPT-2's 50257-token vocab,
uint32 accepted for larger vocabularies — the nanoGPT train.bin
convention). Batches are random (B, T+1) windows;
`dnn_tpu_torch.train.next_token_loss` shifts them into inputs and
targets.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

_DTYPES = {2: np.uint16, 4: np.uint32}


class TokenDataset:
    """Random-window sampler over a memory-mapped token file."""

    def __init__(self, path: str, *, dtype=None):
        size = os.path.getsize(path)
        if dtype is None:
            dtype = np.uint16
        dtype = np.dtype(dtype)
        if dtype.type not in (np.uint16, np.uint32):
            raise ValueError(f"token dtype must be uint16/uint32, got {dtype}")
        if size % dtype.itemsize != 0:
            raise ValueError(f"{path}: size {size} not divisible by {dtype.itemsize}")
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        if len(self.tokens) < 2:
            raise ValueError(f"{path}: need at least 2 tokens")

    def __len__(self) -> int:
        return len(self.tokens)

    def sample(self, rng: np.random.Generator, batch_size: int, seq_len: int) -> np.ndarray:
        """(B, seq_len + 1) int32 windows at random offsets."""
        if seq_len + 1 > len(self.tokens):
            raise ValueError(
                f"seq_len {seq_len} + 1 exceeds dataset length {len(self.tokens)}"
            )
        starts = rng.integers(0, len(self.tokens) - seq_len, batch_size)
        return np.stack(
            [self.tokens[s:s + seq_len + 1] for s in starts]
        ).astype(np.int32)

    def batches(self, batch_size: int, seq_len: int, *, seed: int = 0) -> Iterator[np.ndarray]:
        """Infinite iterator of (B, seq_len + 1) batches (deterministic per
        seed — resume-friendly with train.fit's advance_batches)."""
        rng = np.random.default_rng(seed)
        while True:
            yield self.sample(rng, batch_size, seq_len)


def write_tokens(path: str, tokens: np.ndarray, *, dtype=np.uint16):
    """Flat token-id binary writer (fixture/export counterpart)."""
    arr = np.asarray(tokens)
    info = np.iinfo(dtype)
    if arr.min() < 0 or arr.max() > info.max:
        raise ValueError(f"token ids out of range for {np.dtype(dtype)}")
    with open(path, "wb") as f:
        f.write(arr.astype(dtype).tobytes())
