"""Analytic FLOP counts of the GPT forward and train step (a copy of the
arithmetic of dnn_tpu/utils/flops.py:82, :234, :251 — that module
imports jax). chip_smoke.py prices its MFU lines from these."""

from __future__ import annotations


def gpt_forward_flops(cfg, batch: int, seq: int) -> float:
    """Forward FLOPs for one GPT batch: per layer 24*T*C^2 of linear
    matmuls (qkv 6TC^2 + attn proj 2TC^2 + mlp 8TC^2 + 8TC^2) plus
    4*T^2*C of attention score/value matmuls, plus the 2*T*C*V
    lm_head."""
    c, l, v = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    per_seq = l * (24 * seq * c * c + 4 * seq * seq * c) + 2 * seq * c * v
    return float(batch) * per_seq


def _train_step_factor(batch: int, accum_steps: int, remat: bool) -> float:
    """The forward -> train-step multiplier: 3x a forward (the backward
    does two matmuls per forward matmul), 4x under full
    rematerialization (the backward replays the forward). Microbatch
    accumulation leaves the total unchanged; the divisibility check
    catches the split make_train_step rejects."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if batch % accum_steps:
        raise ValueError(
            f"batch {batch} not divisible by accum_steps {accum_steps}")
    return 4.0 if remat else 3.0


def gpt_train_step_flops(cfg, batch: int, seq: int, *,
                         accum_steps: int = 1, remat: bool = False) -> float:
    """Training-step FLOPs for one GPT batch: factor x forward."""
    return _train_step_factor(batch, accum_steps, remat) \
        * gpt_forward_flops(cfg, batch, seq)


def tree_weight_bytes(tree) -> float:
    """Device bytes of a parameter tree's array leaves (a copy of the
    pricing of dnn_tpu/utils/flops.py:169): every tensor or numpy leaf at
    its element size, so int8 kernels at 1 byte an element and packed
    int4 kernels (uint8, two values a byte; quant.pack_int4) at half a
    byte an element of the unpacked kernel; f32 scales at full width. A
    numpy int4 leaf (ml_dtypes, one value a byte on the host) counts
    half a byte, as JAX prices it."""
    total = 0.0
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
            continue
        dt = getattr(node, "dtype", None)
        if dt is None:
            continue
        if getattr(dt, "name", None) in ("int4", "uint4"):
            total += node.size * 0.5
        elif hasattr(node, "element_size"):
            total += node.numel() * node.element_size()
        else:
            total += node.size * dt.itemsize
    return float(total)
