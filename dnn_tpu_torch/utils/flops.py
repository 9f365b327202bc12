"""FLOP and byte accounting, and the card's roofline (a copy of the
arithmetic of dnn_tpu/utils/flops.py — that module imports jax — with
the peaks of an NVIDIA card in place of its TPU table).

Conventions (the standard MFU bookkeeping, e.g. the PaLM appendix, as
JAX's): a matmul (m, k) @ (k, n) costs 2*m*k*n FLOPs; causal attention
is charged the full T^2 score/value matmuls; a training step costs ~3x a
forward. chip_smoke.py prices its MFU lines from these, and
obs/goodput.py its live MFU / MBU gauges.

Peaks (`device_peak_flops`, `device_peak_hbm_bw`): from the name
torch.cuda.get_device_name gives, matched against `_CUDA_PEAKS` — "H100
80GB HBM3", the SXM part: 989e12 FLOP/s bf16 dense and 3.35e12 B/s,
NVIDIA's data sheet. Any other card, and the CPU, give None, as JAX's
table does off the TPU: a guessed peak is worse than no number.
DNN_TPU_PEAK_FLOPS / DNN_TPU_PEAK_HBM_BW state a roofline that wins over
the table. MFU is always taken against the bf16 peak, whatever the
compute dtype (the dtype is a label beside it).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

# (substring of torch.cuda.get_device_name, bf16 dense FLOP/s, HBM B/s):
# NVIDIA's data sheets; first hit wins
_CUDA_PEAKS = (
    ("H100 80GB HBM3", 989e12, 3.35e12),
)


def _env_peak(raw) -> Optional[float]:
    """An operator-stated roofline env var; garbage or <= 0 reads as
    unset (JAX's rule: DNN_TPU_PEAK_FLOPS=0 means "unknown")."""
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        logging.getLogger("dnn_tpu_torch.utils").warning(
            "ignoring malformed peak override %r (want a number)", raw)
        return None
    return v if v > 0 else None


def _card_peaks(device=None):
    """(bf16 FLOP/s, HBM B/s) of `device` (a torch.device or index; None:
    the current CUDA card) from its name, or None: no card, a CPU device,
    or a card the table does not know."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for sub, flops, bw in _CUDA_PEAKS:
        if sub in name:
            return flops, bw
    return None


def device_peak_flops(device=None) -> Optional[float]:
    """bf16 dense peak FLOP/s of the card (DNN_TPU_PEAK_FLOPS first), or
    None where unknown — callers omit the MFU rather than publish a
    made-up one."""
    env = _env_peak(os.environ.get("DNN_TPU_PEAK_FLOPS"))
    if env is not None:
        return env
    peaks = _card_peaks(device)
    return None if peaks is None else peaks[0]


def peak_flops_source(device=None) -> Optional[str]:
    """Where device_peak_flops' number comes from, in words: the
    DNN_TPU_PEAK_FLOPS env, or the card's table row; None where there is
    no peak."""
    if _env_peak(os.environ.get("DNN_TPU_PEAK_FLOPS")) is not None:
        return "DNN_TPU_PEAK_FLOPS"
    if _card_peaks(device) is None:
        return None
    import torch

    return (f"{torch.cuda.get_device_name(device)}: bf16 dense peak "
            "(utils/flops._CUDA_PEAKS)")


def device_peak_hbm_bw(device=None) -> Optional[float]:
    """Peak device-memory bytes/s of the card (DNN_TPU_PEAK_HBM_BW
    first), or None where unknown."""
    env = _env_peak(os.environ.get("DNN_TPU_PEAK_HBM_BW"))
    if env is not None:
        return env
    peaks = _card_peaks(device)
    return None if peaks is None else peaks[1]


def gpt_forward_flops(cfg, batch: int, seq: int) -> float:
    """Forward FLOPs for one GPT batch: per layer 24*T*C^2 of linear
    matmuls (qkv 6TC^2 + attn proj 2TC^2 + mlp 8TC^2 + 8TC^2) plus
    4*T^2*C of attention score/value matmuls, plus the 2*T*C*V
    lm_head."""
    c, l, v = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    per_seq = l * (24 * seq * c * c + 4 * seq * seq * c) + 2 * seq * c * v
    return float(batch) * per_seq


def llama_forward_flops(cfg, batch: int, seq: int) -> float:
    """Forward FLOPs for one LLaMA batch: per layer q 2TC^2 + k/v
    2*2TC*(KV*D) + o 2TC^2 + SwiGLU 6TCF, plus the full-T^2 attention
    charge 4T^2C, plus the 2TCV head."""
    c, l, v, f = cfg.n_embd, cfg.n_layer, cfg.vocab_size, cfg.d_ff
    kv_width = cfg.n_kv_head * cfg.head_dim
    per_seq = l * (2 * seq * c * c            # q proj
                   + 2 * 2 * seq * c * kv_width  # k + v projs
                   + 2 * seq * c * c          # o proj
                   + 6 * seq * c * f          # gate + up + down
                   + 4 * seq * seq * c)       # attention score/value
    return float(batch) * (per_seq + 2 * seq * c * v)


# serving-shape accounting (obs/goodput.py): one decoded token's FLOPs and
# bytes at a live context

def gpt_param_count(cfg) -> float:
    """Analytic parameter count of the GPT family (wte V*C + wpe
    block*C + per layer 12C^2 + 13C, + ln_f, + lm_head V*C)."""
    c, l, v = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    per_layer = 12 * c * c + 13 * c
    return float(v * c + cfg.block_size * c + l * per_layer
                 + 2 * c            # ln_f
                 + v * c)           # lm_head (materialized even when tied)


def llama_param_count(cfg) -> float:
    """Analytic parameter count of the LLaMA family: embed V*C + per
    layer q C*(H*D) + k/v 2*C*(KV*D) + o (H*D)*C + SwiGLU 3*C*F + 2
    norms, + final norm + lm_head (absent when tied)."""
    c, l, v, f = cfg.n_embd, cfg.n_layer, cfg.vocab_size, cfg.d_ff
    q_width = cfg.n_head * cfg.head_dim
    kv_width = cfg.n_kv_head * cfg.head_dim
    per_layer = (c * q_width + 2 * c * kv_width + q_width * c
                 + 3 * c * f + 2 * c)
    head = 0 if getattr(cfg, "tie_word_embeddings", False) else v * c
    return float(v * c + l * per_layer + c + head)


def gpt_decode_token_flops(cfg, context: float) -> float:
    """FLOPs to decode ONE token at `context` live cache positions: 24C^2
    of linear matmuls a layer, 4*context*C of score/value matmuls, the
    2CV head."""
    c, l, v = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    return l * (24.0 * c * c + 4.0 * context * c) + 2.0 * c * v


def llama_decode_token_flops(cfg, context: float) -> float:
    """LLaMA-family decode-token FLOPs at `context` live positions: q/o
    2C*(H*D) each, k/v 2*C*(KV*D) each, SwiGLU 6*C*F, attention
    4*context*(H*D), + the 2CV head."""
    c, l, v, f = cfg.n_embd, cfg.n_layer, cfg.vocab_size, cfg.d_ff
    q_width = cfg.n_head * cfg.head_dim
    kv_width = cfg.n_kv_head * cfg.head_dim
    per_layer = (2.0 * c * q_width + 2.0 * 2.0 * c * kv_width
                 + 2.0 * q_width * c + 6.0 * c * f
                 + 4.0 * context * q_width)
    return l * per_layer + 2.0 * c * v


_KV_ITEMSIZE = {"f32": 4, "float32": 4, "bf16": 2, "bfloat16": 2,
                "float16": 2}


def kv_bytes_per_pos(cfg, *, kv_bytes: float = 2, kv_dtype=None) -> float:
    """Bytes one cache POSITION occupies (K + V rows across all layers)
    — decode streams `context` of these per token, and prefill writes
    one per prompt position. `kv_dtype` (a torch dtype, or "f32" /
    "bf16" / "int8" / "int4") prices it exactly: int8 at a byte an
    element, int4 at half (two values a byte), both plus the per-(position,
    head) f32 K and V scale rows; a float type at its itemsize."""
    kv_width = (cfg.n_kv_head * cfg.head_dim
                if hasattr(cfg, "n_kv_head") else cfg.n_embd)
    heads = cfg.n_kv_head if hasattr(cfg, "n_kv_head") else cfg.n_head
    if kv_dtype is not None:
        name = str(kv_dtype).replace("torch.", "")
        if name in ("int8", "int4"):
            per_elem = 1.0 if name == "int8" else 0.5
            return float(2 * cfg.n_layer * (kv_width * per_elem + heads * 4))
        kv_bytes = _KV_ITEMSIZE[name]
    return float(2 * cfg.n_layer * kv_width * kv_bytes)


def decode_step_bytes(weight_bytes: float, kv_live_positions: float,
                      cfg, *, kv_bytes: int = 2) -> float:
    """Device-memory traffic of ONE decode step over a slot pool: the
    weights once a step (shared by every active row) plus every live
    row's cache positions."""
    return float(weight_bytes) + float(kv_live_positions) * \
        kv_bytes_per_pos(cfg, kv_bytes=kv_bytes)


def roofline_items_per_sec(flops_per_item: float, bytes_per_item: float,
                           device=None) -> Optional[float]:
    """min(compute, bandwidth) roofline for one item, or None where the
    card's peaks are unknown."""
    peak_f = device_peak_flops(device)
    peak_b = device_peak_hbm_bw(device)
    if peak_f is None or peak_b is None:
        return None
    return min(peak_f / flops_per_item, peak_b / bytes_per_item)


def mfu(flops_per_item: float, items_per_sec: float,
        device=None) -> Optional[float]:
    """Achieved FLOP/s over the bf16 peak, or None where unknown."""
    peak = device_peak_flops(device)
    if peak is None:
        return None
    return flops_per_item * items_per_sec / peak


def mbu(bytes_per_item: float, items_per_sec: float,
        device=None) -> Optional[float]:
    """Achieved bytes/s over the peak memory rate, or None where
    unknown."""
    peak = device_peak_hbm_bw(device)
    if peak is None:
        return None
    return bytes_per_item * items_per_sec / peak


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


def llama_train_step_flops(cfg, batch: int, seq: int, *,
                           accum_steps: int = 1, remat: bool = False) -> float:
    """Training-step FLOPs for one LLaMA batch: factor x forward."""
    return _train_step_factor(batch, accum_steps, remat) \
        * llama_forward_flops(cfg, batch, seq)


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
