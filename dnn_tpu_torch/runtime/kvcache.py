"""KV cache codecs: float and int8 (port of dnn_tpu/runtime/kvcache.py:
74-85, 182-303, 306-312, 330-461, 606-637).

A dense cache is {"k", "v"} of shape (L, B, H, S, D) in f32 or bf16, or
{"k", "v", "ks", "vs"} for int8: int8 K/V plus one f32 scale per
(position, head), (L, B, H, S), written as amax/127 of the row
(`_quantize_rows`). H is the model's KV heads: n_head for GPT-2,
n_kv_head for a grouped-query (LLaMA-family) config, whose G = n_head /
n_kv_head query heads share one cached head. The layer loop hands a
codec one layer's (B, H, S[, D]) views. Writes are IN PLACE (torch has
no donation; the JAX codecs return a functionally updated cache that
XLA aliases onto its input).

Attention always runs a kernel wrapper: on a CUDA cache that is the
kernel at every length (the TPU length crossovers, AUTO_KERNEL_MIN_S and
the use_kernel policy, are not carried over), on a CPU cache its plain
version. `attend(base=)` sends a one-row step to K6 (decode_attention)
and a chunk to K5 (cached_attention), as the JAX codecs' kernel path
does, with grouped query heads (a one-row step folds each group into
K6's rows); `attend_rows` (per-slot decode, R rows a cached head) is K6;
`attend_rows_causal` (the speculative verify block: T rows a slot at
per-slot bases, row t attending columns <= pos[b] + t, grouped heads
included) is exactly K5's contract and runs K5. `write_rows` writes one
position a slot (decode) or T of them (the verify block) at per-slot
bases, gated per slot.
Output dtypes follow the JAX codecs: a float codec returns the cache
dtype, the int8 codec q's type (f32, or bf16 under bf16 compute: the
kernels take a bf16 q and write a bf16 output). Writes cast k/v to the
cache's type (int8: quantize them).

Not ported (ROADMAP PyTorch/CUDA port items 2 and 7): int4 caches,
the rolling ring codecs and sliding windows (item 2), logit softcapping
(item 7).
"""

from __future__ import annotations

import torch

from dnn_tpu_torch.ops.cuda.cached_attention import (
    cached_attention,
    decode_attention,
)

__all__ = ["FloatKV", "Int8KV", "band_keep", "cache_shape",
           "codec_for_cache", "span_positions"]


def band_keep(cols, limit, window):
    """The attention band predicate: causal upper bound (cols <= limit)
    plus the optional sliding-window lower bound (cols > limit -
    window). Broadcasts over whatever shapes the caller aligned."""
    keep = cols <= limit
    if window is not None:
        keep &= cols > limit - window
    return keep


def _quantize_rows(x):
    """x (..., D) -> (int8 (..., D), f32 scales (...,)): symmetric per
    row, scale amax/127 (1 for an all-zero row), round half to even of
    x / scale — a division, as the JAX codec does, so payload and scales
    are bit-identical to it — clipped at +-127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def span_positions(start, t: int, device):
    """The positions [start, start + t) as an int64 tensor. `start` is an
    int, or a (1,) int32 device tensor: the base a captured CUDA graph
    reads at each replay (the batcher's mixed step), so that no host
    value is baked into the graph."""
    if isinstance(start, torch.Tensor):
        return start.long() + torch.arange(t, device=device)
    return torch.arange(start, start + t, device=device)


def _write_span(c, new: dict, start_pos):
    """new[name] (B, H, T[, D]) lands at positions [start_pos,
    start_pos + T) of every leaf, in place. The JAX codec's
    dynamic_update_slice clamps an overhanging write back onto real
    positions; here it is an error (for a device-tensor start, an index
    error of index_copy_)."""
    t = next(iter(new.values())).shape[2]
    s_len = c["k"].shape[2]
    if isinstance(start_pos, torch.Tensor):
        idx = span_positions(start_pos, t, c["k"].device)
        for name, val in new.items():
            c[name].index_copy_(2, idx, val)
        return
    if not 0 <= start_pos <= s_len - t:
        raise ValueError(f"write of {t} positions at {start_pos} "
                         f"overhangs a {s_len}-position cache")
    for name, val in new.items():
        c[name][:, :, start_pos:start_pos + t] = val


def _write_rows(c, new: dict, pos, write_gate):
    """new[name] (B, H, T[, D]) lands at each slot's positions pos[b] ..
    pos[b] + T - 1 (pos (B,)), in place. The start clamps to [0, S - T],
    as the JAX codec's dynamic slice does, and a gated-off row re-writes
    the values it already holds there — the JAX codec's clamped
    gather-select-scatter: a bitwise no-op, so an inactive slot whose
    stale pos reaches the cache length changes nothing and indexes
    nothing past it. No host sync: gate and positions stay on the
    device (a captured step reads them at each replay)."""
    s_len = c["k"].shape[2]
    t = next(iter(new.values())).shape[2]
    b = torch.arange(pos.shape[0], device=pos.device)
    if t == 1:  # one position a slot: the decode step
        p = pos.long().clamp(max=s_len - 1)
        for name, val in new.items():
            val = val[:, :, 0]
            leaf = c[name]
            gate = write_gate.reshape((-1,) + (1,) * (val.dim() - 1))
            leaf[b, :, p] = torch.where(gate, val.to(leaf.dtype),
                                        leaf[b, :, p])
        return
    # (B, T) columns; the advanced index puts T before the head dim
    idx = (pos.long().clamp(0, s_len - t)[:, None]
           + torch.arange(t, device=pos.device))
    b = b[:, None]
    for name, val in new.items():
        leaf = c[name]
        val = val.transpose(1, 2)  # (B, T, H[, D])
        gate = write_gate.reshape((-1,) + (1,) * (val.dim() - 1))
        leaf[b, :, idx] = torch.where(gate, val.to(leaf.dtype),
                                      leaf[b, :, idx])


def cache_shape(cfg, batch: int, max_len: int):
    """(L, B, KV heads, S, D) of a dense cache for `cfg`: GQA configs
    (n_kv_head, head_dim) store their KV heads, GPT-2 its n_head."""
    heads = getattr(cfg, "n_kv_head", cfg.n_head)
    d = getattr(cfg, "head_dim", cfg.n_embd // cfg.n_head)
    return (cfg.n_layer, batch, heads, max_len, d)


def _attend_from(q, c, base, **scales):
    """q (B, H, T, D) at positions base + arange(T) against the whole
    cache of Hk = H / G heads, row t attending key positions <= base + t
    (the contiguous limit contract of the JAX codecs' `base=` path): a
    chunk runs K5 with grouped heads; a one-row step runs K6 with each
    group of G query heads folded into its KV head's rows (JAX's LLaMA
    decode fold). `base` is an int or a (1,) int32 device tensor. Out in
    q's type."""
    b, h, t, d = q.shape
    if isinstance(base, torch.Tensor):
        pos = base.to(torch.int32).expand(b).contiguous()
    else:
        pos = torch.full((b,), base, dtype=torch.int32, device=q.device)
    if t > 1:
        return cached_attention(q.contiguous(), c["k"], c["v"], pos, **scales)
    hk = c["k"].shape[1]
    return decode_attention(q.reshape(b, hk, h // hk, d).contiguous(),
                            c["k"], c["v"], pos, **scales).reshape(b, h, 1, d)


class FloatKV:
    """The plain cache: K/V stored in `dtype` (f32, or bf16 for halved
    bandwidth)."""

    def __init__(self, dtype=torch.float32):
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"KV dtype {dtype}: float caches are f32 or bf16 (int8 is "
                "Int8KV; int4 waits for ROADMAP PyTorch/CUDA port item 2)")
        self.dtype = dtype

    def init(self, cfg, batch: int, max_len: int, device):
        shape = cache_shape(cfg, batch, max_len)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=device),
                "v": torch.zeros(shape, dtype=self.dtype, device=device)}

    def write(self, c, k, v, start_pos):
        """c: one layer's {"k","v"} (B, H, S, D); k/v (B, H, T, D) land at
        positions [start_pos, start_pos + T), in place (`start_pos` an
        int or a (1,) int32 device tensor)."""
        _write_span(c, {"k": k.to(c["k"].dtype), "v": v.to(c["v"].dtype)},
                    start_pos)

    def attend(self, q, c, base):
        """q (B, H, T, D) at positions base + arange(T) against a cache of
        H / G heads (see _attend_from). Returns (B, H, T, D) in the cache
        dtype."""
        return _attend_from(q, c, base).to(c["v"].dtype)

    # --- per-row variants (continuous batching: each slot at its own
    # position; `write_gate` (B,) bool keeps inactive slots untouched) ---

    def write_rows(self, c, k, v, pos, write_gate):
        """k/v (B, H, T, D) at per-slot positions pos[b] .. pos[b] + T - 1
        (T = 1: a decode step; T = k + 1: a verify block)."""
        _write_rows(c, {"k": k, "v": v}, pos, write_gate)

    def attend_rows(self, q, c, pos):
        """q (B, Hk, R, D), R rows a cached head (1, or a GQA config's
        folded group); every row of slot b attends key positions
        <= pos[b] (K6). Returns (B, Hk, R, D) in the cache dtype."""
        return decode_attention(q.contiguous(), c["k"], c["v"], pos) \
            .to(c["v"].dtype)

    def attend_rows_causal(self, q, c, pos):
        """q (B, H, T, D), the verify block: row t of slot b attends key
        positions <= pos[b] + t, over a cache of H / G heads (K5 at the
        slots' own bases). Returns (B, H, T, D) in the cache dtype. (The
        JAX codec pins its einsum here and rounds the probabilities to
        the cache dtype; K5 keeps them in f32.)"""
        return cached_attention(q.contiguous(), c["k"], c["v"], pos) \
            .to(c["v"].dtype)


class Int8KV:
    """int8 K/V with per-(position, head) f32 scales — 4x less cache
    bandwidth per decode step than f32, 2x less than bf16. The kernels
    read the 1-byte payload and fold the scales in (K scale onto the
    scores, V scale onto the probabilities); no float copy of the cache
    is ever made."""

    def init(self, cfg, batch: int, max_len: int, device):
        shape = cache_shape(cfg, batch, max_len)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.ones(shape[:-1], dtype=torch.float32, device=device),
            "vs": torch.ones(shape[:-1], dtype=torch.float32, device=device),
        }

    def write(self, c, k, v, start_pos):
        kq, ks = _quantize_rows(k)
        vq, vs = _quantize_rows(v)
        _write_span(c, {"k": kq, "v": vq, "ks": ks, "vs": vs}, start_pos)

    def attend(self, q, c, base):
        """As FloatKV.attend, with the scales; returns q's type."""
        return _attend_from(q, c, base, ks=c["ks"], vs=c["vs"])

    def write_rows(self, c, k, v, pos, write_gate):
        kq, ks = _quantize_rows(k)   # (B, H, T, D), (B, H, T)
        vq, vs = _quantize_rows(v)
        _write_rows(c, {"k": kq, "v": vq, "ks": ks, "vs": vs}, pos,
                    write_gate)

    def attend_rows(self, q, c, pos):
        """q (B, Hk, R, D) shared-limit decode rows (K6); returns q's
        type."""
        return decode_attention(q.contiguous(), c["k"], c["v"], pos,
                                ks=c["ks"], vs=c["vs"])


def codec_for_cache(cache, *, window=None, rolling: bool = False,
                    softcap=None):
    """The codec of a dense cache, from its structure: scale leaves mean
    int8. Sliding windows, rolling rings and softcapping are not ported
    and raise."""
    if rolling or window is not None:
        raise NotImplementedError(
            "sliding-window and rolling KV caches are not ported to "
            "dnn_tpu_torch yet (ROADMAP PyTorch/CUDA port item 2)")
    if softcap is not None:
        raise NotImplementedError(
            "attention-logit softcapping is not ported to dnn_tpu_torch "
            "yet (ROADMAP PyTorch/CUDA port item 7)")
    if "ks" in cache:
        if cache["k"].dtype != torch.int8:
            raise NotImplementedError(
                f"quantized cache of {cache['k'].dtype}: only int8 is "
                "ported (int4 waits for ROADMAP PyTorch/CUDA port item 2)")
        return Int8KV()
    return FloatKV(cache["k"].dtype)
