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
K6's rows); `attend_rows` (per-slot decode, R rows a cached head) is K6.
Output dtypes follow the JAX codecs: a float codec returns the cache
dtype, the int8 codec f32.

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
           "codec_for_cache"]


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


def _write_span(c, new: dict, start_pos: int):
    """new[name] (B, H, T[, D]) lands at positions [start_pos,
    start_pos + T) of every leaf, in place. The JAX codec's
    dynamic_update_slice clamps an overhanging write back onto real
    positions; here it is an error."""
    t = next(iter(new.values())).shape[2]
    s_len = c["k"].shape[2]
    if not 0 <= start_pos <= s_len - t:
        raise ValueError(f"write of {t} positions at {start_pos} "
                         f"overhangs a {s_len}-position cache")
    for name, val in new.items():
        c[name][:, :, start_pos:start_pos + t] = val


def _write_rows(c, new: dict, pos, write_gate):
    """new[name] (B, H[, D]) lands at each slot's position pos (B,), in
    place. A gated-off row re-writes the value it already holds at
    min(pos, S - 1) — the JAX codec's clamped gather-select-scatter: a
    bitwise no-op, so an inactive slot whose stale pos reaches the
    cache length changes nothing and indexes nothing past it. No host
    sync: gate and positions stay on the device."""
    s_len = c["k"].shape[2]
    b = torch.arange(pos.shape[0], device=pos.device)
    p = pos.long().clamp(max=s_len - 1)
    for name, val in new.items():
        leaf = c[name]
        gate = write_gate.reshape((-1,) + (1,) * (val.dim() - 1))
        leaf[b, :, p] = torch.where(gate, val.to(leaf.dtype), leaf[b, :, p])


def cache_shape(cfg, batch: int, max_len: int):
    """(L, B, KV heads, S, D) of a dense cache for `cfg`: GQA configs
    (n_kv_head, head_dim) store their KV heads, GPT-2 its n_head."""
    heads = getattr(cfg, "n_kv_head", cfg.n_head)
    d = getattr(cfg, "head_dim", cfg.n_embd // cfg.n_head)
    return (cfg.n_layer, batch, heads, max_len, d)


def _attend_from(q, c, base: int, **scales):
    """q (B, H, T, D) at positions base + arange(T) against the whole
    cache of Hk = H / G heads, row t attending key positions <= base + t
    (the contiguous limit contract of the JAX codecs' `base=` path): a
    chunk runs K5 with grouped heads; a one-row step runs K6 with each
    group of G query heads folded into its KV head's rows (JAX's LLaMA
    decode fold). f32 out."""
    b, h, t, d = q.shape
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

    def write(self, c, k, v, start_pos: int):
        """c: one layer's {"k","v"} (B, H, S, D); k/v (B, H, T, D) land at
        positions [start_pos, start_pos + T), in place."""
        _write_span(c, {"k": k.to(c["k"].dtype), "v": v.to(c["v"].dtype)},
                    start_pos)

    def attend(self, q, c, base: int):
        """q (B, H, T, D) at positions base + arange(T) against a cache of
        H / G heads (see _attend_from). Returns (B, H, T, D) in the cache
        dtype."""
        return _attend_from(q, c, base).to(c["v"].dtype)

    # --- per-row variants (continuous batching: each slot at its own
    # position; `write_gate` (B,) bool keeps inactive slots untouched) ---

    def write_rows(self, c, k, v, pos, write_gate):
        """k/v (B, H, 1, D) at per-slot positions pos (B,)."""
        _write_rows(c, {"k": k[:, :, 0], "v": v[:, :, 0]}, pos, write_gate)

    def attend_rows(self, q, c, pos):
        """q (B, Hk, R, D), R rows a cached head (1, or a GQA config's
        folded group); every row of slot b attends key positions
        <= pos[b] (K6). Returns (B, Hk, R, D) in the cache dtype."""
        return decode_attention(q.contiguous(), c["k"], c["v"], pos) \
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

    def write(self, c, k, v, start_pos: int):
        kq, ks = _quantize_rows(k)
        vq, vs = _quantize_rows(v)
        _write_span(c, {"k": kq, "v": vq, "ks": ks, "vs": vs}, start_pos)

    def attend(self, q, c, base: int):
        """As FloatKV.attend, with the scales; returns f32."""
        return _attend_from(q, c, base, ks=c["ks"], vs=c["vs"])

    def write_rows(self, c, k, v, pos, write_gate):
        kq, ks = _quantize_rows(k[:, :, 0])   # (B, H, D), (B, H)
        vq, vs = _quantize_rows(v[:, :, 0])
        _write_rows(c, {"k": kq, "v": vq, "ks": ks, "vs": vs}, pos,
                    write_gate)

    def attend_rows(self, q, c, pos):
        """q (B, Hk, R, D) shared-limit decode rows (K6); returns f32."""
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
