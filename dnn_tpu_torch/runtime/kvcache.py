"""KV cache codecs: float and int8, banded, soft-capped and rolling (port
of dnn_tpu/runtime/kvcache.py:74-150, 182-303, 306-312, 330-461,
494-637).

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

`window=W` (Mistral-class sliding windows) adds the band's lower bound
to every attend — a row whose limit is L sees only the key positions
after L - W (`band_keep`) — over an ordinary full-length cache; each
attend also takes a per-call `window=` override, the channel of Gemma-2's
alternating per-layer windows (a global layer passes block_size, which
bands nothing). `softcap=c` (Gemma-2) caps every score at c * tanh(s /
c) after its scales, before the mask. Both ride the kernels (K5, K6:
the band and the cap are two more predicates there; JAX's codecs send
them to the einsum).

`RollingFloatKV` / `RollingInt8KV` store only W positions as a ring
(position p at slot p % W; `ring_positions`): the solo decoder's cache
for a stream longer than the window. Attention over keys does not depend
on their order and keys are cached already rotated, so a W-slot ring
whose written slots are 0 .. min(p, W - 1) is K6 over the ring with pos
clipped to W - 1 — the JAX codecs' ring-occupancy mask, without one.

Not ported (ROADMAP PyTorch/CUDA port item 2): int4 caches.
"""

from __future__ import annotations

from typing import Optional

import torch

from dnn_tpu_torch.ops.cuda.cached_attention import (
    band_keep,
    cached_attention,
    decode_attention,
)

__all__ = ["FloatKV", "Int8KV", "RollingFloatKV", "RollingInt8KV",
           "band_keep", "cache_shape", "codec_for_cache", "ring_positions",
           "span_positions"]


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


def _slot_positions(base, b: int, device):
    """(B,) int32 positions of a shared base: an int, or a (1,) int32
    device tensor (expanded, not copied to the host)."""
    if isinstance(base, torch.Tensor):
        return base.to(torch.int32).expand(b).contiguous()
    return torch.full((b,), base, dtype=torch.int32, device=device)


def _attend_from(q, c, base, **kw):
    """q (B, H, T, D) at positions base + arange(T) against the whole
    cache of Hk = H / G heads, row t attending key positions <= base + t
    (the contiguous limit contract of the JAX codecs' `base=` path; `kw`:
    the scales, window and softcap): a chunk runs K5 with grouped heads;
    a one-row step runs K6 with each group of G query heads folded into
    its KV head's rows (JAX's LLaMA decode fold). `base` is an int or a
    (1,) int32 device tensor. Out in q's type."""
    b, h, t, d = q.shape
    pos = _slot_positions(base, b, q.device)
    if t > 1:
        return cached_attention(q.contiguous(), c["k"], c["v"], pos, **kw)
    hk = c["k"].shape[1]
    return decode_attention(q.reshape(b, hk, h // hk, d).contiguous(),
                            c["k"], c["v"], pos, **kw).reshape(b, h, 1, d)


class _Band:
    """The band and the cap every attend of a codec applies (JAX's
    _KernelDispatch without its kernel policy): the codec's `window` and
    `softcap`, and a per-call `window` override that wins over the
    codec's (Gemma-2's per-layer windows)."""

    window: Optional[int] = None
    softcap: Optional[float] = None

    def _kw(self, window=None, **scales):
        return {"window": window if window is not None else self.window,
                "softcap": self.softcap, **scales}


class FloatKV(_Band):
    """The plain cache: K/V stored in `dtype` (f32, or bf16 for halved
    bandwidth); `window` and `softcap` as the module docstring says."""

    def __init__(self, dtype=torch.float32, window: Optional[int] = None,
                 softcap: Optional[float] = None):
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"KV dtype {dtype}: float caches are f32 or bf16 (int8 is "
                "Int8KV; int4 waits for ROADMAP PyTorch/CUDA port item 2)")
        self.dtype = dtype
        self.window = window
        self.softcap = softcap

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

    def attend(self, q, c, base, window=None):
        """q (B, H, T, D) at positions base + arange(T) against a cache of
        H / G heads (see _attend_from). Returns (B, H, T, D) in the cache
        dtype."""
        return _attend_from(q, c, base, **self._kw(window)).to(c["v"].dtype)

    # --- per-row variants (continuous batching: each slot at its own
    # position; `write_gate` (B,) bool keeps inactive slots untouched) ---

    def write_rows(self, c, k, v, pos, write_gate):
        """k/v (B, H, T, D) at per-slot positions pos[b] .. pos[b] + T - 1
        (T = 1: a decode step; T = k + 1: a verify block)."""
        _write_rows(c, {"k": k, "v": v}, pos, write_gate)

    def attend_rows(self, q, c, pos, window=None):
        """q (B, Hk, R, D), R rows a cached head (1, or a GQA config's
        folded group); every row of slot b attends key positions
        <= pos[b] (K6). Returns (B, Hk, R, D) in the cache dtype."""
        return decode_attention(q.contiguous(), c["k"], c["v"], pos,
                                **self._kw(window)).to(c["v"].dtype)

    def attend_rows_causal(self, q, c, pos, window=None):
        """q (B, H, T, D), the verify block: row t of slot b attends key
        positions <= pos[b] + t, over a cache of H / G heads (K5 at the
        slots' own bases). Returns (B, H, T, D) in the cache dtype. (The
        JAX codec pins its einsum here and rounds the probabilities to
        the cache dtype; K5 keeps them in f32.)"""
        return cached_attention(q.contiguous(), c["k"], c["v"], pos,
                                **self._kw(window)).to(c["v"].dtype)


class Int8KV(_Band):
    """int8 K/V with per-(position, head) f32 scales — 4x less cache
    bandwidth per decode step than f32, 2x less than bf16. The kernels
    read the 1-byte payload and fold the scales in (K scale onto the
    scores, V scale onto the probabilities); no float copy of the cache
    is ever made. `window` and `softcap` as FloatKV's."""

    def __init__(self, window: Optional[int] = None,
                 softcap: Optional[float] = None):
        self.window = window
        self.softcap = softcap

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

    def attend(self, q, c, base, window=None):
        """As FloatKV.attend, with the scales; returns q's type."""
        return _attend_from(q, c, base,
                            **self._kw(window, ks=c["ks"], vs=c["vs"]))

    def write_rows(self, c, k, v, pos, write_gate):
        kq, ks = _quantize_rows(k)   # (B, H, T, D), (B, H, T)
        vq, vs = _quantize_rows(v)
        _write_rows(c, {"k": kq, "v": vq, "ks": ks, "vs": vs}, pos,
                    write_gate)

    def attend_rows(self, q, c, pos, window=None):
        """q (B, Hk, R, D) shared-limit decode rows (K6); returns q's
        type."""
        return decode_attention(q.contiguous(), c["k"], c["v"], pos,
                                **self._kw(window, ks=c["ks"], vs=c["vs"]))

    def attend_rows_causal(self, q, c, pos, window=None):
        """The verify block (FloatKV.attend_rows_causal) over the int8
        cache, with its scales; returns q's type."""
        return cached_attention(q.contiguous(), c["k"], c["v"], pos,
                                **self._kw(window, ks=c["ks"], vs=c["vs"]))


def ring_positions(pos, w: int):
    """The absolute position ring slot j holds at stream position `pos`
    (JAX's ring_positions): a_j = pos - ((pos - j) mod w), the latest
    position congruent to j that is <= pos; negative means not written
    yet. Broadcasts over pos's shape (an int or a tensor), appending a
    (w,) axis."""
    pos = torch.as_tensor(pos)
    j = torch.arange(w, device=pos.device)
    return pos[..., None] - torch.remainder(pos[..., None] - j, w)


class _RingStorage:
    """The rolling ring over a base codec (JAX's _RingStorage): `window`
    positions stored, position p written at slot p % window, and a
    decode row at position p attending the ring's written slots — K6
    over the ring with pos clipped to window - 1 (the module docstring
    says why that is the band). Multi-row attends (prefill chunks, the
    speculative verify) belong on a full-length cache with the band
    (llama.make_generate's rolling path prefills there, then gathers the
    live band into the ring), so they raise."""

    def init(self, cfg, batch: int, max_len: int, device):
        del max_len  # the stream's bound; the storage is the window
        return super().init(cfg, batch, self.window, device)

    def attend(self, q, c, base, window=None):
        if q.shape[2] != 1:
            raise ValueError(
                "rolling cache attends single decode rows only — prefill "
                "on a full-length cache with window= masking, then gather "
                "the live band (llama.make_generate's rolling path)")
        b, h, _, d = q.shape
        hk = c["k"].shape[1]
        y = self.attend_rows(q.reshape(b, hk, h // hk, d), c,
                             _slot_positions(base, b, q.device))
        return y.reshape(b, h, 1, d)

    def attend_rows(self, q, c, pos, window=None):
        """Every row of slot b attends the ring's written slots at stream
        position pos[b]; a per-call window makes no sense on a ring (its
        storage is the window) and is ignored, as JAX's. (The codec's own
        window, which rides into K6, bands nothing over its W slots: the
        kernel runs unbanded.)"""
        del window
        return super().attend_rows(q, c, pos.clamp(max=c["k"].shape[2] - 1))

    def write(self, c, k, v, start_pos):
        """k/v (B, H, T, D) at stream positions [start_pos, start_pos +
        T) into their slots; only the last min(T, window) rows survive
        the wrap, in distinct slots."""
        t, w = k.shape[2], c["k"].shape[2]
        m = min(t, w)
        slots = torch.remainder(
            span_positions(start_pos, t, k.device)[t - m:], w)
        for name, val in self._encode(k[:, :, t - m:], v[:, :, t - m:]).items():
            c[name].index_copy_(2, slots, val.to(c[name].dtype))

    def write_rows(self, c, k, v, pos, write_gate):
        super().write_rows(c, k, v, torch.remainder(pos, c["k"].shape[2]),
                           write_gate)

    def attend_rows_causal(self, q, c, pos, window=None):
        raise ValueError(
            "speculative verify blocks need a full-length cache — rolling "
            "storage cannot express per-row history beyond the ring")


def _check_ring_window(window):
    if window is None or window < 1:
        raise ValueError(f"rolling cache needs a positive window, got {window}")


class RollingFloatKV(_RingStorage, FloatKV):
    """Ring-buffer float cache for sliding-window decode (_RingStorage)."""

    def __init__(self, dtype=torch.float32, window: Optional[int] = None):
        _check_ring_window(window)
        super().__init__(dtype, window=window)

    @staticmethod
    def _encode(k, v):
        return {"k": k, "v": v}


class RollingInt8KV(_RingStorage, Int8KV):
    """Ring-buffer int8 cache: _RingStorage over Int8KV's per-row
    scales."""

    def __init__(self, window: Optional[int] = None):
        _check_ring_window(window)
        super().__init__(window=window)

    @staticmethod
    def _encode(k, v):
        kq, ks = _quantize_rows(k)
        vq, vs = _quantize_rows(v)
        return {"k": kq, "v": vq, "ks": ks, "vs": vs}


def codec_for_cache(cache, *, window=None, rolling: bool = False,
                    softcap=None):
    """The codec of a dense cache, from its structure (JAX's
    codec_for_cache): scale leaves mean int8. `window` adds the band,
    `softcap` the score cap; `rolling=True` treats the cache as a
    `window`-slot ring (a ring leaf looks like a short cache, so rolling
    cannot be inferred). int4 caches raise (ROADMAP PyTorch/CUDA port
    item 2)."""
    if "ks" in cache and cache["k"].dtype != torch.int8:
        raise NotImplementedError(
            f"quantized cache of {cache['k'].dtype}: only int8 is ported "
            "(int4 waits for ROADMAP PyTorch/CUDA port item 2)")
    if rolling:
        if softcap is not None:
            raise ValueError("softcap is not supported on rolling caches")
        if "ks" in cache:
            return RollingInt8KV(window=window)
        return RollingFloatKV(cache["k"].dtype, window=window)
    if "ks" in cache:
        return Int8KV(window=window, softcap=softcap)
    return FloatKV(cache["k"].dtype, window=window, softcap=softcap)
