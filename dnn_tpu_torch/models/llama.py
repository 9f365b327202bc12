"""LLaMA-family decoder-only LM (port of dnn_tpu/models/llama.py):
RMSNorm, RoPE, SwiGLU and grouped-query attention (GQA), with the
switches that turn the block into Qwen2, Gemma-1, Phi, Qwen3 or OLMo-2.

Parameters keep the JAX package's tree layout (`init`), so one set of
weights feeds both packages (dnn_tpu_torch/convert.py):

  {"wte": {"embedding" (V, C)},
   "h_i": {"ln_1": {"scale"[, "bias"]},
           "attn": {"q", "k", "v", "o": {"kernel"[, "bias"]}
                    [, "q_norm", "k_norm": {"scale"}]},
           "ln_2": {...}, "mlp": {["gate",] "up", "down": {...}}
           [, "post_ln_1", "post_ln_2": {...}]},
   "ln_f": {"scale"[, "bias"]}[, "lm_head": {"kernel" (C, V)[, "bias"]}]}

The served form is gpt.prepare_stacked's: every block leaf stacked on a
leading (L,) axis. q projects to n_head heads, k and v to n_kv_head: the
cache stores KV heads (runtime/kvcache.py, runtime/paged_kvcache.py), and
attention against it folds each group of G = n_head / n_kv_head query
heads onto its KV head — K5 takes grouped heads for a prefill chunk, K6
and K7 take the group as G query rows a KV head for a decode step. The
stateless forward (`make_apply`) runs the grouped einsum, as JAX's does.
RoPE tables are computed in f32 at each row's absolute position. The
speculative batcher's verify block (`LlamaFamilyRows.verify_rows`: T
rows a slot at its own base) runs K5 with grouped heads.

Sliding windows (Mistral: `sliding_window` on every layer; Gemma-2:
`alt_window`, the window on even layers and none on odd ones,
`layer_windows`) band every attention: the stateless forward's mask, and
on a cache the codec's window (uniform) or a per-layer window handed to
each layer's attend (alternating); the kernels take the band as a
predicate (K5-K7). Gemma-2's attention softcap rides the codec into K5
and K6, its final softcap caps the head's logits. The solo decoder of a
uniformly windowed config whose stream outgrows the window decodes on a
rolling ring (runtime/generate.py, `_ring_from_prompt`).

The block's MLP may be overridden by an `ffn(bp, h)` hook (JAX's
_mlp_out :565): the MoE subclass (models/llama_moe.MixtralConfig)
resolves its routed experts through `default_ffn`, which every entry
point here consults when no `ffn` is passed -- the stateless forwards,
the cached forward, the batcher's family hooks (prefill chunks, decode
rows, verify rows) and the pipeline stages -- so the solo decoder, the
speculative decoder, beam search and the embedding endpoint route
through the experts without MoE-specific wiring.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from dnn_tpu_torch.models.gpt import layer_params, layer_ranges, unstack
from dnn_tpu_torch.ops.attention import (
    apply_rope,
    merge_heads,
    rope_cos_sin,
    split_heads,
)
from dnn_tpu_torch.ops.cuda.cached_attention import band_keep, soft_cap
from dnn_tpu_torch.ops.nn import embedding, gelu, layer_norm, linear, rms_norm, silu
from dnn_tpu_torch.registry import ModelSpec, StageSpec, register_model

_NEG_BIG = -1e30


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The port's copy of JAX's LlamaConfig (:55-186): the same fields,
    defaults and validation. See the JAX class for each switch."""

    block_size: int = 2048
    vocab_size: int = 32000
    n_layer: int = 22
    n_head: int = 32
    n_kv_head: int = 4
    n_embd: int = 2048
    d_ff: int = 5632
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    sliding_window: Optional[int] = None
    rope_scaling: Optional[str] = None
    rope_scale: float = 1.0
    attn_bias: bool = False
    head_dim_override: Optional[int] = None
    norm_plus_one: bool = False
    mlp_act: str = "silu"
    tie_word_embeddings: bool = False
    embed_scale: bool = False
    query_scale: Optional[float] = None
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    post_norms: bool = False
    alt_window: bool = False
    layer_norm: bool = False
    parallel_block: bool = False
    rotary_dim: Optional[int] = None
    dense_bias: bool = False
    mlp_gated: bool = True
    qk_norm: bool = False
    qk_norm_width: str = "head"
    pre_norm: bool = True

    def __post_init__(self):
        if self.parallel_block and self.post_norms:
            raise ValueError(
                "parallel_block (Phi) and post_norms (Gemma-2) describe "
                "incompatible residual structures")
        if not self.pre_norm and (not self.post_norms
                                  or self.parallel_block):
            raise ValueError(
                "pre_norm=False (OLMo-2) requires post_norms=True and a "
                "sequential block — without pre-norms the post-branch "
                "norms are the only normalization")
        if self.qk_norm_width not in ("head", "proj"):
            raise ValueError(
                f"qk_norm_width must be 'head' or 'proj', got "
                f"{self.qk_norm_width!r}")
        if self.rotary_dim is not None and (
                self.rotary_dim % 2 or not
                0 < self.rotary_dim <= self.head_dim):
            raise ValueError(
                f"rotary_dim must be an even value in (0, head_dim="
                f"{self.head_dim}], got {self.rotary_dim}")

    @property
    def head_dim(self):
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.n_embd // self.n_head

    def default_ffn(self, compute_dtype=None):
        """The config's MLP override, which every entry point picks up
        when no `ffn` is passed (JAX :181): None, the dense MLP, here;
        the MoE subclass returns its routed experts."""
        return None


PRESETS = {
    "tinyllama-1.1b": LlamaConfig(),
    "llama2-7b": LlamaConfig(block_size=4096, n_layer=32, n_head=32,
                             n_kv_head=32, n_embd=4096, d_ff=11008),
    "llama3-8b": LlamaConfig(block_size=8192, vocab_size=128256, n_layer=32,
                             n_head=32, n_kv_head=8, n_embd=4096, d_ff=14336,
                             rope_theta=500000.0),
    "llama-test": LlamaConfig(block_size=64, vocab_size=256, n_layer=4,
                              n_head=4, n_kv_head=2, n_embd=64, d_ff=128),
    "mistral-7b": LlamaConfig(block_size=32768, vocab_size=32000,
                              n_layer=32, n_head=32, n_kv_head=8,
                              n_embd=4096, d_ff=14336,
                              rope_theta=10000.0, sliding_window=4096),
    "mistral-test": LlamaConfig(block_size=64, vocab_size=256, n_layer=4,
                                n_head=4, n_kv_head=2, n_embd=64, d_ff=128,
                                sliding_window=16),
    "qwen2-7b": LlamaConfig(block_size=32768, vocab_size=152064,
                            n_layer=28, n_head=28, n_kv_head=4,
                            n_embd=3584, d_ff=18944,
                            rope_theta=1_000_000.0, rms_eps=1e-6,
                            attn_bias=True),
    "qwen2-test": LlamaConfig(block_size=64, vocab_size=256, n_layer=4,
                              n_head=4, n_kv_head=2, n_embd=64, d_ff=128,
                              attn_bias=True),
    "gemma-2b": LlamaConfig(block_size=8192, vocab_size=256000,
                            n_layer=18, n_head=8, n_kv_head=1,
                            n_embd=2048, d_ff=16384,
                            head_dim_override=256, rms_eps=1e-6,
                            norm_plus_one=True, mlp_act="gelu_tanh",
                            tie_word_embeddings=True, embed_scale=True),
    "gemma-7b": LlamaConfig(block_size=8192, vocab_size=256000,
                            n_layer=28, n_head=16, n_kv_head=16,
                            n_embd=3072, d_ff=24576,
                            head_dim_override=256, rms_eps=1e-6,
                            norm_plus_one=True, mlp_act="gelu_tanh",
                            tie_word_embeddings=True, embed_scale=True),
    "gemma-test": LlamaConfig(block_size=64, vocab_size=256, n_layer=4,
                              n_head=4, n_kv_head=1, n_embd=64, d_ff=128,
                              head_dim_override=32, rms_eps=1e-6,
                              norm_plus_one=True, mlp_act="gelu_tanh",
                              tie_word_embeddings=True, embed_scale=True),
    "gemma2-9b": LlamaConfig(block_size=8192, vocab_size=256000,
                             n_layer=42, n_head=16, n_kv_head=8,
                             n_embd=3584, d_ff=14336,
                             head_dim_override=256, rms_eps=1e-6,
                             norm_plus_one=True, mlp_act="gelu_tanh",
                             tie_word_embeddings=True, embed_scale=True,
                             post_norms=True, query_scale=256.0,
                             attn_softcap=50.0, final_softcap=30.0,
                             sliding_window=4096, alt_window=True),
    "gemma2-test": LlamaConfig(block_size=64, vocab_size=256, n_layer=4,
                               n_head=4, n_kv_head=2, n_embd=64, d_ff=128,
                               head_dim_override=32, rms_eps=1e-6,
                               norm_plus_one=True, mlp_act="gelu_tanh",
                               tie_word_embeddings=True, embed_scale=True,
                               post_norms=True, query_scale=64.0,
                               attn_softcap=50.0, final_softcap=30.0,
                               sliding_window=16, alt_window=True),
    "phi-2": LlamaConfig(block_size=2048, vocab_size=51200, n_layer=32,
                         n_head=32, n_kv_head=32, n_embd=2560,
                         d_ff=10240, rms_eps=1e-5, layer_norm=True,
                         parallel_block=True, rotary_dim=32,
                         attn_bias=True, dense_bias=True,
                         mlp_gated=False, mlp_act="gelu_tanh"),
    "phi-test": LlamaConfig(block_size=64, vocab_size=256, n_layer=4,
                            n_head=4, n_kv_head=4, n_embd=64, d_ff=128,
                            rms_eps=1e-5, layer_norm=True,
                            parallel_block=True, rotary_dim=8,
                            attn_bias=True, dense_bias=True,
                            mlp_gated=False, mlp_act="gelu_tanh"),
    "qwen3-8b": LlamaConfig(block_size=40960, vocab_size=151936,
                            n_layer=36, n_head=32, n_kv_head=8,
                            n_embd=4096, d_ff=12288,
                            head_dim_override=128,
                            rope_theta=1_000_000.0, rms_eps=1e-6,
                            qk_norm=True),
    "qwen3-test": LlamaConfig(block_size=64, vocab_size=256, n_layer=4,
                              n_head=4, n_kv_head=2, n_embd=64, d_ff=128,
                              head_dim_override=32, rms_eps=1e-6,
                              qk_norm=True),
    "olmo2-7b": LlamaConfig(block_size=4096, vocab_size=100352,
                            n_layer=32, n_head=32, n_kv_head=32,
                            n_embd=4096, d_ff=11008,
                            rope_theta=500000.0, rms_eps=1e-6,
                            qk_norm=True, qk_norm_width="proj",
                            pre_norm=False, post_norms=True),
    "olmo2-test": LlamaConfig(block_size=64, vocab_size=256, n_layer=4,
                              n_head=4, n_kv_head=2, n_embd=64, d_ff=128,
                              rms_eps=1e-5, qk_norm=True,
                              qk_norm_width="proj", pre_norm=False,
                              post_norms=True),
}


def layer_windows(cfg: LlamaConfig):
    """Per-layer window list of an alternating-attention config (JAX
    :255): sliding_window on even layers, block_size on odd ones; None
    for uniform attention."""
    if not cfg.alt_window:
        return None
    if cfg.sliding_window is None:
        raise ValueError(
            "alt_window=True requires sliding_window to be set: alternating "
            "window/global layers need a window width for the even layers")
    return [cfg.sliding_window if i % 2 == 0 else cfg.block_size
            for i in range(cfg.n_layer)]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

class Draws:
    """Random leaves from one seeded stream: float32 numpy arrays drawn
    with numpy, or, with `device`, tensors drawn there from a seeded
    torch.Generator (`rng`: the numpy Generator or the torch.Generator,
    for a caller's own draws from the same stream)."""

    def __init__(self, seed, device=None):
        self.device = device
        if device is None:
            self.rng = np.random.default_rng(seed)
        else:
            self.rng = torch.Generator(device=device).manual_seed(seed)

    def normal(self, shape, std=0.02):
        if self.device is None:
            return (self.rng.standard_normal(shape, dtype=np.float32)
                    * np.float32(std))
        return torch.randn(shape, generator=self.rng,
                           device=self.device) * std

    def full(self, n, value):
        if self.device is None:
            return np.full((n,), value, np.float32)
        return torch.full((n,), float(value), device=self.device)

    def proj(self, shape, std=0.02, bias=False):
        p = {"kernel": self.normal(shape, std)}
        if bias:
            p["bias"] = self.full(shape[-1], 0.0)
        return p

    def norm(self, cfg: "LlamaConfig", n):
        p = {"scale": self.full(n, 0.0 if cfg.norm_plus_one else 1.0)}
        if cfg.layer_norm:
            p["bias"] = self.full(n, 0.0)
        return p


def init_top(draw: Draws, cfg: LlamaConfig):
    """The tree's non-block leaves: wte, ln_f and (untied) lm_head."""
    params = {"wte": {"embedding": draw.normal((cfg.vocab_size,
                                                 cfg.n_embd))},
              "ln_f": draw.norm(cfg, cfg.n_embd)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = draw.proj((cfg.n_embd, cfg.vocab_size),
                                      bias=cfg.dense_bias)
    return params


def init_block(draw: Draws, cfg: LlamaConfig, include_mlp: bool = True):
    """One block's leaves (JAX's _init_block): attention, norms and,
    with `include_mlp`, the dense MLP."""
    c, d = cfg.n_embd, cfg.head_dim
    out_std = 0.02 / (2 * cfg.n_layer) ** 0.5
    attn = {
        "q": draw.proj((c, cfg.n_head * d), bias=cfg.attn_bias),
        "k": draw.proj((c, cfg.n_kv_head * d), bias=cfg.attn_bias),
        "v": draw.proj((c, cfg.n_kv_head * d), bias=cfg.attn_bias),
        "o": draw.proj((cfg.n_head * d, c), out_std, bias=cfg.dense_bias),
    }
    if cfg.qk_norm:
        per_head = cfg.qk_norm_width == "head"
        attn["q_norm"] = {"scale": draw.full(
            d if per_head else cfg.n_head * d, 1.0)}
        attn["k_norm"] = {"scale": draw.full(
            d if per_head else cfg.n_kv_head * d, 1.0)}
    blk = {"ln_1": draw.norm(cfg, c), "attn": attn}
    if not cfg.parallel_block:
        blk["ln_2"] = draw.norm(cfg, c)
    if not cfg.pre_norm:
        del blk["ln_1"], blk["ln_2"]
    if include_mlp and cfg.mlp_gated:
        blk["mlp"] = {"gate": draw.proj((c, cfg.d_ff)),
                      "up": draw.proj((c, cfg.d_ff)),
                      "down": draw.proj((cfg.d_ff, c), out_std)}
    elif include_mlp:
        blk["mlp"] = {"up": draw.proj((c, cfg.d_ff), bias=cfg.dense_bias),
                      "down": draw.proj((cfg.d_ff, c), out_std,
                                        bias=cfg.dense_bias)}
    if cfg.post_norms:
        blk["post_ln_1"] = draw.norm(cfg, c)
        blk["post_ln_2"] = draw.norm(cfg, c)
    return blk


def init(seed: int, cfg: LlamaConfig = PRESETS["llama-test"], *,
         device=None, include_mlp: bool = True):
    """Random weights from `seed`: the tree, shapes and standard
    deviations of dnn_tpu.models.llama.init (0.02 normal, o and down
    scaled by 1/sqrt(2 n_layer), norms at one, or zero under
    norm_plus_one, biases at zero). The draws differ from jax.random's;
    tests share weights through convert.from_jax_params. Returns the
    JAX-layout tree of float32 numpy arrays drawn with numpy or, with
    `device`, of tensors drawn there from a seeded torch.Generator (a
    full-size model never visits the host). `include_mlp=False` leaves
    the dense MLPs out (JAX :347): the MoE families add their expert
    stacks instead."""
    draw = Draws(seed, device)
    params = init_top(draw, cfg)
    for i in range(cfg.n_layer):
        params[f"h_{i}"] = init_block(draw, cfg, include_mlp)
    return params


# --------------------------------------------------------------------------
# the block's parts (JAX :447-640)
# --------------------------------------------------------------------------

def _rope_tables(cfg: LlamaConfig, positions):
    """cos/sin at `positions` with the config's long-context scaling and
    partial rotary width: the one place scaling happens."""
    theta = cfg.rope_theta
    d = cfg.rotary_dim or cfg.head_dim
    if cfg.rope_scaling is None:
        if cfg.rope_scale != 1.0:
            raise ValueError(
                f"rope_scale={cfg.rope_scale} has no effect without "
                "rope_scaling='linear' or 'ntk'")
        return rope_cos_sin(positions, d, theta=theta)
    if cfg.rope_scaling not in ("linear", "ntk"):
        raise ValueError(
            f"unknown rope_scaling {cfg.rope_scaling!r} "
            "(expected 'linear' or 'ntk')")
    if cfg.rope_scale == 1.0:
        return rope_cos_sin(positions, d, theta=theta)
    if cfg.rope_scale < 1.0:
        raise ValueError(f"rope_scale must be >= 1, got {cfg.rope_scale}")
    if cfg.rope_scaling == "linear":
        positions = positions.float() / cfg.rope_scale
    else:  # "ntk"
        theta = theta * cfg.rope_scale ** (d / (d - 2))
    return rope_cos_sin(positions, d, theta=theta)


def _norm(p, x, cfg: LlamaConfig):
    """Every norm site: LayerNorm (Phi) or RMSNorm ((1 + w) for Gemma)."""
    if cfg.layer_norm:
        return layer_norm(p, x, eps=cfg.rms_eps)
    return rms_norm(p, x, eps=cfg.rms_eps, plus_one=cfg.norm_plus_one)


def _mlp_act(cfg: LlamaConfig):
    if cfg.mlp_act == "silu":
        return silu
    if cfg.mlp_act == "gelu_tanh":
        return gelu
    raise ValueError(f"unknown mlp_act {cfg.mlp_act!r}")


def _q_rescale(q, cfg: LlamaConfig):
    """Gemma-2's query_pre_attn_scalar folded into q."""
    if cfg.query_scale is not None:
        q = q * torch.tensor((cfg.head_dim / cfg.query_scale) ** 0.5,
                             dtype=q.dtype)
    return q


def _rope_apply(x, cos, sin, cfg: LlamaConfig):
    """apply_rope over the first rotary_dim dims of each head (Phi's
    partial rotary); the rest pass through."""
    if cfg.rotary_dim is None:
        return apply_rope(x, cos, sin)
    rot = apply_rope(x[..., :cfg.rotary_dim], cos, sin)
    return torch.cat([rot, x[..., cfg.rotary_dim:]], dim=-1)


def _pre_normed(bp, x, cfg: LlamaConfig):
    """ln_1(x), or the raw residual stream for OLMo-2 (pre_norm=False)."""
    if not cfg.pre_norm:
        return x
    return _norm(bp["ln_1"], x, cfg)


def _qk_normed(bp, q, k, cfg: LlamaConfig):
    """q/k RMSNorm before RoPE (Qwen3 per head, OLMo-2 over the whole
    projection); identity when qk_norm is off."""
    if not cfg.qk_norm:
        return q, k
    if cfg.qk_norm_width == "proj":
        hq, hk = q.shape[1], k.shape[1]
        q2 = rms_norm(bp["attn"]["q_norm"], merge_heads(q), eps=cfg.rms_eps)
        k2 = rms_norm(bp["attn"]["k_norm"], merge_heads(k), eps=cfg.rms_eps)
        return split_heads(q2, hq), split_heads(k2, hk)
    return (rms_norm(bp["attn"]["q_norm"], q, eps=cfg.rms_eps),
            rms_norm(bp["attn"]["k_norm"], k, eps=cfg.rms_eps))


def _qkv(bp, h, cfg: LlamaConfig, compute_dtype=None):
    """The three projections, head-split and q/k-normed: q (B, H, T, D),
    k/v (B, Hk, T, D)."""
    q, k, v = (split_heads(linear(bp["attn"][n], h,
                                  compute_dtype=compute_dtype), heads)
               for n, heads in (("q", cfg.n_head), ("k", cfg.n_kv_head),
                                ("v", cfg.n_kv_head)))
    q, k = _qk_normed(bp, q, k, cfg)
    return q, k, v


def _rotated(q, k, cos, sin, cfg: LlamaConfig):
    """q and k rotated by the tables, q then rescaled."""
    return (_q_rescale(_rope_apply(q, cos, sin, cfg), cfg),
            _rope_apply(k, cos, sin, cfg))


def _mlp_out(bp, h, *, cfg: LlamaConfig, compute_dtype=None, ffn=None):
    """The MLP branch over a normed h: gated SwiGLU / GeGLU, Phi's plain
    two-layer MLP, or the `ffn(bp, h)` override (the MoE hook)."""
    if ffn is not None:
        return ffn(bp, h)
    act = _mlp_act(cfg)
    mlp = bp["mlp"]
    up = linear(mlp["up"], h, compute_dtype=compute_dtype)
    inner = (act(up) if not cfg.mlp_gated else
             act(linear(mlp["gate"], h, compute_dtype=compute_dtype)) * up)
    return linear(mlp["down"], inner, compute_dtype=compute_dtype)


def _branches_residual(bp, x, o, h, *, cfg: LlamaConfig, compute_dtype=None,
                       ffn=None):
    """The attention output `o` and the MLP (or `ffn`) into the residual
    stream: sequential (x + o, then ln_2 + MLP + residual, Gemma-2's
    post norms where set) or parallel (Phi: x + o + mlp(h), both
    branches reading ln_1's h)."""
    if cfg.parallel_block:
        m = _mlp_out(bp, h, cfg=cfg, compute_dtype=compute_dtype, ffn=ffn)
        return x + o.to(x.dtype) + m.to(x.dtype)
    if cfg.post_norms:
        o = _norm(bp["post_ln_1"], o, cfg)
    x = x + o.to(x.dtype)
    h2 = x if not cfg.pre_norm else _norm(bp["ln_2"], x, cfg)
    m = _mlp_out(bp, h2, cfg=cfg, compute_dtype=compute_dtype, ffn=ffn)
    if cfg.post_norms:
        m = _norm(bp["post_ln_2"], m, cfg)
    return x + m.to(x.dtype)


def _gqa_scores_attend(q, k, v, keep, softcap=None):
    """Grouped attention, the einsum formula (JAX :623): q (B, H, T, D)
    against k/v (B, Hk, S, D), H = G * Hk, with the group folded next to
    the rows so the einsums run at KV heads; scores soft-capped
    (`softcap`, Gemma-2) before the mask; `keep` broadcasts against the
    (B, Hk, G, T, S) scores. f32 out."""
    b, h, t, d = q.shape
    kv = k.shape[1]
    qg = q.reshape(b, kv, h // kv, t, d).float()
    s = soft_cap(torch.einsum("bkgtd,bksd->bkgts", qg, k.float())
                 / math.sqrt(d), softcap)
    p = torch.softmax(torch.where(keep, s, _NEG_BIG), dim=-1)
    y = torch.einsum("bkgts,bksd->bkgtd", p, v.float())
    return y.reshape(b, h, t, d)


def _dense_attn(bp, h, *, cfg: LlamaConfig, compute_dtype=None,
                window=None):
    """Causal GQA over the whole (B, T, C) h, banded to the layer's
    `window` or else the config's sliding_window (JAX's _dense_attn)."""
    t = h.shape[1]
    rows = torch.arange(t, device=h.device)
    q, k, v = _qkv(bp, h, cfg, compute_dtype)
    q, k = _rotated(q, k, *_rope_tables(cfg, rows), cfg)
    keep = band_keep(rows[None, :], rows[:, None],
                     window if window is not None else cfg.sliding_window)
    y = _gqa_scores_attend(q, k, v, keep, softcap=cfg.attn_softcap)
    return linear(bp["attn"]["o"], merge_heads(y.to(h.dtype)),
                  compute_dtype=compute_dtype)


def block_apply(bp, x, *, cfg: LlamaConfig, compute_dtype=None,
                window=None, ffn=None):
    """One block of the stateless forward (JAX :643); `window` is the
    layer's own (alternating configs), `ffn` the MLP override."""
    h = _pre_normed(bp, x, cfg)
    o = _dense_attn(bp, h, cfg=cfg, compute_dtype=compute_dtype,
                    window=window)
    return _branches_residual(bp, x, o, h, cfg=cfg,
                              compute_dtype=compute_dtype, ffn=ffn)


def _window_of(cfg: LlamaConfig, i: int):
    """Layer i's window override: its entry of layer_windows for an
    alternating config, None (the codec's or the config's window) else."""
    wins = layer_windows(cfg)
    return None if wins is None else wins[i]


def _scaled_embed(p, ids, cfg: LlamaConfig):
    """Token lookup, times sqrt(n_embd) for Gemma (embed_scale)."""
    e = embedding(p["wte"], ids.long())
    if cfg.embed_scale:
        e = e * torch.tensor(cfg.n_embd ** 0.5, dtype=e.dtype)
    return e


def embed(params, idx, *, cfg: LlamaConfig):
    """Token embedding of idx (B, T) with the T <= block_size guard;
    positions live in RoPE."""
    t = idx.shape[-1]
    if t > cfg.block_size:
        raise ValueError(f"Cannot forward: sequence length {t} > block_size "
                         f"{cfg.block_size}")
    return _scaled_embed(params, idx, cfg)


def head(params, x, *, cfg: LlamaConfig, compute_dtype=None):
    """Final norm + lm_head -> f32 logits, soft-capped for Gemma-2
    (final_softcap, JAX :721); a tied config (no lm_head leaf) projects
    through wte.embedding.T."""
    x = _norm(params["ln_f"], x, cfg)
    lm = params.get("lm_head") or {"kernel": params["wte"]["embedding"].T}
    if compute_dtype is None:
        out = linear(lm, x)
    else:
        out = linear(lm, x, compute_dtype=compute_dtype,
                     accum_dtype=torch.float32)
    return soft_cap(out, cfg.final_softcap)


def _apply_layers(params, idx, layers, *, cfg, compute_dtype, ffn):
    x = embed(params, idx, cfg=cfg)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    for i, bp in enumerate(layers):
        x = block_apply(bp, x, cfg=cfg, compute_dtype=compute_dtype,
                        window=_window_of(cfg, i), ffn=ffn)
    return head(params, x.float(), cfg=cfg, compute_dtype=compute_dtype)


def make_apply(cfg: LlamaConfig, *, compute_dtype=None, ffn=None):
    """Full forward over the per-layer tree of tensors (JAX's make_apply
    :761): apply(params, idx) -> f32 logits (B, T, V). The attention is
    the grouped einsum, as JAX's (no kernel runs). `ffn` overrides the
    MLP; by default the config's (`default_ffn`)."""
    ffn = ffn or cfg.default_ffn(compute_dtype)

    def apply(params, idx):
        layers = (params[f"h_{i}"] for i in range(cfg.n_layer))
        return _apply_layers(params, idx, layers, cfg=cfg,
                             compute_dtype=compute_dtype, ffn=ffn)

    return apply


def make_apply_stacked(cfg: LlamaConfig, *, compute_dtype=None, ffn=None):
    """make_apply over the prepare_stacked layout."""
    ffn = ffn or cfg.default_ffn(compute_dtype)

    def apply(prepared, idx):
        return _apply_layers(prepared, idx,
                             unstack(prepared["blocks"], cfg.n_layer),
                             cfg=cfg, compute_dtype=compute_dtype, ffn=ffn)

    return apply


def make_hidden_stacked(cfg: LlamaConfig, *, compute_dtype=None):
    """Final-normed hidden states (B, T, C) f32 over the prepare_stacked
    layout (JAX's make_hidden_stacked :769): make_apply_stacked without
    the lm_head, the embedding endpoint's forward; the attention is the
    grouped einsum of the stateless forward; the config's MLP override
    (`default_ffn`) included."""
    ffn = cfg.default_ffn(compute_dtype)

    def hidden(prepared, idx):
        x = embed(prepared, idx, cfg=cfg)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        for i, bp in enumerate(unstack(prepared["blocks"], cfg.n_layer)):
            x = block_apply(bp, x, cfg=cfg, compute_dtype=compute_dtype,
                            window=_window_of(cfg, i), ffn=ffn)
        return _norm(prepared["ln_f"], x.float(), cfg)

    return hidden


@torch.no_grad()
def forward_no_cache(prepared, ids, *, cfg: LlamaConfig):
    """Plain full-sequence causal forward, no cache and no kernel: ids
    (B, T) -> f32 logits (B, T, V) (the reference the cached paths are
    held against)."""
    return make_apply_stacked(cfg)(prepared, ids)


# --------------------------------------------------------------------------
# KV-cache decode: the cache holds KV heads (JAX :815-990)
# --------------------------------------------------------------------------

def init_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype, device):
    """Dense cache at KV-head width, (L, B, n_kv_head, S, head_dim) per
    leaf: H / Hk times fewer bytes a step than a cache of query heads.
    `dtype` as generate.init_cache takes it."""
    from dnn_tpu_torch.runtime.generate import init_cache as _init

    return _init(cfg, batch, max_len, dtype, device)


def _block_with_cache(bp, x, layer_cache, start_pos, *,
                      cfg: LlamaConfig, codec, compute_dtype=None,
                      window=None, ffn=None):
    """One block over x (B, T, C) at positions [start_pos, start_pos +
    T): writes the rotated k (and v) into the KV-head cache, then
    attends it — K5 with grouped heads for a chunk, K6 with the group
    folded into the rows for a one-token step (codec.attend), banded to
    the layer's `window` (alternating configs) or the codec's.
    `start_pos` is an int or a (1,) int32 device tensor
    (kvcache.span_positions); `ffn` overrides the MLP."""
    from dnn_tpu_torch.runtime.kvcache import span_positions

    h = _pre_normed(bp, x, cfg)
    q, k, v = _qkv(bp, h, cfg, compute_dtype)
    rows = span_positions(start_pos, x.shape[1], x.device)
    q, k = _rotated(q, k, *_rope_tables(cfg, rows), cfg)
    codec.write(layer_cache, k, v, start_pos)
    y = codec.attend(q, layer_cache, start_pos, window=window)
    o = linear(bp["attn"]["o"], merge_heads(y.to(x.dtype)),
               compute_dtype=compute_dtype)
    return _branches_residual(bp, x, o, h, cfg=cfg,
                              compute_dtype=compute_dtype, ffn=ffn)


def _embedded(prepared, ids, cfg: LlamaConfig, compute_dtype):
    """The scaled token embedding in f32, cast to `compute_dtype` (JAX's
    x.astype(compute_dtype) after the lookup)."""
    x = _scaled_embed(prepared, ids, cfg)
    return x if compute_dtype is None else x.to(compute_dtype)


@torch.no_grad()
def forward_with_cache(prepared, ids, cache, start_pos, *,
                       cfg: LlamaConfig, compute_dtype=None,
                       rolling: bool = False, ffn=None):
    """ids (B, T) at positions [start_pos, start_pos + T) -> f32 logits
    (B, T, V); the KV-head cache (float {"k","v"} or int8 with
    {"ks","vs"}, leaves (L, B, Hk, S[, D])) is written in place and
    returned. `start_pos` is an int or a (1,) int32 device tensor (the
    batcher's captured mixed step). `compute_dtype` (bf16 compute): the
    residual stream and the block products in it, norms and RoPE in f32,
    f32 logits. The codec carries the config's window (uniform) and
    attention softcap; an alternating config hands each layer its window
    (JAX :863-900). `rolling`: the cache is a sliding_window-slot ring
    (one-token steps only). `ffn` overrides every block's MLP, by
    default the config's (`default_ffn`: a MoE config routes the B*T
    tokens of this forward)."""
    from dnn_tpu_torch.runtime.kvcache import codec_for_cache

    ffn = ffn or cfg.default_ffn(compute_dtype)
    wins = layer_windows(cfg)
    codec = codec_for_cache(
        cache, window=None if wins is not None else cfg.sliding_window,
        rolling=rolling, softcap=cfg.attn_softcap)
    x = _embedded(prepared, ids, cfg, compute_dtype)
    for i in range(cfg.n_layer):
        layer_cache = {name: leaf[i] for name, leaf in cache.items()}
        x = _block_with_cache(layer_params(prepared["blocks"], i), x,
                              layer_cache, start_pos, cfg=cfg, codec=codec,
                              compute_dtype=compute_dtype,
                              window=None if wins is None else wins[i],
                              ffn=ffn)
    return head(prepared, x.float(), cfg=cfg,
                compute_dtype=compute_dtype), cache


def _ring_from_prompt(prompt_cache, t: int, w: int):
    """A prompt-length cache's live band gathered into a w-slot ring
    (JAX :902): slot j takes position a_j = (t - 1) - ((t - 1 - j) mod
    w), the latest prompt position congruent to j, zeros where there is
    none (a_j < 0: a short prompt). Decode steps then write positions t,
    t + 1, ... at pos % w. Leaves (L, B, Hk, S[, D]) -> (L, B, Hk, w[,
    D])."""
    from dnn_tpu_torch.runtime.kvcache import ring_positions

    dev = prompt_cache["k"].device
    a = ring_positions(torch.tensor(t - 1, device=dev), w)  # (w,)
    src = a.clamp(0, t - 1)
    out = {}
    for kk, leaf in prompt_cache.items():
        g = leaf.index_select(3, src)
        live = (a >= 0).reshape((1, 1, 1, w) + (1,) * (leaf.dim() - 4))
        out[kk] = torch.where(live, g, torch.zeros_like(g))
    return out


def make_generate(cfg: LlamaConfig, *, max_new_tokens: int, **kwargs):
    """The solo decoder (JAX's make_generate :923): generate(prepared,
    ids, seed=0) -> (B, max_new_tokens) int32 tokens, the prompt in one
    forward (K5 with grouped heads on the card), then one forward per
    token (K6 at G rows a KV head) over a dense KV-head cache — or, for
    a uniformly windowed config whose stream outgrows the window, over a
    rolling ring (the prompt banded on a prompt-length cache, its live
    band gathered into the ring). It is runtime/generate.make_generate,
    which dispatches on the config: the same options, the same
    sampling."""
    from dnn_tpu_torch.runtime.generate import make_generate as _make

    return _make(cfg, max_new_tokens=max_new_tokens, **kwargs)


class LlamaFamilyRows:
    """The batcher's family hooks (JAX's LlamaFamilyRows :1222): the
    padded-prompt prefill and the per-slot decode with RoPE at each
    slot's own position over a KV-head-width pool; a decode step folds
    each slot's query group into G rows of its KV head (K6 dense, K7
    paged). `compute_dtype=torch.bfloat16` runs both in bf16 compute
    (K5/K6/K7 with bf16 queries). `ffn` overrides the MLP on every path
    (prefill, decode rows, verify rows); by default the config's
    (`default_ffn`: Mixtral's routed experts).

    The batcher reads the attributes JAX's adapter sets (:1240-1262):
    `window`, a uniform config's window, for its codecs (the pool stays
    full-length; a paged pool reclaims the blocks the band left behind);
    `alt_window` and `softcap`, which no paged pool takes; `paged_ok`,
    "attends plain causal", which the speculative batcher requires."""

    def __init__(self, cfg: LlamaConfig, *, compute_dtype=None, ffn=None):
        from dnn_tpu_torch.runtime.generate import check_compute_dtype

        self.cfg = cfg
        self.compute_dtype = check_compute_dtype(compute_dtype)
        self.ffn = ffn or cfg.default_ffn(self.compute_dtype)
        self._wins = layer_windows(cfg)
        self.window = None if self._wins is not None else cfg.sliding_window
        self.alt_window = cfg.alt_window
        self.softcap = cfg.attn_softcap
        self.paged_ok = (cfg.sliding_window is None
                         and cfg.attn_softcap is None)

    def init_cache(self, batch: int, max_len: int, dtype, device):
        return init_cache(self.cfg, batch, max_len, dtype, device)

    def prefill(self, prepared, padded, row_cache, start_pos):
        """One (1, P) prompt chunk at [start_pos, start_pos + P) ->
        logits (1, P, V); row_cache is written in place (K5). `start_pos`
        is an int or a (1,) int32 device tensor."""
        logits, _ = forward_with_cache(prepared, padded, row_cache,
                                       start_pos, cfg=self.cfg,
                                       compute_dtype=self.compute_dtype,
                                       ffn=self.ffn)
        return logits

    @torch.no_grad()
    def decode_rows(self, prepared, cache, tok, pos, active, codec):
        """One step of every slot: tok/pos/active (B,) device tensors ->
        logits (B, V). The codec's write_rows gates inactive slots;
        attend_rows takes q folded to (B, Hk, G, D). Per-layer views are
        taken here, each step (a bucket grow replaces the cache)."""
        cfg, cdt = self.cfg, self.compute_dtype
        b = tok.shape[0]
        hk, d = cfg.n_kv_head, cfg.head_dim
        x = _embedded(prepared, tok[:, None], cfg, cdt)  # (B, 1, C)
        cos, sin = _rope_tables(cfg, pos)  # (B, D): each slot's position
        cos, sin = cos[:, None, None, :], sin[:, None, None, :]
        for i in range(cfg.n_layer):
            bp = layer_params(prepared["blocks"], i)
            c = {kk: leaf if kk == "tables" else leaf[i]
                 for kk, leaf in cache.items()}
            h = _pre_normed(bp, x, cfg)
            q, k, v = _qkv(bp, h, cfg, cdt)
            q, k = _rotated(q, k, cos, sin, cfg)
            codec.write_rows(c, k, v, pos, active)
            y = codec.attend_rows(
                q.reshape(b, hk, cfg.n_head // hk, d), c, pos,
                window=None if self._wins is None else self._wins[i])
            o = linear(bp["attn"]["o"],
                       merge_heads(y.reshape(b, cfg.n_head, 1, d).to(x.dtype)),
                       compute_dtype=cdt)
            x = _branches_residual(bp, x, o, h, cfg=cfg, compute_dtype=cdt,
                                   ffn=self.ffn)
        return head(prepared, x.float(), cfg=cfg, compute_dtype=cdt)[:, -1]

    @torch.no_grad()
    def verify_rows(self, prepared, cache, chunk, pos, active, codec):
        """A (B, T) token block at per-slot bases pos (B,) -> logits (B, T,
        V) (JAX's :1301): rotated K/V written at pos .. pos + T - 1 of each
        active slot, row t attending columns <= pos[b] + t with grouped
        query heads (codec.attend_rows_causal: K5, query head h reading
        KV head h / G). The speculative batcher's target verify and draft
        sync; windowed and soft-capped presets raise JAX's ValueError (the
        speculative batcher refuses them at construction)."""
        cfg, cdt = self.cfg, self.compute_dtype
        if cfg.sliding_window is not None or cfg.attn_softcap is not None:
            raise ValueError(
                "speculative verify supports dense-attention LLaMA-family "
                "configs only (no sliding window / softcap)")
        t = chunk.shape[1]
        positions = pos.long()[:, None] + torch.arange(t, device=pos.device)
        x = _embedded(prepared, chunk, cfg, cdt)  # (B, T, C)
        cos, sin = _rope_tables(cfg, positions)  # (B, T, D)
        cos, sin = cos[:, None], sin[:, None]  # over the heads
        for i in range(cfg.n_layer):
            bp = layer_params(prepared["blocks"], i)
            c = {kk: leaf[i] for kk, leaf in cache.items()}
            h = _pre_normed(bp, x, cfg)
            q, k, v = _qkv(bp, h, cfg, cdt)
            q, k = _rotated(q, k, cos, sin, cfg)
            codec.write_rows(c, k, v, pos, active)
            y = codec.attend_rows_causal(q, c, pos)
            o = linear(bp["attn"]["o"], merge_heads(y.to(x.dtype)),
                       compute_dtype=cdt)
            x = _branches_residual(bp, x, o, h, cfg=cfg, compute_dtype=cdt,
                                   ffn=self.ffn)
        return head(prepared, x.float(), cfg=cfg, compute_dtype=cdt)


# --------------------------------------------------------------------------
# pipeline partitioning + registry
# --------------------------------------------------------------------------

class LlamaPipelineFamily:
    """Pipeline-parallel decode hooks (JAX :1401; see
    runtime/generate.GPTPipelineFamily): stage-local cache shards at
    KV-head width, RoPE at the ring's absolute positions. Alternating
    windows and MoE configs are refused with JAX's messages."""

    def __init__(self, cfg: LlamaConfig, *, compute_dtype=None,
                 kv_dtype=None):
        from dnn_tpu_torch.runtime.generate import check_compute_dtype

        if cfg.alt_window:
            raise ValueError(
                "alternating-window configs (Gemma-2) are not supported on "
                "the pipeline decode path: the stage scan has no per-layer "
                "window channel (use the solo decoder or the batcher)")
        if cfg.default_ffn(compute_dtype) is not None:
            raise ValueError(
                "MoE configs are not supported on this pipeline decode "
                "path (MoE pipeline decode is runtime/generate_moe's "
                "machinery)")
        self.cfg = cfg
        self.compute_dtype = check_compute_dtype(compute_dtype)
        self.kv_dtype = kv_dtype

    def stage_cache(self, per_stage, batch, s_max, device):
        from dnn_tpu_torch.runtime.generate import _cache_dtype

        dt = _cache_dtype(self.kv_dtype if self.kv_dtype is not None
                          else self.compute_dtype)
        stage_cfg = dataclasses.replace(self.cfg, n_layer=per_stage)
        return init_cache(stage_cfg, batch, s_max, dt, device)

    def codec(self, cache):
        from dnn_tpu_torch.runtime.kvcache import codec_for_cache

        return codec_for_cache(cache, window=self.cfg.sliding_window,
                               softcap=self.cfg.attn_softcap)

    def block_with_cache(self, bp, x, layer_cache, start_pos, codec):
        return _block_with_cache(bp, x, layer_cache, start_pos, cfg=self.cfg,
                                 codec=codec,
                                 compute_dtype=self.compute_dtype)

    def embed(self, aux, ids, start_pos):
        return _embedded(aux, ids, self.cfg, self.compute_dtype)

    def head(self, aux, h):
        return head(aux, h.float(), cfg=self.cfg,
                    compute_dtype=self.compute_dtype)


def make_pipeline_generate(cfg: LlamaConfig, mesh, *, max_new_tokens: int,
                           temperature: float = 0.0,
                           top_k: Optional[int] = None,
                           top_p: Optional[float] = None,
                           compute_dtype=None, axis_name=None,
                           kv_dtype=None):
    """Pipeline-parallel generation for the LLaMA family (JAX :1448):
    runtime/generate.make_pipeline_generate with LlamaPipelineFamily;
    each stage keeps its blocks and its KV-head cache shard. Tokens equal
    llama.make_generate's for the same seed (a uniformly windowed config
    keeps a full-length banded shard where the solo decoder rolls a
    ring: the same function)."""
    from dnn_tpu_torch.runtime.generate import (
        make_pipeline_generate as _mk,
    )

    return _mk(cfg, mesh, max_new_tokens=max_new_tokens,
               temperature=temperature, top_k=top_k, top_p=top_p,
               compute_dtype=compute_dtype, axis_name=axis_name,
               family=LlamaPipelineFamily(cfg, compute_dtype=compute_dtype,
                                          kv_dtype=kv_dtype))


def make_partition(cfg: LlamaConfig, *, compute_dtype=None):
    """partition(num_parts) -> StageSpecs over the per-layer tree (JAX's
    make_partition :1474): the first stage embeds, the last runs the
    head; a tied config's last stage holds wte too. The config's MLP
    override (`default_ffn`) runs in every stage, routing the batch the
    stage is handed."""
    part_ffn = cfg.default_ffn(compute_dtype)

    def partition(num_parts):
        stages = []
        for p, (lo, hi) in enumerate(layer_ranges(cfg.n_layer, num_parts)):
            first, last = p == 0, p == num_parts - 1
            keys = tuple(f"h_{i}" for i in range(lo, hi))
            if first:
                keys = ("wte",) + keys
            if last:
                keys = keys + ("ln_f",)
                if not cfg.tie_word_embeddings:
                    keys = keys + ("lm_head",)
                elif not first:
                    keys = keys + ("wte",)

            def stage_fn(params, x, _lo=lo, _hi=hi, _first=first,
                         _last=last):
                if _first:
                    x = embed(params, x, cfg=cfg)
                if compute_dtype is not None and x.is_floating_point():
                    x = x.to(compute_dtype)
                for i in range(_lo, _hi):
                    x = block_apply(params[f"h_{i}"], x, cfg=cfg,
                                    compute_dtype=compute_dtype,
                                    window=_window_of(cfg, i), ffn=part_ffn)
                if _last:
                    x = head(params, x.float(), cfg=cfg,
                             compute_dtype=compute_dtype)
                return x

            stages.append(StageSpec(
                name=f"llama_blocks[{lo}:{hi}]" + ("+embed" if first else "")
                + ("+head" if last else ""),
                apply=stage_fn, param_keys=keys))
        return stages

    return partition


def _register(name: str, cfg: LlamaConfig):
    def convert(sd, _cfg=cfg):
        from dnn_tpu_torch.io import checkpoint

        if _cfg.parallel_block:  # Phi layout (fc1/fc2, dense, LN biases)
            return checkpoint.phi_params_from_state_dict(
                sd, n_layer=_cfg.n_layer)
        return checkpoint.llama_params_from_state_dict(
            sd, n_layer=_cfg.n_layer, post_norms=_cfg.post_norms,
            tied_head="omit" if _cfg.tie_word_embeddings else "materialize")

    def example_input(batch_size=1, seq_len=None, seed=0, _cfg=cfg):
        t = min(seq_len or _cfg.block_size, _cfg.block_size)
        rng = np.random.default_rng(seed)
        return rng.integers(0, _cfg.vocab_size, (batch_size, t)).astype(
            np.int32)

    register_model(ModelSpec(
        name=name,
        init=lambda seed=0, _cfg=cfg: init(seed, _cfg),
        apply=make_apply(cfg),
        partition=make_partition(cfg),
        example_input=example_input,
        supported_parts=tuple(range(1, cfg.n_layer + 1)),
        convert_state_dict=convert,
        config=cfg,
        extras={"make_partition": lambda compute_dtype=None, _cfg=cfg, **_kw:
                make_partition(_cfg, compute_dtype=compute_dtype)},
    ))


for _name, _cfg in PRESETS.items():
    _register(_name, _cfg)
