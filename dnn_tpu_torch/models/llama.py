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

Not ported, and raising NotImplementedError when a model that needs them
is built or served (the presets are all registered): sliding windows and
Gemma-2's alternating windows (ROADMAP PyTorch/CUDA port item 2, rolling
rings and bands), attention and final logit softcapping (port item 7's
softcapping), and an `ffn` override, the MoE families' hook (port item
7, = Queue 1 item 9).
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
        """The config's MLP override (JAX: the MoE subclasses' hook);
        None, the dense MLP, for every config here."""
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


def check_ported(cfg: LlamaConfig, ffn=None):
    """Raise NotImplementedError, naming the ROADMAP item, for a switch
    this port does not run. Every entry point calls it when it builds or
    serves a model."""
    if cfg.sliding_window is not None or cfg.alt_window:
        raise NotImplementedError(
            "sliding-window attention (sliding_window / alt_window) is not "
            "ported to dnn_tpu_torch yet (ROADMAP PyTorch/CUDA port item 2, "
            "rolling rings and bands)")
    if cfg.attn_softcap is not None or cfg.final_softcap is not None:
        raise NotImplementedError(
            "attention / final logit softcapping is not ported to "
            "dnn_tpu_torch yet (ROADMAP PyTorch/CUDA port item 7, logit "
            "softcapping)")
    if ffn is not None or cfg.default_ffn() is not None:
        raise NotImplementedError(
            "ffn: MoE block FFNs are not ported to dnn_tpu_torch yet "
            "(ROADMAP PyTorch/CUDA port item 7, the MoE families)")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init(seed: int, cfg: LlamaConfig = PRESETS["llama-test"], *,
         device=None):
    """Random weights from `seed`: the tree, shapes and standard
    deviations of dnn_tpu.models.llama.init (0.02 normal, o and down
    scaled by 1/sqrt(2 n_layer), norms at one, or zero under
    norm_plus_one, biases at zero). The draws differ from jax.random's;
    tests share weights through convert.from_jax_params. Returns the
    JAX-layout tree of float32 numpy arrays drawn with numpy or, with
    `device`, of tensors drawn there from a seeded torch.Generator (a
    full-size model never visits the host)."""
    c, d = cfg.n_embd, cfg.head_dim
    out_std = 0.02 / (2 * cfg.n_layer) ** 0.5
    if device is None:
        rng = np.random.default_rng(seed)

        def normal(shape, std=0.02):
            return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

        def full(n, value):
            return np.full((n,), value, np.float32)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)

        def normal(shape, std=0.02):
            return torch.randn(shape, generator=gen, device=device) * std

        def full(n, value):
            return torch.full((n,), float(value), device=device)

    def zeros(n):
        return full(n, 0.0)

    def norm_p(n):
        p = {"scale": full(n, 0.0 if cfg.norm_plus_one else 1.0)}
        if cfg.layer_norm:
            p["bias"] = zeros(n)
        return p

    def proj(shape, std=0.02, bias=False):
        p = {"kernel": normal(shape, std)}
        if bias:
            p["bias"] = zeros(shape[-1])
        return p

    params = {"wte": {"embedding": normal((cfg.vocab_size, c))},
              "ln_f": norm_p(c)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = proj((c, cfg.vocab_size), bias=cfg.dense_bias)
    for i in range(cfg.n_layer):
        attn = {
            "q": proj((c, cfg.n_head * d), bias=cfg.attn_bias),
            "k": proj((c, cfg.n_kv_head * d), bias=cfg.attn_bias),
            "v": proj((c, cfg.n_kv_head * d), bias=cfg.attn_bias),
            "o": proj((cfg.n_head * d, c), out_std, bias=cfg.dense_bias),
        }
        if cfg.qk_norm:
            per_head = cfg.qk_norm_width == "head"
            attn["q_norm"] = {"scale": full(
                d if per_head else cfg.n_head * d, 1.0)}
            attn["k_norm"] = {"scale": full(
                d if per_head else cfg.n_kv_head * d, 1.0)}
        blk = {"ln_1": norm_p(c), "attn": attn}
        if not cfg.parallel_block:
            blk["ln_2"] = norm_p(c)
        if not cfg.pre_norm:
            del blk["ln_1"], blk["ln_2"]
        if cfg.mlp_gated:
            blk["mlp"] = {"gate": proj((c, cfg.d_ff)),
                          "up": proj((c, cfg.d_ff)),
                          "down": proj((cfg.d_ff, c), out_std)}
        else:
            blk["mlp"] = {"up": proj((c, cfg.d_ff), bias=cfg.dense_bias),
                          "down": proj((cfg.d_ff, c), out_std,
                                       bias=cfg.dense_bias)}
        if cfg.post_norms:
            blk["post_ln_1"] = norm_p(c)
            blk["post_ln_2"] = norm_p(c)
        params[f"h_{i}"] = blk
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


def _mlp_out(bp, h, *, cfg: LlamaConfig, compute_dtype=None):
    """The MLP branch over a normed h: gated SwiGLU / GeGLU, or Phi's
    plain two-layer MLP."""
    act = _mlp_act(cfg)
    mlp = bp["mlp"]
    up = linear(mlp["up"], h, compute_dtype=compute_dtype)
    inner = (act(up) if not cfg.mlp_gated else
             act(linear(mlp["gate"], h, compute_dtype=compute_dtype)) * up)
    return linear(mlp["down"], inner, compute_dtype=compute_dtype)


def _branches_residual(bp, x, o, h, *, cfg: LlamaConfig, compute_dtype=None):
    """The attention output `o` and the MLP into the residual stream:
    sequential (x + o, then ln_2 + MLP + residual, Gemma-2's post norms
    where set) or parallel (Phi: x + o + mlp(h), both branches reading
    ln_1's h)."""
    if cfg.parallel_block:
        m = _mlp_out(bp, h, cfg=cfg, compute_dtype=compute_dtype)
        return x + o.to(x.dtype) + m.to(x.dtype)
    if cfg.post_norms:
        o = _norm(bp["post_ln_1"], o, cfg)
    x = x + o.to(x.dtype)
    h2 = x if not cfg.pre_norm else _norm(bp["ln_2"], x, cfg)
    m = _mlp_out(bp, h2, cfg=cfg, compute_dtype=compute_dtype)
    if cfg.post_norms:
        m = _norm(bp["post_ln_2"], m, cfg)
    return x + m.to(x.dtype)


def _gqa_scores_attend(q, k, v, keep):
    """Grouped attention, the einsum formula (JAX :623): q (B, H, T, D)
    against k/v (B, Hk, S, D), H = G * Hk, with the group folded next to
    the rows so the einsums run at KV heads; `keep` broadcasts against
    the (B, Hk, G, T, S) scores. f32 out."""
    b, h, t, d = q.shape
    kv = k.shape[1]
    qg = q.reshape(b, kv, h // kv, t, d).float()
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k.float()) / math.sqrt(d)
    p = torch.softmax(torch.where(keep, s, _NEG_BIG), dim=-1)
    y = torch.einsum("bkgts,bksd->bkgtd", p, v.float())
    return y.reshape(b, h, t, d)


def _dense_attn(bp, h, *, cfg: LlamaConfig, compute_dtype=None):
    """Causal GQA over the whole (B, T, C) h (JAX's _dense_attn)."""
    t = h.shape[1]
    rows = torch.arange(t, device=h.device)
    q, k, v = _qkv(bp, h, cfg, compute_dtype)
    q, k = _rotated(q, k, *_rope_tables(cfg, rows), cfg)
    keep = rows[:, None] >= rows[None, :]
    y = _gqa_scores_attend(q, k, v, keep)
    return linear(bp["attn"]["o"], merge_heads(y.to(h.dtype)),
                  compute_dtype=compute_dtype)


def block_apply(bp, x, *, cfg: LlamaConfig, compute_dtype=None):
    """One block of the stateless forward (JAX :643)."""
    h = _pre_normed(bp, x, cfg)
    o = _dense_attn(bp, h, cfg=cfg, compute_dtype=compute_dtype)
    return _branches_residual(bp, x, o, h, cfg=cfg,
                              compute_dtype=compute_dtype)


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
    """Final norm + lm_head -> f32 logits; a tied config (no lm_head
    leaf) projects through wte.embedding.T."""
    x = _norm(params["ln_f"], x, cfg)
    lm = params.get("lm_head") or {"kernel": params["wte"]["embedding"].T}
    if compute_dtype is None:
        return linear(lm, x)
    return linear(lm, x, compute_dtype=compute_dtype,
                  accum_dtype=torch.float32)


def _apply_layers(params, idx, layers, *, cfg, compute_dtype):
    x = embed(params, idx, cfg=cfg)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    for bp in layers:
        x = block_apply(bp, x, cfg=cfg, compute_dtype=compute_dtype)
    return head(params, x.float(), cfg=cfg, compute_dtype=compute_dtype)


def make_apply(cfg: LlamaConfig, *, compute_dtype=None):
    """Full forward over the per-layer tree of tensors (JAX's make_apply
    :761): apply(params, idx) -> f32 logits (B, T, V). The attention is
    the grouped einsum, as JAX's (no kernel runs)."""

    def apply(params, idx):
        check_ported(cfg)
        layers = (params[f"h_{i}"] for i in range(cfg.n_layer))
        return _apply_layers(params, idx, layers, cfg=cfg,
                             compute_dtype=compute_dtype)

    return apply


def make_apply_stacked(cfg: LlamaConfig, *, compute_dtype=None):
    """make_apply over the prepare_stacked layout."""

    def apply(prepared, idx):
        check_ported(cfg)
        return _apply_layers(prepared, idx,
                             unstack(prepared["blocks"], cfg.n_layer),
                             cfg=cfg, compute_dtype=compute_dtype)

    return apply


def make_hidden_stacked(cfg: LlamaConfig, *, compute_dtype=None):
    """Final-normed hidden states (B, T, C) f32 over the prepare_stacked
    layout (JAX's make_hidden_stacked :769): make_apply_stacked without
    the lm_head, the embedding endpoint's forward; the attention is the
    grouped einsum of the stateless forward."""

    def hidden(prepared, idx):
        check_ported(cfg)
        x = embed(prepared, idx, cfg=cfg)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        for bp in unstack(prepared["blocks"], cfg.n_layer):
            x = block_apply(bp, x, cfg=cfg, compute_dtype=compute_dtype)
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
                      cfg: LlamaConfig, codec, compute_dtype=None):
    """One block over x (B, T, C) at positions [start_pos, start_pos +
    T): writes the rotated k (and v) into the KV-head cache, then
    attends it — K5 with grouped heads for a chunk, K6 with the group
    folded into the rows for a one-token step (codec.attend).
    `start_pos` is an int or a (1,) int32 device tensor
    (kvcache.span_positions)."""
    from dnn_tpu_torch.runtime.kvcache import span_positions

    h = _pre_normed(bp, x, cfg)
    q, k, v = _qkv(bp, h, cfg, compute_dtype)
    rows = span_positions(start_pos, x.shape[1], x.device)
    q, k = _rotated(q, k, *_rope_tables(cfg, rows), cfg)
    codec.write(layer_cache, k, v, start_pos)
    y = codec.attend(q, layer_cache, start_pos)
    o = linear(bp["attn"]["o"], merge_heads(y.to(x.dtype)),
               compute_dtype=compute_dtype)
    return _branches_residual(bp, x, o, h, cfg=cfg,
                              compute_dtype=compute_dtype)


def _embedded(prepared, ids, cfg: LlamaConfig, compute_dtype):
    """The scaled token embedding in f32, cast to `compute_dtype` (JAX's
    x.astype(compute_dtype) after the lookup)."""
    x = _scaled_embed(prepared, ids, cfg)
    return x if compute_dtype is None else x.to(compute_dtype)


@torch.no_grad()
def forward_with_cache(prepared, ids, cache, start_pos, *,
                       cfg: LlamaConfig, compute_dtype=None):
    """ids (B, T) at positions [start_pos, start_pos + T) -> f32 logits
    (B, T, V); the KV-head cache (float {"k","v"} or int8 with
    {"ks","vs"}, leaves (L, B, Hk, S[, D])) is written in place and
    returned. `start_pos` is an int or a (1,) int32 device tensor (the
    batcher's captured mixed step). `compute_dtype` (bf16 compute): the residual stream and
    the block products in it, norms and RoPE in f32, f32 logits."""
    from dnn_tpu_torch.runtime.kvcache import codec_for_cache

    check_ported(cfg)
    codec = codec_for_cache(cache)
    x = _embedded(prepared, ids, cfg, compute_dtype)
    for i in range(cfg.n_layer):
        layer_cache = {name: leaf[i] for name, leaf in cache.items()}
        x = _block_with_cache(layer_params(prepared["blocks"], i), x,
                              layer_cache, start_pos, cfg=cfg, codec=codec,
                              compute_dtype=compute_dtype)
    return head(prepared, x.float(), cfg=cfg,
                compute_dtype=compute_dtype), cache


def make_generate(cfg: LlamaConfig, *, max_new_tokens: int, **kwargs):
    """The solo decoder (JAX's make_generate :923): generate(prepared,
    ids, seed=0) -> (B, max_new_tokens) int32 tokens, the prompt in one
    forward (K5 with grouped heads on the card), then one forward per
    token (K6 at G rows a KV head) over a dense KV-head cache. It is
    runtime/generate.make_generate, which dispatches on the config: the
    same options, the same sampling."""
    from dnn_tpu_torch.runtime.generate import make_generate as _make

    return _make(cfg, max_new_tokens=max_new_tokens, **kwargs)


class LlamaFamilyRows:
    """The batcher's family hooks (JAX's LlamaFamilyRows :1222): the
    padded-prompt prefill and the per-slot decode with RoPE at each
    slot's own position over a KV-head-width pool; a decode step folds
    each slot's query group into G rows of its KV head (K6 dense, K7
    paged). `compute_dtype=torch.bfloat16` runs both in bf16 compute
    (K5/K6/K7 with bf16 queries). `ffn` (MoE, ROADMAP PyTorch/CUDA port
    item 7) raises, as do the switches `check_ported` names."""

    def __init__(self, cfg: LlamaConfig, *, compute_dtype=None, ffn=None):
        from dnn_tpu_torch.runtime.generate import check_compute_dtype

        check_ported(cfg, ffn)
        self.cfg = cfg
        self.compute_dtype = check_compute_dtype(compute_dtype)

    def init_cache(self, batch: int, max_len: int, dtype, device):
        return init_cache(self.cfg, batch, max_len, dtype, device)

    def prefill(self, prepared, padded, row_cache, start_pos):
        """One (1, P) prompt chunk at [start_pos, start_pos + P) ->
        logits (1, P, V); row_cache is written in place (K5). `start_pos`
        is an int or a (1,) int32 device tensor."""
        logits, _ = forward_with_cache(prepared, padded, row_cache,
                                       start_pos, cfg=self.cfg,
                                       compute_dtype=self.compute_dtype)
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
            y = codec.attend_rows(q.reshape(b, hk, cfg.n_head // hk, d), c,
                                  pos)
            o = linear(bp["attn"]["o"],
                       merge_heads(y.reshape(b, cfg.n_head, 1, d).to(x.dtype)),
                       compute_dtype=cdt)
            x = _branches_residual(bp, x, o, h, cfg=cfg, compute_dtype=cdt)
        return head(prepared, x.float(), cfg=cfg, compute_dtype=cdt)[:, -1]

    @torch.no_grad()
    def verify_rows(self, prepared, cache, chunk, pos, active, codec):
        """A (B, T) token block at per-slot bases pos (B,) -> logits (B, T,
        V) (JAX's :1301): rotated K/V written at pos .. pos + T - 1 of each
        active slot, row t attending columns <= pos[b] + t with grouped
        query heads (codec.attend_rows_causal: K5, query head h reading
        KV head h / G). The speculative batcher's target verify and draft
        sync. Windowed and soft-capped presets never get here: the
        constructor's check_ported raises for them."""
        cfg, cdt = self.cfg, self.compute_dtype
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
            x = _branches_residual(bp, x, o, h, cfg=cfg, compute_dtype=cdt)
        return head(prepared, x.float(), cfg=cfg, compute_dtype=cdt)


# --------------------------------------------------------------------------
# pipeline partitioning + registry
# --------------------------------------------------------------------------

def make_partition(cfg: LlamaConfig, *, compute_dtype=None):
    """partition(num_parts) -> StageSpecs over the per-layer tree (JAX's
    make_partition :1474): the first stage embeds, the last runs the
    head; a tied config's last stage holds wte too."""

    def partition(num_parts):
        check_ported(cfg)
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
                                    compute_dtype=compute_dtype)
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
