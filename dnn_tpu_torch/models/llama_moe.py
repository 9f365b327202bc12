"""Mixtral and Qwen2-MoE: the LLaMA block with a sparse mixture-of-experts
MLP (port of dnn_tpu/models/llama_moe.py).

Every path is the LLaMA family's (models/llama.py) with the `ffn` hook
installed: `MixtralConfig.default_ffn` returns the routed experts, and
every llama entry point resolves it from the config -- the stateless
forward, the cached forward (so make_generate, the speculative decoder
and beam search), `LlamaFamilyRows` (the batcher's prefill chunks,
decode rows and verify rows), the embedding forward and the pipeline
stages. The experts are parallel/moe.py's static-capacity dispatch over
the gated (SwiGLU) stack; `route_topk(normalize=True)` is Mixtral's
routing (softmax over every expert, the top k renormalised), and
`router_norm_topk=False` keeps Qwen2-MoE's raw softmax weights. A
`d_shared` config adds Qwen2-MoE's always-on shared expert, scaled per
token by a sigmoid gate. With capacity_factor >= n_expert (the presets'
setting) nothing can drop and the logits match HF's.

The tree is llama's with each block's "mlp" replaced by "moe":
{"router": {"kernel" (D, E)}, "wg"/"wu" (E, D, F), "wd" (E, F, D)[,
"shared": {"gate", "up", "down": {"kernel"}}, "shared_gate": {"kernel"
(D, 1)}]}. Each block is drawn from its own seeded stream (`init_layer`),
so `init_prepared` can draw, quantize and stack a full-size model one
block at a time (Mixtral-8x7B is 187 GB as an f32 tree, 93 GB in bf16).

The expert-parallel builders (`make_apply_ep`, `make_generate_ep`,
`make_pipeline_generate_ep`) need a device mesh and are not ported
(ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from dnn_tpu_torch.models import gpt, llama
from dnn_tpu_torch.ops.nn import linear, silu
from dnn_tpu_torch.parallel.moe import init_moe_gated, moe_ffn, unported_ep
from dnn_tpu_torch.registry import ModelSpec, register_model


@dataclasses.dataclass(frozen=True)
class MixtralConfig(llama.LlamaConfig):
    """JAX's MixtralConfig (:45): the LLaMA config plus the router's
    switches. capacity_factor >= n_expert drops nothing."""

    n_expert: int = 8
    router_top_k: int = 2
    capacity_factor: float = 8.0
    # Qwen2-MoE: an always-on shared SwiGLU expert of width d_shared,
    # scaled per token by sigmoid(h @ shared_gate)
    d_shared: Optional[int] = None
    # True (Mixtral): renormalise the selected top-k router weights;
    # False (Qwen2-MoE norm_topk_prob=false): the raw softmax weights
    router_norm_topk: bool = True

    def default_ffn(self, compute_dtype=None):
        """The routed experts, which every llama entry point picks up."""
        return make_ffn(self, compute_dtype=compute_dtype)


PRESETS = {
    # Mixtral-8x7B: GQA 4:1, 8 experts top-2
    "mixtral-8x7b": MixtralConfig(block_size=32768, vocab_size=32000,
                                  n_layer=32, n_head=32, n_kv_head=8,
                                  n_embd=4096, d_ff=14336,
                                  rope_theta=1_000_000.0, rms_eps=1e-5,
                                  n_expert=8, router_top_k=2),
    # tiny config for tests (4 experts top-2, GQA 2:1)
    "mixtral-test": MixtralConfig(block_size=64, vocab_size=256,
                                  n_layer=3, n_head=4, n_kv_head=2,
                                  n_embd=64, d_ff=128,
                                  n_expert=4, router_top_k=2,
                                  capacity_factor=4.0),
    # Qwen1.5-MoE-A2.7B: Qwen2 attention (q/k/v biases), 60 experts
    # top-4 with raw softmax weights, the sigmoid-gated shared expert
    "qwen15-moe-a2.7b": MixtralConfig(block_size=8192, vocab_size=151936,
                                      n_layer=24, n_head=16, n_kv_head=16,
                                      n_embd=2048, d_ff=1408,
                                      rope_theta=1_000_000.0,
                                      rms_eps=1e-6, attn_bias=True,
                                      n_expert=60, router_top_k=4,
                                      capacity_factor=60.0,
                                      d_shared=5632,
                                      router_norm_topk=False),
    # tiny shared-expert config for tests (every switch acts)
    "qwen2moe-test": MixtralConfig(block_size=64, vocab_size=256,
                                   n_layer=3, n_head=4, n_kv_head=2,
                                   n_embd=64, d_ff=32, attn_bias=True,
                                   n_expert=4, router_top_k=2,
                                   capacity_factor=4.0, d_shared=96,
                                   router_norm_topk=False),
}


def _shared_expert_out(moe_p, h, *, compute_dtype=None):
    """The shared expert (JAX :108): a dense SwiGLU over h, times
    sigmoid(h @ shared_gate) per token, in f32, cast to h's type."""
    sp = moe_p["shared"]
    s = linear(sp["down"],
               silu(linear(sp["gate"], h, compute_dtype=compute_dtype))
               * linear(sp["up"], h, compute_dtype=compute_dtype),
               compute_dtype=compute_dtype)
    g = torch.sigmoid(linear(moe_p["shared_gate"], h,
                             compute_dtype=compute_dtype).float())
    return (g * s.float()).to(h.dtype)


def make_ffn(cfg: MixtralConfig, *, compute_dtype=None, groups: int = 1):
    """The llama `ffn` hook (JAX :153): (block params, h) -> the MoE
    MLP's output, h's B*T tokens routed in `groups` groups, plus the
    shared expert for a d_shared config."""

    def ffn(bp, h):
        out = moe_ffn(bp["moe"], h, top_k=cfg.router_top_k,
                      capacity_factor=cfg.capacity_factor, groups=groups,
                      compute_dtype=compute_dtype,
                      normalize=cfg.router_norm_topk)
        if cfg.d_shared:
            out = out + _shared_expert_out(bp["moe"], h,
                                           compute_dtype=compute_dtype)
        return out

    return ffn


def _layer_seed(seed: int, i: int) -> int:
    return seed * 1_000_003 + i + 1


def init_layer(seed: int, cfg: MixtralConfig, i: int, *, device=None,
               dtype=None):
    """Block i from its own stream: llama's attention half
    (include_mlp=False) and the gated expert stacks (init_moe_gated),
    for a d_shared config the shared expert and its gate; numpy float32
    leaves, or tensors drawn on `device`, cast to `dtype` when given."""
    draw = llama.Draws(_layer_seed(seed, i), device)
    blk = llama.init_block(draw, cfg, include_mlp=False)
    moe = init_moe_gated(draw.rng, cfg.n_embd, cfg.n_expert, cfg.d_ff)
    if cfg.d_shared:
        si = 1.0 / math.sqrt(cfg.n_embd)
        so = 1.0 / math.sqrt(cfg.d_shared)
        c, f = cfg.n_embd, cfg.d_shared
        moe["shared"] = {"gate": {"kernel": draw.normal((c, f), si)},
                         "up": {"kernel": draw.normal((c, f), si)},
                         "down": {"kernel": draw.normal((f, c), so)}}
        moe["shared_gate"] = {"kernel": draw.normal((c, 1), si)}
    blk["moe"] = moe
    return gpt.cast_floats(blk, dtype)


def init(seed: int = 0, cfg: MixtralConfig = PRESETS["mixtral-test"], *,
         device=None, dtype=None):
    """Random weights from `seed` (JAX's init :171): llama's embeddings,
    final norm and head, then every block from init_layer; numpy float32
    leaves, or tensors drawn on `device`, cast to `dtype` when given
    (JAX's `dtype`). The draws differ from jax.random's; tests share
    weights through convert.from_jax_params."""
    params = gpt.cast_floats(
        llama.init_top(llama.Draws(seed, device), cfg), dtype)
    for i in range(cfg.n_layer):
        params[f"h_{i}"] = init_layer(seed, cfg, i, device=device,
                                      dtype=dtype)
    return params


def init_prepared(seed: int, cfg: MixtralConfig, device, *,
                  compute_dtype=None, weights: str = "f32", dtype=None):
    """The served form of init(seed, cfg, device=device, dtype=dtype),
    built one block at a time (gpt.prepare_streamed): each block is
    drawn on `device` (cast to `dtype` when given), quantized when
    `weights="int8"`, and copied into the stacks, so only the stacks and
    one block are ever alive. Equal to from_jax_params(init(...), cfg,
    device, compute_dtype) for f32 weights, and for int8 to
    quant.quantize_gpt of the f32 form (the int8 tree is left at f32 for
    every float leaf: the server casts for compute, as
    LMServer(weights="int8") does)."""
    from dnn_tpu_torch.quant import quantize_gpt

    if weights not in ("f32", "int8"):
        raise ValueError(f"weights must be 'f32' or 'int8', got {weights!r}")
    if weights == "int8" and dtype is not None:
        raise ValueError("int8 weights quantize the f32 draw: no dtype")
    top = gpt.cast_floats(llama.init_top(llama.Draws(seed, device), cfg),
                          dtype)
    if weights == "int8":
        top = quantize_gpt(top)
        compute_dtype = None

    def block(i):
        b = init_layer(seed, cfg, i, device=device, dtype=dtype)
        return quantize_gpt(b) if weights == "int8" else b

    return gpt.prepare_streamed(top, block, cfg.n_layer, device,
                                compute_dtype)


def make_apply(cfg: MixtralConfig, *, compute_dtype=None):
    """llama.make_apply; the config resolves the experts."""
    return llama.make_apply(cfg, compute_dtype=compute_dtype)


def make_generate(cfg: MixtralConfig, *, max_new_tokens: int, **kwargs):
    """llama.make_generate (runtime/generate.make_generate) with the
    experts resolved from the config: the prompt routes (B, T) tokens,
    each decode step (B, 1)."""
    return llama.make_generate(cfg, max_new_tokens=max_new_tokens, **kwargs)


def family_rows(cfg: MixtralConfig, *, compute_dtype=None):
    """The batcher's adapter: LlamaFamilyRows, the experts resolved from
    the config on every path (prefill, decode rows, verify rows)."""
    return llama.LlamaFamilyRows(cfg, compute_dtype=compute_dtype)


make_apply_ep = unported_ep("make_apply_ep", "models/llama_moe.py:251")
make_generate_ep = unported_ep("make_generate_ep", "models/llama_moe.py:320")
make_pipeline_generate_ep = unported_ep("make_pipeline_generate_ep",
                                        "models/llama_moe.py:417")


def params_from_state_dict(sd, *, n_layer: Optional[int] = None):
    """HF MixtralForCausalLM or Qwen2MoeForCausalLM state dict -> this
    family's tree (io/checkpoint.moe_params_from_state_dict)."""
    from dnn_tpu_torch.io.checkpoint import moe_params_from_state_dict

    return moe_params_from_state_dict(sd, n_layer=n_layer)


def to_hf_config(cfg: MixtralConfig, **overrides):
    """transformers.MixtralConfig, or Qwen2MoeConfig for a d_shared
    config, for parity tests (JAX :695); needs `transformers`."""
    import transformers

    if cfg.d_shared:
        return transformers.Qwen2MoeConfig(
            vocab_size=cfg.vocab_size, hidden_size=cfg.n_embd,
            intermediate_size=cfg.d_ff, moe_intermediate_size=cfg.d_ff,
            shared_expert_intermediate_size=cfg.d_shared,
            num_hidden_layers=cfg.n_layer, num_attention_heads=cfg.n_head,
            num_key_value_heads=cfg.n_kv_head,
            max_position_embeddings=cfg.block_size,
            rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps,
            num_experts=cfg.n_expert, num_experts_per_tok=cfg.router_top_k,
            norm_topk_prob=cfg.router_norm_topk, decoder_sparse_step=1,
            tie_word_embeddings=cfg.tie_word_embeddings, **overrides)
    kw = dict(
        vocab_size=cfg.vocab_size, hidden_size=cfg.n_embd,
        intermediate_size=cfg.d_ff, num_hidden_layers=cfg.n_layer,
        num_attention_heads=cfg.n_head, num_key_value_heads=cfg.n_kv_head,
        max_position_embeddings=cfg.block_size, rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.rms_eps, num_local_experts=cfg.n_expert,
        num_experts_per_tok=cfg.router_top_k, sliding_window=None)
    kw.update(overrides)
    return transformers.MixtralConfig(**kw)


def _register(name: str, cfg: MixtralConfig):
    def convert(sd, _cfg=cfg):
        return params_from_state_dict(sd, n_layer=_cfg.n_layer)

    def example_input(batch_size=1, seq_len=None, seed=0, _cfg=cfg):
        t = min(seq_len or _cfg.block_size, _cfg.block_size)
        rng = np.random.default_rng(seed)
        return rng.integers(0, _cfg.vocab_size, (batch_size, t)).astype(
            np.int32)

    register_model(ModelSpec(
        name=name,
        init=lambda seed=0, device=None, dtype=None, _cfg=cfg: init(
            seed, _cfg, device=device, dtype=dtype),
        apply=make_apply(cfg),
        partition=llama.make_partition(cfg),
        example_input=example_input,
        supported_parts=tuple(range(1, cfg.n_layer + 1)),
        convert_state_dict=convert,
        config=cfg,
        extras={
            "make_apply": lambda compute_dtype=None, _cfg=cfg, **_kw:
                make_apply(_cfg, compute_dtype=compute_dtype),
            "make_partition": lambda compute_dtype=None, _cfg=cfg, **_kw:
                llama.make_partition(_cfg, compute_dtype=compute_dtype),
            "family_rows": lambda compute_dtype=None, _cfg=cfg, **_kw:
                family_rows(_cfg, compute_dtype=compute_dtype),
            # the daemon's random weights, drawn, quantized and stacked
            # block by block on its device (engine.served_params):
            # Mixtral-8x7B's f32 tree is 187 GB
            "init_prepared": lambda seed, device, _cfg=cfg, **kw:
                init_prepared(seed, _cfg, device, **kw),
        },
    ))


for _name, _cfg in PRESETS.items():
    _register(_name, _cfg)
