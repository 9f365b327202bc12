"""GPT with Mixture-of-Experts FFNs (port of dnn_tpu/models/gpt_moe.py).

Every block's dense MLP is a top-k routed MoE FFN (parallel/moe.py);
attention, the embeddings and the LM head are GPT-2's. The block tree is
gpt's with "mlp" replaced by "moe": {"router": {"kernel" (D, E)}, "wi"
(E, D, F), "bi" (E, F), "wo" (E, F, D), "bo" (E, D)}.

The stateless forward (`make_apply`) routes each block's B*T tokens in
`groups` groups; the cached paths route whatever tokens a forward sees
(runtime/generate_moe.py: the prompt as one group, then the B current
tokens of each decode step; the batcher's steps route every slot, idle
ones included), so with a capacity factor below n_experts the drops, and
so the outputs, depend on the batch, as in any capacity-based MoE and as
in the JAX package. `make_partition` stages the family over layer
ranges; each stage routes the batch it is handed (JAX :228).

The expert-parallel forward (`make_apply_ep`) needs a device mesh and
is not ported (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dnn_tpu_torch.models import gpt
from dnn_tpu_torch.ops.attention import causal_self_attention
from dnn_tpu_torch.ops.nn import layer_norm
from dnn_tpu_torch.parallel.moe import _normal, init_moe, moe_ffn, unported_ep
from dnn_tpu_torch.registry import ModelSpec, StageSpec, register_model


@dataclasses.dataclass(frozen=True)
class GPTMoEConfig(gpt.GPTConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    d_ff: int = 0  # 0 = 4 * n_embd (per expert)

    @property
    def ff_dim(self):
        return self.d_ff or 4 * self.n_embd


PRESETS = {
    # 8 experts, top-2, over gpt2-small's attention
    "gpt2-moe": GPTMoEConfig(n_layer=12, n_head=12, n_embd=768, n_experts=8),
    # tiny config for tests (experts divisible by 2 and 4)
    "gpt2-moe-test": GPTMoEConfig(block_size=64, vocab_size=256, n_layer=2,
                                  n_head=4, n_embd=32, n_experts=4, d_ff=64),
}


def init(seed: int, cfg: GPTMoEConfig = PRESETS["gpt2-moe"], *,
         device=None, dtype=None):
    """Random weights from `seed` with the shapes and standard deviations
    of JAX's init (:82): gpt2's embeddings and attention, each block's
    MoE layer (init_moe), lm_head tied to wte.T. numpy float32 leaves,
    or, with `device`, tensors drawn there from a seeded torch.Generator;
    cast to `dtype` when given (JAX's `dtype`). The draws differ from
    jax.random's; tests share weights through convert.from_jax_params."""
    rng = (np.random.default_rng(seed) if device is None else
           torch.Generator(device=device).manual_seed(seed))
    c = cfg.n_embd

    def zeros(n):
        return (np.zeros((n,), np.float32) if device is None
                else torch.zeros((n,), device=device))

    def ln():
        one = (np.ones((c,), np.float32) if device is None
               else torch.ones((c,), device=device))
        return {"scale": one, "bias": zeros(c)}

    proj_std = 0.02 / (2 * cfg.n_layer) ** 0.5
    params = {"wte": {"embedding": _normal(rng, (cfg.vocab_size, c), 0.02)},
              "wpe": {"embedding": _normal(rng, (cfg.block_size, c), 0.01)},
              "ln_f": ln()}
    for i in range(cfg.n_layer):
        params[f"h_{i}"] = {
            "ln_1": ln(),
            "attn": {
                "qkv": {"kernel": _normal(rng, (c, 3 * c), 0.02),
                        "bias": zeros(3 * c)},
                "proj": {"kernel": _normal(rng, (c, c), proj_std),
                         "bias": zeros(c)},
            },
            "ln_2": ln(),
            "moe": init_moe(rng, c, cfg.n_experts, cfg.ff_dim),
        }
    wte = params["wte"]["embedding"]
    params["lm_head"] = {"kernel": np.ascontiguousarray(wte.T)
                         if device is None else wte.T.contiguous()}
    return gpt.cast_floats(params, dtype)


def init_prepared(seed: int, cfg: GPTMoEConfig, device, *,
                  compute_dtype=None, weights: str = "f32", dtype=None):
    """The served form of init(seed, cfg, device=device, dtype=dtype):
    drawn on `device`, stacked at `compute_dtype`, or for
    `weights="int8"` left at f32 and quantized (quant.quantize_gpt:
    the expert stacks too), as llama_moe.init_prepared returns it."""
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.quant import quantize_gpt

    if weights not in ("f32", "int8"):
        raise ValueError(f"weights must be 'f32' or 'int8', got {weights!r}")
    if weights == "int8" and dtype is not None:
        raise ValueError("int8 weights quantize the f32 draw: no dtype")
    int8 = weights == "int8"
    prepared = from_jax_params(init(seed, cfg, device=device, dtype=dtype),
                               cfg, device, None if int8 else compute_dtype)
    return quantize_gpt(prepared) if int8 else prepared


def block_apply(bp, x, *, cfg: GPTMoEConfig, groups: int = 1,
                compute_dtype=None):
    """Pre-LN block (JAX's _block_core :127): causal MHA (the einsum)
    and the routed FFN in `groups` groups, both residual."""
    h = layer_norm(bp["ln_1"], x, eps=cfg.ln_eps)
    x = x + causal_self_attention(bp["attn"], h, n_head=cfg.n_head,
                                  compute_dtype=compute_dtype)
    h = layer_norm(bp["ln_2"], x, eps=cfg.ln_eps)
    m = moe_ffn(bp["moe"], h, top_k=cfg.top_k,
                capacity_factor=cfg.capacity_factor, groups=groups,
                compute_dtype=compute_dtype)
    return x + m.to(x.dtype)


def _run(params, x, layers, *, cfg, groups, compute_dtype):
    if compute_dtype is not None and x.is_floating_point():
        x = x.to(compute_dtype)
    for bp in layers:
        x = block_apply(bp, x, cfg=cfg, groups=groups,
                        compute_dtype=compute_dtype)
    return x


def make_apply(cfg: GPTMoEConfig, *, groups: int = 1, compute_dtype=None):
    """Stateless forward over the per-layer tree (JAX :186):
    apply(params, idx) -> f32 logits (B, T, V); `groups` routing groups
    a block."""

    @torch.no_grad()
    def apply(params, idx):
        x = _run(params, gpt.embed(params, idx, cfg=cfg),
                 (params[f"h_{i}"] for i in range(cfg.n_layer)), cfg=cfg,
                 groups=groups, compute_dtype=compute_dtype)
        return gpt.head(params, x.float(), cfg=cfg,
                        compute_dtype=compute_dtype)

    return apply


def make_apply_stacked(cfg: GPTMoEConfig, *, groups: int = 1,
                       compute_dtype=None):
    """make_apply over the prepare_stacked layout."""

    @torch.no_grad()
    def apply(prepared, idx):
        x = _run(prepared, gpt.embed(prepared, idx, cfg=cfg),
                 gpt.unstack(prepared["blocks"], cfg.n_layer), cfg=cfg,
                 groups=groups, compute_dtype=compute_dtype)
        return gpt.head(prepared, x.float(), cfg=cfg,
                        compute_dtype=compute_dtype)

    return apply


make_apply_ep = unported_ep("make_apply_ep", "models/gpt_moe.py:149")


def make_partition(cfg: GPTMoEConfig, *, compute_dtype=None):
    """Pipeline stages over layer ranges (JAX :228): the first stage
    embeds, the last runs the head; each stage's blocks route the batch
    they are handed as one group."""

    def partition(num_parts):
        stages = []
        for p, (lo, hi) in enumerate(gpt.layer_ranges(cfg.n_layer,
                                                      num_parts)):
            first, last = p == 0, p == num_parts - 1
            keys = tuple(f"h_{i}" for i in range(lo, hi))
            if first:
                keys = ("wte", "wpe") + keys
            if last:
                keys = keys + ("ln_f", "lm_head")

            @torch.no_grad()
            def stage_fn(params, x, _lo=lo, _hi=hi, _first=first,
                         _last=last):
                if _first:
                    x = gpt.embed(params, x, cfg=cfg)
                x = _run(params, x, [params[f"h_{i}"] for i in
                                     range(_lo, _hi)],
                         cfg=cfg, groups=1, compute_dtype=compute_dtype)
                if _last:
                    x = gpt.head(params, x.float(), cfg=cfg,
                                 compute_dtype=compute_dtype)
                return x

            stages.append(StageSpec(
                name=f"moe_blocks[{lo}:{hi}]" + ("+embed" if first else "")
                + ("+head" if last else ""),
                apply=stage_fn, param_keys=keys))
        return stages

    return partition


def _register(name: str, cfg: GPTMoEConfig):
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
        partition=make_partition(cfg),
        example_input=example_input,
        supported_parts=tuple(range(1, cfg.n_layer + 1)),
        config=cfg,
        extras={
            "make_apply": lambda compute_dtype=None, _cfg=cfg, **_kw:
                make_apply(_cfg, compute_dtype=compute_dtype),
            "make_partition": lambda compute_dtype=None, _cfg=cfg, **_kw:
                make_partition(_cfg, compute_dtype=compute_dtype),
            "make_apply_ep": make_apply_ep,
            # the daemon's random weights, drawn as the served stacks on
            # its device (engine.served_params)
            "init_prepared": lambda seed, device, _cfg=cfg, **kw:
                init_prepared(seed, _cfg, device, **kw),
        },
    ))


for _name, _cfg in PRESETS.items():
    _register(_name, _cfg)
