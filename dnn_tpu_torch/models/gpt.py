"""GPT-2 model family (port of dnn_tpu/models/gpt.py).

Parameters keep the JAX package's pytree layout — {"wte", "wpe",
"h_0".."h_{L-1}", "ln_f", "lm_head"} with (in, out) linear kernels — so
one set of weights feeds both packages (dnn_tpu_torch/convert.py).
`prepare_stacked` turns that tree into the served form: per-block
tensors stacked along a leading layer axis, on one device. The layer
loop is plain Python (`layer_params` takes one layer's views).

The stateless forward (`make_apply`, `make_apply_stacked`: embed ->
blocks -> head) is the training path's model; with `use_flash=True` its
attention runs the flash kernels (ops/cuda/flash_attention.py).
Training sets requires_grad on the stacked leaves; the layers' gradients
reach each (L, ...) leaf through `unstack`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dnn_tpu_torch.ops.attention import causal_self_attention
from dnn_tpu_torch.ops.nn import embedding, gelu, layer_norm, linear


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    block_size: int = 1024
    vocab_size: int = 50257
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    ln_eps: float = 1e-5


PRESETS = {
    "gpt2": GPTConfig(n_layer=12, n_head=12, n_embd=768),
    "gpt2-medium": GPTConfig(n_layer=24, n_head=16, n_embd=1024),
    "gpt2-large": GPTConfig(n_layer=36, n_head=20, n_embd=1280),
    "gpt2-xl": GPTConfig(n_layer=48, n_head=25, n_embd=1600),
    # tiny config for tests
    "gpt2-test": GPTConfig(block_size=64, vocab_size=256, n_layer=4,
                           n_head=4, n_embd=64),
}


def init(seed: int, cfg: GPTConfig = PRESETS["gpt2"]):
    """Random GPT-2 weights drawn with numpy from `seed`: the shapes and
    standard deviations of dnn_tpu.models.gpt.init (0.02 normal, 0.01
    for wpe, residual projections scaled by 1/sqrt(2 n_layer), unit
    LayerNorm scales, zero biases, lm_head tied to wte.T). The draws
    differ from jax.random's; tests share weights through
    convert.from_jax_params instead. Returns the JAX-layout tree of
    float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    c = cfg.n_embd

    def normal(shape, std=0.02):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(std))

    def ln():
        return {"scale": np.ones((c,), np.float32),
                "bias": np.zeros((c,), np.float32)}

    proj_std = 0.02 / (2 * cfg.n_layer) ** 0.5
    params = {
        "wte": {"embedding": normal((cfg.vocab_size, c))},
        "wpe": {"embedding": normal((cfg.block_size, c), std=0.01)},
        "ln_f": ln(),
    }
    for i in range(cfg.n_layer):
        params[f"h_{i}"] = {
            "ln_1": ln(),
            "attn": {
                "qkv": {"kernel": normal((c, 3 * c)),
                        "bias": np.zeros((3 * c,), np.float32)},
                "proj": {"kernel": normal((c, c), proj_std),
                         "bias": np.zeros((c,), np.float32)},
            },
            "ln_2": ln(),
            "mlp": {
                "fc": {"kernel": normal((c, 4 * c)),
                       "bias": np.zeros((4 * c,), np.float32)},
                "proj": {"kernel": normal((4 * c, c), proj_std),
                         "bias": np.zeros((c,), np.float32)},
            },
        }
    params["lm_head"] = {
        "kernel": np.ascontiguousarray(params["wte"]["embedding"].T)}
    return params


def _to_tensor(a, device):
    # np.array copies: the source may be a read-only view of JAX memory
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tensors(params, device):
    """JAX-layout tree (numpy leaves) -> the same per-layer tree of
    float32 tensors on `device` (the layout `make_apply` takes)."""
    return _map(lambda a: _to_tensor(a, device), params)


def prepare_stacked(params, cfg: GPTConfig, device):
    """JAX-layout tree (numpy leaves) -> the served form: every block
    leaf stacked along a leading (L,) axis, all leaves float32 tensors
    on `device`."""
    blocks = [params[f"h_{i}"] for i in range(cfg.n_layer)]

    def stack(*path):
        leaves = []
        for b in blocks:
            node = b
            for key in path:
                node = node[key]
            leaves.append(np.asarray(node, np.float32))
        return _to_tensor(np.stack(leaves), device)

    def stack_tree(node, path=()):
        if isinstance(node, dict):
            return {k: stack_tree(v, path + (k,)) for k, v in node.items()}
        return stack(*path)

    out = {k: _map(lambda a: _to_tensor(a, device), v)
           for k, v in params.items() if not k.startswith("h_")}
    out["blocks"] = stack_tree(blocks[0])
    return out


def layer_params(blocks, i: int):
    """Layer i's parameter views out of the stacked block tree."""
    return _map(lambda t: t[i], blocks)


def unstack(blocks, n_layer: int):
    """Every layer's parameter views, through one unbind per stacked
    leaf: under autograd its backward stacks the layers' gradients into
    the (L, ...) leaf in one op (n_layer separate `t[i]` views would
    each scatter into a zero tensor of the whole leaf)."""
    split = _map(lambda t: t.unbind(0), blocks)
    return [_map(lambda parts: parts[i], split) for i in range(n_layer)]


def head(prepared, x, *, cfg: GPTConfig, compute_dtype=None):
    """Final LayerNorm + lm_head -> f32 logits (JAX's head :213). With
    `compute_dtype` the lm_head product reads operands rounded to it and
    accumulates in f32."""
    x = layer_norm(prepared["ln_f"], x, eps=cfg.ln_eps)
    if compute_dtype is None:
        return linear(prepared["lm_head"], x)
    return linear(prepared["lm_head"], x, compute_dtype=compute_dtype,
                  accum_dtype=torch.float32)


def embed(params, idx, *, cfg: GPTConfig):
    """Token + position embedding of idx (B, T) (JAX's embed :202),
    with its T <= block_size guard."""
    t = idx.shape[-1]
    if t > cfg.block_size:
        raise ValueError(f"Cannot forward: sequence length {t} > block_size "
                         f"{cfg.block_size}")
    pos = torch.arange(t, device=idx.device)
    return embedding(params["wte"], idx.long()) + embedding(params["wpe"], pos)


def block_apply(block_params, x, *, cfg: GPTConfig, use_flash=False,
                compute_dtype=None):
    """Pre-LN transformer block (JAX's block_apply :138): every matmul in
    `compute_dtype` when given, residuals and layer norms in x's
    dtype."""
    h = layer_norm(block_params["ln_1"], x, eps=cfg.ln_eps)
    x = x + causal_self_attention(block_params["attn"], h, n_head=cfg.n_head,
                                  use_flash=use_flash,
                                  compute_dtype=compute_dtype)
    h = layer_norm(block_params["ln_2"], x, eps=cfg.ln_eps)
    mlp = block_params["mlp"]
    m = linear(mlp["proj"],
               gelu(linear(mlp["fc"], h, compute_dtype=compute_dtype)),
               compute_dtype=compute_dtype)
    return x + m


def _run_blocks(layers, x, *, cfg, use_flash, compute_dtype, remat):
    """The layer loop. `remat=True` wraps each block in a non-reentrant
    activation checkpoint (JAX's jax.checkpoint): the backward recomputes
    the block's forward instead of keeping its intermediates."""
    def block(bp, h):
        return block_apply(bp, h, cfg=cfg, use_flash=use_flash,
                           compute_dtype=compute_dtype)

    for bp in layers:
        x = checkpoint(block, bp, x, use_reentrant=False) if remat \
            else block(bp, x)
    return x


def blocks_scan(stacked, x, *, cfg: GPTConfig, use_flash=False,
                compute_dtype=None, remat=False):
    """Every block of the (L, ...)-stacked tree over x, in order (JAX's
    blocks_scan :171; a Python loop in place of lax.scan)."""
    return _run_blocks(unstack(stacked, cfg.n_layer), x, cfg=cfg,
                       use_flash=use_flash, compute_dtype=compute_dtype,
                       remat=remat)


def _apply_from(params, idx, layers, *, cfg, use_flash, compute_dtype,
                remat):
    x = embed(params, idx, cfg=cfg)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    x = _run_blocks(layers, x, cfg=cfg, use_flash=use_flash,
                    compute_dtype=compute_dtype, remat=remat)
    return head(params, x.float(), cfg=cfg, compute_dtype=compute_dtype)


def make_apply(cfg: GPTConfig, *, use_flash=False, compute_dtype=None,
               remat=False):
    """Full forward over the per-layer tree {"wte", "wpe", "h_i", "ln_f",
    "lm_head"} of tensors (JAX's make_apply :243): apply(params, idx)
    -> f32 logits (B, T, V)."""

    def apply(params, idx):
        layers = (params[f"h_{i}"] for i in range(cfg.n_layer))
        return _apply_from(params, idx, layers, cfg=cfg, use_flash=use_flash,
                           compute_dtype=compute_dtype, remat=remat)

    return apply


def make_apply_stacked(cfg: GPTConfig, *, use_flash=False, compute_dtype=None,
                       remat=False):
    """Full forward over `prepare_stacked` params (JAX's
    make_apply_stacked :281): embed -> cast to `compute_dtype` -> blocks
    -> head on f32 activations (bf16 operands, f32 accumulation when
    `compute_dtype` is set)."""

    def apply(prepared, idx):
        layers = unstack(prepared["blocks"], cfg.n_layer)
        return _apply_from(prepared, idx, layers, cfg=cfg,
                           use_flash=use_flash, compute_dtype=compute_dtype,
                           remat=remat)

    return apply

