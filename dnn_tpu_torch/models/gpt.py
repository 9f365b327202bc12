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

`make_partition` splits the model into pipeline stages over the
per-layer tree (first stage: embed, last: head), and every preset is
registered with the model registry.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dnn_tpu_torch.ops.attention import causal_self_attention
from dnn_tpu_torch.ops.nn import embedding, gelu, layer_norm, linear
from dnn_tpu_torch.registry import ModelSpec, StageSpec, register_model


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
    # long-context variants of the JAX package's presets
    "gpt2-4k": GPTConfig(block_size=4096, n_layer=12, n_head=12, n_embd=768),
    "gpt2-8k": GPTConfig(block_size=8192, n_layer=12, n_head=12, n_embd=768),
    # tiny config for tests
    "gpt2-test": GPTConfig(block_size=64, vocab_size=256, n_layer=4,
                           n_head=4, n_embd=64),
}


def init(seed: int, cfg: GPTConfig = PRESETS["gpt2"], *, device=None):
    """Random GPT-2 weights from `seed`: the shapes and standard
    deviations of dnn_tpu.models.gpt.init (0.02 normal, 0.01 for wpe,
    residual projections scaled by 1/sqrt(2 n_layer), unit LayerNorm
    scales, zero biases, lm_head tied to wte.T). The draws differ from
    jax.random's; tests share weights through convert.from_jax_params
    instead. Returns the JAX-layout tree of float32 numpy arrays drawn
    with numpy, or, with `device`, of tensors drawn there from a seeded
    torch.Generator (gpt2-xl's 1.6 G draws take seconds on the host)."""
    c = cfg.n_embd
    if device is None:
        rng = np.random.default_rng(seed)

        def normal(shape, std=0.02):
            return (rng.standard_normal(shape, dtype=np.float32)
                    * np.float32(std))

        def full(n, value):
            return np.full((n,), value, np.float32)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)

        def normal(shape, std=0.02):
            return torch.randn(shape, generator=gen, device=device) * std

        def full(n, value):
            return torch.full((n,), float(value), device=device)

    def ln():
        return {"scale": full(c, 1.0), "bias": full(c, 0.0)}

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
                        "bias": full(3 * c, 0.0)},
                "proj": {"kernel": normal((c, c), proj_std),
                         "bias": full(c, 0.0)},
            },
            "ln_2": ln(),
            "mlp": {
                "fc": {"kernel": normal((c, 4 * c)),
                       "bias": full(4 * c, 0.0)},
                "proj": {"kernel": normal((4 * c, c), proj_std),
                         "bias": full(c, 0.0)},
            },
        }
    wte = params["wte"]["embedding"]
    params["lm_head"] = {"kernel": np.ascontiguousarray(wte.T)
                         if device is None else wte.T.contiguous()}
    return params


def _to_tensor(a, device):
    """A leaf -> a tensor on `device`: float leaves as float32, integer
    leaves (a quantized linear's q) in their own type, and a numpy int4
    leaf (ml_dtypes, JAX's int4 kernels) packed two to a byte
    (quant.pack_int4). A tensor moves (no copy where it is already
    there); anything else goes through np.array, which copies: the
    source may be a read-only view of JAX memory."""
    if isinstance(a, torch.Tensor):
        if a.is_floating_point():
            return a.to(device=device, dtype=torch.float32)
        return a.to(device)
    if getattr(getattr(a, "dtype", None), "name", "") == "int4":
        from dnn_tpu_torch.quant import pack_int4

        return pack_int4(torch.from_numpy(
            np.asarray(a).astype(np.int8))).to(device)
    arr = np.asarray(a)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.from_numpy(np.array(arr, order="C")).to(device)
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def cast_floats(tree, dtype):
    """A tree's leaves cast to the torch `dtype` (numpy leaves become CPU
    tensors); `dtype=None` returns the tree as it is (a random init's
    `dtype`, JAX's)."""
    if dtype is None:
        return tree
    return _map(lambda a: (a if isinstance(a, torch.Tensor)
                           else torch.from_numpy(a)).to(dtype), tree)


def tensors(params, device):
    """JAX-layout tree (numpy leaves) -> the same per-layer tree of
    float32 tensors on `device` (the layout `make_apply` takes)."""
    return _map(lambda a: _to_tensor(a, device), params)


def prepare_stacked(params, cfg, device, compute_dtype=None):
    """JAX-layout tree -> the served form: every block leaf stacked
    along a leading (L,) axis, all leaves float32 tensors on `device`.
    Leaves are numpy arrays, or tensors (stacked where they lie, so a
    tree drawn on the card never visits the host). Any config with
    n_layer and "h_i" blocks: the GPT, LLaMA and MoE families share it.
    With `compute_dtype` (bf16 compute) the matmul weights are held in
    it (`for_compute`), each block leaf cast as it is copied into its
    stack, so no f32 copy of a stack coexists with the tree."""
    top = {k: v for k, v in params.items() if not k.startswith("h_")}
    return prepare_streamed(top, lambda i: params[f"h_{i}"], cfg.n_layer,
                            device, compute_dtype)


def prepare_streamed(top, block, n_layer: int, device, compute_dtype=None):
    """prepare_stacked over blocks handed out one at a time: `block(i)`
    returns layer i's tree (numpy or tensor leaves), which is copied
    into the (L, ...) stacks, allocated from layer 0's leaves in their
    served type, and then dropped. So a model larger than the card's
    memory twice over (Mixtral-8x7B's int8 experts) can be drawn,
    quantized and stacked block by block: only the stacks and one
    block are alive at a time. `top` holds the non-block leaves."""
    first = block(0)
    stacks = {}

    def alloc(node, out, path):
        for k, v in node.items():
            if isinstance(v, dict):
                alloc(v, out.setdefault(k, {}), path + (k,))
                continue
            t = _to_tensor(v, device)
            if _matmul_leaf(path + (k,), first) and compute_dtype is not None \
                    and t.is_floating_point():
                t = t.to(compute_dtype)
            out[k] = torch.empty((n_layer,) + tuple(t.shape), dtype=t.dtype,
                                 device=device)
            out[k][0].copy_(t)

    def fill(node, out, i):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v, out[k], i)
            else:
                out[k][i].copy_(_to_tensor(v, device))

    alloc(first, stacks, ())
    del first
    for i in range(1, n_layer):
        fill(block(i), stacks, i)
    out = {k: _map(lambda a: _to_tensor(a, device), v) for k, v in top.items()}
    out["blocks"] = stacks
    return for_compute(out, compute_dtype)


# the expert stacks of an MoE block (parallel/moe.py): matmul weights
# held in the compute type, beside the router and the expert biases,
# which stay f32 (JAX routes in f32 and adds the biases in f32)
_EXPERT_STACKS = ("wi", "wo", "wg", "wu", "wd")


def _matmul_leaf(path, block) -> bool:
    """Whether the block leaf at `path` is a linear's kernel or bias
    (its parent holds a "kernel"; a MoE router's is not one), or an MoE
    expert stack; not a norm's scale or bias."""
    if path[-1] in _EXPERT_STACKS and "moe" in path:
        return True
    if "router" in path:
        return False
    parent = block
    for key in path[:-1]:
        parent = parent[key]
    return "kernel" in parent and path[-1] in ("kernel", "bias")


def for_compute(prepared, compute_dtype):
    """The served form under bf16 compute: every block linear's kernel
    and bias, every float MoE expert stack, and the lm_head's kernel
    held in `compute_dtype`, cast here once -- the operands JAX's
    `linear(compute_dtype=)` and expert FFN cast to on every call -- so
    a served step launches no cast of a weight. Embeddings, norm scales,
    MoE routers and expert biases stay f32 (JAX's norms and routing
    compute in f32, its embedding is cast after the lookup and its
    expert biases add in f32); the lm_head's bias stays f32 (the head
    adds it to f32 logits). A tied head (no "lm_head" leaf: the LLaMA
    family's tied configs read wte's transpose) gets an "lm_head" of its
    own, wte.T in `compute_dtype`. Leaves already of the type are not
    copied; `compute_dtype=None` returns `prepared` itself."""
    if compute_dtype is None:
        return prepared

    def cast(node, bias: bool):
        if not isinstance(node, dict):
            return node
        if "kernel" not in node:
            return {k: v if k == "router" else
                    v.to(compute_dtype) if k in _EXPERT_STACKS
                    and not isinstance(v, dict) and v.is_floating_point()
                    else cast(v, bias) for k, v in node.items()}
        return {k: v.to(compute_dtype)
                if k == "kernel" or (k == "bias" and bias) else v
                for k, v in node.items()}

    out = dict(prepared)
    out["blocks"] = cast(prepared["blocks"], True)
    if "lm_head" in prepared:
        out["lm_head"] = cast(prepared["lm_head"], False)
    else:
        out["lm_head"] = {"kernel": prepared["wte"]["embedding"].T
                          .to(compute_dtype).contiguous()}
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
    accumulates in f32 (one bf16 x bf16 -> f32 product on the card;
    ops/nn.linear)."""
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


def make_hidden_stacked(cfg: GPTConfig, *, compute_dtype=None):
    """Final-normed hidden states (B, T, C) f32 over the prepare_stacked
    layout (JAX's make_hidden_stacked :262): make_apply_stacked without
    the lm_head, the embedding endpoint's forward. Its attention is the
    flash forward (use_flash=True): K1 on the card, the plain version on
    the CPU -- JAX's takes the einsum, the same function."""

    def hidden(prepared, idx):
        x = embed(prepared, idx, cfg=cfg)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        x = blocks_scan(prepared["blocks"], x, cfg=cfg, use_flash=True,
                        compute_dtype=compute_dtype)
        return layer_norm(prepared["ln_f"], x.float(), eps=cfg.ln_eps)

    return hidden


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



def layer_ranges(n_layer: int, num_parts: int):
    """Split n_layer blocks into num_parts contiguous [lo, hi) ranges,
    earlier stages taking the remainder (JAX's layer_ranges :494)."""
    if not 1 <= num_parts <= n_layer:
        raise ValueError(f"num_parts must be in [1, {n_layer}], got {num_parts}")
    base, rem = divmod(n_layer, num_parts)
    ranges, lo = [], 0
    for p in range(num_parts):
        hi = lo + base + (1 if p < rem else 0)
        ranges.append((lo, hi))
        lo = hi
    return ranges


def make_partition(cfg: GPTConfig, *, use_flash=False, compute_dtype=None):
    """partition(num_parts) -> StageSpecs over the per-layer tree (JAX's
    make_partition :509). The first stage takes int ids and embeds them,
    cast to `compute_dtype`; each stage runs its blocks; the last runs
    `head` on x.float() (f32 logits)."""

    def partition(num_parts):
        stages = []
        for p, (lo, hi) in enumerate(layer_ranges(cfg.n_layer, num_parts)):
            first, last = p == 0, p == num_parts - 1
            keys = tuple(f"h_{i}" for i in range(lo, hi))
            if first:
                keys = ("wte", "wpe") + keys
            if last:
                keys = keys + ("ln_f", "lm_head")

            def stage_fn(params, x, _lo=lo, _hi=hi, _first=first,
                         _last=last):
                if _first:
                    x = embed(params, x, cfg=cfg)
                if compute_dtype is not None and x.is_floating_point():
                    x = x.to(compute_dtype)
                x = _run_blocks([params[f"h_{i}"] for i in range(_lo, _hi)],
                                x, cfg=cfg, use_flash=use_flash,
                                compute_dtype=compute_dtype, remat=False)
                if _last:
                    x = head(params, x.float(), cfg=cfg,
                             compute_dtype=compute_dtype)
                return x

            stages.append(StageSpec(
                name=f"gpt_blocks[{lo}:{hi}]" + ("+embed" if first else "")
                + ("+head" if last else ""),
                apply=stage_fn, param_keys=keys))
        return stages

    return partition


def _register(name: str, cfg: GPTConfig):
    def convert(sd, _cfg=cfg):
        from dnn_tpu_torch.io.checkpoint import gpt_params_from_state_dict

        return gpt_params_from_state_dict(sd, n_layer=_cfg.n_layer)

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
        extras={"make_partition": lambda compute_dtype=None, use_flash=False,
                _cfg=cfg: make_partition(_cfg, compute_dtype=compute_dtype,
                                         use_flash=use_flash)},
    ))


for _name, _cfg in PRESETS.items():
    _register(_name, _cfg)
