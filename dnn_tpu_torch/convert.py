"""Carry weights between the JAX package and the port.

`from_jax_params` takes dnn_tpu's GPT param pytree — {"wte", "wpe",
"h_i", "ln_f", "lm_head"} — or its LLaMA-family pytree ({"wte", "h_i",
"ln_f"[, "lm_head"]}: KV-width k/v projections, optional biases, q/k
norms and post-norms, no "ln_*" under OLMo-2, no "lm_head" when tied),
leaves as numpy arrays (np.asarray of the JAX arrays) or as tensors on
any device, and returns the port's prepared tensors, so both packages
run the very same weights. `load_npz` reads the same tree from a flat
.npz whose keys are the "/"-joined paths ("h_0/attn/qkv/kernel").
`to_jax_params` is the inverse of `from_jax_params`: trained weights go
back to the JAX package, and tests compare trees leaf by leaf. The MoE
families' blocks carry a "moe" subtree ({"router", the expert stacks
wi/bi/wo/bo or wg/wu/wd, their int8 `*_scale` leaves, Qwen2-MoE's
"shared" and "shared_gate"}), which crosses both ways like any other
(stacked to (L, E, ...) leaves), its expert shapes checked.

Weight-quantized trees (quant.py: {"q", "scale", "bias"?} linears) cross
too: int8 q leaves as they are, JAX's int4 q leaves (ml_dtypes int4
numpy arrays) packed two to a byte on the way in and unpacked on the way
out.

KV caches cross with `int4_cache_from_jax` / `int4_cache_to_jax`: a JAX
int4 cache (dense or paged: K/V as their int4 values widened to int8 in
numpy, f32 scales, int32 tables) into the port's packed layout (uint8 K/V
of last dim D / 2, runtime/kvcache.py's nibble order), and back."""

from __future__ import annotations

import numpy as np
import torch

from dnn_tpu_torch.models.gpt import _map, prepare_stacked


def _shape(a):
    return tuple(a.shape) if isinstance(a, torch.Tensor) else np.shape(a)


def _kernel_shape(linear):
    """The (in, out) shape of a linear's kernel, float or quantized (a
    packed int4 tensor holds in/2 rows)."""
    if "kernel" in linear:
        return _shape(linear["kernel"])
    q = linear["q"]
    shape = _shape(q)
    if isinstance(q, torch.Tensor) and q.dtype == torch.uint8:
        return shape[:-2] + (2 * shape[-2], shape[-1])
    return shape


def _check_llama(tree, cfg):
    """The LLaMA-family tree's shapes that a wrong config gets wrong:
    the vocabulary, the head (absent when tied) and the KV width."""
    c, d = cfg.n_embd, cfg.head_dim
    want = {"wte": ((cfg.vocab_size, c), _shape(tree["wte"]["embedding"])),
            "h_0.attn.q": ((c, cfg.n_head * d),
                           _kernel_shape(tree["h_0"]["attn"]["q"])),
            "h_0.attn.k": ((c, cfg.n_kv_head * d),
                           _kernel_shape(tree["h_0"]["attn"]["k"]))}
    if cfg.tie_word_embeddings:
        if "lm_head" in tree:
            raise ValueError("a tied config's tree carries no lm_head")
    else:
        want["lm_head"] = ((c, cfg.vocab_size),
                           _kernel_shape(tree["lm_head"]))
    for name, (shape, got) in want.items():
        if got != shape:
            raise ValueError(f"{name} kernel is {got}, expected {shape}")


def _check_moe(tree, cfg):
    """An MoE tree's expert shapes (block 0): the router (C, E) and the
    first expert stack, (E, C, F) -- Mixtral's gated wg at d_ff, or
    GPT-MoE's wi at its ff_dim."""
    moe = tree["h_0"].get("moe")
    if moe is None:
        raise ValueError("an MoE config's blocks carry a 'moe' subtree")
    c = cfg.n_embd
    if hasattr(cfg, "n_expert"):
        e, stack, f = cfg.n_expert, "wg", cfg.d_ff
    else:
        e, stack, f = cfg.n_experts, "wi", cfg.ff_dim
    want = {"h_0.moe.router": ((c, e), _kernel_shape(moe["router"])),
            f"h_0.moe.{stack}": ((e, c, f), _shape(moe[stack]))}
    for name, (shape, got) in want.items():
        if got != shape:
            raise ValueError(f"{name} is {got}, expected {shape}")


def from_jax_params(tree, cfg, device, compute_dtype=None):
    """JAX-layout param tree (numpy or tensor leaves) of a GPTConfig or a
    LlamaConfig -> prepared tensors on `device` (gpt.prepare_stacked).
    Validates the layer count and the shapes a wrong config gets
    wrong. `compute_dtype` (torch.bfloat16 for bf16 compute) holds the
    matmul weights in that type (gpt.for_compute): the form the serving
    entry points run at that compute type."""
    from dnn_tpu_torch.models.llama import LlamaConfig

    missing = [f"h_{i}" for i in range(cfg.n_layer) if f"h_{i}" not in tree]
    if missing:
        raise ValueError(f"param tree lacks blocks {missing[:3]}...")
    if isinstance(cfg, LlamaConfig):
        _check_llama(tree, cfg)
    else:
        want = (cfg.n_embd, cfg.vocab_size)
        got = _kernel_shape(tree["lm_head"])
        if got != want:
            raise ValueError(f"lm_head kernel is {got}, expected {want}")
    if hasattr(cfg, "n_expert") or hasattr(cfg, "n_experts"):
        _check_moe(tree, cfg)
    return prepare_stacked(tree, cfg, device, compute_dtype)


def to_jax_params(prepared, cfg):
    """Prepared tensors -> the JAX-layout tree of numpy arrays: the
    stacked (L, ...) block leaves unstacked into "h_0".."h_{L-1}", every
    leaf detached and copied to the host in its own dtype."""

    def host(t):
        t = t.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()

    def walk(node, pick):
        if not isinstance(node, dict):
            return host(pick(node))
        out = {k: walk(v, pick) for k, v in node.items()}
        q = node.get("q")
        if isinstance(q, torch.Tensor) and q.dtype == torch.uint8:
            # packed int4 -> JAX's int4 leaf (ml_dtypes ships with jax)
            import ml_dtypes

            from dnn_tpu_torch.quant import unpack_int4

            out["q"] = host(unpack_int4(pick(q))).astype(ml_dtypes.int4)
        return out

    tree = {k: walk(v, lambda t: t) for k, v in prepared.items()
            if k != "blocks"}
    for i in range(cfg.n_layer):
        tree[f"h_{i}"] = walk(prepared["blocks"], lambda t, i=i: t[i])
    return tree


def load_npz(path: str):
    """Flat .npz with "/"-joined keys -> the nested JAX-layout tree."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def int4_cache_from_jax(cache, device="cpu"):
    """A JAX int4 KV cache -> the port's: K/V leaves (int4 values as int8,
    or ml_dtypes int4, numpy or JAX arrays of last dim D) packed two to a
    byte (cached_attention.pack_nibbles), every other leaf (the f32
    scales, a paged pool's int32 tables) as it is, all on `device`."""
    from dnn_tpu_torch.ops.cuda.cached_attention import pack_nibbles

    out = {}
    for name, leaf in cache.items():
        a = np.asarray(leaf)
        if name in ("k", "v"):
            out[name] = pack_nibbles(torch.from_numpy(a.astype(np.int8)))
        else:
            out[name] = torch.from_numpy(np.array(a))
        out[name] = out[name].to(device)
    return out


def int4_cache_to_jax(cache):
    """`int4_cache_from_jax`'s inverse: the port's int4 cache -> numpy
    leaves, K/V as their int4 values widened to int8 (last dim D; cast
    with .astype(ml_dtypes.int4), or jnp.int4, for a JAX cache)."""
    from dnn_tpu_torch.ops.cuda.cached_attention import unpack_nibbles

    out = {}
    for name, leaf in cache.items():
        t = leaf.detach().cpu()
        out[name] = (unpack_nibbles(t) if name in ("k", "v") else t).numpy()
    return out
