"""Weight-only int8 and int4 quantization for serving (port of
dnn_tpu/quant.py).

The scheme is the JAX package's, bit for bit:
  * int8: symmetric per output channel. For an (in, out) kernel — or a
    stacked (L, in, out) one, per layer — `scale = max|W[:, j]| / 127`
    (1 where the column is all zero) and `q = round(W / scale)` clipped
    at +-127, the division done as a division (not a product with the
    reciprocal) and the rounding half to even, as jnp.round.
  * int4: group-wise symmetric, one scale per (group of `group` input
    channels, output channel), levels +-7. The values are stored PACKED
    two to a byte along the input dim: a uint8 q of shape (..., in/2,
    out) whose low nibble holds input row 2i and high nibble row 2i + 1,
    each a two's-complement nibble. So a packed leaf costs half a byte
    an element, as JAX's native int4 costs on the TPU, and `param_bytes`
    equals JAX's `tree_weight_bytes`.
  * A quantized linear is {"q", "scale", "bias"?} in place of {"kernel",
    "bias"?}; ops/nn.linear dispatches on q's dtype (int8, or uint8 for
    packed int4). Embeddings, norms and biases stay f32.

`convert.from_jax_params` takes JAX's quantized trees (int8 leaves, and
ml_dtypes int4 leaves, which it packs), and `convert.to_jax_params`
gives them back.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from dnn_tpu_torch.utils.flops import tree_weight_bytes

__all__ = [
    "INT4_GROUP",
    "quantize_tensor",
    "quantize_tensor_int4",
    "dequantize_tensor",
    "pack_int4",
    "unpack_int4",
    "quantize_linear",
    "quantize_tree",
    "quantize_gpt",
    "param_bytes",
]

INT4_GROUP = 64  # input channels per int4 scale group (JAX's default)


def _quantize(w, levels: float, reduce_axis: int):
    """(round(w / scale) clipped at +-levels as int8, f32 scale kept at
    size 1 on `reduce_axis`), JAX's arithmetic: amax / levels, a true
    division of w by the scale, round half to even."""
    w = w.float()
    amax = w.abs().amax(dim=reduce_axis, keepdim=True)
    scale = torch.where(amax > 0, amax / float(levels),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -levels, levels)
    return q.to(torch.int8), scale


def quantize_tensor(w, *, axis: int = -2):
    """Symmetric int8 quantization of `w` with scales reduced over `axis`
    (kept as size 1). The default is the contraction dim of an (in, out)
    or stacked (L, in, out) kernel: per-output-channel (and per-layer)
    scales. A stacked kernel (a layer or an expert axis in front) is
    quantized one slice of its leading axis at a time (the scales never
    mix slices, so the result is the same), which bounds the f32
    temporaries at one slice's."""
    ax = axis % w.ndim
    if w.ndim >= 3 and ax != 0:
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        sshape = list(w.shape)
        sshape[ax] = 1
        scale = torch.empty(sshape, dtype=torch.float32, device=w.device)
        for i in range(w.shape[0]):
            q[i], scale[i] = quantize_tensor(w[i], axis=ax - 1)
        return q, scale
    return _quantize(w, 127, ax)


def dequantize_tensor(q, scale, dtype=torch.float32):
    """int8 q and its scales -> w = q * scale."""
    return (q.float() * scale).to(dtype)


def pack_int4(vals):
    """int values in [-8, 7] of shape (..., in, out), `in` even -> uint8
    (..., in/2, out): row 2i in the low nibble, row 2i + 1 in the high."""
    if vals.shape[-2] % 2:
        raise ValueError(f"int4 packing needs an even input dim, got "
                         f"{vals.shape[-2]}")
    v = vals.to(torch.int16) & 0xF
    lo, hi = v[..., 0::2, :], v[..., 1::2, :]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(packed):
    """pack_int4's inverse: uint8 (..., in/2, out) -> int8 (..., in,
    out), each nibble sign-extended."""
    b = packed.to(torch.int16)
    lo = ((b & 0xF) ^ 8) - 8
    hi = (((b >> 4) & 0xF) ^ 8) - 8
    out = torch.stack([lo, hi], dim=-2)  # (..., in/2, 2, out)
    return out.reshape(*packed.shape[:-2], 2 * packed.shape[-2],
                       packed.shape[-1]).to(torch.int8)


def quantize_tensor_int4(w, *, group: int = INT4_GROUP):
    """Group-wise symmetric int4 (JAX's quantize_tensor_int4): returns
    (q packed uint8 (..., in/2, out), scale (..., in/group, out) f32).
    The values and scales are JAX's bit for bit."""
    in_dim = w.shape[-2]
    if in_dim % group:
        raise ValueError(
            f"input dim {in_dim} not divisible by int4 group {group}")
    g_count = in_dim // group
    wg = w.reshape(*w.shape[:-2], g_count, group, w.shape[-1])
    q, scale = _quantize(wg, 7, -2)
    return pack_int4(q.reshape(w.shape)), scale[..., 0, :]


def quantize_linear(params, *, bits: int = 8, int4_group: int = INT4_GROUP):
    """{"kernel", "bias"?} -> {"q", "scale", "bias"?}; bits=4 selects the
    group-wise int4 scheme."""
    if bits == 4:
        q, scale = quantize_tensor_int4(params["kernel"], group=int4_group)
    elif bits == 8:
        q, scale = quantize_tensor(params["kernel"])
    else:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    out = {"q": q, "scale": scale}
    if "bias" in params:
        out["bias"] = params["bias"]
    return out


def _default_should_quantize(path: str, kernel) -> bool:
    """Matmul kernels only (2-D, or 3-D layer-stacked) of at least 32 in
    both matrix dims; a MoE router stays f32 (JAX's rule)."""
    if path.endswith("/router"):
        return False
    return kernel.ndim in (2, 3) and min(kernel.shape[-2:]) >= 32


def quantize_tree(params, *, should_quantize: Optional[Callable] = None,
                  bits: int = 8, int4_group: int = INT4_GROUP):
    """Walk a tree of nested dicts of tensors and replace every
    {"kernel": ...} linear the predicate accepts (called with the
    "/"-joined path and the kernel) with its quantized form. Raw
    per-layer trees and `prepare_stacked` trees alike; other leaves pass
    through. A new tree is returned; the input's leaves are shared, not
    copied.

    MoE expert stacks (JAX :151-177) are found by their structure: a
    dict holding raw float `wi`/`wo` (parallel/moe.init_moe) or
    `wg`/`wu`/`wd` (init_moe_gated) arrays, 3-D (E, in, out) or 4-D
    stacked (L, E, in, out). They become int8 with per-(expert, channel)
    `*_scale` keys whatever `bits` is (the routed FFN has no int4 path),
    and the predicate is not asked. An int8 stack, or one that already
    has its scales, is left as it is, so the rule is idempotent; the
    router stays f32 (`_default_should_quantize`)."""
    pred = should_quantize or _default_should_quantize

    def walk(node, path):
        if isinstance(node, dict):
            if "kernel" in node and hasattr(node["kernel"], "ndim"):
                if pred(path, node["kernel"]):
                    return quantize_linear(node, bits=bits,
                                           int4_group=int4_group)
                return node
            for ks in (("wi", "wo"), ("wg", "wu", "wd")):
                if all(k in node and hasattr(node[k], "ndim")
                       and node[k].ndim in (3, 4)
                       and node[k].is_floating_point()
                       and k + "_scale" not in node for k in ks):
                    out = {k: walk(v, f"{path}/{k}")
                           for k, v in node.items() if k not in ks}
                    for k in ks:
                        out[k], out[k + "_scale"] = quantize_tensor(node[k])
                    return out
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        return node

    return walk(params, "")


def quantize_gpt(prepared, *, quantize_head: bool = True, bits: int = 8,
                 int4_group: int = INT4_GROUP):
    """Quantize a GPT- or LLaMA-family tree (raw or stacked): the block
    linears and, unless `quantize_head=False`, the lm_head. A tied head
    (no "lm_head" leaf) stays the f32 embedding, as in JAX."""

    def pred(path, kernel):
        if not _default_should_quantize(path, kernel):
            return False
        if "lm_head" in path:
            return quantize_head
        return True

    return quantize_tree(prepared, should_quantize=pred, bits=bits,
                         int4_group=int4_group)


def param_bytes(tree) -> int:
    """Device bytes of every tensor leaf (packed int4 at half a byte an
    element, scales at f32): JAX's `param_bytes` of the same tree."""
    return int(tree_weight_bytes(tree))
