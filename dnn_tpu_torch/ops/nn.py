"""Core neural-net ops over parameter dicts (port of dnn_tpu/ops/nn.py).

Parameters keep the JAX package's layouts, so weights carry across
unchanged (dnn_tpu_torch/convert.py):
  linear:     {"kernel": (in_features, out_features), "bias": (out,)}
  layer_norm: {"scale": (dim,), "bias": (dim,)}
  embedding:  {"embedding": (vocab, dim)}
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(params, x, *, compute_dtype=None, accum_dtype=None):
    """x @ kernel + bias with the (in, out) kernel layout (JAX's
    ops/nn.linear :66). The product is a plain torch.matmul: a large
    dense product outside any kernel, as the JAX package left it to XLA.

    `compute_dtype` casts both operands (e.g. bf16); the bias is added in
    the product's dtype and the result cast back to x's dtype.
    `accum_dtype` instead keeps the accumulator dtype as the output: the
    operands are rounded to `compute_dtype` and multiplied in
    `accum_dtype` — the exact value of JAX's bf16 dot with
    preferred_element_type=f32 (a product of two bf16 values is exact in
    f32), at the cost of an f32 matmul on the card."""
    if "q" in params:
        raise NotImplementedError(
            "int8/int4 weight-quantized linears are not ported to "
            "dnn_tpu_torch yet (ROADMAP Queue 1 item 8, quant.py)")
    if "lora" in params:
        raise NotImplementedError(
            "LoRA adapters are not ported to dnn_tpu_torch yet (ROADMAP "
            "Queue 1 item 8, lora.py)")
    kernel = params["kernel"]
    orig_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        kernel = kernel.to(compute_dtype)
    if accum_dtype is not None:
        x, kernel = x.to(accum_dtype), kernel.to(accum_dtype)
    out = x @ kernel
    bias = params.get("bias")
    if bias is not None:
        out = out + bias.to(out.dtype)
    if accum_dtype is None and compute_dtype is not None:
        out = out.to(orig_dtype)
    return out


def gelu(x):
    """tanh-approximate GELU (the GPT-2 nonlinearity)."""
    return F.gelu(x, approximate="tanh")


def layer_norm(params, x, *, eps=1e-5):
    """LayerNorm over the last dim: biased variance, f32 statistics."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def embedding(params, ids):
    """Token/position embedding lookup."""
    return params["embedding"][ids]
