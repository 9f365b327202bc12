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


def linear(params, x):
    """x @ kernel + bias with the (in, out) kernel layout. The product
    is a plain torch.matmul: a large dense product outside any kernel,
    as the JAX package left it to XLA."""
    out = x @ params["kernel"]
    bias = params.get("bias")
    if bias is not None:
        out = out + bias
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
