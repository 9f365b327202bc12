"""Core neural-net ops over parameter dicts (port of dnn_tpu/ops/nn.py).

Parameters keep the JAX package's layouts, so weights carry across
unchanged (dnn_tpu_torch/convert.py):
  linear:     {"kernel": (in_features, out_features), "bias": (out,)}
  layer_norm: {"scale": (dim,), "bias": (dim,)}
  embedding:  {"embedding": (vocab, dim)}
  conv2d:     {"kernel": (kh, kw, in, out) HWIO, "bias": (out,)}, NHWC
              activations
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(params, x, *, stride=(1, 1), padding="SAME", compute_dtype=None):
    """2-D convolution over NHWC activations with an HWIO kernel (JAX's
    ops/nn.conv2d :27), returning NHWC. "SAME" pads (k - 1) // 2 on each
    side (k3 s1: pad 1), "VALID" none. Inside it is F.conv2d on
    NCHW/OIHW permutes: the JAX package leaves convolution to XLA,
    outside any kernel, as `linear` leaves its product to a matmul."""
    kernel = params["kernel"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        kernel = kernel.to(compute_dtype)
    kh, kw = kernel.shape[:2]
    if padding == "SAME":
        if tuple(stride) != (1, 1) or kh % 2 == 0 or kw % 2 == 0:
            raise NotImplementedError(
                "conv2d SAME padding is ported for odd kernels at stride 1")
        pad = ((kh - 1) // 2, (kw - 1) // 2)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    out = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                   stride=tuple(stride), padding=pad)
    out = out.permute(0, 2, 3, 1)
    bias = params.get("bias")
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def max_pool2d(x, *, window=(2, 2), stride=(2, 2)):
    """Max pooling over the spatial dims of an NHWC tensor, VALID (JAX's
    ops/nn.max_pool2d :50)."""
    out = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=tuple(window),
                       stride=tuple(stride))
    return out.permute(0, 2, 3, 1)


def relu(x):
    return torch.relu(x)


def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


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
    """tanh-approximate GELU (the GPT-2 nonlinearity; Gemma's GeGLU and
    Phi's MLP use it too)."""
    return F.gelu(x, approximate="tanh")


def silu(x):
    """SiLU / swish (the LLaMA-family gate nonlinearity)."""
    return F.silu(x)


def rms_norm(params, x, *, eps=1e-6, plus_one=False):
    """RMSNorm over the last dim (JAX's ops/nn.rms_norm :241): no mean
    subtraction, no bias, f32 statistics. `plus_one=True` scales by
    (1 + w), the Gemma convention of zero-centred scales."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    scale = params["scale"].float()
    if plus_one:
        scale = 1.0 + scale
    return (y * scale).to(x.dtype)


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
