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


_MM_OUT_DTYPE: dict = {}


def mm_out_dtype(device) -> bool:
    """Whether this torch multiplies bf16 operands into an f32 output
    in one call on `device` (torch.mm(..., out_dtype=)), probed once per
    device type on a 1x1 product. CUDA builds of recent torch have it;
    the CPU kernel does not exist."""
    key = torch.device(device).type
    if key not in _MM_OUT_DTYPE:
        a = torch.ones((1, 1), dtype=torch.bfloat16, device=device)
        try:
            torch.mm(a, a, out_dtype=torch.float32)
            _MM_OUT_DTYPE[key] = True
        except (RuntimeError, TypeError, NotImplementedError):
            _MM_OUT_DTYPE[key] = False
    return _MM_OUT_DTYPE[key]


def _dot(x, kernel, accum_dtype):
    """x @ kernel, both already in the compute type, into `accum_dtype`
    when given (see `linear`)."""
    if accum_dtype is None:
        return x @ kernel
    if (x.dtype == kernel.dtype != accum_dtype
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or kernel.requires_grad))
            and mm_out_dtype(x.device)):
        return torch.mm(x.reshape(-1, x.shape[-1]), kernel,
                        out_dtype=accum_dtype).reshape(*x.shape[:-1],
                                                       kernel.shape[-1])
    return x.to(accum_dtype) @ kernel.to(accum_dtype)


def linear(params, x, *, compute_dtype=None, accum_dtype=None):
    """x @ kernel + bias with the (in, out) kernel layout (JAX's
    ops/nn.linear :66). The product is a plain torch.matmul: a large
    dense product outside any kernel, as the JAX package left it to XLA.

    `compute_dtype` casts both operands (e.g. bf16); the bias is added in
    the product's dtype and the result cast back to x's dtype. A kernel
    already held in `compute_dtype` (the served weights,
    gpt.for_compute) is not copied: `.to` of a tensor already of the type
    is the tensor itself.
    `accum_dtype` instead keeps the accumulator dtype as the output: the
    operands are rounded to `compute_dtype` and multiplied into
    `accum_dtype` — the exact value of JAX's bf16 dot with
    preferred_element_type=f32 (a product of two bf16 values is exact in
    f32). Without autograd, on a device where `mm_out_dtype` holds, that
    is one bf16 x bf16 -> f32 product; otherwise an f32 matmul of the
    rounded operands.

    Weight-only quantized params ({"q", "scale", "bias"?}, quant.py)
    take `_linear_int8` (q int8) or `_linear_int4` (q packed uint8). A
    "lora" entry ({a, b, sel}, lora.lora_view) adds the selected
    adapter's low-rank delta on top of either base, float or quantized
    (`_lora_delta`)."""
    lora = params.get("lora")
    if "q" in params:
        base = (_linear_int4 if params["q"].dtype == torch.uint8
                else _linear_int8)
        out = base(params, x, compute_dtype=compute_dtype,
                   accum_dtype=accum_dtype)
        if lora is not None:
            out = out + _lora_delta(lora, x, compute_dtype).to(out.dtype)
        return out
    kernel = params["kernel"]
    orig_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        kernel = kernel.to(compute_dtype)
    out = _dot(x, kernel, accum_dtype)
    bias = params.get("bias")
    if bias is not None:
        out = out + bias.to(out.dtype)
    if lora is not None:
        out = out + _lora_delta(lora, x, compute_dtype).to(out.dtype)
    if accum_dtype is None and compute_dtype is not None:
        out = out.to(orig_dtype)
    return out


def _lora_delta(lora, x, compute_dtype):
    """The per-row low-rank delta of multi-adapter serving (JAX's
    ops/nn._lora_delta): x (B, T, C) against the adapter stacks a
    (N, C, r) and b (N, r, O), row b taking the adapter its one-hot
    sel (B, N) names. Every adapter's products are computed and then
    masked by sel and summed over the adapter axis (a one-hot product
    and a sum with zeros are exact): N times the rank-r work, but static
    shapes and no gather of weight-sized operands, so a captured step
    reads a new assignment from the sel buffer it was captured over."""
    dt = compute_dtype if compute_dtype is not None else x.dtype
    sel = lora["sel"].to(dt)[:, :, None, None]          # (B, N, 1, 1)
    xa = torch.matmul(x.to(dt)[:, None], lora["a"].to(dt)[None])
    xa = (xa * sel).sum(dim=1)                           # (B, T, r)
    y = torch.matmul(xa[:, None], lora["b"].to(dt)[None])
    return (y * sel).sum(dim=1)                          # (B, T, O)


def _linear_int8(params, x, *, compute_dtype=None, accum_dtype=None):
    """Weight-only int8 dense layer, in JAX's order: (x @ q) * scale +
    bias, the product of x and q cast to the compute type into the
    accumulator type, the per-output-channel scale on the product's
    columns. A dequantize and a torch product: JAX computes it with an
    XLA dot outside any kernel."""
    q = params["q"]
    orig_dtype = x.dtype
    cd = compute_dtype if compute_dtype is not None else x.dtype
    acc = accum_dtype if accum_dtype is not None else cd
    out = _dot(x.to(cd), q.to(cd), accum_dtype)
    out = out * params["scale"][..., 0, :].to(acc)
    bias = params.get("bias")
    if bias is not None:
        out = out + bias.to(out.dtype)
    if accum_dtype is None and compute_dtype is not None:
        out = out.to(orig_dtype)
    return out


def _linear_int4(params, x, *, compute_dtype=None, accum_dtype=None):
    """Weight-only group-wise int4 dense layer (JAX's _linear_int4): q
    packed (in/2, out), scale (in/group, out). Group scales do not
    commute with the whole contraction, so the product runs per group
    and the scales apply before the group sum: out = sum_G (x_G @ q_G) *
    scale_G + bias."""
    from dnn_tpu_torch.quant import unpack_int4

    scale = params["scale"]
    orig_dtype = x.dtype
    cd = compute_dtype if compute_dtype is not None else x.dtype
    acc = accum_dtype if accum_dtype is not None else cd
    q = unpack_int4(params["q"])
    in_dim, out_dim = q.shape[-2], q.shape[-1]
    g_count = scale.shape[-2]
    gsz = in_dim // g_count
    lead = x.shape[:-1]
    xg = x.reshape(-1, g_count, gsz).to(cd).transpose(0, 1)  # (G, N, gsz)
    qg = q.reshape(g_count, gsz, out_dim).to(cd)
    out = torch.matmul(xg.to(acc), qg.to(acc))              # (G, N, out)
    out = (out * scale.to(acc)[:, None, :]).sum(dim=0)
    out = out.reshape(*lead, out_dim)
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
