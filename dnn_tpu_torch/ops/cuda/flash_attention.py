"""Flash attention: the four hand-written CUDA kernels of the training
path and their plain PyTorch twins (port of
dnn_tpu/ops/pallas/flash_attention.py).

  * `flash_attention` — the public entry. Without a gradient it launches
    K1 (csrc/flash_attention.cu, replaces :_flash_kernel); with one it
    goes through `FlashAttentionFn`, whose forward launches K2 and whose
    backward launches K3 and K4 (the custom_vjp of :_flash_tpu).
  * `flash_attention_lse` (K2, csrc/flash_attention.cu with the lse
    store on; replaces :_fwd_lse_kernel) — the forward plus the per-row
    logsumexp, a plain (B, H, T) f32 (the TPU's lane-broadcast
    (bh, t, 128) layout does not carry over).
  * `flash_bwd_dq` (K3, csrc/flash_backward.cu; replaces
    :_bwd_dq_kernel) and `flash_bwd_dkv` (K4, same source; replaces
    :_bwd_dkv_kernel) — dQ and dK/dV from (q, k, v, dO, lse, D) with
    D = rowsum(dO * O) computed outside the kernels, as JAX does.

All four kernels run their products on the tensor cores (wgmma): in
bf16 directly, in f32 on operands split for f32 accuracy (the score
product as 3xTF32, the others as bf16 hi + lo, three products each).

Shapes: q (B, H, T, D); k, v (B, H, S, D); causal masking aligned
bottom-right (query t sees keys <= t + S - T). Inputs f32 or bf16, all
one dtype; outputs in that dtype; lse and D f32. Any T and S (ragged
edges are masked in the kernels); D in {32, 64, 128} on the card;
causal with S < T raises ValueError (JAX refuses to run it in the
kernel as well).

Dispatch is by the tensors' device and nothing else: CPU tensors run the
plain twins (float64 is admitted there, for gradcheck), CUDA tensors
launch the kernel or raise. No failure falls back. Each wrapper counts
its kernel launches in `.launches` and `.launches_by_dtype` ("f32",
"bf16"); `flash_attention`'s own count is K1's.
"""

from __future__ import annotations

import math

import torch

from dnn_tpu_torch.ops.cuda.cached_attention import _launch, _ptr, _same_device

_NEG_BIG = -1e30
_KIND = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16")}
HEAD_DIMS = (32, 64, 128)


# ----------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracle)
# ----------------------------------------------------------------------

def _keep(t: int, s: int, causal: bool, device):
    """(T, S) bool mask, bottom-right aligned (tril with k = S - T); None
    when not causal."""
    if not causal:
        return None
    return torch.ones(t, s, dtype=torch.bool, device=device).tril(s - t)


def _acc_dtype(dtype):
    """f32 for f32/bf16 inputs; f64 for f64 (the gradcheck path)."""
    return torch.promote_types(dtype, torch.float32)


def _scores(q, k, causal):
    """scale * q.k^T in the accumulation dtype, masked at -1e30."""
    acc = _acc_dtype(q.dtype)
    s = torch.einsum("bhtd,bhsd->bhts", q.to(acc), k.to(acc))
    s = s / math.sqrt(q.shape[-1])
    keep = _keep(q.shape[2], k.shape[2], causal, q.device)
    return s if keep is None else torch.where(keep, s, _NEG_BIG)


def reference_attention(q, k, v, *, causal=True):
    """JAX's reference_attention (flash_attention.py:35): scores in the
    inputs' dtype then f32, masked at -1e30, softmax, probabilities cast
    to v's dtype for the product with v."""
    d = q.shape[-1]
    s = torch.einsum("bhtd,bhsd->bhts", q, k).to(_acc_dtype(q.dtype))
    s = s / math.sqrt(d)
    keep = _keep(q.shape[2], k.shape[2], causal, q.device)
    if keep is not None:
        s = torch.where(keep, s, _NEG_BIG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p.to(v.dtype), v)


def reference_attention_lse(q, k, v, *, causal=True):
    """K2's plain twin: the forward in f32 (f64 for f64 inputs) from the
    inputs' values, output cast to their dtype, plus the row logsumexp
    (B, H, T) in the accumulation dtype."""
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhts,bhsd->bhtd", p, v.to(s.dtype))
    return out.to(q.dtype), lse


def _recompute_pds(q, k, v, do, lse, di, causal):
    """The backward recompute (JAX's _recompute_pds): P from the saved
    lse (0 where masked), dS = P * (dO.V^T - D). Accumulation dtype."""
    s = _scores(q, k, causal)
    p = torch.exp(s - lse[..., None].to(s.dtype))
    dp = torch.einsum("bhtd,bhsd->bhts", do.to(s.dtype), v.to(s.dtype))
    return p, p * (dp - di[..., None].to(s.dtype))


def reference_flash_bwd_dq(q, k, v, do, lse, di, *, causal=True):
    """K3's plain twin: dQ = scale * dS . K, in q's dtype."""
    _, ds = _recompute_pds(q, k, v, do, lse, di, causal)
    dq = torch.einsum("bhts,bhsd->bhtd", ds, k.to(ds.dtype))
    return (dq / math.sqrt(q.shape[-1])).to(q.dtype)


def reference_flash_bwd_dkv(q, k, v, do, lse, di, *, causal=True):
    """K4's plain twin: dK = scale * dS^T . Q, dV = P^T . dO, in k's and
    v's dtypes."""
    p, ds = _recompute_pds(q, k, v, do, lse, di, causal)
    dk = torch.einsum("bhts,bhtd->bhsd", ds, q.to(ds.dtype))
    dv = torch.einsum("bhts,bhtd->bhsd", p, do.to(p.dtype))
    return (dk / math.sqrt(q.shape[-1])).to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def _counted(fn):
    fn.launches = 0
    fn.launches_by_dtype = {"f32": 0, "bf16": 0}
    return fn


def _check(q, k, v, causal, *others):
    """Shapes, dtypes and device of a flash call. Returns (device, kind,
    dtype name); kind is None for a CPU float64 call."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected (B,H,T,D)/(B,H,S,D)")
    b, h, t, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, h, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if causal and k.shape[2] < t:
        raise ValueError(f"causal attention with S={k.shape[2]} < T={t} has "
                         "queries before the first key; not supported")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype, got {q.dtype}/"
                        f"{k.dtype}/{v.dtype}")
    dev = _same_device(q, k, v, *others)
    if q.dtype in _KIND:
        return (dev, *_KIND[q.dtype])
    if q.dtype == torch.float64 and dev.type == "cpu":
        return dev, None, None
    raise TypeError(f"flash attention takes float32 or bfloat16 (float64 on "
                    f"the CPU), got {q.dtype}")


def _check_kernel(d, *ts):
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors only")
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernel takes 16-byte aligned tensors")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dim in {HEAD_DIMS}, "
                         f"got {d}")


def _check_stats(q, *stats):
    for st in stats:
        if st.dtype != torch.float32 and not (
                q.dtype == torch.float64 and st.dtype == torch.float64):
            raise TypeError(f"lse and D must be float32, got {st.dtype}")
        if tuple(st.shape) != tuple(q.shape[:3]):
            raise ValueError(f"lse/D {tuple(st.shape)} must be "
                             f"{tuple(q.shape[:3])}")


def _forward(wrapper, q, k, v, causal, with_lse):
    """Launch the forward kernel (K1, or K2 when with_lse)."""
    dev, kind, dname = _check(q, k, v, causal)
    if dev.type == "cpu":
        if with_lse:
            return reference_attention_lse(q, k, v, causal=causal)
        return reference_attention(q, k, v, causal=causal)
    b, h, t, d = q.shape
    _check_kernel(d, q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=dev)
           if with_lse else None)
    _launch(wrapper, "flash_attention", dname, dev, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse), b * h, t,
            k.shape[2], d, int(causal), kind, 1.0 / math.sqrt(d))
    return (out, lse) if with_lse else out


@_counted
def flash_attention_lse(q, k, v, *, causal=True):
    """K2: (out, lse) — out in q's dtype, lse (B, H, T) f32. CPU tensors
    run `reference_attention_lse`."""
    return _forward(flash_attention_lse, q, k, v, causal, True)


@_counted
def flash_bwd_dq(q, k, v, do, lse, di, *, causal=True):
    """K3: dQ (B, H, T, D) in q's dtype from do (q's shape and dtype) and
    the f32 row statistics lse, di (B, H, T). CPU tensors run
    `reference_flash_bwd_dq`."""
    dev, kind, dname = _check(q, k, v, causal, do, lse, di)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q")
    _check_stats(q, lse, di)
    if dev.type == "cpu":
        return reference_flash_bwd_dq(q, k, v, do, lse, di, causal=causal)
    b, h, t, d = q.shape
    _check_kernel(d, q, k, v, do, lse, di)
    dq = torch.empty_like(q)
    _launch(flash_bwd_dq, "flash_bwd_dq", dname, dev, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dq.data_ptr(), b * h, t, k.shape[2], d,
            int(causal), kind, 1.0 / math.sqrt(d))
    return dq


@_counted
def flash_bwd_dkv(q, k, v, do, lse, di, *, causal=True):
    """K4: (dK, dV), each (B, H, S, D) in k's dtype. CPU tensors run
    `reference_flash_bwd_dkv`."""
    dev, kind, dname = _check(q, k, v, causal, do, lse, di)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q")
    _check_stats(q, lse, di)
    if dev.type == "cpu":
        return reference_flash_bwd_dkv(q, k, v, do, lse, di, causal=causal)
    b, h, t, d = q.shape
    _check_kernel(d, q, k, v, do, lse, di)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(flash_bwd_dkv, "flash_bwd_dkv", dname, dev, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, t,
            k.shape[2], d, int(causal), kind, 1.0 / math.sqrt(d))
    return dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a recompute backward (JAX's custom_vjp of
    _flash_tpu): the forward launches K2 and saves (q, k, v, o, lse); the
    backward forms D = rowsum(dO * O) in plain torch, in f32, and
    launches K3 and K4."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_lse(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()  # as JAX casts dO to q's dtype
        acc = _acc_dtype(q.dtype)
        di = (do.to(acc) * o.to(acc)).sum(dim=-1)
        dq = flash_bwd_dq(q, k, v, do, lse, di, causal=ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, causal=ctx.causal)
        return dq, dk, dv, None


@_counted
def flash_attention(q, k, v, *, causal=True):
    """(B, H, T, D) scaled-dot-product attention through the flash
    kernels. When autograd will need a gradient (grad mode on and any
    input requiring one) it runs `FlashAttentionFn` (K2 forward, K3/K4
    backward); otherwise K1. The choice is made here, before `apply`,
    because a Function's forward always runs with grad mode off.
    `.launches` counts K1 only. CPU tensors run the plain twins."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal)
    return _forward(flash_attention, q, k, v, causal, False)
