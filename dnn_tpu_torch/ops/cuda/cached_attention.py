"""Cache-attention wrappers: the two hand-written CUDA kernels of the
serving path and their plain PyTorch twins.

  * `cached_attention` (K5, csrc/cached_attention.cu) — a prefill
    chunk's rows attend a preallocated cache with a runtime base
    position; replaces dnn_tpu/ops/pallas/cached_attention.py
    :_cached_attn_kernel.
  * `paged_decode_attention` (K7, csrc/paged_decode.cu) — one decode
    step of every slot through its block table into the shared pool;
    replaces :_paged_decode_kernel.

Dispatch is by the tensors' device and nothing else: CPU tensors run the
plain version (`reference_*`, the JAX package's reference math), CUDA
tensors launch the kernel or raise. No failure falls back. Each wrapper
counts its kernel launches in a plain int attribute (`.launches`), so a
run can show that the serving path went through the kernels.
"""

from __future__ import annotations

import math

import torch

from dnn_tpu_torch.ops.cuda import _build

_NEG_BIG = -1e30
_KV_DTYPES = (torch.float32, torch.bfloat16)


# ----------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracle)
# ----------------------------------------------------------------------

def reference_cached_attention(q, k, v, pos):
    """q (B, H, T, D) at absolute positions pos[b] + t; k/v (B, H, S, D)
    cache; pos (B,) int32. Row (b, t) attends columns <= pos[b] + t.
    Returns (B, H, T, D) f32."""
    d = q.shape[-1]
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) / math.sqrt(d)
    cols = torch.arange(k.shape[2], device=q.device)
    rows = torch.arange(q.shape[2], device=q.device)
    limit = pos.long()[:, None, None, None] + rows[None, None, :, None]
    s = torch.where(cols <= limit, s, _NEG_BIG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, v.float())


def reference_decode_attention(q, k, v, pos):
    """q (B, Hk, R, D); every row of slot b attends cache columns
    <= pos[b] of k/v (B, Hk, S, D). Returns (B, Hk, R, D) f32."""
    d = q.shape[-1]
    s = torch.einsum("bhrd,bhsd->bhrs", q.float(), k.float()) / math.sqrt(d)
    cols = torch.arange(k.shape[2], device=q.device)
    s = torch.where(cols <= pos.long()[:, None, None, None], s, _NEG_BIG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhrs,bhsd->bhrd", p, v.float())


def gather_view(pool, tables):
    """Dense (B, Hk, nb_max * bp, D) view of every slot's logical cache
    out of a (n_blocks, Hk, bp, D) pool — materialised, which is what
    the paged kernel exists to avoid."""
    b, nb = tables.shape
    g = pool[tables.reshape(-1).long()]  # (B * nb, Hk, bp, D)
    hk, bp = g.shape[1], g.shape[2]
    g = g.reshape(b, nb, hk, bp, *g.shape[3:]).transpose(1, 2)
    return g.reshape(b, hk, nb * bp, *g.shape[4:])


def reference_paged_decode_attention(q, kp, vp, tables, pos):
    """Oracle for the paged kernel: gather the dense view, then the
    dense decode reference. Returns (B, Hk, R, D) f32."""
    return reference_decode_attention(
        q, gather_view(kp, tables), gather_view(vp, tables), pos)


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def _same_device(*ts):
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_dtypes(q, k, v, pos):
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if k.dtype != v.dtype or k.dtype not in _KV_DTYPES:
        raise TypeError(f"k/v must share float32 or bfloat16, got "
                        f"{k.dtype}/{v.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError(f"pos must be int32, got {pos.dtype}")


def _check_kernel_args(ts, *, d, dims, aligned=()):
    """What the CUDA kernel takes: contiguous tensors, head dim in
    `dims`, and 16-byte aligned data for the `aligned` ones (the kernel
    reads them with vector loads)."""
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors only")
    for t in aligned:
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernel takes 16-byte aligned q/k/v")
    if d not in dims:
        raise ValueError(f"the CUDA kernel takes head dim in {dims}, got {d}")


def cached_attention(q, k, v, pos):
    """K5. q (B, H, T, D) f32; k/v (B, H, S, D) f32 or bf16; pos (B,)
    int32 base positions (row t attends columns <= pos[b] + t). Returns
    (B, H, T, D) f32. CPU tensors run `reference_cached_attention`."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (B,H,T,D)/(B,H,S,D)")
    b, h, t, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, h, d):
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    _check_dtypes(q, k, v, pos)
    dev = _same_device(q, k, v, pos)
    if dev.type == "cpu":
        return reference_cached_attention(q, k, v, pos)
    _check_kernel_args((q, k, v, pos), d=d, dims=(32, 64), aligned=(q, k, v))
    fn = _build.load("cached_attention")
    out = torch.empty((b, h, t, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                out.data_ptr(), b * h, h, t, k.shape[2], d,
                int(k.dtype == torch.bfloat16), 1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(f"cached_attention kernel launch failed: "
                           f"cudaError {rc}")
    cached_attention.launches += 1
    return out


cached_attention.launches = 0


def paged_decode_attention(q, kp, vp, tables, pos):
    """K7. q (B, Hk, R, D) f32 — R rows per KV head, all attending
    logical columns <= pos[b]; kp/vp (n_blocks, Hk, bp, D) f32 or bf16
    pool; tables (B, nb_max) int32 logical -> physical block; pos (B,)
    int32. Returns (B, Hk, R, D) f32. CPU tensors run
    `reference_paged_decode_attention`."""
    if q.dim() != 4 or kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError(f"q {tuple(q.shape)}, pool {tuple(kp.shape)}/"
                         f"{tuple(vp.shape)}: expected (B,Hk,R,D)/"
                         "(n_blocks,Hk,bp,D)")
    b, hk, r, d = q.shape
    if (kp.shape[1], kp.shape[3]) != (hk, d):
        raise ValueError(f"pool {tuple(kp.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"tables must be ({b}, nb_max), got "
                         f"{tuple(tables.shape)}")
    if tables.dtype != torch.int32:
        raise TypeError(f"tables must be int32, got {tables.dtype}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    _check_dtypes(q, kp, vp, pos)
    dev = _same_device(q, kp, vp, tables, pos)
    if dev.type == "cpu":
        return reference_paged_decode_attention(q, kp, vp, tables, pos)
    _check_kernel_args((q, kp, vp, tables, pos), d=d, dims=(32, 64, 128))
    fn = _build.load("paged_decode")
    out = torch.empty((b, hk, r, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
                b, hk, r, d, kp.shape[2], tables.shape[1],
                int(kp.dtype == torch.bfloat16), 1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"cudaError {rc}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
