"""Cache-attention wrappers: the three hand-written CUDA kernels of the
serving path and their plain PyTorch twins.

  * `cached_attention` (K5, csrc/cached_attention.cu) — a prefill
    chunk's rows attend a preallocated cache with a runtime base
    position; replaces dnn_tpu/ops/pallas/cached_attention.py
    :_cached_attn_kernel.
  * `decode_attention` (K6, csrc/decode_attention.cu) — one decode step
    of every slot against its dense per-slot cache; replaces
    :_decode_attn_kernel.
  * `paged_decode_attention` (K7, csrc/paged_decode.cu) — one decode
    step of every slot through its block table into the shared pool;
    replaces :_paged_decode_kernel.

Each takes an f32, bf16 or int8 cache; an int8 cache comes with its
per-(position, head) f32 scales `ks`/`vs` (the K scale multiplies the
scores before 1/sqrt(D), the V scale the probabilities after the
softmax), a float cache with none. Every result is f32.

Dispatch is by the tensors' device and nothing else: CPU tensors run the
plain version (`reference_*`, the JAX package's reference math), CUDA
tensors launch the kernel or raise. No failure falls back. Each wrapper
counts its kernel launches in plain int attributes — `.launches` in
total and `.launches_by_dtype[{"f32", "bf16", "int8"}]` by cache type —
so a run can show that the serving path went through the kernels.
"""

from __future__ import annotations

import math

import torch

from dnn_tpu_torch.ops.cuda import _build

_NEG_BIG = -1e30
_KV_KIND = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16"),
            torch.int8: (2, "int8")}


# ----------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracle)
# ----------------------------------------------------------------------

def _scaled_softmax_attend(q, k, v, keep, ks, vs):
    """Scores q.k^T in f32 (times ks before / sqrt(D)), masked to `keep`
    at -1e30, softmax, probabilities times vs, then @ v. q (B, H, T, D);
    k/v (B, H, S, D); ks/vs (B, H, S) or None."""
    d = q.shape[-1]
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
    if ks is not None:
        s = s * ks[:, :, None, :]
    s = s / math.sqrt(d)
    p = torch.softmax(torch.where(keep, s, _NEG_BIG), dim=-1)
    if vs is not None:
        p = p * vs[:, :, None, :]
    return torch.einsum("bhts,bhsd->bhtd", p, v.float())


def reference_cached_attention(q, k, v, pos, *, ks=None, vs=None):
    """q (B, H, T, D) at absolute positions pos[b] + t; k/v (B, H, S, D)
    cache (float, or int8 with ks/vs (B, H, S) scales); pos (B,) int32.
    Row (b, t) attends columns <= pos[b] + t. Returns (B, H, T, D) f32."""
    cols = torch.arange(k.shape[2], device=q.device)
    rows = torch.arange(q.shape[2], device=q.device)
    limit = pos.long()[:, None, None, None] + rows[None, None, :, None]
    return _scaled_softmax_attend(q, k, v, cols <= limit, ks, vs)


def reference_decode_attention(q, k, v, pos, *, ks=None, vs=None):
    """q (B, Hk, R, D); every row of slot b attends cache columns
    <= pos[b] of k/v (B, Hk, S, D) (float, or int8 with ks/vs (B, Hk, S)
    scales). Returns (B, Hk, R, D) f32."""
    cols = torch.arange(k.shape[2], device=q.device)
    keep = cols <= pos.long()[:, None, None, None]
    return _scaled_softmax_attend(q, k, v, keep, ks, vs)


def gather_view(pool, tables):
    """Dense (B, Hk, nb_max * bp[, D]) view of every slot's logical
    cache out of a (n_blocks, Hk, bp[, D]) pool — K/V blocks and scale
    blocks alike; materialised, which is what the paged kernel exists to
    avoid."""
    b, nb = tables.shape
    g = pool[tables.reshape(-1).long()]  # (B * nb, Hk, bp[, D])
    hk, bp = g.shape[1], g.shape[2]
    g = g.reshape(b, nb, hk, bp, *g.shape[3:]).transpose(1, 2)
    return g.reshape(b, hk, nb * bp, *g.shape[4:])


def reference_paged_decode_attention(q, kp, vp, tables, pos, *, ks=None,
                                     vs=None):
    """Oracle for the paged kernel: gather the dense views (scale blocks
    (n_blocks, Hk, bp) too), then the dense decode reference. Returns
    (B, Hk, R, D) f32."""
    return reference_decode_attention(
        q, gather_view(kp, tables), gather_view(vp, tables), pos,
        ks=None if ks is None else gather_view(ks, tables),
        vs=None if vs is None else gather_view(vs, tables))


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def _same_device(*ts):
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_dtypes(q, k, v, pos, ks, vs):
    """Returns (kv_kind, dtype name) of the cache."""
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if k.dtype != v.dtype or k.dtype not in _KV_KIND:
        raise TypeError(f"k/v must share float32, bfloat16 or int8, got "
                        f"{k.dtype}/{v.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError(f"pos must be int32, got {pos.dtype}")
    if k.dtype == torch.int8:
        if ks is None or vs is None:
            raise TypeError("an int8 cache needs both scale tensors ks/vs")
        if ks.dtype != torch.float32 or vs.dtype != torch.float32:
            raise TypeError(f"ks/vs must be float32, got {ks.dtype}/{vs.dtype}")
        if ks.shape != k.shape[:-1] or vs.shape != k.shape[:-1]:
            raise ValueError(f"ks/vs {tuple(ks.shape)}/{tuple(vs.shape)} must "
                             f"be the cache's {tuple(k.shape[:-1])}")
    elif ks is not None or vs is not None:
        raise TypeError(f"scales ks/vs go with an int8 cache, not {k.dtype}")
    return _KV_KIND[k.dtype]


def _check_kernel_args(ts, *, d, dims, aligned=()):
    """What the CUDA kernel takes: contiguous tensors, head dim in
    `dims`, and 16-byte aligned data for the `aligned` ones (the kernel
    reads them with vector loads)."""
    for t in ts:
        if t is not None and not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors only")
    for t in aligned:
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernel takes 16-byte aligned q/k/v")
    if d not in dims:
        raise ValueError(f"the CUDA kernel takes head dim in {dims}, got {d}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(wrapper, name, dtype_name, dev, *args):
    """Call kernel `name` on the current stream of `dev`; raise on a
    refused launch; count it."""
    fn = _build.load(name)
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: "
                           f"cudaError {rc}")
    wrapper.launches += 1
    wrapper.launches_by_dtype[dtype_name] += 1


def _counted(fn):
    fn.launches = 0
    fn.launches_by_dtype = {"f32": 0, "bf16": 0, "int8": 0}
    return fn


@_counted
def cached_attention(q, k, v, pos, *, ks=None, vs=None):
    """K5. q (B, H, T, D) f32; k/v (B, H, S, D) f32 or bf16, or int8 with
    ks/vs (B, H, S) f32 scales; pos (B,) int32 base positions (row t
    attends columns <= pos[b] + t). Returns (B, H, T, D) f32. CPU tensors
    run `reference_cached_attention`."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (B,H,T,D)/(B,H,S,D)")
    b, h, t, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, h, d):
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    kind, dname = _check_dtypes(q, k, v, pos, ks, vs)
    dev = _same_device(q, k, v, pos, ks, vs)
    if dev.type == "cpu":
        return reference_cached_attention(q, k, v, pos, ks=ks, vs=vs)
    _check_kernel_args((q, k, v, pos, ks, vs), d=d, dims=(32, 64),
                       aligned=(q, k, v))
    out = torch.empty((b, h, t, d), dtype=torch.float32, device=dev)
    _launch(cached_attention, "cached_attention", dname, dev,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs),
            pos.data_ptr(), out.data_ptr(), b * h, h, t, k.shape[2], d,
            kind, 1.0 / math.sqrt(d))
    return out


@_counted
def decode_attention(q, k, v, pos, *, ks=None, vs=None):
    """K6. q (B, Hk, R, D) f32 — R rows per KV head, all attending cache
    columns <= pos[b] (a pos at or past S attends the whole cache);
    k/v (B, Hk, S, D) f32 or bf16, or int8 with ks/vs (B, Hk, S) f32
    scales; pos (B,) int32. Returns (B, Hk, R, D) f32. CPU tensors run
    `reference_decode_attention`."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (B,Hk,R,D)/"
                         "(B,Hk,S,D)")
    b, hk, r, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, hk, d):
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    kind, dname = _check_dtypes(q, k, v, pos, ks, vs)
    dev = _same_device(q, k, v, pos, ks, vs)
    if dev.type == "cpu":
        return reference_decode_attention(q, k, v, pos, ks=ks, vs=vs)
    _check_kernel_args((q, k, v, pos, ks, vs), d=d, dims=(32, 64, 128),
                       aligned=(q, k, v))
    out = torch.empty((b, hk, r, d), dtype=torch.float32, device=dev)
    _launch(decode_attention, "decode_attention", dname, dev,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs),
            pos.data_ptr(), out.data_ptr(), b, hk, r, k.shape[2], d, kind,
            1.0 / math.sqrt(d))
    return out


@_counted
def paged_decode_attention(q, kp, vp, tables, pos, *, ks=None, vs=None):
    """K7. q (B, Hk, R, D) f32 — R rows per KV head, all attending
    logical columns <= pos[b]; kp/vp (n_blocks, Hk, bp, D) f32 or bf16
    pool, or int8 with ks/vs (n_blocks, Hk, bp) f32 scale blocks; tables
    (B, nb_max) int32 logical -> physical block; pos (B,) int32. Returns
    (B, Hk, R, D) f32. CPU tensors run
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
    kind, dname = _check_dtypes(q, kp, vp, pos, ks, vs)
    dev = _same_device(q, kp, vp, tables, pos, ks, vs)
    if dev.type == "cpu":
        return reference_paged_decode_attention(q, kp, vp, tables, pos,
                                                ks=ks, vs=vs)
    _check_kernel_args((q, kp, vp, tables, pos, ks, vs), d=d,
                       dims=(32, 64, 128))
    out = torch.empty((b, hk, r, d), dtype=torch.float32, device=dev)
    _launch(paged_decode_attention, "paged_decode", dname, dev,
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), _ptr(ks), _ptr(vs),
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(), b, hk, r, d,
            kp.shape[2], tables.shape[1], kind, 1.0 / math.sqrt(d))
    return out
