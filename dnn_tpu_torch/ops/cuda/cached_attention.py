"""Cache-attention wrappers: the three hand-written CUDA kernels of the
serving path and their plain PyTorch twins.

  * `cached_attention` (K5, csrc/cached_attention.cu) — a prefill
    chunk's rows attend a preallocated cache with a runtime base
    position; replaces dnn_tpu/ops/pallas/cached_attention.py
    :_cached_attn_kernel. The cache may hold fewer heads than q
    (grouped-query attention): query head h reads KV head h / G. Both products run on the tensor cores over a
    split-KV grid (`k5_split`); one call launches the split kernel and,
    where the keys fall into more than one split, the merge kernel.
  * `decode_attention` (K6, csrc/decode_attention.cu) — one decode step
    of every slot against its dense per-slot cache; replaces
    :_decode_attn_kernel.
  * `paged_decode_attention` (K7, csrc/paged_decode.cu) — one decode
    step of every slot through its block table into the shared pool;
    replaces :_paged_decode_kernel.
    K6 and K7 share one body (csrc/decode_split.cuh): a split-KV grid
    (`decode_split`), each block all R query rows of one KV head over
    one range of keys, and a merge kernel where the keys fall into more
    than one split.

Each takes an f32, bf16, int8 or int4 cache; a quantized cache comes
with its per-(position, head) f32 scales `ks`/`vs` (the K scale
multiplies the scores before 1/sqrt(D), the V scale the probabilities
after the softmax), a float cache with none. An int4 cache is uint8 of
last dim D / 2: two values a byte, element 2i in the low nibble and 2i +
1 in the high one, two's complement (`pack_nibbles`; the block wire's
nibble order, kvtier/migrate.py). Its kernels widen each nibble with its
sign and then run the int8 math; its plain versions unpack to int8
values (`unpack_nibbles`) and run the int8 plain math. q is f32, or bf16 under bf16 compute;
the result is of q's type (the kernels read a bf16 q as it is and write
a bf16 output; no cast is launched for either). Scores, softmax and
accumulation are f32 for every type. Head dims 32, 64, 128 and 256
(Gemma).

`window=W` (all three; Mistral's and Gemma-2's sliding windows) adds the
band's lower bound: a row whose causal limit is L attends only the
columns after L - W (`band_keep`, the JAX codecs' predicate); the kernels
skip the columns before the band, never reading them. `softcap=c` (K5
and K6; Gemma-2) caps every score s, after the int8 K scale and the
1/sqrt(D) scale and before the mask, at c * tanh(s / c). A window of at
least the cache's length bands nothing and launches the plain kernel.

Dispatch is by the tensors' device and nothing else: CPU tensors run the
plain version (`reference_*`, the JAX package's reference math), CUDA
tensors launch the kernel or raise. No failure falls back. Each wrapper
counts its calls that launch kernels in plain int attributes —
`.launches` in total, `.launches_by_dtype[{"f32", "bf16", "int8", "int4"}]` by
cache type, one per call, `.launches_bf16_q` by cache type, the calls
among those with a bf16 q, and `.launches_by_variant[{"band",
"softcap", "d256"}]` by cache type, the calls with a window, with a
softcap and at head dim 256 — so a run can show that the serving path
went through the kernels. A call made while a CUDA graph is being
captured launches nothing then: under `recording_launches(log)` it is
written to the `LaunchLog`, and `log.replayed()` counts every recorded
launch once per replay of the graph; without a log it is not counted.
"""

from __future__ import annotations

import math
import threading

import torch

from dnn_tpu_torch.ops.cuda import _build

_NEG_BIG = -1e30
_KV_KIND = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16"),
            torch.int8: (2, "int8"), torch.uint8: (3, "int4")}
_KV_NAMES = ("f32", "bf16", "int8", "int4")
_Q_KIND = {torch.float32: 0, torch.bfloat16: 1}
K5_TILE = 64             # K5's query rows a block and keys a tile
K5_TARGET_BLOCKS = 132   # one block for each of the H100's 132 SMs
DECODE_MIN_SPLIT_KEYS = 64  # K6/K7's shortest split (32-256 timed: PERF.md)
DECODE_TARGET_BLOCKS = 192  # K6/K7's grid; 256-key splits at B=4 S=1024
DECODE_MAX_ROWS = 8      # K6/K7's query rows a KV head


# ----------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracle)
# ----------------------------------------------------------------------

def pack_nibbles(vals):
    """int values in [-8, 7] of shape (..., D), D even -> uint8 (...,
    D / 2): element 2i in the low nibble, 2i + 1 in the high one, two's
    complement (JAX's kvtier/migrate._pack_nibbles, row by row)."""
    if vals.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even last dim, got "
                         f"{vals.shape[-1]}")
    v = vals.to(torch.int16) & 0xF
    return (v[..., 0::2] | (v[..., 1::2] << 4)).to(torch.uint8)


def unpack_nibbles(packed):
    """pack_nibbles' inverse: uint8 (..., D / 2) -> int8 (..., D), each
    nibble sign-extended."""
    b = packed.to(torch.int16)
    lo = ((b & 0xF) ^ 8) - 8
    hi = (((b >> 4) & 0xF) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1]).to(torch.int8)


def _values(kv):
    """A cache leaf as the plain math reads it: an int4 leaf unpacked to
    its int8 values, any other as it is."""
    return unpack_nibbles(kv) if kv.dtype == torch.uint8 else kv


def head_dim_of(kv):
    """The head dim D of a K/V cache leaf (..., D): an int4 leaf holds D
    / 2 bytes a row."""
    return kv.shape[-1] * (2 if kv.dtype == torch.uint8 else 1)


def band_keep(cols, limit, window):
    """The attention band predicate (JAX's kvcache.band_keep): causal
    upper bound (cols <= limit) plus the optional sliding-window lower
    bound (cols > limit - window). Broadcasts over whatever shapes the
    caller aligned."""
    keep = cols <= limit
    if window is not None:
        keep &= cols > limit - window
    return keep


def soft_cap(s, softcap):
    """Gemma-2's attention-logit softcapping, softcap * tanh(s /
    softcap); identity for softcap None."""
    if softcap is None:
        return s
    return softcap * torch.tanh(s / softcap)


def _scaled_softmax_attend(q, k, v, keep, ks, vs, softcap=None):
    """Scores q.k^T in f32 (times ks before / sqrt(D)), soft-capped,
    masked to `keep` at -1e30, softmax, probabilities times vs, then @ v.
    q (B, H, T, D); k/v (B, H, S, D) (int4: (B, H, S, D / 2) packed,
    unpacked here); ks/vs (B, H, S) or None."""
    d = q.shape[-1]
    k, v = _values(k), _values(v)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
    if ks is not None:
        s = s * ks[:, :, None, :]
    s = soft_cap(s / math.sqrt(d), softcap)
    p = torch.softmax(torch.where(keep, s, _NEG_BIG), dim=-1)
    if vs is not None:
        p = p * vs[:, :, None, :]
    return torch.einsum("bhts,bhsd->bhtd", p, v.float())


def reference_cached_attention(q, k, v, pos, *, ks=None, vs=None,
                               window=None, softcap=None):
    """q (B, H, T, D) f32 or bf16 at absolute positions pos[b] + t; k/v
    (B, Hk, S, D) cache with H = G * Hk (float, or int8 / packed int4
    with ks/vs (B, Hk, S) scales); pos (B,) int32. Row (b, t) attends columns <= pos[b]
    + t (and > pos[b] + t - window); query head h reads KV head h / G.
    The group folds into the row dim, as the JAX LLaMA path folds it ((B,
    Hk, G * T, D), row limits tiled G times), so the cache is never
    copied per query head. f32 math; returns (B, H, T, D) in q's type,
    as the kernel writes it."""
    b, h, t, d = q.shape
    hk = k.shape[1]
    cols = torch.arange(k.shape[2], device=q.device)
    rows = torch.arange((h // hk) * t, device=q.device) % t
    limit = pos.long()[:, None, None, None] + rows[None, None, :, None]
    out = _scaled_softmax_attend(q.reshape(b, hk, -1, d), k, v,
                                 band_keep(cols, limit, window), ks, vs,
                                 softcap)
    return out.reshape(b, h, t, d).to(q.dtype)


def reference_decode_attention(q, k, v, pos, *, ks=None, vs=None,
                               window=None, softcap=None):
    """q (B, Hk, R, D) f32 or bf16; every row of slot b attends cache
    columns <= pos[b] (and > pos[b] - window) of k/v (B, Hk, S, D)
    (float, or int8 / packed int4 with ks/vs (B, Hk, S) scales). f32 math; returns (B,
    Hk, R, D) in q's type."""
    cols = torch.arange(k.shape[2], device=q.device)
    keep = band_keep(cols, pos.long()[:, None, None, None], window)
    return _scaled_softmax_attend(q, k, v, keep, ks, vs,
                                  softcap).to(q.dtype)


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
                                     vs=None, window=None):
    """Oracle for the paged kernel: gather the dense views (scale blocks
    (n_blocks, Hk, bp) too), then the dense decode reference (with the
    band). Returns (B, Hk, R, D) in q's type."""
    return reference_decode_attention(
        q, gather_view(kp, tables), gather_view(vp, tables), pos,
        ks=None if ks is None else gather_view(ks, tables),
        vs=None if vs is None else gather_view(vs, tables), window=window)


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
    if q.dtype not in _Q_KIND:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != v.dtype or k.dtype not in _KV_KIND:
        raise TypeError(f"k/v must share float32, bfloat16, int8 or uint8 "
                        f"(int4), got {k.dtype}/{v.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError(f"pos must be int32, got {pos.dtype}")
    if k.dtype in (torch.int8, torch.uint8):
        if ks is None or vs is None:
            raise TypeError("a quantized cache needs both scale tensors "
                            "ks/vs")
        if ks.dtype != torch.float32 or vs.dtype != torch.float32:
            raise TypeError(f"ks/vs must be float32, got {ks.dtype}/{vs.dtype}")
        if ks.shape != k.shape[:-1] or vs.shape != k.shape[:-1]:
            raise ValueError(f"ks/vs {tuple(ks.shape)}/{tuple(vs.shape)} must "
                             f"be the cache's {tuple(k.shape[:-1])}")
    elif ks is not None or vs is not None:
        raise TypeError(f"scales ks/vs go with a quantized cache, not "
                        f"{k.dtype}")
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


class LaunchLog:
    """The kernel calls recorded while a CUDA graph was captured: (wrapper,
    cache dtype name, q is bf16, variants) each. A captured call launches
    nothing, so it is not counted then; each replay of the graph launches
    every recorded call once, and `replayed()` counts them."""

    def __init__(self):
        self.calls = []

    def replayed(self):
        for wrapper, dtype_name, bf16_q, variants in self.calls:
            _count(wrapper, dtype_name, bf16_q, variants)


_capture = threading.local()


class recording_launches:
    """Context manager: this thread's kernel calls are written to `log`
    instead of counted (a CUDA graph being captured)."""

    def __init__(self, log: LaunchLog):
        self.log = log

    def __enter__(self):
        self._prev = getattr(_capture, "log", None)
        _capture.log = self.log
        return self.log

    def __exit__(self, *exc):
        _capture.log = self._prev
        return False


def _count(wrapper, dtype_name, bf16_q, variants=()):
    wrapper.launches += 1
    wrapper.launches_by_dtype[dtype_name] += 1
    if bf16_q:
        wrapper.launches_bf16_q[dtype_name] += 1
    for name in variants:
        wrapper.launches_by_variant[name][dtype_name] += 1


def _record(wrapper, dtype_name, bf16_q, capturing, variants=()):
    """Count a launched call, or, while a graph is captured (the call
    launched nothing), write it to this thread's LaunchLog if there is
    one."""
    if not capturing:
        _count(wrapper, dtype_name, bf16_q, variants)
        return
    log = getattr(_capture, "log", None)
    if log is not None:
        log.calls.append((wrapper, dtype_name, bf16_q, variants))


def _launch(wrapper, name, dtype_name, dev, *args, bf16_q=False,
            variants=()):
    """Call kernel `name` on the current stream of `dev`; raise on a
    refused launch; count it (`_record`; `bf16_q`: the call took a bf16
    q; `variants`: the names of launches_by_variant it adds to)."""
    fn = _build.load(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        rc = fn(*args, stream.cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: "
                           f"cudaError {rc}")
    _record(wrapper, dtype_name, bf16_q, capturing, variants)


def _counted(fn):
    fn.launches = 0
    fn.launches_by_dtype = dict.fromkeys(_KV_NAMES, 0)
    fn.launches_bf16_q = dict.fromkeys(_KV_NAMES, 0)
    fn.launches_by_variant = {v: dict.fromkeys(_KV_NAMES, 0)
                              for v in ("band", "softcap", "d256")}
    return fn


KERNEL_DIMS = (32, 64, 128, 256)  # the head dims K5-K7 take


def _band_args(window, softcap, s_len: int):
    """The kernels' (window, softcap) arguments — 0 for none — and the
    launch's variants. A window must be >= 1 and a softcap > 0; a window
    of at least `s_len` (the cache's columns) bands nothing, so the
    plain kernel runs (Gemma-2's global layers pass block_size)."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    w = 0 if window is None or window >= s_len else int(window)
    variants = (("band",) if w else ()) + (("softcap",) if softcap else ())
    return w, float(softcap or 0.0), variants


def k5_split(bh: int, t: int, s: int):
    """K5's split of the cache's keys, from the shapes alone (the base
    positions stay on the device): (64-key tiles per split, number of
    splits). The grid is ceil(T / 64) query tiles per (batch, head)
    times the splits; the splits bring it up to about K5_TARGET_BLOCKS
    blocks, at most one split per tile of the cache."""
    n_tiles = -(-s // K5_TILE)
    query_tiles = bh * -(-t // K5_TILE)
    splits = max(1, min(n_tiles, -(-K5_TARGET_BLOCKS // query_tiles)))
    split_tiles = -(-n_tiles // splits)
    return split_tiles, -(-n_tiles // split_tiles)


def decode_split(bh: int, s: int, unit: int = 1):
    """K6/K7's split of a slot's `s` logical columns, from the shapes
    alone (the positions stay on the device): (keys a split, number of
    splits). The grid is (splits, bh). The splits bring it up to about
    DECODE_TARGET_BLOCKS blocks, each of at least DECODE_MIN_SPLIT_KEYS
    keys, in whole `unit`s (K7: its block length), and at most the whole
    row. The plan cannot see which slot is long, so it lets every slot
    spread over many SMs; the blocks past a slot's live limit return at
    once."""
    units = -(-s // unit)
    per = max(-(-DECODE_MIN_SPLIT_KEYS // unit),
              -(-units * bh // DECODE_TARGET_BLOCKS))
    per = min(per, units)
    return per * unit, -(-units // per)


def _decode_rows(r):
    if r > DECODE_MAX_ROWS:
        raise ValueError(f"the CUDA kernel takes at most {DECODE_MAX_ROWS} "
                         f"query rows a KV head, got {r}")


@_counted
def cached_attention(q, k, v, pos, *, ks=None, vs=None, window=None,
                     softcap=None):
    """K5. q (B, H, T, D) f32 or bf16; k/v (B, Hk, S, D) f32 or bf16, or
    int8 (int4: uint8 (B, Hk, S, D / 2)) with ks/vs (B, Hk, S) f32
    scales, where H = G * Hk (G = 1: one
    cache head per query head; query head h reads KV head h / G); pos
    (B,) int32 base positions >= 0 (row t attends columns <= pos[b] + t,
    and with `window` only those > pos[b] + t - window; `softcap` caps
    the scores). Returns (B, H, T, D) in q's type. CPU tensors run
    `reference_cached_attention`. On CUDA the partial results of the key
    splits go to an f32 workspace of n_split * B * H * T * (D + 2)
    floats, merged in split order (deterministic)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (B,H,T,D)/(B,Hk,S,D)")
    b, h, t, d = q.shape
    hk = k.shape[1]
    if (k.shape[0], head_dim_of(k)) != (b, d) or hk < 1 or h % hk:
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} (its heads must divide q's)")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    kind, dname = _check_dtypes(q, k, v, pos, ks, vs)
    dev = _same_device(q, k, v, pos, ks, vs)
    w, cap, variants = _band_args(window, softcap, k.shape[2])
    if dev.type == "cpu":
        return reference_cached_attention(q, k, v, pos, ks=ks, vs=vs,
                                          window=window, softcap=softcap)
    _check_kernel_args((q, k, v, pos, ks, vs), d=d, dims=KERNEL_DIMS,
                       aligned=(q, k, v))
    out = torch.empty((b, h, t, d), dtype=q.dtype, device=dev)
    split_tiles, n_split = k5_split(b * h, t, k.shape[2])
    ws = None if n_split == 1 else torch.empty(
        n_split * b * h * t * (d + 2), dtype=torch.float32, device=dev)
    q_kind = _Q_KIND[q.dtype]
    _launch(cached_attention, "cached_attention", dname, dev,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs),
            pos.data_ptr(), out.data_ptr(), _ptr(ws), b * h, h, h // hk, t,
            k.shape[2], d, kind, q_kind, split_tiles, 1.0 / math.sqrt(d), w,
            cap, bf16_q=q_kind == 1,
            variants=variants + (("d256",) if d == 256 else ()))
    return out


@_counted
def decode_attention(q, k, v, pos, *, ks=None, vs=None, window=None,
                     softcap=None):
    """K6. q (B, Hk, R, D) f32 or bf16 — R rows per KV head, all
    attending cache columns <= pos[b] (a pos at or past S attends the
    whole cache), and with `window` only those > pos[b] - window;
    `softcap` caps the scores; k/v (B, Hk, S, D) f32 or bf16, or int8
    (int4: uint8 (B, Hk, S, D / 2)) with ks/vs (B, Hk, S) f32 scales; pos (B,) int32. Returns (B, Hk, R,
    D) in q's type. CPU tensors run
    `reference_decode_attention`. On CUDA, R <= DECODE_MAX_ROWS; the
    partial results of the key splits (`decode_split`) go to an f32
    workspace of n_split * B * Hk * R * (D + 2) floats, merged in split
    order (deterministic)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (B,Hk,R,D)/"
                         "(B,Hk,S,D)")
    b, hk, r, d = q.shape
    if (k.shape[0], k.shape[1], head_dim_of(k)) != (b, hk, d):
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    kind, dname = _check_dtypes(q, k, v, pos, ks, vs)
    dev = _same_device(q, k, v, pos, ks, vs)
    w, cap, variants = _band_args(window, softcap, k.shape[2])
    if dev.type == "cpu":
        return reference_decode_attention(q, k, v, pos, ks=ks, vs=vs,
                                          window=window, softcap=softcap)
    _check_kernel_args((q, k, v, pos, ks, vs), d=d, dims=KERNEL_DIMS,
                       aligned=(q, k, v))
    _decode_rows(r)
    out = torch.empty((b, hk, r, d), dtype=q.dtype, device=dev)
    split_keys, n_split = decode_split(b * hk, k.shape[2])
    ws = None if n_split == 1 else torch.empty(
        n_split * b * hk * r * (d + 2), dtype=torch.float32, device=dev)
    q_kind = _Q_KIND[q.dtype]
    _launch(decode_attention, "decode_attention", dname, dev,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs),
            pos.data_ptr(), out.data_ptr(), _ptr(ws), b, hk, r, k.shape[2],
            d, kind, q_kind, split_keys, 1.0 / math.sqrt(d), w, cap,
            bf16_q=q_kind == 1,
            variants=variants + (("d256",) if d == 256 else ()))
    return out


@_counted
def paged_decode_attention(q, kp, vp, tables, pos, *, ks=None, vs=None,
                           window=None):
    """K7. q (B, Hk, R, D) f32 or bf16 — R rows per KV head, all
    attending logical columns <= pos[b], and with `window` only those >
    pos[b] - window (the blocks wholly before the band, a windowed pool's
    reclaimed ones pointing at the junk block, are never read); kp/vp
    (n_blocks, Hk, bp, D) f32 or bf16 pool, or int8 (int4:
    uint8 (n_blocks, Hk, bp, D / 2)) with ks/vs (n_blocks, Hk, bp) f32
    scale blocks; tables (B, nb_max) int32 logical ->
    physical block; pos (B,) int32. Returns (B, Hk, R, D) in q's type.
    CPU tensors run `reference_paged_decode_attention`. On CUDA, as
    `decode_attention`, over the nb_max * bp logical columns split in
    whole blocks."""
    if q.dim() != 4 or kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError(f"q {tuple(q.shape)}, pool {tuple(kp.shape)}/"
                         f"{tuple(vp.shape)}: expected (B,Hk,R,D)/"
                         "(n_blocks,Hk,bp,D)")
    b, hk, r, d = q.shape
    if (kp.shape[1], head_dim_of(kp)) != (hk, d):
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
    w, _, variants = _band_args(window, None,
                                tables.shape[1] * kp.shape[2])
    if dev.type == "cpu":
        return reference_paged_decode_attention(q, kp, vp, tables, pos,
                                                ks=ks, vs=vs, window=window)
    _check_kernel_args((q, kp, vp, tables, pos, ks, vs), d=d,
                       dims=KERNEL_DIMS, aligned=(q, kp, vp))
    _decode_rows(r)
    bp, nb_max = kp.shape[2], tables.shape[1]
    if kp.shape[0] * hk * bp >= 2**31:
        raise ValueError(f"the CUDA kernel takes a pool of fewer than 2^31 "
                         f"rows, got {tuple(kp.shape)}")
    out = torch.empty((b, hk, r, d), dtype=q.dtype, device=dev)
    split_keys, n_split = decode_split(b * hk, nb_max * bp, bp)
    ws = None if n_split == 1 else torch.empty(
        n_split * b * hk * r * (d + 2), dtype=torch.float32, device=dev)
    q_kind = _Q_KIND[q.dtype]
    _launch(paged_decode_attention, "paged_decode", dname, dev,
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), _ptr(ks), _ptr(vs),
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(), _ptr(ws), b,
            hk, r, d, bp, nb_max, kind, q_kind, split_keys,
            1.0 / math.sqrt(d), w, bf16_q=q_kind == 1,
            variants=variants + (("d256",) if d == 256 else ()))
    return out
