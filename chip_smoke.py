#!/usr/bin/env python
"""Chip smoke test of the PyTorch/CUDA port: builds the CUDA kernels,
holds each against its plain PyTorch version on the card, then serves
GPT-2 at full width through the LM daemon over gRPC in four cache
configurations, runs the solo decoder, checks every greedy stream
against an independent reference, and trains full-width GPT-2 through
the flash-attention kernels.

    python3 chip_smoke.py        # from the repo root, on a machine with one CUDA card

Phases (any failure exits non-zero and prints no result):
  1. the card's name and power limit (nvidia-smi); TF32 off; kernel build
  2. K5 cached_attention at the prefill shape (B=1 H=12 T=64 S=1024 D=64),
     bases {0, 64, 448, 960}, f32, bf16 and int8 caches; its split-KV
     plan (splits, kernel launches a call), and at base 960 its time
     against SDPA's
  3. K6 decode_attention at the dense decode shape (B=4 Hk=12 R=1 D=64
     S=1024), pos {0,15,16,1023}, f32/bf16/int8; also a stale slot at
     pos = S and an R=2 case (checked only)
  4. K7 paged_decode_attention at the decode shape (B=4 Hk=12 R=1 D=64,
     bp=16, nb_max=64, 257 pool blocks), permuted table, pos
     {0,15,16,1023}, f32/bf16/int8 pools
  4b. K1 flash_attention and K2 flash_attention_lse, then K3
     flash_bwd_dq and K4 flash_bwd_dkv, at the training shape (B=8 H=12
     T=S=512 D=64, causal), f32 and bf16; also T=S=500 and a T=128 S=512
     bottom-right case (checked only). K1/K2 against the plain forward
     (and logsumexp), K3/K4 against torch.autograd.grad through the plain
     reference_attention; bf16 against the plain version in f32 on the
     same bf16 values. Library yardsticks: scaled_dot_product_attention
     for K1; for K2 a call that also returns the logsumexp (bf16: the
     flash backend, aten._scaled_dot_product_flash_attention; f32: the
     efficient-attention backend); for K3/K4 SDPA's whole backward: in
     bf16 the flash backend's backward
     (aten._scaled_dot_product_flash_attention_backward on the residuals
     of its forward), timed like the kernels; in f32, which the flash
     backend does not take, the profiler's device time of autograd.grad
     of SDPA minus that of its forward (in bf16 printed beside the other);
     and, checked only, K1/K2 and K3/K4 f32 at T=S=512 with q and k x 4
     (scores of tens), out and lse at 1e-4, gradients at 1e-4 x each
     one's max
  5. the main path (gpt2, random weights from seed 0, 4 slots, max_len
     1024, prompt_pad 64; prompts of 5/70/130/300 tokens, 16 new tokens,
     greedy, 4 concurrent gRPC clients), each run with the launch counts
     zeroed just before and read just after:
       A. kv="paged", f32 — against a no-cache greedy loop (K5, K7)
       B. kv="dense", decode_buckets, f32 — the same reference (K5, K6)
       C. kv="paged", kv_dtype="int8" — against an independent int8
          greedy loop: plain attention over a dense int8 cache quantized
          with the port's _quantize_rows, no batcher, no kernel (K5, K7
          int8)
       D. kv="paged", kv_dtype="bf16" — against the same loop over a
          dense bf16 cache (K/V rounded to bf16, the attention's output
          cast to bf16 as the port's FloatKV does) (K5, K7 bf16)
       solo make_generate on the 300-token prompt, f32, bf16 and int8
          caches, against the matching reference (K5, K6)
  6. information: a torch.profiler view of a decode step and of one
     prompt's admission on each pool A-D (wall, device busy, top
     kernels, K5's share of the admission's device time)
  6b. the training main path (gpt2 at full width, seed-0 weights, B=8
     T=512, make_apply_stacked(use_flash=True), next_token_loss, the
     port's adamw(1e-4), batches from a seeded token file through
     TokenDataset), each run with the launch counts zeroed just before
     and read just after, and the exact flash launches required
     (per step: K2 = K3 = K4 = 12, K1 = 0; K2 = 24 under remat):
       T-a loss and per-leaf gradients of one step, kernels against the
           einsum formula (loss within 1e-5 relative, every leaf's
           max|dg| <= 1e-4 x its max|g|)
       T-b 8 fit steps on one batch: the loss falls at every step
       remat 2 steps: K2 twice per layer; losses and params within 1e-6
           of T-b's first two steps
       T-c 6 fit steps, checkpoints every 3; resume_or_init from step 3
           and 3 more steps equal the uninterrupted params bit for bit
       T-d evaluate on 2 held-out batches: K1 = 12 per batch, no K2-K4
       T-e bf16 compute, 3 steps + evaluate: first loss within 2e-2 of
           the f32 one, finite gradients, K1-K4 launched in bf16
     plus information: step wall (f32: T-b's warm steps; bf16: 6 more
     steps), tokens/s, peak memory, MFU, and a torch.profiler view of
     one f32 and one bf16 step (flash share of device time)
  7. one JSON line describing the kernels, then the result line.

Tolerances against the plain versions: 1e-4 for f32 and int8 caches
(both sides read the same values; only the summation order differs),
2e-2 for bf16. A served token may differ from its reference only where
the reference's top-2 logit gap is below 1e-4 (a near-tie).
Timings: warm-up, then the calls are captured in a CUDA graph and the
graph is replayed between CUDA events (device time, no host overhead).
Kernel timings cycle over the 12 layers' slices of a full-model cache,
so each launch reads K/V the previous launches did not leave in the
50 MB L2 — as on the serving path.
Bounds: bytes moved (each input read once, each output written once,
live columns only, int8 scales included) at 3.35 TB/s, or the work at
the inputs' type's peak. K6 and K7: f32 FMAs at 67 TFLOP/s. The flash
kernels (K1-K4): the function's own products at the card's fastest rate
for the inputs' type, bf16 on the tensor cores at 989 TFLOP/s and f32
on the TF32 tensor cores at 494.7, so that a design's way of reaching
f32 accuracy does not move its bound. Each flash line also prints the
products on the units its kernel runs them on: the tensor cores for the
bf16 kernels, and for K1-K4 in f32 the split products they issue on the
tensor cores (the score product as three TF32 products, every other as
three bf16 products) beside the f32 CUDA-core figure. K5 runs
its products on the tensor cores in every cache type: its operations
bound is the bf16 products it issues at 989 TFLOP/s, with the f32
CUDA-core bound of the live scores printed beside it.
"""

from __future__ import annotations

import json
import math
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
TF32_FLOPS_PER_S = 494.7e12  # H100 SXM TF32 tensor cores, dense
F32_TOL, BF16_TOL = 1e-4, 2e-2
LAYERS = 12


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 24, reps: int = 10) -> float:
    """Mean device time of one fn() call. `iters` calls are captured in
    a CUDA graph after a warm-up on a side stream, and the graph is
    replayed `reps` times between CUDA events — so the wrapper's host
    overhead never shows in the device time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def cycling(fn, n: int):
    """A no-argument callable that calls fn(0), fn(1), ... fn(n-1), fn(0)..."""
    state = {"i": 0}

    def call():
        i = state["i"]
        state["i"] = (i + 1) % n
        return fn(i)
    return call


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS_PER_S):
    """(bound ms, "bytes" | "operations", bytes ms, operations ms), the
    operations priced at `peak` FLOP/s (the inputs' type's peak)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, t_bytes, t_ops


def kernel_label(mangled: str) -> str:
    """`flash_fwd_tc_kernel<64>` from a mangled kernel name: the
    length-prefixed identifier that ends in "kernel", then its template
    arguments (the element type, then the ints)."""
    # a length prefix may follow digits of a hash: try every tail of a run
    starts = [i for m in re.finditer(r"\d+", mangled)
              for i in range(m.start(), m.end())]
    for i in starts:
        end = re.match(r"\d+", mangled[i:]).end() + i
        word = mangled[end:end + int(mangled[i:end])]
        if not word.endswith("kernel"):
            continue
        targs = mangled[end + len(word):].split("EE")[0]
        if not targs.startswith("I"):
            return word
        types = {"If": "f32", "I13__nv_bfloat16": "bf16", "Ia": "int8"}
        names = [t for pre, t in types.items() if targs.startswith(pre)]
        names += re.findall(r"L[ib](-?\d+)", targs)
        return f"{word}<{', '.join(names)}>"
    return mangled


def phase_build():
    from dnn_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[build] {len(logs)} kernel libraries built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        kernel = "?"
        for line in log.splitlines():
            entry = re.search(r"entry function '(\w+)'", line)
            if entry:
                kernel = kernel_label(entry.group(1))
            elif ("registers" in line or "spill" in line
                  or "Performance Loss" in line):
                print(f"[build] {name}: {kernel}: {line.strip()}",
                      flush=True)


KV_CASES = (("f32", F32_TOL), ("bf16", BF16_TOL), ("int8", F32_TOL))


def kv_cache(gen, shape, name, dev):
    """(k, v, ks, vs) of `shape` for cache type `name`: f32 draws, cast
    to bf16, or quantized to int8 with the port's own quantizer (then
    ks/vs are its per-row scales; None for the float types)."""
    from dnn_tpu_torch.runtime.kvcache import _quantize_rows

    k = torch.randn(*shape, generator=gen, device=dev)
    v = torch.randn(*shape, generator=gen, device=dev)
    if name == "int8":
        (kq, ks), (vq, vs) = _quantize_rows(k), _quantize_rows(v)
        return kq, vq, ks, vs
    dt = torch.float32 if name == "f32" else torch.bfloat16
    return k.to(dt), v.to(dt), None, None


def scales_at(ks, vs, i):
    """The ks/vs keyword arguments for layer i of stacked int8 scales;
    none for a float cache."""
    return {} if ks is None else {"ks": ks[i], "vs": vs[i]}


def kv_bytes(name: str, positions: int, d: int) -> int:
    """Bytes of K plus V at `positions` (position, head) rows of width d,
    int8 scales included."""
    el = {"f32": 4, "bf16": 2, "int8": 1}[name]
    return 2 * positions * (d * el + (4 if name == "int8" else 0))


def check(label: str, got, want, tol: float) -> float:
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite output")
    err = (got - want).abs().max().item()
    if not math.isfinite(err) or err > tol:
        fail(f"{label}: max abs err {err} > {tol}")
    return err


def report(tag, label, row, nbytes, byte_ms, op_ms):
    lib = row["library_ms"]
    print(f"[{tag}] {label}: err {row['max_abs_err']:.3e} kernel_ms "
          f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} library_ms "
          f"{'none' if lib is None else f'{lib:.4f}'} bound_ms "
          f"{row['bound_ms']:.5f} ({row['bound_by']}; bytes {byte_ms:.5f} "
          f"for {nbytes / 1e6:.3f} MB at 3.35 TB/s, f32 ops {op_ms:.5f})",
          flush=True)


def phase_k5(dev, gen):
    """K5 against its plain version at the prefill-chunk shape, f32,
    bf16 and int8 caches. Returns {(dtype, base): row}. The bound is that
    of the units the kernel now uses: the bytes, or the tensor-core
    operations of the products it issues (over every 64-key tile up to
    each query tile's last live column, two bf16 products a tile for
    Q.K^T and two for P.V, three each for an f32 cache) at 989 TFLOP/s.
    The f32 CUDA-core bound of the live scores, the bound of the earlier
    CUDA-core design, is printed beside it."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        K5_TILE, cached_attention, k5_split, reference_cached_attention)

    B, H, T, S, D = 1, 12, 64, 1024, 64
    split_tiles, n_split = k5_split(B * H, T, S)
    q_tiles = -(-T // K5_TILE)
    print(f"[K5] B={B} H={H} T={T} S={S} D={D}: {n_split} splits of "
          f"{split_tiles * K5_TILE} keys, grid ({n_split}, {q_tiles}, "
          f"{B * H}), {2 if n_split > 1 else 1} kernel launches a call "
          f"(split{' + merge' if n_split > 1 else ''})", flush=True)
    rows = {}
    for name, tol in KV_CASES:
        q = torch.randn(LAYERS, B, H, T, D, generator=gen, device=dev)
        k, v, ks, vs = kv_cache(gen, (LAYERS, B, H, S, D), name, dev)
        for base in (0, 64, 448, 960):
            pos = torch.full((B,), base, dtype=torch.int32, device=dev)
            sc = scales_at(ks, vs, 0)
            err = check(f"K5 {name} base {base}",
                        cached_attention(q[0], k[0], v[0], pos, **sc),
                        reference_cached_attention(q[0], k[0], v[0], pos, **sc),
                        tol)
            live = min(S, base + T)
            nbytes = (2 * B * H * T * D * 4 + B * H * kv_bytes(name, live, D)
                      + B * 4)
            scores = B * H * sum(min(S, base + t + 1) for t in range(T))
            tiles = B * H * sum(
                min(S - 1, base + min(T, K5_TILE * (i + 1)) - 1) // K5_TILE + 1
                for i in range(q_tiles))
            products = 3 if name == "f32" else 2
            tc_flops = tiles * 2 * products * 2 * K5_TILE * K5_TILE * D
            b_ms, b_by, byte_ms, op_ms = bound(nbytes, tc_flops,
                                               BF16_FLOPS_PER_S)
            ms = time_ms(cycling(lambda i: cached_attention(
                q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
            plain = time_ms(cycling(lambda i: reference_cached_attention(
                q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
            lib = None
            if name != "int8":  # no one-call library counterpart for int8
                cols = torch.arange(S, device=dev)
                mask = cols[None, :] <= (base + torch.arange(T, device=dev))[:, None]
                qd = q.to(k.dtype)
                lib = time_ms(cycling(
                    lambda i: torch.nn.functional.scaled_dot_product_attention(
                        qd[i], k[i], v[i], attn_mask=mask), LAYERS))
            row = rows[(name, base)] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err)
            print(f"[K5] {name:4s} base {base:4d}: err {err:.3e} kernel_ms "
                  f"{ms:.4f} plain_ms {plain:.4f} library_ms "
                  f"{'none' if lib is None else f'{lib:.4f}'} bound_ms "
                  f"{b_ms:.5f} ({b_by}; bytes {byte_ms:.5f} for "
                  f"{nbytes / 1e6:.3f} MB at 3.35 TB/s, tensor-core ops "
                  f"{op_ms:.5f} for {tiles} tiles x {2 * products} products "
                  f"at 989 TFLOP/s; f32 CUDA-core ops of the live scores "
                  f"{4 * D * scores / F32_FLOPS_PER_S * 1e3:.5f}); kernel / "
                  f"bound {ms / b_ms:.1f}", flush=True)
        if lib is not None:
            at = rows[(name, 960)]
            print(f"[K5] {name} base 960: kernel {at['ms']:.4f} ms, SDPA "
                  f"({name} q, k, v) {at['library_ms']:.4f} ms: kernel / "
                  f"library {at['ms'] / at['library_ms']:.2f}", flush=True)
    return rows


def phase_k6(dev, gen):
    """K6 against its plain version at the dense decode-step shape
    (B=4 Hk=12 R=1 D=64 S=1024, pos {0, 15, 16, 1023}), f32, bf16 and
    int8 caches; plus, checked only, a stale inactive slot at pos = S and
    an R=2 case. Returns {dtype: row}."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        decode_attention, reference_decode_attention)

    B, Hk, R, D, S = 4, 12, 1, 64, 1024
    pos_list = [0, 15, 16, 1023]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    stale = torch.tensor([0, 15, S, 1023], dtype=torch.int32, device=dev)
    cols = torch.arange(S, device=dev)
    mask = cols[None, None, None, :] <= pos[:, None, None, None]
    rows = {}
    for name, tol in KV_CASES:
        q = torch.randn(LAYERS, B, Hk, R, D, generator=gen, device=dev)
        k, v, ks, vs = kv_cache(gen, (LAYERS, B, Hk, S, D), name, dev)
        q2 = torch.randn(B, Hk, 2, D, generator=gen, device=dev)
        err = 0.0
        for label, i, qq, pp in (("", 0, q[0], pos),
                                 (" stale pos = S", 1, q[1], stale),
                                 (" R=2", 2, q2, pos)):
            sc = scales_at(ks, vs, i)
            err = max(err, check(
                f"K6 {name}{label}",
                decode_attention(qq, k[i], v[i], pp, **sc),
                reference_decode_attention(qq, k[i], v[i], pp, **sc), tol))
        live = sum(p + 1 for p in pos_list)
        nbytes = 2 * B * Hk * R * D * 4 + Hk * kv_bytes(name, live, D) + B * 4
        flops = 4 * D * Hk * R * live
        b_ms, b_by, byte_ms, op_ms = bound(nbytes, flops)
        ms = time_ms(cycling(lambda i: decode_attention(
            q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
        plain = time_ms(cycling(lambda i: reference_decode_attention(
            q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
        lib = None
        if name != "int8":  # no one-call library counterpart for int8
            qd = q.to(k.dtype)
            lib = time_ms(cycling(
                lambda i: torch.nn.functional.scaled_dot_product_attention(
                    qd[i], k[i], v[i], attn_mask=mask), LAYERS))
        row = rows[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        report("K6", f"{name:4s} pos {pos_list}", row, nbytes, byte_ms, op_ms)
    return rows


def phase_k7(dev, gen):
    """K7 against its plain version at the paged decode-step shape, f32,
    bf16 and int8 pools. Returns {dtype: row}."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        paged_decode_attention, reference_paged_decode_attention)

    B, Hk, R, D, bp, nb_max, n_blocks = 4, 12, 1, 64, 16, 64, 257
    pos_list = [0, 15, 16, 1023]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(0))
    tables = (perm[:B * nb_max] + 1).reshape(B, nb_max).to(torch.int32).to(dev)
    rows = {}
    for name, tol in KV_CASES:
        q = torch.randn(LAYERS, B, Hk, R, D, generator=gen, device=dev)
        kp, vp, ks, vs = kv_cache(gen, (LAYERS, n_blocks, Hk, bp, D), name,
                                  dev)
        sc = scales_at(ks, vs, 0)
        err = check(f"K7 {name}",
                    paged_decode_attention(q[0], kp[0], vp[0], tables, pos,
                                           **sc),
                    reference_paged_decode_attention(q[0], kp[0], vp[0],
                                                     tables, pos, **sc), tol)
        live = sum(p + 1 for p in pos_list)
        nbytes = (2 * B * Hk * R * D * 4 + Hk * kv_bytes(name, live, D)
                  + sum(p // bp + 1 for p in pos_list) * 4 + B * 4)
        flops = 4 * D * Hk * R * live
        b_ms, b_by, byte_ms, op_ms = bound(nbytes, flops)
        ms = time_ms(cycling(lambda i: paged_decode_attention(
            q[i], kp[i], vp[i], tables, pos, **scales_at(ks, vs, i)),
            LAYERS))
        plain = time_ms(cycling(lambda i: reference_paged_decode_attention(
            q[i], kp[i], vp[i], tables, pos, **scales_at(ks, vs, i)),
            LAYERS))
        row = rows[name] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        report("K7", f"{name:4s} pos {pos_list} (no one-call library "
               "equivalent)", row, nbytes, byte_ms, op_ms)
    return rows


FLASH_B, FLASH_H, FLASH_T, FLASH_D = 8, 12, 512, 64
FLASH_TYPES = (("f32", torch.float32, F32_TOL), ("bf16", torch.bfloat16,
                                                 BF16_TOL))
# (T, S, label): the training shape, then two shapes checked only
FLASH_SHAPES = ((FLASH_T, FLASH_T, ""), (500, 500, " ragged T=S=500"),
                (128, FLASH_T, " bottom-right T=128 S=512"))


def flash_tensors(gen, dev, dtype, *lengths):
    """(B, H, n, D) normal draws, one per length, in `dtype`."""
    return [torch.randn(FLASH_B, FLASH_H, n, FLASH_D, generator=gen,
                        device=dev).to(dtype) for n in lengths]


def live_pairs(t: int, s: int) -> int:
    """(query, key) pairs a causal (bottom-right) call computes, per
    (batch, head)."""
    return sum(min(s, r + 1 + s - t) for r in range(t))


def flash_bound(nbytes: float, flops: float, f32: bool) -> dict:
    """The bound of a flash kernel (K1-K4): the larger of its bytes at
    3.35 TB/s and its function's own products (`flops`) at the card's
    fastest rate for the inputs' type -- bf16 on the tensor cores at 989
    TFLOP/s, f32 on the TF32 tensor cores at 494.7 (a kernel that keeps
    f32 accuracy issues more than that; what it issues does not move the
    bound). Also the same products as f32 FMAs on the CUDA cores at 67,
    the bound of the f32 CUDA-core designs."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / (TF32_FLOPS_PER_S if f32 else BF16_FLOPS_PER_S) * 1e3
    return dict(nbytes=nbytes, flops=flops, f32=f32, bytes_ms=bytes_ms,
                ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                f32_cuda_core_ms=flops / F32_FLOPS_PER_S * 1e3)


def flash_report(tag, label, row, b):
    """One flash kernel's line: its time beside the plain version, the
    library yardstick and the bound `b` (flash_bound), and the products
    on the units the kernel runs them on: issued on the tensor cores as
    split f32 products where `b` has "issued" (f32), else on the tensor
    cores in bf16."""
    lib = row["library_ms"]
    if "issued" in b:
        tf32, bf16 = b["issued"]["tf32"], b["issued"]["bf16"]
        issued_ms = (tf32 / TF32_FLOPS_PER_S + bf16 / BF16_FLOPS_PER_S) * 1e3
        units = (f"issued on the tensor cores as split products: TF32 "
                 f"{tf32 / 1e9:.2f} GFLOP at 494.7 + bf16 {bf16 / 1e9:.2f} "
                 f"GFLOP at 989, {issued_ms:.5f}; as f32 FMAs on the CUDA "
                 f"cores {b['f32_cuda_core_ms']:.5f} at 67")
    else:
        units = "products on the tensor cores"
    print(f"[{tag}] {label}: err {row['max_abs_err']:.3e} kernel_ms "
          f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} library_ms "
          f"{'none' if lib is None else f'{lib:.4f}'} bound_ms "
          f"{row['bound_ms']:.5f} ({row['bound_by']}; bytes "
          f"{b['bytes_ms']:.5f} for {b['nbytes'] / 1e6:.1f} MB at 3.35 TB/s, "
          f"ops {b['ops_ms']:.5f} for {b['flops'] / 1e9:.2f} GFLOP at "
          f"{'TF32 494.7' if b['f32'] else 'bf16 989'} TFLOP/s; {units}); "
          f"kernel / bound {row['ms'] / row['bound_ms']:.1f}", flush=True)


def flash_fwd_bound(f32: bool, bh: int, t: int, s: int, d: int,
                    with_lse: bool) -> dict:
    """flash_bound of K1 (with_lse False) or K2 at (bh, t, s, d), causal.
    Bytes: q (t rows), k and v (s rows) read, out (t) written, in the
    inputs' type, plus K2's lse (f32). Products: S and P.V, 2 d flops per
    live pair each. In f32, "issued" also gives what the split design
    issues (information, not the bound): S as three TF32 products, P.V as
    three bf16 products."""
    nbytes = (2 * t + 2 * s) * bh * d * (4 if f32 else 2)
    if with_lse:
        nbytes += bh * t * 4
    product = 2 * d * bh * live_pairs(t, s)
    b = flash_bound(nbytes, 2 * product, f32)
    if f32:
        b["issued"] = dict(tf32=3 * product, bf16=3 * product)
    return b


def flash_bwd_bound(kernel: str, f32: bool, bh: int, t: int, s: int,
                    d: int) -> dict:
    """flash_bound of K3 (kernel "flash_bwd_dq") or K4 ("flash_bwd_dkv")
    at (bh, t, s, d), causal. Bytes: q and dO (t rows), k and v (s rows)
    read, dQ (t) or dK and dV (s) written, in the inputs' type, plus lse
    and D (f32). Products: the backward's own (K3: S, dP, dQ; K4: S, dP,
    dV, dK), 2 d flops per live pair each. In f32, "issued" also gives
    what the split design issues (information, not the bound): each
    product as three, the score product on TF32 and the others on bf16."""
    el = 4 if f32 else 2
    rows_out = t if kernel == "flash_bwd_dq" else 2 * s
    nbytes = (2 * t + 2 * s + rows_out) * bh * d * el + 2 * bh * t * 4
    product = 2 * d * bh * live_pairs(t, s)
    n_products = 3 if kernel == "flash_bwd_dq" else 4
    b = flash_bound(nbytes, n_products * product, f32)
    if f32:
        b["issued"] = dict(tf32=3 * product,
                           bf16=3 * (n_products - 1) * product)
    return b


def yardstick_ms(label, fn):
    """time_ms of a library call used only as a yardstick; None (and a
    note) where this torch build does not run it."""
    try:
        return time_ms(fn)
    except Exception as e:  # noqa: BLE001 — a yardstick, not the port
        print(f"[yardstick] {label}: not timed ({type(e).__name__}: "
              f"{str(e)[:120]})", flush=True)
        return None


def phase_flash_fwd(dev, gen):
    """K1 (flash_attention without a gradient) and K2 (with the
    logsumexp) against the plain versions at the training shape (B=8
    H=12 T=S=512 D=64, causal), f32 and bf16, plus the ragged and the
    bottom-right shape (checked only). bf16 is held against the plain
    version run in f32 on the same bf16 values. Returns {kernel: {dtype:
    row}}."""
    from dnn_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_lse, reference_attention,
        reference_attention_lse)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {"flash_attention": {}, "flash_attention_lse": {}}
    for name, dt, tol in FLASH_TYPES:
        err1 = err2 = 0.0
        for t, s, label in FLASH_SHAPES:
            q, k, v = flash_tensors(gen, dev, dt, t, s, s)
            qf, kf, vf = q.float(), k.float(), v.float()
            want2, want_lse = reference_attention_lse(qf, kf, vf)
            err1 = max(err1, check(f"K1 {name}{label}",
                                   flash_attention(q, k, v).float(),
                                   reference_attention(qf, kf, vf), tol))
            out, lse = flash_attention_lse(q, k, v)
            err2 = max(err2, check(f"K2 {name}{label} out", out.float(),
                                   want2, tol),
                       check(f"K2 {name}{label} lse", lse, want_lse,
                             F32_TOL))
            if (t, s) == (FLASH_T, FLASH_T):
                main = (q, k, v)
        q, k, v = main
        bh = FLASH_B * FLASH_H
        lib1 = time_ms(lambda: sdpa(q, k, v, is_causal=True))
        # K2's yardstick: a call that also returns the logsumexp. In bf16
        # the flash backend (the backend of K1's SDPA yardstick); the
        # efficient-attention backend, which takes f32 too, beside it.
        lib2 = eff2 = yardstick_ms(
            "SDPA with logsumexp (aten efficient attention)",
            lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                q, k, v, None, True, is_causal=True))
        if dt == torch.bfloat16:
            lib2 = yardstick_ms(
                "SDPA with logsumexp (aten flash attention)",
                lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                    q, k, v, 0.0, True))
            print(f"[K2] {name} yardsticks with the logsumexp (ms): flash "
                  f"backend {lib2} (library_ms), efficient attention "
                  f"{eff2}", flush=True)
        for kname, fn, plain, err, lib in (
                ("flash_attention", lambda: flash_attention(q, k, v),
                 lambda: reference_attention(q, k, v), err1, lib1),
                ("flash_attention_lse", lambda: flash_attention_lse(q, k, v),
                 lambda: reference_attention_lse(q, k, v), err2, lib2)):
            b = flash_fwd_bound(dt == torch.float32, bh, FLASH_T, FLASH_T,
                                FLASH_D, kname == "flash_attention_lse")
            row = rows[kname][name] = dict(
                ms=time_ms(fn), plain_ms=time_ms(plain), library_ms=lib,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                max_abs_err=err)
            flash_report("K1" if kname == "flash_attention" else "K2",
                         f"{name:4s} B=8 H=12 T=S=512 D=64 causal", row, b)
    flash_fwd_large_scores(dev, gen)
    return rows


def flash_fwd_large_scores(dev, gen):
    """Checked only: K1 and K2 in f32 at T=S=512 with q and k x 4, so that
    scores reach tens, as a trained model's do; an error in the score
    product goes through exp into out and the lse. Limit 1e-4 absolute;
    K1's out equals K2's bit for bit."""
    from dnn_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_lse, reference_attention_lse)

    q, k, v = flash_tensors(gen, dev, torch.float32, FLASH_T, FLASH_T,
                            FLASH_T)
    q, k = 4 * q, 4 * k
    out1 = flash_attention(q, k, v)
    out, lse = flash_attention_lse(q, k, v)
    want, want_lse = reference_attention_lse(q, k, v)
    e1 = check("K1 f32 q, k x 4", out1, want, F32_TOL)
    e2 = check("K2 f32 q, k x 4 out", out, want, F32_TOL)
    el = check("K2 f32 q, k x 4 lse", lse, want_lse, F32_TOL)
    if not torch.equal(out1, out):
        fail("K1 f32 q, k x 4: out differs from K2's")
    print(f"[K1/K2] f32 T=S=512 q, k x 4 (checked only) max abs err (limit "
          f"{F32_TOL:g}): K1 out {e1:.3e}, K2 out {e2:.3e}, lse {el:.3e} "
          f"(lse up to {want_lse.abs().max().item():.1f})", flush=True)


def phase_flash_bwd(dev, gen):
    """K3 (dQ) and K4 (dK, dV) at the same shapes, held against
    torch.autograd.grad through the plain reference_attention (in f32 on
    the same values for bf16). Tolerance relative to each gradient's max
    |value|: 1e-4 for f32 (sums of up to 512 products in another order),
    2e-2 for bf16 (outputs rounded to bf16). Returns {kernel: {dtype:
    row}}."""
    from dnn_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_lse, flash_bwd_dkv, flash_bwd_dq, reference_attention,
        reference_flash_bwd_dkv, reference_flash_bwd_dq)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for name, dt, tol in FLASH_TYPES:
        err3 = err4 = 0.0
        for t, s, label in FLASH_SHAPES:
            q, k, v, do = flash_tensors(gen, dev, dt, t, s, s, t)
            qf, kf, vf = (x.float().requires_grad_(True) for x in (q, k, v))
            gq, gk, gv = torch.autograd.grad(reference_attention(qf, kf, vf),
                                             (qf, kf, vf), do.float())
            out, lse = flash_attention_lse(q, k, v)
            di = (do.float() * out.float()).sum(-1)
            dq = flash_bwd_dq(q, k, v, do, lse, di)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, di)
            errs = {}
            for g, got, want in (("dq", dq, gq), ("dk", dk, gk),
                                 ("dv", dv, gv)):
                top = want.abs().max().item()
                errs[g] = check(f"K{3 if g == 'dq' else 4} {name}{label} "
                                f"{g}", got.float(), want, tol * top), top
            print(f"[K3/K4] {name}{label or ' T=S=512'} max abs err / the "
                  "gradient's max |value| (limit "
                  f"{tol:g}): " + ", ".join(
                      f"{g} {e:.3e} / {top:.3f} = {e / top:.2e}"
                      for g, (e, top) in errs.items()), flush=True)
            err3 = max(err3, errs["dq"][0])
            err4 = max(err4, errs["dk"][0], errs["dv"][0])
            if (t, s) == (FLASH_T, FLASH_T):
                main = (q, k, v, do, lse, di)
        q, k, v, do, lse, di = main
        bh = FLASH_B * FLASH_H
        qg, kg, vg = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))
        # SDPA's backward: the device time of autograd.grad of SDPA
        # minus that of its forward (a backward is not captured into a
        # graph here; eager event timing would count host overhead)
        lib = (device_ms(lambda: torch.autograd.grad(
            sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), do))
            - device_ms(lambda: sdpa(q, k, v, is_causal=True)))
        if dt == torch.bfloat16:
            # bf16: the flash backend's backward alone, on the residuals
            # of its forward, replayed from a CUDA graph as the kernels
            # are (the difference above spreads from run to run)
            res = []

            def sdpa_backward():
                if not res:  # the forward's residuals, once, in the warm-up
                    res.extend(torch.ops.aten
                               ._scaled_dot_product_flash_attention(
                                   q, k, v, 0.0, True))
                o, l, cq, ck, mq, mk, seed, offset, _ = res
                return (torch.ops.aten
                        ._scaled_dot_product_flash_attention_backward(
                            do, q, k, v, o, l, cq, ck, mq, mk, 0.0, True,
                            seed, offset))
            graphed = yardstick_ms(
                "SDPA's backward (aten flash attention backward)",
                sdpa_backward)
            print(f"[K3/K4] {name} SDPA's whole backward (ms): flash "
                  f"backend's backward, graph-timed, {graphed} "
                  f"(library_ms); autograd.grad minus forward, profiled, "
                  f"{lib}", flush=True)
            if graphed is not None:
                lib = graphed
        for kname, fn, plain, err in (
                ("flash_bwd_dq", lambda: flash_bwd_dq(q, k, v, do, lse, di),
                 lambda: reference_flash_bwd_dq(q, k, v, do, lse, di), err3),
                ("flash_bwd_dkv", lambda: flash_bwd_dkv(q, k, v, do, lse, di),
                 lambda: reference_flash_bwd_dkv(q, k, v, do, lse, di),
                 err4)):
            b = flash_bwd_bound(kname, dt == torch.float32, bh, FLASH_T,
                                FLASH_T, FLASH_D)
            row = rows[kname][name] = dict(
                ms=time_ms(fn), plain_ms=time_ms(plain), library_ms=lib,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                max_abs_err=err)
            flash_report("K3" if kname == "flash_bwd_dq" else "K4",
                         f"{name:4s} B=8 H=12 T=S=512 D=64 causal (library: "
                         "SDPA's whole backward, dQ dK dV)", row, b)
    flash_bwd_large_scores(dev, gen)
    return rows


def flash_bwd_large_scores(dev, gen):
    """Checked only: K3 and K4 in f32 at T=S=512 with q and k x 4, so that
    scores reach tens, as a trained model's do; an error in the score
    product goes through exp. Limit 1e-4 x each gradient's max |value|."""
    from dnn_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_lse, flash_bwd_dkv, flash_bwd_dq,
        reference_flash_bwd_dkv, reference_flash_bwd_dq)

    q, k, v, do = flash_tensors(gen, dev, torch.float32, FLASH_T, FLASH_T,
                                FLASH_T, FLASH_T)
    q, k = 4 * q, 4 * k
    out, lse = flash_attention_lse(q, k, v)
    di = (do * out).sum(-1)
    got = (flash_bwd_dq(q, k, v, do, lse, di),
           *flash_bwd_dkv(q, k, v, do, lse, di))
    want = (reference_flash_bwd_dq(q, k, v, do, lse, di),
            *reference_flash_bwd_dkv(q, k, v, do, lse, di))
    errs = []
    for g, a, b in zip(("dq", "dk", "dv"), got, want):
        top = b.abs().max().item()
        e = check(f"K{3 if g == 'dq' else 4} f32 q, k x 4 {g}", a, b,
                  F32_TOL * top)
        errs.append(f"{g} {e:.3e} / {top:.3f} = {e / top:.2e}")
    print("[K3/K4] f32 T=S=512 q, k x 4 (checked only) max abs err / the "
          f"gradient's max |value| (limit {F32_TOL:g}): " + ", ".join(errs),
          flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def reference_greedy(prepared, cfg, prompt, n_new, dev):
    """Independent greedy loop: the plain no-cache forward recomputed
    over the whole sequence for every token. Returns (tokens, top-2
    logit gap at each step)."""
    from dnn_tpu_torch.runtime.generate import forward_no_cache

    ids = torch.tensor(prompt, dtype=torch.int64, device=dev)[None]
    toks, gaps = [], []
    for _ in range(n_new):
        logits = forward_no_cache(prepared, ids, cfg=cfg)[0, -1]
        top2 = torch.topk(logits, 2).values
        gaps.append((top2[0] - top2[1]).item())
        nxt = int(logits.argmax())
        toks.append(nxt)
        ids = torch.cat([ids, torch.tensor([[nxt]], device=dev)], dim=1)
    return toks, gaps


def reference_greedy_cache(prepared, cfg, prompt, n_new, dev, kv_dtype):
    """Independent greedy loop over a dense cache of type `kv_dtype`
    ("bf16" or "int8"): no batcher and no kernel. A cache of prompt +
    n_new positions; bf16 stores K/V rounded to bf16, int8 quantizes them
    with the port's _quantize_rows and keeps the scales; attention is the
    plain version, its output cast to the cache's type for a bf16 cache,
    as the port's FloatKV.attend does. Returns (tokens, top-2 logit gap at
    each step)."""
    from dnn_tpu_torch.models.gpt import head, layer_params
    from dnn_tpu_torch.ops.attention import merge_heads
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        reference_cached_attention)
    from dnn_tpu_torch.ops.nn import embedding, layer_norm, linear
    from dnn_tpu_torch.runtime.generate import _mlp, _qkv_heads
    from dnn_tpu_torch.runtime.kvcache import _quantize_rows

    if kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"kv_dtype must be bf16 or int8, got {kv_dtype!r}")
    quant = kv_dtype == "int8"
    store = torch.int8 if quant else torch.bfloat16
    n_l, h, d = cfg.n_layer, cfg.n_head, cfg.n_embd // cfg.n_head
    s_len = len(prompt) + n_new
    kv = {"k": torch.zeros(n_l, 1, h, s_len, d, dtype=store, device=dev),
          "v": torch.zeros(n_l, 1, h, s_len, d, dtype=store, device=dev)}
    if quant:
        kv["ks"] = torch.ones(n_l, 1, h, s_len, device=dev)
        kv["vs"] = torch.ones(n_l, 1, h, s_len, device=dev)

    def last_logits(ids, start):
        t = ids.shape[1]
        x = (embedding(prepared["wte"], ids) + embedding(
            prepared["wpe"], torch.arange(start, start + t, device=dev)))
        pos = torch.full((1,), start, dtype=torch.int32, device=dev)
        for i in range(n_l):
            bp = layer_params(prepared["blocks"], i)
            q, k, v = _qkv_heads(bp, layer_norm(bp["ln_1"], x, eps=cfg.ln_eps),
                                 cfg=cfg)
            for name, new in (("k", k), ("v", v)):
                if quant:
                    payload, scale = _quantize_rows(new)
                    kv[name + "s"][i, :, :, start:start + t] = scale
                else:
                    payload = new.to(store)
                kv[name][i, :, :, start:start + t] = payload
            scales = {"ks": kv["ks"][i], "vs": kv["vs"][i]} if quant else {}
            y = reference_cached_attention(q, kv["k"][i], kv["v"][i], pos,
                                           **scales)
            if not quant:
                y = y.to(store)
            x = x + linear(bp["attn"]["proj"], merge_heads(y.to(x.dtype)))
            x = x + _mlp(bp, layer_norm(bp["ln_2"], x, eps=cfg.ln_eps))
        return head(prepared, x, cfg=cfg)[0, -1]

    with torch.no_grad():
        ids = torch.tensor(prompt, dtype=torch.int64, device=dev)[None]
        logits, start, toks, gaps = last_logits(ids, 0), len(prompt), [], []
        for _ in range(n_new):
            top2 = torch.topk(logits, 2).values
            gaps.append((top2[0] - top2[1]).item())
            toks.append(int(logits.argmax()))
            logits = last_logits(torch.tensor([[toks[-1]]], device=dev), start)
            start += 1
    return toks, gaps


def compare_tokens(label, got, want, gaps):
    """Served tokens against a reference's; a divergence is accepted only
    at a near-tie of the reference (top-2 gap < 1e-4), and the rest of
    the stream is then not compared."""
    if len(got) != len(want):
        fail(f"{label}: {len(got)} tokens, expected {len(want)}")
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            if gaps[j] < 1e-4:
                print(f"[main] {label}: near-tie at step {j} (top-2 gap "
                      f"{gaps[j]:.2e}), served {a} vs reference {b}; rest "
                      "not compared", flush=True)
                return
            fail(f"{label} step {j}: served {a} != reference {b} (top-2 gap "
                 f"{gaps[j]:.3e})\nserved    {got}\nreference {want}")
    print(f"[main] {label}: {got[:8]}... matches the reference", flush=True)


CACHE_KERNELS = ("cached_attention", "decode_attention",
                 "paged_decode_attention")
FLASH_KERNELS = ("flash_attention", "flash_attention_lse", "flash_bwd_dq",
                 "flash_bwd_dkv")


def _wrappers():
    from dnn_tpu_torch.ops.cuda import cached_attention as tca
    from dnn_tpu_torch.ops.cuda import flash_attention as tfa

    out = {name: getattr(tca, name) for name in CACHE_KERNELS}
    out.update({name: getattr(tfa, name) for name in FLASH_KERNELS})
    return out


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0
        for dt in fn.launches_by_dtype:
            fn.launches_by_dtype[dt] = 0


def read_counts():
    """{kernel: {cache dtype: launches}} since the last reset."""
    return {name: dict(fn.launches_by_dtype)
            for name, fn in _wrappers().items()}


def require(label, counts, needed):
    print(f"[main] {label} launches: {counts}", flush=True)
    for name, dt in needed:
        if counts[name][dt] <= 0:
            fail(f"{label}: {name} ({dt}) was never launched")


def serve_run(label, cfg, prepared, prompts, n_new, refs, needed, dev,
              card, **kv):
    """One main-path run: the LM daemon in-process (4 slots, max_len
    1024, prompt_pad 64) with the cache options `kv`, 4 concurrent gRPC
    generate calls, greedy; tokens checked against `refs` (tokens, gaps)
    per prompt, and every (kernel, dtype) of `needed` launched in the
    run. Returns the run's launch counts."""
    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background

    port = free_port()
    _thread, stop = start_lm_server_in_background(
        cfg, prepared, port=port, slots=4, max_len=1024, prompt_pad=64,
        block_len=16, seed=0, device=dev, **kv)
    batcher = stop.servicer.batcher
    results, errors = {}, []
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        if not client.wait_healthy(deadline=60):
            fail(f"{label}: LM daemon never became healthy")
        client.generate(prompts[0], max_new_tokens=2, timeout=300)  # warm-up
        torch.cuda.synchronize()
        grows0 = batcher.bucket_grows
        reset_counts()

        def call(i):
            try:
                results[i] = client.generate(prompts[i], max_new_tokens=n_new,
                                             timeout=300).tolist()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {e!r}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        counts = read_counts()
        grows = batcher.bucket_grows - grows0
        if errors or len(results) != len(prompts):
            fail(f"{label}: generate calls failed: {errors or 'timed out'}")
        # TTFT, as information: one streamed request on the idle daemon
        t1 = time.perf_counter()
        stream = client.generate_stream(prompts[3], max_new_tokens=n_new,
                                        timeout=300)
        next(stream)
        ttft = time.perf_counter() - t1
        rest = list(stream)
        client.close()
    finally:
        stop()
    if len(rest) != n_new - 1:
        fail(f"{label}: stream returned {len(rest) + 1} tokens, expected {n_new}")
    layout = "paged" if batcher.paged else "dense"
    print(f"[main] run {label} ({layout} pool, kv_dtype "
          f"{kv.get('kv_dtype') or 'f32'}"
          + (f", {grows} bucket grows, final bucket "
             f"{batcher.cache['k'].shape[3]}"
             if kv.get("decode_buckets") else "") + ")", flush=True)
    require(f"run {label}", counts, needed)
    n_tokens = sum(len(r) for r in results.values())
    print(f"[main] run {label}: 4 concurrent requests, {n_tokens} tokens in "
          f"{wall:.3f} s = {n_tokens / wall:.1f} tokens/s; TTFT (300-token "
          f"prompt, idle daemon) {ttft * 1e3:.1f} ms; on {card}", flush=True)
    for i, prompt in enumerate(prompts):
        compare_tokens(f"run {label} request {i} (prompt {len(prompt)})",
                       results[i], *refs[i])
    return counts


def phase_solo(cfg, prepared, prompt, n_new, refs, dev):
    """Solo make_generate on the card, f32, bf16 and int8 caches, greedy,
    against the no-cache reference and the bf16 and int8 cache loops.
    Returns launches."""
    from dnn_tpu_torch.runtime.generate import make_generate

    total = {}
    for kv_dtype, ref in refs.items():
        gen = make_generate(cfg, max_new_tokens=n_new, kv_dtype=kv_dtype,
                            device=dev)
        gen(prepared, [prompt[:8]])  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = gen(prepared, [prompt])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        require(f"make_generate {kv_dtype}", counts,
                [("cached_attention", kv_dtype),
                 ("decode_attention", kv_dtype)])
        print(f"[main] make_generate {kv_dtype}: {n_new} tokens after a "
              f"{len(prompt)}-token prompt in {wall * 1e3:.1f} ms", flush=True)
        compare_tokens(f"make_generate {kv_dtype}", out[0].tolist(), *ref)
        for name, by in counts.items():
            for dt, n in by.items():
                total.setdefault(name, {}).setdefault(dt, 0)
                total[name][dt] += n
    return total


def phase_main_path(dev, card: str):
    """Every main-path run: A paged f32, B dense + buckets f32, C paged
    int8, D paged bf16, then solo make_generate f32, bf16 and int8.
    Returns the launches of all runs summed per (kernel, dtype), and what
    the profile needs."""
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models.gpt import PRESETS, init

    cfg = PRESETS["gpt2"]
    t0 = time.perf_counter()
    prepared = from_jax_params(init(0, cfg), cfg, dev)
    torch.cuda.synchronize()
    print(f"[main] gpt2 weights (seed 0) on {dev} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 70, 130, 300)]
    n_new = 16
    t0 = time.perf_counter()
    ref_f32 = [reference_greedy(prepared, cfg, p, n_new, dev) for p in prompts]
    ref_i8, ref_bf16 = ([reference_greedy_cache(prepared, cfg, p, n_new, dev,
                                                kv_dtype) for p in prompts]
                        for kv_dtype in ("int8", "bf16"))
    print(f"[main] references (no-cache f32, plain int8 and bf16 cache "
          f"loops) in {time.perf_counter() - t0:.1f} s", flush=True)
    runs = [
        serve_run("A", cfg, prepared, prompts, n_new, ref_f32,
                  [("cached_attention", "f32"),
                   ("paged_decode_attention", "f32")], dev, card, kv="paged"),
        serve_run("B", cfg, prepared, prompts, n_new, ref_f32,
                  [("cached_attention", "f32"), ("decode_attention", "f32")],
                  dev, card, kv="dense", decode_buckets=True),
        serve_run("C", cfg, prepared, prompts, n_new, ref_i8,
                  [("cached_attention", "int8"),
                   ("paged_decode_attention", "int8")], dev, card,
                  kv="paged", kv_dtype="int8"),
        serve_run("D", cfg, prepared, prompts, n_new, ref_bf16,
                  [("cached_attention", "bf16"),
                   ("paged_decode_attention", "bf16")], dev, card,
                  kv="paged", kv_dtype="bf16"),
        phase_solo(cfg, prepared, prompts[3], n_new,
                   {"f32": ref_f32[3], "bf16": ref_bf16[3],
                    "int8": ref_i8[3]}, dev),
    ]
    launches = {name: {dt: sum(r[name][dt] for r in runs)
                       for dt in ("f32", "bf16", "int8")}
                for name in CACHE_KERNELS}
    return launches, prepared, cfg, prompts


def _kernel_events(fn):
    """(wall ms, the device-side events of fn()) under torch.profiler:
    kernels and copies only — an operator's row repeats the time of its
    kernels, and a user annotation (Optimizer.step) the time of the
    kernels inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not getattr(e, "is_user_annotation", False)]


def device_ms(fn, iters: int = 10) -> float:
    """Mean device time of one fn() call: the profiler's sum of its
    kernels' own time over `iters` calls, after a warm-up. For library
    calls that are not captured into a graph (an autograd backward): host
    overhead between kernels does not count."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    _, evs = _kernel_events(run)
    return sum(e.self_device_time_total for e in evs) / 1e3 / iters


def _profiled(fn):
    """(wall ms, device ms, kernel launches, top kernels, K5 device ms) of
    fn() under torch.profiler: device ms sums the kernels' own device
    time; K5's sums its split and merge kernels (cached_attn_*)."""
    wall, evs = _kernel_events(fn)
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    k5_ms = sum(e.self_device_time_total for e in evs
                if "cached_attn" in e.key) / 1e3
    n_kernels = sum(e.count for e in evs)
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:6]
    return wall, dev_ms, n_kernels, [(e.key[:60], e.self_device_time_total
                                      / 1e3, e.count) for e in top], k5_ms


PROFILED_POOLS = (("A paged f32", {"kv": "paged"}),
                  ("B dense+buckets f32", {"kv": "dense",
                                           "decode_buckets": True}),
                  ("C paged int8", {"kv": "paged", "kv_dtype": "int8"}),
                  ("D paged bf16", {"kv": "paged", "kv_dtype": "bf16"}))


def phase_profile(prepared, cfg, prompts, dev):
    """Information only: where a decode step's and a prefill's time goes
    on each main-path pool (the batcher driven directly, as the daemon's
    worker drives it): wall, device busy, kernel launches, top kernels."""
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    steps = 8
    for label, kv in PROFILED_POOLS:
        b = ContinuousBatcher(cfg, prepared, slots=4, max_len=1024,
                              prompt_pad=64, block_len=16, device=dev, **kv)
        for p in prompts[:3]:
            b.submit(p, 64)
        for _ in range(4):
            b.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            b.step()
        torch.cuda.synchronize()
        plain_wall = (time.perf_counter() - t0) * 1e3 / steps

        def decode():
            for _ in range(steps):
                b.step()

        wall, dev_ms, n_kern, top, _ = _profiled(decode)
        print(f"[profile] {label}: decode step (3 active slots) "
              f"{plain_wall:.3f} ms wall; under the profiler "
              f"{wall / steps:.3f} ms wall, {dev_ms / steps:.3f} ms device "
              f"busy ({100 * dev_ms / wall:.1f}% of wall), "
              f"{n_kern / steps:.0f} kernel launches per step", flush=True)
        for name, ms, n in top:
            print(f"[profile]   decode {ms / steps:.4f} ms/step  "
                  f"x{n // steps}  {name}", flush=True)
        wall, dev_ms, n_kern, top, k5_ms = _profiled(
            lambda: b.submit(prompts[3], 2))
        print(f"[profile] {label}: admission of a {len(prompts[3])}-token "
              f"prompt (5 chunks + install): {wall:.3f} ms wall, "
              f"{dev_ms:.3f} ms device busy ({100 * dev_ms / wall:.1f}%), "
              f"{n_kern} kernel launches; K5 {k5_ms:.4f} ms = "
              f"{100 * k5_ms / dev_ms:.1f}% of device busy", flush=True)
        for name, ms, n in top[:3]:
            print(f"[profile]   prefill {ms:.4f} ms  x{n}  {name}", flush=True)


TRAIN_B, TRAIN_T, TRAIN_LAYERS = 8, 512, 12


def require_exact(label, counts, expected):
    """Every (kernel, dtype) of `expected` launched exactly that many
    times in the run; prints the run's flash counts."""
    flash = {n: {dt: c for dt, c in counts[n].items() if c}
             for n in FLASH_KERNELS}
    print(f"[train] {label} flash launches: {flash}", flush=True)
    for (name, dt), n in expected.items():
        if counts[name][dt] != n:
            fail(f"{label}: {name} ({dt}) launched {counts[name][dt]} times, "
                 f"expected {n}")


def per_step(n_steps: int, dt: str = "f32", remat: bool = False):
    """The exact flash launches of n train steps (no eval): K2 once per
    layer (twice under remat: the recompute), K3 and K4 once, K1 never."""
    n, k2 = n_steps * TRAIN_LAYERS, (2 if remat else 1)
    return {("flash_attention", dt): 0, ("flash_attention_lse", dt): k2 * n,
            ("flash_bwd_dq", dt): n, ("flash_bwd_dkv", dt): n}


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def add_counts(total, counts):
    for name in FLASH_KERNELS:
        for dt in ("f32", "bf16"):
            total[name][dt] += counts[name][dt]


def _flash_share(fn):
    """(wall ms, device ms, flash-kernel share of device time, top
    kernels) of fn() under torch.profiler."""
    wall, evs = _kernel_events(fn)
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    flash_ms = sum(e.self_device_time_total for e in evs
                   if "flash_" in e.key) / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    return wall, dev_ms, flash_ms, [(e.key[:70], e.self_device_time_total
                                     / 1e3, e.count) for e in top]


def phase_train(dev, card):
    """The training main path: full-width gpt2 (seed-0 weights, nothing
    cut), B=8 T=512, make_apply_stacked(use_flash=True), next_token_loss,
    the port's adamw(1e-4), batches from a seeded token file through
    TokenDataset. Runs T-a..T-e, each with the launch counts zeroed just
    before and read just after. Returns the flash launches summed over
    the runs, {kernel: {dtype: n}}."""
    import itertools
    import os
    import shutil
    import tempfile

    from dnn_tpu_torch import optim, train
    from dnn_tpu_torch.data.tokens import TokenDataset, write_tokens
    from dnn_tpu_torch.models.gpt import (PRESETS, init, make_apply_stacked,
                                          prepare_stacked)
    from dnn_tpu_torch.utils.flops import gpt_train_step_flops

    cfg = PRESETS["gpt2"]
    t0 = time.perf_counter()
    tree = init(0, cfg)
    total = {n: {"f32": 0, "bf16": 0} for n in FLASH_KERNELS}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        path = os.path.join(tmp, "tokens.bin")
        write_tokens(path, np.random.default_rng(1).integers(
            0, cfg.vocab_size, 2_000_000))
        ds = TokenDataset(path)
        batch0 = next(ds.batches(TRAIN_B, TRAIN_T, seed=0))
        held = list(itertools.islice(ds.batches(TRAIN_B, TRAIN_T, seed=99), 2))
        print(f"[train] gpt2 tree (seed 0) and a {len(ds)}-token file in "
              f"{time.perf_counter() - t0:.1f} s; B={TRAIN_B} T={TRAIN_T}",
              flush=True)

        def fresh():
            prepared = prepare_stacked(tree, cfg, dev)
            opt = optim.adamw(1e-4)
            return (prepared, opt.init(prepared)), opt

        def fit_fn(opt, **kw):
            apply = make_apply_stacked(cfg, **kw)
            step = train.make_train_step(
                lambda p, b: train.next_token_loss(apply, p, b), opt)

            def fn(state, batch):
                params, opt_state, loss = step(*state, batch)
                return (params, opt_state), loss
            return fn

        def run(label, fn, state, batches, n, hook=None, **fit_kw):
            """fit n steps with the counts zeroed before and read after
            (hook(step) after each); returns (state, losses, per-step
            walls, counts)."""
            losses, stamps = [], []

            def on_step(step, loss):
                losses.append(loss.item())
                stamps.append(time.perf_counter())
                if hook is not None:
                    hook(step)
            torch.cuda.synchronize()
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            stamps.append(time.perf_counter())
            state, _ = train.fit(fn, state, batches, num_steps=n,
                                 on_step=on_step, **fit_kw)
            torch.cuda.synchronize()
            counts = read_counts()
            add_counts(total, counts)
            walls = [b - a for a, b in zip(stamps, stamps[1:])]
            print(f"[train] {label}: losses {[round(x, 5) for x in losses]}",
                  flush=True)
            return state, losses, walls, counts

        # T-a: loss and per-leaf gradients, kernels against the einsum
        tokens0 = torch.as_tensor(batch0, device=dev)
        grads = {}
        for use_flash in (True, False):
            (prepared, _), _ = fresh()
            apply = make_apply_stacked(cfg, use_flash=use_flash)
            torch.cuda.synchronize()
            reset_counts()
            loss = train.next_token_loss(apply, prepared, tokens0)
            loss.backward()
            torch.cuda.synchronize()
            counts = read_counts()
            if use_flash:
                add_counts(total, counts)
                require_exact("T-a one step", counts, per_step(1))
            else:
                require_exact("T-a einsum step", counts, {
                    (n, "f32"): 0 for n in FLASH_KERNELS})
            grads[use_flash] = (loss.item(), {
                k: leaf.grad for k, leaf in named_leaves(prepared)})
            del prepared
        (lf, gf), (le, ge) = grads[True], grads[False]
        if not abs(lf - le) <= 1e-5 * abs(le):
            fail(f"T-a: loss {lf} (kernels) vs {le} (einsum)")
        worst = max(((gf[k] - ge[k]).abs().max().item()
                     / max(ge[k].abs().max().item(), 1e-30), k) for k in ge)
        if not worst[0] <= 1e-4:
            fail(f"T-a: leaf {worst[1]} max|dg| = {worst[0]:.3e} x max|g|")
        print(f"[train] T-a: loss {lf:.6f} (kernels) vs {le:.6f} (einsum), "
              f"rel {abs(lf - le) / le:.2e}; worst leaf {worst[1]} max|dg| "
              f"{worst[0]:.2e} x its max|g| (limit 1e-4)", flush=True)
        del grads, gf, ge

        # T-b: 8 steps on one repeated batch; the loss falls at every step
        state, opt = fresh()
        after2 = {}

        def keep_step2(step):
            if step == 2:
                after2.update({k: t.detach().clone()
                               for k, t in named_leaves(state[0])})
        _, losses_b, walls_b, counts = run(
            "T-b 8 steps, one batch", fit_fn(opt, use_flash=True), state,
            itertools.repeat(batch0), 8, hook=keep_step2)
        del state
        require_exact("T-b", counts, per_step(8))
        if any(b >= a for a, b in zip(losses_b, losses_b[1:])):
            fail(f"T-b: the loss did not fall at every step: {losses_b}")
        peak_f32 = torch.cuda.max_memory_allocated()

        # remat: 2 steps; K2 twice per layer, loss and params as without
        state_r, opt_r = fresh()
        state_r, losses_r, _, counts = run(
            "remat 2 steps", fit_fn(opt_r, use_flash=True, remat=True),
            state_r, itertools.repeat(batch0), 2)
        require_exact("remat", counts, per_step(2, remat=True))
        d_loss = max(abs(a - b) for a, b in zip(losses_r, losses_b[:2]))
        d_par = max((t - after2[k]).abs().max().item()
                    for k, t in named_leaves(state_r[0]))
        if d_loss > 1e-6 or d_par > 1e-6:
            fail(f"remat: loss differs by {d_loss}, params by {d_par}")
        print(f"[train] remat: losses within {d_loss:.1e}, params within "
              f"{d_par:.1e} of the run without it (limit 1e-6)", flush=True)
        del state_r, after2

        # T-c: 6 steps with checkpoints every 3; resume from 3, 3 more
        ck, ck3 = os.path.join(tmp, "ck"), os.path.join(tmp, "ck3")
        state, opt = fresh()
        fn = fit_fn(opt, use_flash=True)
        state, _, _, counts = run(
            "T-c 6 steps, checkpoint every 3", fn, state,
            ds.batches(TRAIN_B, TRAIN_T, seed=2), 6, ckpt_dir=ck,
            ckpt_every=3, keep_checkpoints=2)
        require_exact("T-c", counts, per_step(6))
        whole = {k: t.detach().clone() for k, t in named_leaves(state[0])}
        os.makedirs(ck3)
        for name in ("step_00000003.npz", "step_00000003.npz.manifest.json"):
            os.replace(os.path.join(ck, name), os.path.join(ck3, name))
        del state
        fresh_state, opt = fresh()
        state, start = train.resume_or_init(ck3, fresh_state)
        if start != 3:
            fail(f"T-c: resumed at step {start}, expected 3")
        state, _, _, counts = run(
            "T-c resumed at 3, to 6", fit_fn(opt, use_flash=True), state,
            ds.batches(TRAIN_B, TRAIN_T, seed=2), 6, start_step=3)
        require_exact("T-c resume", counts, per_step(3))
        d_res = max((t - whole[k]).abs().max().item()
                    for k, t in named_leaves(state[0]))
        if d_res != 0.0:
            fail(f"T-c: resumed params differ by {d_res} (expected "
                 "bit-equal: the kernels and the step are deterministic)")
        print(f"[train] T-c: resumed run == uninterrupted run, max|d| "
              f"{d_res} (bit-equal)", flush=True)
        del whole

        # T-d: evaluate, K1's path
        apply = make_apply_stacked(cfg, use_flash=True)
        torch.cuda.synchronize()
        reset_counts()
        ev = train.evaluate(apply, state[0], held)
        torch.cuda.synchronize()
        counts = read_counts()
        add_counts(total, counts)
        require_exact("T-d evaluate", counts, {
            ("flash_attention", "f32"): TRAIN_LAYERS * len(held),
            ("flash_attention_lse", "f32"): 0, ("flash_bwd_dq", "f32"): 0,
            ("flash_bwd_dkv", "f32"): 0})
        if not math.isfinite(ev["loss"]):
            fail(f"T-d: evaluate loss {ev['loss']}")
        print(f"[train] T-d: evaluate on {ev['batches']} held-out batches "
              f"({ev['tokens']} tokens): loss {ev['loss']:.5f} perplexity "
              f"{ev['perplexity']:.2f}", flush=True)

        # information: one profiled f32 step
        wall, dev_ms, flash_ms, top = _flash_share(
            lambda: fn(state, batch0))
        print(f"[profile] train step f32: {wall:.1f} ms wall, {dev_ms:.1f} ms "
              f"device busy; flash kernels {flash_ms:.2f} ms = "
              f"{100 * flash_ms / dev_ms:.1f}% of device time", flush=True)
        for name, ms, n in top:
            print(f"[profile]   {ms:8.3f} ms  x{n}  {name}", flush=True)
        del state

        # T-e: bf16 compute, 3 steps, then evaluate
        state, opt = fresh()
        fn_e = fit_fn(opt, use_flash=True, compute_dtype=torch.bfloat16)
        state, losses_e, _, counts = run(
            "T-e bf16 3 steps", fn_e, state, itertools.repeat(batch0), 3)
        if abs(losses_e[0] - lf) > 2e-2:
            fail(f"T-e: first bf16 loss {losses_e[0]} vs f32 {lf}")
        if not all(torch.isfinite(t.grad).all() for _, t in
                   named_leaves(state[0])):
            fail("T-e: non-finite gradients")
        apply_bf16 = make_apply_stacked(cfg, use_flash=True,
                                        compute_dtype=torch.bfloat16)
        reset_counts()
        ev_bf16 = train.evaluate(apply_bf16, state[0], held[:1])
        torch.cuda.synchronize()
        counts_e = read_counts()
        add_counts(total, counts_e)
        for name in FLASH_KERNELS:
            counts_e[name]["bf16"] += counts[name]["bf16"]
        require_exact("T-e steps + evaluate", counts_e, {
            **per_step(3, "bf16"),
            ("flash_attention", "bf16"): TRAIN_LAYERS})
        print(f"[train] T-e: first bf16 loss {losses_e[0]:.5f} vs f32 "
              f"{lf:.5f} (limit 2e-2); evaluate loss {ev_bf16['loss']:.5f}",
              flush=True)

        # information: 6 more bf16 steps for the step time, one profiled
        state, _, walls_e, counts = run(
            "bf16 timing, 6 more steps", fn_e, state,
            itertools.repeat(batch0), 6)
        require_exact("bf16 timing", counts, per_step(6, "bf16"))
        peak_bf16 = torch.cuda.max_memory_allocated()
        wall, dev_ms, flash_ms, top = _flash_share(
            lambda: fn_e(state, batch0))
        print(f"[profile] train step bf16: {wall:.1f} ms wall, {dev_ms:.1f} "
              f"ms device busy; flash kernels {flash_ms:.2f} ms = "
              f"{100 * flash_ms / dev_ms:.1f}% of device time", flush=True)
        for name, ms, n in top:
            print(f"[profile]   {ms:8.3f} ms  x{n}  {name}", flush=True)

        flops = gpt_train_step_flops(cfg, TRAIN_B, TRAIN_T)
        for label, walls, peak_mem, peak, pname in (
                ("f32", walls_b[1:], peak_f32, F32_FLOPS_PER_S,
                 "67 TFLOP/s f32 CUDA-core peak"),
                ("bf16", walls_e, peak_bf16, BF16_FLOPS_PER_S,
                 "989 TFLOP/s bf16 tensor-core peak")):
            step_s = float(np.median(walls))
            print(f"[train] {label} step (median of {len(walls)} warm "
                  f"steps): {step_s * 1e3:.1f} ms wall, "
                  f"{TRAIN_B * TRAIN_T / step_s:.0f} tokens/s, peak "
                  f"{peak_mem / 2**30:.2f} GiB allocated, MFU "
                  f"{100 * flops / step_s / peak:.2f}% of the {pname} "
                  f"({flops / 1e12:.3f} TFLOP/step); on {card}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total


def kernel_record(name, source, replaces, rows, main_row, launches):
    """One entry of the kernels line: the f32 case at the main-path shape
    on top, every cache type under by_dtype, launches summed over the
    main-path runs."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    by = {dt: {"launches": launches[dt], **{k: rows[dt][k] for k in keys}}
          for dt in rows}
    top = {k: rows[main_row][k] for k in keys}
    top["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            **top, "by_dtype": by}


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    phase_build()
    k5 = phase_k5(dev, gen)
    k6 = phase_k6(dev, gen)
    k7 = phase_k7(dev, gen)
    flash = {**phase_flash_fwd(dev, gen), **phase_flash_bwd(dev, gen)}
    launches, prepared, cfg, prompts = phase_main_path(dev, smi)
    phase_profile(prepared, cfg, prompts, dev)
    del prepared
    launches.update(phase_train(dev, smi))

    src = "dnn_tpu_torch/ops/cuda/csrc/"
    pallas = "dnn_tpu/ops/pallas/cached_attention.py"
    kernels = [
        kernel_record("cached_attention", src + "cached_attention.cu",
                      pallas + ":77",
                      {dt: k5[(dt, 960)] for dt, _ in KV_CASES}, "f32",
                      launches["cached_attention"]),
        kernel_record("decode_attention", src + "decode_attention.cu",
                      pallas + ":296", k6, "f32",
                      launches["decode_attention"]),
        kernel_record("paged_decode_attention", src + "paged_decode.cu",
                      pallas + ":459", k7, "f32",
                      launches["paged_decode_attention"]),
    ]
    flash_py = "dnn_tpu/ops/pallas/flash_attention.py"
    for name, source, line in (
            ("flash_attention", "flash_attention.cu", 50),
            ("flash_attention_lse", "flash_attention.cu", 102),
            ("flash_bwd_dq", "flash_backward.cu", 149),
            ("flash_bwd_dkv", "flash_backward.cu", 181)):
        kernels.append(kernel_record(name, src + source, f"{flash_py}:{line}",
                                     flash[name], "f32", launches[name]))
    print(f"{smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
