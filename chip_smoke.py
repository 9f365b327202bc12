#!/usr/bin/env python
"""Chip smoke test of the PyTorch/CUDA port: builds the CUDA kernels,
holds each against its plain PyTorch version on the card, then serves
GPT-2 at full width through the LM daemon over gRPC in four cache
configurations, runs the solo decoder, checks every greedy stream
against an independent reference, trains full-width GPT-2 through the
flash-attention kernels, and serves llama3-8b at full width and depth
over the paged pool (K5 with grouped heads, K6/K7 at four rows a KV
head).

    python3 chip_smoke.py        # from the repo root, on a machine with one CUDA card
    python3 chip_smoke.py --decode-turns PARENT
        # K6/K7 of this tree against those of the tree unpacked at PARENT
        # (e.g. a `git archive` of the parent commit), in turns: parent,
        # this tree, this tree, parent -- each turn one process that
        # builds the two libraries and runs that tree's phases 3 and 4

Phases (any failure exits non-zero and prints no result):
  1. the card's name and power limit (nvidia-smi); TF32 off; kernel build
  1b. [wire] the native CRC-32C on the host, on the crc32 instruction
     and on slice-by-8: each equal to the per-byte version on
     0/1/7/8/9/4095/65537-byte buffers with two seeds, each one's rate
     on 64 MiB, make_tensor and tensor_view of P-b's 51.5 MB f32
     logits timed, a flipped byte refused
  2. K5 cached_attention at the prefill shape (B=1 H=12 T=64 S=1024 D=64),
     bases {0, 64, 448, 960}, f32, bf16 and int8 caches; its split-KV
     plan (splits, kernel launches a call), and at base 960 its time
     against SDPA's
  3. K6 decode_attention at the dense decode shape (B=4 Hk=12 R=1 D=64
     S=1024), pos {0,15,16,1023}, f32/bf16/int8; also a stale slot at
     pos = S and an R=2 case (checked only); its split-KV plan; and at
     the solo decoder's shape (B=1 Hk=12 R=1 S=316, pos 315), timed
     against SDPA for the float types
  4. K7 paged_decode_attention at the decode shape (B=4 Hk=12 R=1 D=64,
     bp=16, nb_max=64, 257 pool blocks), permuted table, pos
     {0,15,16,1023}, f32/bf16/int8 pools; its split-KV plan
  4a. information: K6 at both shapes and K7 timed (and checked) under
     splits of 64, 128 and 256 keys
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
  5b. [text] the daemon at run A's configuration with a tokenizer that
     encodes as ByteTokenizer does and decodes each id to a character of
     its own: on a 282-byte UTF-8 prompt, the ids behind generate_text's
     reply (SendMessage), GenerateStream's ids and SendTensor's tokens
     each equal the no-cache greedy loop; the reply equals the decode of
     SendTensor's tokens; generate_text_stream's chunks join to the
     reply; "!stats"; launches counted (K5, K7)
  6. information: a torch.profiler view of a decode step and of one
     prompt's admission on each pool A-D (wall, device busy, top
     kernels, K6/K7's share of the step's device busy, K5's share of the
     admission's)
  6a. [pipe] the staged pipeline: P-a cifar_cnn as two `node --serve`
     processes; P-b gpt2-medium (configs/gpt2_8stage.json, bf16) as 8
     in-process stage servers, one B=1 T=256 request whose logits equal
     the relay engine's bit for bit; P-d the same servers, 4 microbatches
     over the streamed Relay RPC (send_tensors), each equal to the relay
     engine's run bit for bit, beside 4 sequential unary requests; P-c
     engine.generate gpt2 in 4 parts against the greedy loop (K5, K6)
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
  6c. [llama] llama3-8b (32 layers, 4096 wide, 32 heads over 8 KV
     heads, D=128, vocab 128256, rope theta 500000), f32:
       kernel rows at its shapes, each against its plain version, f32,
       bf16 and int8, timed against SDPA with enable_gqa for the float
       types: K5 with grouped heads (B=1 H=32 Hk=8 T=64 S=1024, base
       960), K7 (B=4 Hk=8 R=4, 16-row blocks), K6 solo (B=1 Hk=8 R=4
       S=332, L-solo's cache);
       weights drawn on the card in the JAX tree layout from a seeded
       torch.Generator and passed through convert.from_jax_params; then,
       each run with the launch counts zeroed just before and read just
       after, and the exact counts of the call pattern required:
       L-A the LM daemon (paged f32 pool, 257 blocks of 16), the four
           prompts, 16 greedy tokens each, against the no-cache loop on
           the llama forward (K5, K7)
       L-C the same with int8 KV, against the plain int8 cache loop
           prefilled in 64-token chunks as served (K5, K7 int8); a
           divergence is accepted where the loop's top-2 gap is below
           5e-3 (QUANT_TIE): int8 rounding flips of values at a
           quantization boundary; the whole-prompt int8 loop's parting
           from the chunked one is printed
       L-solo llama.make_generate on the 300-token prompt, 32 tokens,
           dense f32 cache, against the no-cache loop (K5, K6)
     plus information: a decode step's and the 300-token admission's
     wall, device busy and top kernels
  7. one JSON line describing the kernels, then the result line.

Tolerances against the plain versions: 1e-4 for f32 and int8 caches
(both sides read the same values; only the summation order differs),
2e-2 for bf16. A served token may differ from its reference only where
the reference's top-2 logit gap is below 1e-4 (a near-tie); 5e-3 for
llama3-8b over an int8 cache (QUANT_TIE).
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
three bf16 products) beside the f32 CUDA-core figure. K5 likewise
(k5_bound): its function's products over the live columns at the
fastest tensor-core rate for its cache's type (TF32 for f32, bf16 for
bf16 and int8), with the products it issues and the f32 CUDA-core
figure printed beside it.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import signal
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
    # a length prefix may follow digits of a hash: try every tail of a run;
    # a hash's digits can also prefix a longer run that ends in "kernel",
    # so the identifier is the shortest such word
    starts = [i for m in re.finditer(r"\d+", mangled)
              for i in range(m.start(), m.end())]
    words = []
    for i in starts:
        end = re.match(r"\d+", mangled[i:]).end() + i
        word = mangled[end:end + int(mangled[i:end])]
        if word.endswith("kernel"):
            words.append((len(word), end, word))
    if not words:
        return mangled
    _, end, word = min(words)
    targs = mangled[end + len(word):].split("EE")[0]
    if not targs.startswith("I"):
        return word
    types = {"If": "f32", "I13__nv_bfloat16": "bf16", "Ia": "int8"}
    names = [t for pre, t in types.items() if targs.startswith(pre)]
    names += re.findall(r"L[ib](-?\d+)", targs)
    return f"{word}<{', '.join(names)}>"


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


WIRE_LENGTHS = (0, 1, 7, 8, 9, 4095, 65537)
WIRE_RATE_BYTES = 64 << 20
WIRE_LOGITS = (1, 256, 50257)  # P-b's f32 logits, 51.5 MB


def phase_wire(card):
    """[wire] the native CRC-32C on the host: its route (the SSE4.2
    crc32 instruction or slice-by-8) and the slice-by-8 route both equal
    to the per-byte version on buffers of WIRE_LENGTHS bytes, seed 0 and
    a nonzero seed; both routes' rates on a 64 MiB buffer; make_tensor
    and tensor_view of P-b's checksummed f32 logits timed; a flipped
    payload byte refused."""
    from dnn_tpu_torch import native
    from dnn_tpu_torch.comm import wirecodec as wc

    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    for n in WIRE_LENGTHS:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0, 0x1234ABCD):
            want = native.crc32c_plain(data, seed)
            for fn in (native.crc32c, native.crc32c_sliced):
                got = fn(data, seed)
                if got != want:
                    fail(f"[wire] {fn.__name__} of {n} bytes (seed "
                         f"{seed:#x}): {got:#010x} != per-byte {want:#010x}")
    big = rng.integers(0, 256, WIRE_RATE_BYTES, dtype=np.uint8)
    best_s = {}
    for fn in (native.crc32c, native.crc32c_sliced):
        fn(big)
        times = []
        for _ in range(5):
            t1 = time.perf_counter()
            fn(big)
            times.append(time.perf_counter() - t1)
        best_s[fn.__name__] = min(times)
    rate = WIRE_RATE_BYTES / best_s["crc32c"] / 1e9
    rate_sliced = WIRE_RATE_BYTES / best_s["crc32c_sliced"] / 1e9
    route = "the SSE4.2 crc32 instruction" if native.hardware() else \
        "slice-by-8"
    logits = rng.standard_normal(WIRE_LOGITS, dtype=np.float32)
    t1 = time.perf_counter()
    raw = wc.serialize_response(wc.TensorResponse(
        status="ok", result_tensor=wc.make_tensor(logits)))
    encode_s = time.perf_counter() - t1
    msg = wc.parse_response(raw).result_tensor
    t1 = time.perf_counter()
    view = wc.tensor_view(msg)
    verify_s = time.perf_counter() - t1
    if not np.array_equal(view, logits):
        fail("[wire] the logits did not survive the wire")
    bad = bytearray(raw)
    bad[len(bad) // 2] ^= 0x01
    try:
        wc.tensor_view(wc.parse_response(bytes(bad)).result_tensor)
        fail("[wire] a flipped payload byte was not refused")
    except wc.PayloadCorruptError:
        pass
    print(f"[wire] native crc32c on {route} (g++ build/load "
          f"{build_s:.2f} s) and its slice-by-8 route equal the per-byte "
          f"version on {len(WIRE_LENGTHS)} lengths x 2 seeds; on "
          f"{WIRE_RATE_BYTES >> 20} MiB (best of 5) crc32c {rate:.2f} GB/s "
          f"({best_s['crc32c'] * 1e3:.2f} ms), slice-by-8 "
          f"{rate_sliced:.2f} GB/s ({best_s['crc32c_sliced'] * 1e3:.2f} ms)"
          f"; the {logits.nbytes / 1e6:.1f} MB "
          f"logits: make_tensor + serialize {encode_s * 1e3:.2f} ms, "
          f"tensor_view (crc verify) {verify_s * 1e3:.2f} ms; a flipped "
          f"byte raises PayloadCorruptError; on the host of {card}",
          flush=True)
    return {"crc32c_gb_s": rate, "crc32c_sliced_gb_s": rate_sliced,
            "tensor_view_ms": verify_s * 1e3}


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


def report(tag, label, row, nbytes, byte_ms, op_ms, ops="f32 ops"):
    lib = row["library_ms"]
    print(f"[{tag}] {label}: err {row['max_abs_err']:.3e} kernel_ms "
          f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} library_ms "
          f"{'none' if lib is None else f'{lib:.4f}'} bound_ms "
          f"{row['bound_ms']:.5f} ({row['bound_by']}; bytes {byte_ms:.5f} "
          f"for {nbytes / 1e6:.3f} MB at 3.35 TB/s, {ops} {op_ms:.5f})",
          flush=True)


def k5_bound(name, B, H, HK, T, S, base, D):
    """K5's bound at one chunk of q (B, H, T, D) at positions base + t
    against a cache (B, HK, S, D) of type `name`: the bytes (q read and
    the output written in f32, the HK heads' live K/V once, int8 scales
    included, pos) at 3.35 TB/s, or the function's own products (one
    Q.K^T and one P.V over each row's live columns, 4 D FLOPs a live
    score) at the fastest tensor-core rate for the cache's type: TF32 for
    f32, bf16 for bf16 and for int8 (q stays f32, so the int8 rate does
    not apply). Returns (nbytes, live scores, ops label, bound(...))."""
    live = min(S, base + T)
    nbytes = 2 * B * H * T * D * 4 + B * HK * kv_bytes(name, live, D) + B * 4
    scores = B * H * sum(min(S, base + t + 1) for t in range(T))
    peak, label = ((TF32_FLOPS_PER_S, "TF32 ops at 494.7 TFLOP/s")
                   if name == "f32" else
                   (BF16_FLOPS_PER_S, "bf16 ops at 989 TFLOP/s"))
    return nbytes, scores, label, bound(nbytes, 4 * D * scores, peak)


def phase_k5(dev, gen):
    """K5 against its plain version at the prefill-chunk shape, f32,
    bf16 and int8 caches. Returns {(dtype, base): row}. The bound is
    k5_bound's. Printed beside it, as information: the products the
    kernel issues on the tensor cores (over every 64-key tile up to each
    query tile's last live column, two bf16 products a tile for Q.K^T and
    two for P.V, three each for an f32 cache) at 989 TFLOP/s, and the f32
    CUDA-core time of the live scores, the bound of the earlier CUDA-core
    design."""
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
            nbytes, scores, ops, (b_ms, b_by, byte_ms, op_ms) = k5_bound(
                name, B, H, H, T, S, base, D)
            tiles = B * H * sum(
                min(S - 1, base + min(T, K5_TILE * (i + 1)) - 1) // K5_TILE + 1
                for i in range(q_tiles))
            products = 3 if name == "f32" else 2
            tc_flops = tiles * 2 * products * 2 * K5_TILE * K5_TILE * D
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
                  f"{nbytes / 1e6:.3f} MB at 3.35 TB/s, {ops} {op_ms:.5f}; "
                  f"issued: {tiles} tiles x {2 * products} bf16 products "
                  f"{tc_flops / BF16_FLOPS_PER_S * 1e3:.5f} at 989 TFLOP/s, "
                  f"f32 CUDA-core ops of the live scores "
                  f"{4 * D * scores / F32_FLOPS_PER_S * 1e3:.5f}); kernel / "
                  f"bound {ms / b_ms:.1f}", flush=True)
        if lib is not None:
            at = rows[(name, 960)]
            print(f"[K5] {name} base 960: kernel {at['ms']:.4f} ms, SDPA "
                  f"({name} q, k, v) {at['library_ms']:.4f} ms: kernel / "
                  f"library {at['ms'] / at['library_ms']:.2f}", flush=True)
    return rows


def decode_plan(tag, bh, s, unit=1):
    """Prints K6/K7's split-KV plan for `bh` (slot, KV head) pairs over
    `s` logical columns (in whole `unit`s: K7's blocks)."""
    from dnn_tpu_torch.ops.cuda.cached_attention import decode_split

    split_keys, n_split = decode_split(bh, s, unit)
    print(f"[{tag}] plan for {bh} (slot, head) pairs over {s} columns: "
          f"{n_split} splits of {split_keys} keys, grid ({n_split}, {bh}), "
          f"{2 if n_split > 1 else 1} kernel launches a call (split"
          f"{' + merge' if n_split > 1 else ''})", flush=True)


def phase_k6(dev, gen):
    """K6 against its plain version at the dense decode-step shape
    (B=4 Hk=12 R=1 D=64 S=1024, pos {0, 15, 16, 1023}), f32, bf16 and
    int8 caches; plus, checked only, a stale inactive slot at pos = S and
    an R=2 case. Returns {dtype: row}."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        decode_attention, reference_decode_attention)

    B, Hk, R, D, S = 4, 12, 1, 64, 1024
    decode_plan("K6", B * Hk, S)
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
    decode_plan("K7", B * Hk, nb_max * bp, bp)
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


SOLO_B, SOLO_HK, SOLO_S = 1, 12, 316  # make_generate: 300 + 16 rows


def phase_k6_solo(dev, gen):
    """K6 at the solo decoder's shape (B=1 Hk=12 R=1 D=64, a 316-row
    cache, pos 315: the last step of a 300-token prompt's 16 new
    tokens), f32, bf16 and int8, against its plain version, timed
    against SDPA for the float types. Returns {dtype: row}."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        decode_attention, reference_decode_attention)

    B, Hk, R, D, S = SOLO_B, SOLO_HK, 1, 64, SOLO_S
    decode_plan("K6 solo", B * Hk, S)
    pos = torch.tensor([S - 1], dtype=torch.int32, device=dev)
    rows = {}
    for name, tol in KV_CASES:
        q = torch.randn(LAYERS, B, Hk, R, D, generator=gen, device=dev)
        k, v, ks, vs = kv_cache(gen, (LAYERS, B, Hk, S, D), name, dev)
        sc = scales_at(ks, vs, 0)
        err = check(f"K6 solo {name}",
                    decode_attention(q[0], k[0], v[0], pos, **sc),
                    reference_decode_attention(q[0], k[0], v[0], pos, **sc),
                    tol)
        nbytes = 2 * B * Hk * R * D * 4 + Hk * kv_bytes(name, S, D) + B * 4
        b_ms, b_by, byte_ms, op_ms = bound(nbytes, 4 * D * Hk * R * S)
        ms = time_ms(cycling(lambda i: decode_attention(
            q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
        plain = time_ms(cycling(lambda i: reference_decode_attention(
            q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
        lib = None
        if name != "int8":  # every column is live: SDPA without a mask
            qd = q.to(k.dtype)
            lib = time_ms(cycling(
                lambda i: torch.nn.functional.scaled_dot_product_attention(
                    qd[i], k[i], v[i]), LAYERS))
        row = rows[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        report("K6 solo", f"{name:4s} B={B} S={S} pos {S - 1}", row, nbytes,
               byte_ms, op_ms)
        if lib is not None:
            print(f"[K6 solo] {name}: kernel / SDPA {ms / lib:.2f}",
                  flush=True)
    return rows


DECODE_SWEEP = (32, 64, 128, 256)  # keys a split


def phase_decode_splits(dev, gen):
    """Information: K6 at the timing and solo shapes and K7 at the timing
    shape under splits of DECODE_SWEEP keys (in place of the wrapper's
    plan, `decode_split`), each checked against its plain version and
    timed."""
    from dnn_tpu_torch.ops.cuda import cached_attention as tca

    def fixed(keys):
        def plan(bh, s, unit=1):
            split_keys = -(-keys // unit) * unit
            return split_keys, -(-s // split_keys)
        return plan

    shapes = (("K6", 4, 1024, [0, 15, 16, 1023]),
              ("K6 solo", SOLO_B, SOLO_S, [SOLO_S - 1]),
              ("K7", 4, 1024, [0, 15, 16, 1023]))
    keep = tca.decode_split
    try:
        for tag, B, S, pos_list in shapes:
            paged = tag == "K7"
            pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
            bp = 16
            tables = torch.arange(1, B * S // bp + 1, dtype=torch.int32,
                                  device=dev).reshape(B, S // bp)
            for name, tol in KV_CASES:
                q = torch.randn(LAYERS, B, 12, 1, 64, generator=gen,
                                device=dev)
                shape = ((LAYERS, B * S // bp + 1, 12, bp, 64) if paged
                         else (LAYERS, B, 12, S, 64))
                k, v, ks, vs = kv_cache(gen, shape, name, dev)

                def call(f, i):
                    sc = scales_at(ks, vs, i)
                    if paged:
                        return f(q[i], k[i], v[i], tables, pos, **sc)
                    return f(q[i], k[i], v[i], pos, **sc)
                fn, ref = ((tca.paged_decode_attention,
                            tca.reference_paged_decode_attention) if paged
                           else (tca.decode_attention,
                                 tca.reference_decode_attention))
                times = []
                for keys in DECODE_SWEEP:
                    tca.decode_split = fixed(keys)
                    check(f"{tag} {name} split {keys}", call(fn, 0),
                          call(ref, 0), tol)
                    times.append(time_ms(cycling(
                        lambda i: call(fn, i), LAYERS)))
                print(f"[splits] {tag} {name:4s} B={B} S={S}: "
                      + ", ".join(f"{keys} keys {t:.4f} ms" for keys, t
                                  in zip(DECODE_SWEEP, times)), flush=True)
    finally:
        tca.decode_split = keep


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


def reference_greedy_cache(prepared, cfg, prompt, n_new, dev, kv_dtype,
                           chunk=None):
    """Independent greedy loop over a dense cache of type `kv_dtype`
    ("bf16" or "int8"): no batcher and no kernel. A cache of prompt +
    n_new positions (at KV heads for a LlamaConfig); bf16 stores K/V
    rounded to bf16, int8 quantizes them with the port's _quantize_rows
    and keeps the scales; attention is the plain version (grouped heads
    for llama), its output cast to the cache's type for a bf16 cache, as
    the port's FloatKV.attend does. The blocks around the attention are
    the family's own (gpt2's, or models/llama.py's). The prompt prefills
    in one piece or, with `chunk`, in chunk-token pieces, the last one
    right-padded with id 0, as the batcher prefills (the padded rows'
    K/V lie past every later query's limit). Returns (tokens, top-2
    logit gap at each step)."""
    from dnn_tpu_torch.models.gpt import head, layer_params
    from dnn_tpu_torch.ops.attention import merge_heads
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        reference_cached_attention)
    from dnn_tpu_torch.ops.nn import embedding, layer_norm, linear
    from dnn_tpu_torch.runtime.generate import _mlp, _qkv_heads
    from dnn_tpu_torch.runtime.kvcache import _quantize_rows

    from dnn_tpu_torch.models import llama
    from dnn_tpu_torch.runtime.kvcache import cache_shape

    if kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"kv_dtype must be bf16 or int8, got {kv_dtype!r}")
    quant = kv_dtype == "int8"
    store = torch.int8 if quant else torch.bfloat16
    is_llama = isinstance(cfg, llama.LlamaConfig)
    padded = len(prompt) if chunk is None else -(-len(prompt) // chunk) * chunk
    shape = cache_shape(cfg, 1, max(padded, len(prompt) + n_new))
    kv = {"k": torch.zeros(shape, dtype=store, device=dev),
          "v": torch.zeros(shape, dtype=store, device=dev)}
    if quant:
        kv["ks"] = torch.ones(shape[:-1], device=dev)
        kv["vs"] = torch.ones(shape[:-1], device=dev)

    def attend(i, q, k, v, start, pos):
        """Writes this layer's k/v at [start, start + T) of the cache,
        then attends it in the plain version (grouped heads for llama)."""
        t = k.shape[2]
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
        return y if quant else y.to(store)

    def last_logits(ids, start):
        t = ids.shape[1]
        pos = torch.full((1,), start, dtype=torch.int32, device=dev)
        rows = torch.arange(start, start + t, device=dev)
        if is_llama:  # the LLaMA block, its attention the plain version
            x = llama._scaled_embed(prepared, ids, cfg)
            cos, sin = llama._rope_tables(cfg, rows)
            for i in range(cfg.n_layer):
                bp = layer_params(prepared["blocks"], i)
                h = llama._pre_normed(bp, x, cfg)
                q, k, v = llama._qkv(bp, h, cfg)
                q, k = llama._rotated(q, k, cos, sin, cfg)
                y = attend(i, q, k, v, start, pos)
                o = linear(bp["attn"]["o"], merge_heads(y.to(x.dtype)))
                x = llama._branches_residual(bp, x, o, h, cfg=cfg)
            return llama.head(prepared, x, cfg=cfg)[0]
        x = (embedding(prepared["wte"], ids)
             + embedding(prepared["wpe"], rows))
        for i in range(cfg.n_layer):
            bp = layer_params(prepared["blocks"], i)
            q, k, v = _qkv_heads(bp, layer_norm(bp["ln_1"], x, eps=cfg.ln_eps),
                                 cfg=cfg)
            y = attend(i, q, k, v, start, pos)
            x = x + linear(bp["attn"]["proj"], merge_heads(y.to(x.dtype)))
            x = x + _mlp(bp, layer_norm(bp["ln_2"], x, eps=cfg.ln_eps))
        return head(prepared, x, cfg=cfg)[0]

    with torch.no_grad():
        ids = torch.zeros((1, padded), dtype=torch.int64, device=dev)
        ids[0, :len(prompt)] = torch.tensor(prompt, device=dev)
        step = chunk or padded
        for c0 in range(0, padded, step):
            logits = last_logits(ids[:, c0:c0 + step], c0)
        logits = logits[len(prompt) - 1 - c0]
        start, toks, gaps = len(prompt), [], []
        for _ in range(n_new):
            top2 = torch.topk(logits, 2).values
            gaps.append((top2[0] - top2[1]).item())
            toks.append(int(logits.argmax()))
            logits = last_logits(torch.tensor([[toks[-1]]], device=dev),
                                 start)[-1]
            start += 1
    return toks, gaps


NEAR_TIE = 1e-4
# llama3-8b over an int8 cache: a K/V value within f32 rounding noise of
# a quantization boundary rounds either way, and 32 layers carry the flip
# to the logits. L-C's served streams are held to the plain int8 loop
# prefilled in the served 64-token chunks; on an H100 they parted from it
# only at a top-2 gap of 1.967e-3, so the tie is that with 2.5x headroom
# (the [llama] lines print this run's gaps)
QUANT_TIE = 5e-3


def compare_tokens(label, got, want, gaps, tie=NEAR_TIE):
    """Served tokens against a reference's; a divergence is accepted only
    at a near-tie of the reference (top-2 gap < `tie`), and the rest of
    the stream is then not compared."""
    if len(got) != len(want):
        fail(f"{label}: {len(got)} tokens, expected {len(want)}")
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            if gaps[j] < tie:
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
              card, exact=None, tie=NEAR_TIE, **kv):
    """One main-path run: the LM daemon in-process (4 slots, max_len
    1024, prompt_pad 64) with the cache options `kv`, 4 concurrent gRPC
    generate calls, greedy; tokens checked against `refs` (tokens, gaps)
    per prompt, and every (kernel, dtype) of `needed` launched in the
    run. `exact(steps)`, where given, returns {(kernel, dtype): launches}
    that the run must show exactly, from the number of decode steps the
    batcher took in it (counted). `tie` is compare_tokens'. Returns the
    run's launch counts."""
    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background

    port = free_port()
    _thread, stop = start_lm_server_in_background(
        cfg, prepared, port=port, slots=4, max_len=1024, prompt_pad=64,
        block_len=16, seed=0, device=dev, **kv)
    batcher = stop.servicer.batcher
    step, n_steps = batcher.step, [0]

    def counted_step():  # the worker steps only while a slot is active
        n_steps[0] += 1
        return step()

    batcher.step = counted_step
    results, errors = {}, []
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        if not client.wait_healthy(deadline=60):
            fail(f"{label}: LM daemon never became healthy")
        client.generate(prompts[0], max_new_tokens=2, timeout=300)  # warm-up
        sync(dev)
        grows0 = batcher.bucket_grows
        reset_counts()
        n_steps[0] = 0

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
        steps = n_steps[0]
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
    if dev.type == "cuda":
        require(f"run {label}", counts, needed)
        if exact is not None:
            want = exact(steps)
            for (name, dt), n in want.items():
                if counts[name][dt] != n:
                    fail(f"run {label}: {name} ({dt}) launched "
                         f"{counts[name][dt]} times, expected {n} from the "
                         f"call pattern ({steps} decode steps)")
            print(f"[main] run {label}: launches equal the call pattern's "
                  f"({steps} decode steps): " + ", ".join(
                      f"{name} {dt} {n}" for (name, dt), n in want.items()),
                  flush=True)
    n_tokens = sum(len(r) for r in results.values())
    print(f"[main] run {label}: 4 concurrent requests, {n_tokens} tokens in "
          f"{wall:.3f} s = {n_tokens / wall:.1f} tokens/s; TTFT (300-token "
          f"prompt, idle daemon) {ttft * 1e3:.1f} ms; on {card}", flush=True)
    for i, prompt in enumerate(prompts):
        compare_tokens(f"run {label} request {i} (prompt {len(prompt)})",
                       results[i], *refs[i], tie=tie)
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


TEXT_PROMPT = ("Grüße aus Zürich — naïve café, déjà vu; ∑ λ ≈ 3.14, "
               "数据 流水线, 🙂🚀. ") * 3  # 282 UTF-8 bytes, multi-byte
TEXT_NEW = 16


class IdMarkedTokenizer:
    """[text]'s tokenizer: ByteTokenizer's encode, and a decode that gives
    every id a character of its own (U+F0000 + id, in plane 15's private
    use area), so the ids behind a text reply read back exactly.
    ByteTokenizer's decode maps every id of 256 or more to U+FFFD, and a
    random-weight model generates almost only such ids, so a reply in
    ByteTokenizer's text would pin down none of them."""

    BASE = 0xF0000

    def __init__(self, vocab_size):
        from dnn_tpu_torch.io.tokenizer import ByteTokenizer

        if vocab_size > 0xFFFE:  # U+FFFFE and U+FFFFF are noncharacters
            raise ValueError(f"vocab_size {vocab_size} exceeds plane 15")
        self.vocab_size = vocab_size
        self.byte_tok = ByteTokenizer(vocab_size)

    def encode(self, text):
        return self.byte_tok.encode(text)

    def decode(self, ids):
        return "".join(chr(self.BASE + int(i)) for i in ids)

    def ids(self, text, label):
        """The ids `text` decodes from; fails on any other character."""
        out = [ord(c) - self.BASE for c in text]
        if not all(0 <= i < self.vocab_size for i in out):
            fail(f"{label}: {text!r} holds characters no id decodes to")
        return out


def phase_text(cfg, prepared, dev, card):
    """[text] the daemon at serving run A's configuration (paged f32
    pool, 4 slots, max_len 1024, prompt_pad 64) with IdMarkedTokenizer
    (ByteTokenizer's encode) over the model's vocab: the ids behind
    generate_text's reply (SendMessage), the ids GenerateStream yields and
    the tokens SendTensor returns for the prompt's bytes each equal
    reference_greedy (near-tie rule); the reply equals the decode of
    SendTensor's tokens; generate_text_stream's chunks join to the reply;
    "!stats" answers with the pool's stats; K5 and K7 launched in the
    run. Returns the run's launch counts."""
    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background

    tok = IdMarkedTokenizer(cfg.vocab_size)
    ids = tok.encode(TEXT_PROMPT)
    port = free_port()
    _thread, stop = start_lm_server_in_background(
        cfg, prepared, port=port, slots=4, max_len=1024, prompt_pad=64,
        block_len=16, seed=0, device=dev, kv="paged", tokenizer=tok)
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        if not client.wait_healthy(deadline=60):
            fail("[text] LM daemon never became healthy")
        client.generate_text(TEXT_PROMPT[:8], max_new_tokens=2,
                             timeout=300)  # warm-up
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        reply = client.generate_text(TEXT_PROMPT, max_new_tokens=TEXT_NEW,
                                     timeout=300)
        wall = time.perf_counter() - t0
        tokens = client.generate(ids, max_new_tokens=TEXT_NEW,
                                 timeout=300).tolist()
        streamed = [int(t) for t in client.generate_stream(
            ids, max_new_tokens=TEXT_NEW, timeout=300)]
        chunks = list(client.generate_text_stream(
            TEXT_PROMPT, tok, max_new_tokens=TEXT_NEW, timeout=300))
        stats = client.send_message("chip_smoke", "!stats")
        counts = read_counts()
        client.close()
    finally:
        stop()
    if reply != tok.decode(tokens):
        fail(f"[text] generate_text's reply decodes from "
             f"{tok.ids(reply, '[text] reply')}, SendTensor returned "
             f"{tokens}")
    if "".join(chunks) != reply:
        fail(f"[text] generate_text_stream's {len(chunks)} chunks decode "
             f"from {tok.ids(''.join(chunks), '[text] stream')}, not the "
             f"reply's {tok.ids(reply, '[text] reply')}")
    if not stats.startswith("[lm] pool: "):
        fail(f"[text] '!stats' answered {stats!r}")
    if dev.type == "cuda":
        require("[text]", counts, [("cached_attention", "f32"),
                                   ("paged_decode_attention", "f32")])
    want = reference_greedy(prepared, cfg, ids, TEXT_NEW, dev)
    for label, got in (("SendMessage", tok.ids(reply, "[text] reply")),
                       ("GenerateStream", streamed), ("SendTensor", tokens)):
        compare_tokens(f"[text] {len(ids)}-byte prompt, {label}", got, *want)
    print(f"[text] IdMarkedTokenizer({cfg.vocab_size}): a "
          f"{len(TEXT_PROMPT)}-character, {len(ids)}-byte prompt -> "
          f"{TEXT_NEW} tokens; the reply's ids {tok.ids(reply, '[text]')} "
          f"equal SendTensor's tokens, GenerateStream's equal them too, "
          f"and the text stream's {len(chunks)} chunks join to the reply "
          f"(ByteTokenizer's text: "
          f"{tok.byte_tok.decode(tok.ids(reply, '[text]'))!r}); '!stats': "
          f"{stats!r}; generate_text wall {wall * 1e3:.1f} ms; on {card}",
          flush=True)
    return counts


PIPE_B_TOKENS = 256  # P-b: one request of B=1 T=256 int32 ids
PIPE_C_NEW = 32      # P-c: greedy tokens after the 300-token prompt
PIPE_D_ITEMS = 4     # P-d: microbatches of B=1 T=PIPE_B_TOKENS over Relay


def pipe_config(name: str, **override) -> dict:
    """A config of configs/ with fresh localhost ports and `override`."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "configs", name)) as f:
        raw = json.load(f)
    for node in raw["nodes"]:
        node["address"] = f"127.0.0.1:{free_port()}"
    raw.update(override)
    return raw


def _wait_for(path, text, procs, timeout):
    """Poll `path` until it holds `text`; fail if a process ends first."""
    t_end = time.monotonic() + timeout
    while True:
        with open(path) as f:
            got = f.read()
        if text in got:
            return got
        if time.monotonic() > t_end or any(p.poll() is not None
                                           for p in procs):
            fail(f"[pipe] no {text!r} in {path} (exit codes "
                 f"{[p.poll() for p in procs]}):\n{got[-3000:]}")
        time.sleep(0.2)


def pipe_cifar(dev, card):
    """P-a: cifar_cnn on configs/cifar_2stage.json. The in-process
    engine (role full, relay) on the dummy image against the port's
    apply on the CPU (1e-5, same argmax); then two `node --serve`
    subprocesses on a native .npz of the same weights, node1 given a
    missing --input_image (the dummy image): its FINAL PREDICTION must
    equal the engine's, and each child must log its device."""
    import shutil
    import tempfile

    from dnn_tpu_torch.comm.client import NodeClient, pipeline_budget
    from dnn_tpu_torch.config import TopologyConfig
    from dnn_tpu_torch.io.checkpoint import params_to_flat, save_npz
    from dnn_tpu_torch.io.preprocess import dummy_image
    from dnn_tpu_torch.parallel.pipeline import place
    from dnn_tpu_torch.registry import get_model
    from dnn_tpu_torch.runtime.engine import PipelineEngine

    where = {"device_type": "cpu"} if dev.type == "cpu" else {}
    raw = pipe_config("cifar_2stage.json", runtime="relay", **where)
    spec = get_model("cifar_cnn")
    params = spec.init(0)
    x = dummy_image()
    engine = PipelineEngine(TopologyConfig.from_dict(raw), params=params)
    probs = engine.run(x).cpu()
    pred = engine.predict(x)
    with torch.no_grad():
        want = spec.apply(place(params, "cpu"), torch.from_numpy(x))
    err = (probs - want).abs().max().item()
    if err > 1e-5 or int(want.argmax()) != pred:
        fail(f"[pipe] P-a engine probs max abs err {err:.3e} (limit 1e-5), "
             f"argmax {pred} vs CPU {int(want.argmax())}")
    print(f"[pipe] P-a cifar_cnn engine (relay, 2 stages on {dev}): "
          f"prediction {pred}, probs within {err:.2e} of the CPU apply",
          flush=True)

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipe_")
    procs = []
    try:
        save_npz(os.path.join(tmp, "cifar.npz"), params_to_flat(params))
        cfg_path = os.path.join(tmp, "cfg.json")
        with open(cfg_path, "w") as f:
            json.dump({**raw, "model_weights": os.path.join(tmp, "cifar.npz")},
                      f)
        outs = [os.path.join(tmp, f"node{i}.out") for i in (1, 2)]
        env = {**os.environ, "PYTHONPATH": root}
        for node, out, extra in (
                ("node2", outs[1], []),
                ("node1", outs[0], ["--input_image",
                                    os.path.join(tmp, "missing.png")])):
            with open(out, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "dnn_tpu_torch.node", "--node_id",
                     node, "--config", cfg_path, "--serve", *extra],
                    cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        text = _wait_for(outs[0], "FINAL PREDICTION", procs, 300)
        first = time.perf_counter() - t0
        line = [ln for ln in text.splitlines() if "FINAL PREDICTION" in ln][0]
        if line.strip() != f"***** FINAL PREDICTION (Index): {pred} *****":
            fail(f"[pipe] P-a node1 printed {line.strip()!r}, the engine "
                 f"predicts {pred}")
        for node, out in zip(("node1", "node2"), outs):
            logged = _wait_for(out, f"device {dev.type}", procs, 60)
            print(f"[pipe] P-a {node}: " + [
                ln for ln in logged.splitlines()
                if f"device {dev.type}" in ln][0].split(":", 2)[-1].strip(),
                flush=True)
        client = NodeClient(raw["nodes"][0]["address"])
        walls = []
        for _ in range(5):
            t1 = time.perf_counter()
            status, result = client.send_tensor(x, timeout=pipeline_budget(2))
            walls.append(time.perf_counter() - t1)
            if result is None or int(result.argmax()) != pred:
                fail(f"[pipe] P-a client round trip: {status}")
        client.close()
        for p in procs:
            p.send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=60) for p in procs]
        if rcs != [0, 0]:
            fail(f"[pipe] P-a children exited {rcs} on SIGTERM")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[pipe] P-a two `node --serve` processes: node1 printed "
          f"prediction {pred} {first:.1f} s after launch (process start, "
          f"weights, health wait included); a client's round trip over "
          f"gRPC (stage 0 on node1, stage 1 on node2) median "
          f"{sorted(walls)[2] * 1e3:.2f} ms of 5 (min {min(walls) * 1e3:.2f})"
          f"; on {card}", flush=True)


def pipe_gpt_stages(dev, card, model=None, n_tokens=PIPE_B_TOKENS):
    """P-b: configs/gpt2_8stage.json (gpt2-medium, 8 stages, bf16
    compute) at full width, seeded weights drawn once and shared. Eight
    in-process stage servers (role stage) answer one send_tensor of int32
    ids B=1 T=n_tokens: the f32 logits must equal the in-process relay
    engine's bit for bit (same card, same operations), and lie within
    5e-2 x max|logit| of an f32 relay run, with the same argmax wherever
    the f32 top-2 gap exceeds 0.1. Then P-d on the same servers
    (pipe_relay)."""
    from dnn_tpu_torch.comm.client import NodeClient, pipeline_budget
    from dnn_tpu_torch.comm.service import start_stage_servers_in_background
    from dnn_tpu_torch.config import TopologyConfig
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.registry import get_model
    from dnn_tpu_torch.runtime.engine import PipelineEngine

    where = {"device_type": "cpu"} if dev.type == "cpu" else {}
    raw = pipe_config("gpt2_8stage.json", runtime="relay", **where,
                      **({"model": model} if model else {}))
    spec = get_model(raw["model"])
    t0 = time.perf_counter()
    params = spec.init(0)
    print(f"[pipe] P-b {raw['model']} weights (seed 0, numpy) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    config = TopologyConfig.from_dict(raw)
    ids = np.random.default_rng(1).integers(
        0, spec.config.vocab_size, (1, n_tokens)).astype(np.int32)
    relay = PipelineEngine(config, params=params)
    want = relay.run(ids).cpu()
    items = [np.random.default_rng(10 + i).integers(
        0, spec.config.vocab_size, (1, n_tokens)).astype(np.int32)
        for i in range(PIPE_D_ITEMS)]
    wants = [relay.run(x).cpu() for x in items]
    _, stage_s = relay.stage_times(ids)
    last_in = torch.as_tensor(ids)  # the activation entering the last stage
    for part in range(len(raw["nodes"]) - 1):
        last_in = relay.run_stage(part, last_in)
    last_in = last_in.cpu()
    _, stop = start_stage_servers_in_background([
        (PipelineEngine(config, params=params, role="stage"), node["id"], None)
        for node in raw["nodes"]])
    try:
        client = NodeClient(raw["nodes"][0]["address"])
        if not client.wait_healthy(deadline=60):
            fail("[pipe] P-b stage server node1 never became healthy")
        client.send_tensor(ids, timeout=pipeline_budget(8))  # warm-up
        t1 = time.perf_counter()
        status, got = client.send_tensor(ids, timeout=pipeline_budget(8))
        wall = time.perf_counter() - t1
        client.close()
        # the last stage alone: one hop in, the logits back
        last = NodeClient(raw["nodes"][-1]["address"])
        last.send_tensor(last_in, timeout=pipeline_budget(1))
        t1 = time.perf_counter()
        _, got_last = last.send_tensor(last_in, timeout=pipeline_budget(1))
        wall_last = time.perf_counter() - t1
        last.close()
        pipe_relay(raw["nodes"][0]["address"], items, wants, card)
    finally:
        stop()
    if got_last is None or not torch.equal(got_last, want):
        fail("[pipe] P-b the last stage server alone returned other logits "
             "than the relay engine's")
    if got is None:
        fail(f"[pipe] P-b no logits came back: {status}")
    if got.dtype != torch.float32 or got.shape != want.shape:
        fail(f"[pipe] P-b logits {got.dtype} {tuple(got.shape)}, the relay "
             f"engine's {want.dtype} {tuple(want.shape)}")
    if not torch.equal(got, want):
        fail(f"[pipe] P-b logits over gRPC differ from the relay engine's: "
             f"max abs {(got - want).abs().max().item():.3e}")
    f32 = PipelineEngine(TopologyConfig.from_dict({**raw, "dtype": "float32"}),
                         params=params)
    ref = f32.run(ids).cpu()
    del relay, f32
    top = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    top2 = torch.topk(ref[0], 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 0.1
    flips = int((got[0].argmax(-1) != ref[0].argmax(-1))[decided].sum())
    if not torch.isfinite(got).all() or err > 5e-2 * top or flips:
        fail(f"[pipe] P-b bf16 logits against f32: max abs err {err:.3e} "
             f"(limit 5e-2 x {top:.3f}), {flips} argmax flips where the f32 "
             "top-2 gap > 0.1")
    sync(dev)
    print(f"[pipe] P-b {raw['model']} 8 stage servers, bf16 compute, "
          f"B=1 T={n_tokens}: {status.rsplit('Next node status: ', 1)[-1]}; "
          f"logits ({got.numel() * 4 / 1e6:.1f} MB f32) equal the relay "
          f"engine's bit for bit; against f32: max abs err {err:.3e} = "
          f"{err / top:.2e} x max|logit|, argmax equal at "
          f"{int(decided.sum())} decided positions", flush=True)
    print(f"[pipe] P-b request wall over gRPC (8 hops) {wall * 1e3:.1f} ms; "
          f"the last stage alone (its {last_in.numel() * 2 / 1e6:.2f} MB "
          f"bf16 input in, the logits back) {wall_last * 1e3:.1f} ms; "
          "relay per-stage compute (record_timings) ms "
          + " / ".join(f"{t * 1e3:.2f}" for t in stage_s)
          + f" (sum {sum(stage_s) * 1e3:.1f}); on {card}", flush=True)


def pipe_relay(address, items, wants, card):
    """P-d: the microbatches `items` through P-b's stage servers with
    send_tensors over the streamed Relay RPC (the client's hello must say
    relay); each result must equal the relay engine's run of its item
    (`wants`) bit for bit. Prints the streamed wall, each item's ack
    latency, and beside them the wall of the same items as sequential
    unary send_tensor calls (checked alike)."""
    from dnn_tpu_torch.comm.client import NodeClient, pipeline_budget

    client = NodeClient(address)
    neg = client.negotiated()
    if not neg.relay_ok:
        fail(f"[pipe] P-d the first stage's hello gave no Relay: {neg.reason}")
    budget = pipeline_budget(8)
    client.send_tensors(items[:1], timeout=budget)  # warm-up
    t0 = time.perf_counter()
    acks = []
    streamed = client.send_tensors(items, timeout=budget, ack_s=acks)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    unary = [client.send_tensor(x, timeout=budget) for x in items]
    wall_unary = time.perf_counter() - t0
    client.close()
    for i, ((status, got), (_, got_u), want) in enumerate(
            zip(streamed, unary, wants)):
        if got is None or "Processing complete" not in status:
            fail(f"[pipe] P-d item {i} over Relay: {status}")
        if not torch.equal(got, want) or not torch.equal(got_u, want):
            fail(f"[pipe] P-d item {i}: logits differ from the relay "
                 "engine's")
    if any(a is None for a in acks):
        fail(f"[pipe] P-d items without an ack: {acks}")
    n = len(items)
    print(f"[pipe] P-d {n} microbatches of {tuple(items[0].shape)} ids over "
          f"Relay (hello: grpc, relay): each result equals the relay "
          f"engine's bit for bit; streamed wall {wall * 1e3:.1f} ms "
          f"({wall * 1e3 / n:.1f} ms an item), acks after "
          + " / ".join(f"{a * 1e3:.2f}" for a in acks)
          + f" ms; {n} sequential unary send_tensor {wall_unary * 1e3:.1f} ms"
          f" ({wall_unary * 1e3 / n:.1f} ms an item); streamed / unary "
          f"{wall / wall_unary:.2f}; on {card}", flush=True)


def pipe_generate(dev, card, prompt, model="gpt2", n_new=PIPE_C_NEW):
    """P-c: a derived config (model, 4 parts, relay, f32):
    engine.generate greedy, n_new tokens after `prompt`, against
    reference_greedy on the same weights, with K5 and K6 launched
    (counted in the run). Returns the run's launch counts."""
    from dnn_tpu_torch.config import TopologyConfig
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models.gpt import PRESETS
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime.engine import PipelineEngine

    cfg = PRESETS[model]
    raw = {"nodes": [{"id": f"node{i + 1}", "part_index": i,
                      "address": f"127.0.0.1:{free_port()}"}
                     for i in range(4)],
           "model": model, "num_parts": 4, "runtime": "relay",
           "dtype": "float32",
           "device_type": "cpu" if dev.type == "cpu" else "tpu"}
    engine = PipelineEngine(TopologyConfig.from_dict(raw))
    engine.generate([prompt[:8]], max_new_tokens=2)  # warm-up
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    toks = engine.generate([prompt], max_new_tokens=n_new)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()
    if dev.type == "cuda":
        require("P-c engine.generate", counts,
                [("cached_attention", "f32"), ("decode_attention", "f32")])
    ref = reference_greedy(from_jax_params(engine.params, cfg, dev), cfg,
                           prompt, n_new, dev)
    compare_tokens(f"P-c engine.generate ({model}, 4 parts)",
                   toks[0].tolist(), *ref)
    print(f"[pipe] P-c {n_new} tokens after a {len(prompt)}-token prompt in "
          f"{wall * 1e3:.1f} ms = {n_new / wall:.1f} tokens/s; on {card}",
          flush=True)
    return counts


def phase_pipe(dev, card, prompt):
    """The staged pipeline: P-a, P-b, P-c. Returns P-c's launches."""
    t0 = time.perf_counter()
    pipe_cifar(dev, card)
    pipe_gpt_stages(dev, card)
    counts = pipe_generate(dev, card, prompt)
    print(f"[pipe] done in {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


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


DECODE_KERNEL_NAMES = ("decode_attn_kernel", "paged_decode_kernel",
                       "decode_merge_kernel")


def _profiled(fn):
    """(wall ms, device ms, kernel launches, top kernels, K5 device ms,
    K6/K7 device ms) of fn() under torch.profiler: device ms sums the
    kernels' own device time; K5's sums its split and merge kernels
    (cached_attn_*), K6/K7's theirs (DECODE_KERNEL_NAMES)."""
    wall, evs = _kernel_events(fn)
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    k5_ms = sum(e.self_device_time_total for e in evs
                if "cached_attn" in e.key) / 1e3
    dec_ms = sum(e.self_device_time_total for e in evs
                 if any(n in e.key for n in DECODE_KERNEL_NAMES)) / 1e3
    n_kernels = sum(e.count for e in evs)
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:6]
    return wall, dev_ms, n_kernels, [(e.key[:60], e.self_device_time_total
                                      / 1e3, e.count) for e in top], k5_ms, \
        dec_ms


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

        wall, dev_ms, n_kern, top, _, dec_ms = _profiled(decode)
        print(f"[profile] {label}: decode step (3 active slots) "
              f"{plain_wall:.3f} ms wall; under the profiler "
              f"{wall / steps:.3f} ms wall, {dev_ms / steps:.3f} ms device "
              f"busy ({100 * dev_ms / wall:.1f}% of wall), "
              f"{n_kern / steps:.0f} kernel launches per step; K6/K7 "
              f"{dec_ms / steps:.4f} ms/step = {100 * dec_ms / dev_ms:.1f}% "
              "of device busy", flush=True)
        for name, ms, n in top:
            print(f"[profile]   decode {ms / steps:.4f} ms/step  "
                  f"x{n // steps}  {name}", flush=True)
        wall, dev_ms, n_kern, top, k5_ms, _ = _profiled(
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


LLAMA_NEW, LLAMA_SOLO_NEW = 16, 32  # L-A / L-C tokens; L-solo tokens
LLAMA_PROMPTS = (5, 70, 130, 300)
LLAMA_SOLO_S = LLAMA_PROMPTS[-1] + LLAMA_SOLO_NEW  # L-solo's dense cache


def sdpa_gqa(q, k, v, mask=None):
    """The library yardstick: SDPA with grouped heads (enable_gqa)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def phase_llama_kernels(dev, gen):
    """[llama] kernel rows at llama3-8b's shapes (32 query heads over 8 KV
    heads, D=128), each against its plain version, f32, bf16 and int8:
    K5 with grouped heads at a prefill chunk (B=1 H=32 Hk=8 T=64 S=1024,
    base 960); K7 at the decode step (B=4 Hk=8 R=4, 16-row blocks, 64 a
    slot, 257 pool blocks, pos {0, 15, 16, 1023}); K6 at L-solo's shape
    (B=1 Hk=8 R=4, S=LLAMA_SOLO_S: the 300-token prompt plus its 32 new
    tokens, so its split plan; pos S - 2, the last decode step). The
    library time is SDPA with enable_gqa on q of (B, 32, T, 128) and the
    same boolean mask, for the float caches; none for int8 and for paged.
    Bounds as the gpt2 rows': bytes (the Hk heads' live K/V read once),
    K5's function products at its type's fastest rate (k5_bound), K6/K7's
    f32 FMAs at 67 TFLOP/s. Returns {"K5": rows, "K7": rows, "K6 solo":
    rows}."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        K5_TILE, cached_attention, decode_attention, k5_split,
        paged_decode_attention, reference_cached_attention,
        reference_decode_attention, reference_paged_decode_attention)

    out = {"K5": {}, "K7": {}, "K6 solo": {}}
    H, HK, D = 32, 8, 128
    G = H // HK
    # K5, grouped heads
    B, T, S, base = 1, 64, 1024, 960
    split_tiles, n_split = k5_split(B * H, T, S)
    print(f"[llama] K5 B={B} H={H} Hk={HK} T={T} S={S} D={D} base {base}: "
          f"{n_split} splits of {split_tiles * K5_TILE} keys, grid "
          f"({n_split}, 1, {B * H})", flush=True)
    pos = torch.full((B,), base, dtype=torch.int32, device=dev)
    cols = torch.arange(S, device=dev)
    mask = cols[None, :] <= (base + torch.arange(T, device=dev))[:, None]
    for name, tol in KV_CASES:
        q = torch.randn(LAYERS, B, H, T, D, generator=gen, device=dev)
        k, v, ks, vs = kv_cache(gen, (LAYERS, B, HK, S, D), name, dev)
        sc = scales_at(ks, vs, 0)
        err = check(f"[llama] K5 {name} G={G}",
                    cached_attention(q[0], k[0], v[0], pos, **sc),
                    reference_cached_attention(q[0], k[0], v[0], pos, **sc),
                    tol)
        nbytes, _, ops, (b_ms, b_by, byte_ms, op_ms) = k5_bound(
            name, B, H, HK, T, S, base, D)
        ms = time_ms(cycling(lambda i: cached_attention(
            q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
        plain = time_ms(cycling(lambda i: reference_cached_attention(
            q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
        lib = None
        if name != "int8":
            qd = q.to(k.dtype)
            lib = time_ms(cycling(lambda i: sdpa_gqa(qd[i], k[i], v[i], mask),
                                  LAYERS))
        out["K5"][name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        report("llama", f"K5 {name:4s} G={G} base {base}", out["K5"][name],
               nbytes, byte_ms, op_ms, ops)
    # K7 at R = G rows a KV head
    B, bp, nb_max, n_blocks = 4, 16, 64, 257
    decode_plan("llama K7", B * HK, nb_max * bp, bp)
    pos_list = [0, 15, 16, 1023]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    perm = torch.randperm(n_blocks - 1,
                          generator=torch.Generator().manual_seed(0))
    tables = (perm[:B * nb_max] + 1).reshape(B, nb_max).to(torch.int32).to(dev)
    for name, tol in KV_CASES:
        q = torch.randn(LAYERS, B, HK, G, D, generator=gen, device=dev)
        kp, vp, ks, vs = kv_cache(gen, (LAYERS, n_blocks, HK, bp, D), name,
                                  dev)
        sc = scales_at(ks, vs, 0)
        err = check(f"[llama] K7 {name} R={G}",
                    paged_decode_attention(q[0], kp[0], vp[0], tables, pos,
                                           **sc),
                    reference_paged_decode_attention(q[0], kp[0], vp[0],
                                                     tables, pos, **sc), tol)
        live = sum(p + 1 for p in pos_list)
        nbytes = (2 * B * HK * G * D * 4 + HK * kv_bytes(name, live, D)
                  + sum(p // bp + 1 for p in pos_list) * 4 + B * 4)
        b_ms, b_by, byte_ms, op_ms = bound(nbytes, 4 * D * HK * G * live)
        ms = time_ms(cycling(lambda i: paged_decode_attention(
            q[i], kp[i], vp[i], tables, pos, **scales_at(ks, vs, i)),
            LAYERS))
        plain = time_ms(cycling(lambda i: reference_paged_decode_attention(
            q[i], kp[i], vp[i], tables, pos, **scales_at(ks, vs, i)),
            LAYERS))
        out["K7"][name] = dict(ms=ms, plain_ms=plain, library_ms=None,
                               bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        report("llama", f"K7 {name:4s} R={G} pos {pos_list} (no one-call "
               "library equivalent)", out["K7"][name], nbytes, byte_ms, op_ms)
    # K6 at L-solo's shape, R = G: its dense cache of prompt + new tokens
    # (the split plan it launches), at its last decode step's position
    B, S, last = 1, LLAMA_SOLO_S, LLAMA_SOLO_S - 2
    decode_plan("llama K6 solo", B * HK, S)
    pos = torch.tensor([last], dtype=torch.int32, device=dev)
    for name, tol in KV_CASES:
        q = torch.randn(LAYERS, B, HK, G, D, generator=gen, device=dev)
        k, v, ks, vs = kv_cache(gen, (LAYERS, B, HK, S, D), name, dev)
        sc = scales_at(ks, vs, 0)
        err = check(f"[llama] K6 solo {name} R={G}",
                    decode_attention(q[0], k[0], v[0], pos, **sc),
                    reference_decode_attention(q[0], k[0], v[0], pos, **sc),
                    tol)
        nbytes = 2 * B * HK * G * D * 4 + HK * kv_bytes(name, last + 1, D) + 4
        b_ms, b_by, byte_ms, op_ms = bound(nbytes, 4 * D * HK * G * (last + 1))
        ms = time_ms(cycling(lambda i: decode_attention(
            q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
        plain = time_ms(cycling(lambda i: reference_decode_attention(
            q[i], k[i], v[i], pos, **scales_at(ks, vs, i)), LAYERS))
        lib = None
        if name != "int8":  # columns <= last; q as 32 heads
            qd = q.reshape(LAYERS, B, H, 1, D).to(k.dtype)
            live = torch.arange(S, device=dev)[None, :] <= last
            lib = time_ms(cycling(lambda i: sdpa_gqa(qd[i], k[i], v[i],
                                                     live), LAYERS))
        out["K6 solo"][name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                    bound_ms=b_ms, bound_by=b_by,
                                    max_abs_err=err)
        report("llama", f"K6 solo {name:4s} R={G} S={S} pos {last}",
               out["K6 solo"][name], nbytes, byte_ms, op_ms)
    return out


def phase_llama(dev, card, cfg=None):
    """[llama] llama3-8b at full width and depth (or `cfg`), random
    weights in the JAX tree layout drawn on the card from a seeded
    torch.Generator (llama.init with device=: std 0.02, o and down at
    0.02 / sqrt(2 n_layer), norm scales at one) and passed through
    convert.from_jax_params; then, each run with the launch counts zeroed
    just before and read just after:
      L-A the LM daemon in-process (serve_run: 4 slots, max_len 1024,
          prompt_pad 64, paged f32 pool of 257 blocks of 16), 4
          concurrent greedy requests (prompts of 5/70/130/300 seeded
          tokens, 16 new each) equal to reference_greedy on the llama
          forward; K5 launched once per layer per prefill chunk (11
          chunks), K7 once per layer per decode step, exactly;
      L-C the same with int8 KV, against reference_greedy_cache over a
          dense int8 cache at KV heads, prefilled in 64-token chunks as
          served, a divergence accepted only where its top-2 gap is
          below QUANT_TIE (K5, K7 int8, exactly); the same loop
          prefilling each prompt whole is printed beside it, as the
          measure of the int8 noise;
      L-solo llama.make_generate on the 300-token prompt, dense f32
          cache, 32 tokens, equal to reference_greedy; K5 once per layer,
          K6 once per layer per token after the first, exactly;
    plus, as information, a decode step's and the 300-token admission's
    wall and device busy on the paged f32 pool. Returns the runs' launch
    counts."""
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models import llama
    from dnn_tpu_torch.parallel.pipeline import sync
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    cfg = cfg or llama.PRESETS["llama3-8b"]
    L = cfg.n_layer
    t0 = time.perf_counter()
    tree = llama.init(0, cfg, device=dev)
    prepared = from_jax_params(tree, cfg, dev)
    del tree
    sync(dev)
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(prepared))
    print(f"[llama] {cfg.n_layer} layers, {cfg.n_embd} wide, "
          f"{cfg.n_head} heads over {cfg.n_kv_head} KV heads, D "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}: f32 weights "
          f"{n_bytes / 1e9:.2f} GB drawn on {dev} and prepared in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in LLAMA_PROMPTS]
    t0 = time.perf_counter()
    ref = [reference_greedy(prepared, cfg, p, LLAMA_NEW, dev)
           for p in prompts[:3]]
    solo_ref = reference_greedy(prepared, cfg, prompts[3], LLAMA_SOLO_NEW, dev)
    ref.append((solo_ref[0][:LLAMA_NEW], solo_ref[1][:LLAMA_NEW]))
    # the int8 reference prefills in the served path's 64-token chunks;
    # the loop prefilling each prompt whole measures the quantization
    # noise that QUANT_TIE allows for
    ref_i8 = [reference_greedy_cache(prepared, cfg, p, LLAMA_NEW, dev, "int8",
                                     chunk=64) for p in prompts]
    whole_i8 = [reference_greedy_cache(prepared, cfg, p, LLAMA_NEW, dev,
                                       "int8") for p in prompts]
    print(f"[llama] references (no-cache f32; plain int8 cache loops, "
          f"chunked and whole) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for p, (toks, gaps), (whole, _) in zip(prompts, ref_i8, whole_i8):
        j = next((j for j, (a, b) in enumerate(zip(toks, whole)) if a != b),
                 None)
        print(f"[llama] plain int8 loops, prompt {len(p)}: chunked and whole "
              + ("agree on every token" if j is None else
                 f"part at step {j}, top-2 gap {gaps[j]:.3e}")
              + f" (smallest gap {min(gaps):.3e})", flush=True)
    chunks = sum(-(-len(p) // 64) for p in prompts)

    def exact(dt):
        return lambda steps: {("cached_attention", dt): L * chunks,
                              ("paged_decode_attention", dt): L * steps}

    runs = [
        serve_run("L-A", cfg, prepared, prompts, LLAMA_NEW, ref,
                  [("cached_attention", "f32"),
                   ("paged_decode_attention", "f32")], dev, card,
                  exact=exact("f32"), kv="paged"),
        serve_run("L-C", cfg, prepared, prompts, LLAMA_NEW, ref_i8,
                  [("cached_attention", "int8"),
                   ("paged_decode_attention", "int8")], dev, card,
                  exact=exact("int8"), tie=QUANT_TIE, kv="paged",
                  kv_dtype="int8"),
    ]
    # L-solo
    gen = llama.make_generate(cfg, max_new_tokens=LLAMA_SOLO_NEW, device=dev)
    gen(prepared, [prompts[3][:8]])  # warm-up
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    toks = gen(prepared, [prompts[3]])
    sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()
    if dev.type == "cuda":
        want = {("cached_attention", "f32"): L,
                ("decode_attention", "f32"): L * (LLAMA_SOLO_NEW - 1)}
        for (name, dt), n in want.items():
            if counts[name][dt] != n:
                fail(f"[llama] L-solo: {name} ({dt}) launched "
                     f"{counts[name][dt]} times, expected {n}")
    print(f"[llama] L-solo make_generate: {LLAMA_SOLO_NEW} tokens after a "
          f"{len(prompts[3])}-token prompt in {wall * 1e3:.1f} ms; launches "
          f"{ {n: {d: c for d, c in by.items() if c} for n, by in counts.items() if any(by.values())} }",
          flush=True)
    compare_tokens("[llama] L-solo make_generate f32", toks[0].tolist(),
                   *solo_ref)
    runs.append(counts)
    # information: where a decode step's and an admission's time goes
    b = ContinuousBatcher(cfg, prepared, slots=4, max_len=1024, prompt_pad=64,
                          block_len=16, device=dev, kv="paged")
    for p in prompts[:3]:
        b.submit(p, 64)
    for _ in range(2):
        b.step()
    sync(dev)
    steps = 4
    t0 = time.perf_counter()
    for _ in range(steps):
        b.step()
    sync(dev)
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    if dev.type == "cuda":
        def decode():
            for _ in range(steps):
                b.step()

        wall, dev_ms, n_kern, top, _, dec_ms = _profiled(decode)
        print(f"[llama] decode step (3 active slots, paged f32): "
              f"{step_ms:.3f} ms wall; under the profiler "
              f"{wall / steps:.3f} ms wall, {dev_ms / steps:.3f} ms device "
              f"busy ({100 * dev_ms / wall:.1f}% of wall), "
              f"{n_kern / steps:.0f} kernel launches a step; K7 "
              f"{dec_ms / steps:.4f} ms/step = {100 * dec_ms / dev_ms:.1f}% "
              f"of device busy; on {card}", flush=True)
        for name, ms, n in top[:4]:
            print(f"[llama]   decode {ms / steps:.4f} ms/step  x{n // steps}  "
                  f"{name}", flush=True)
        wall, dev_ms, n_kern, top, k5_ms, _ = _profiled(
            lambda: b.submit(prompts[3], 2))
        print(f"[llama] admission of the {len(prompts[3])}-token prompt (5 "
              f"chunks + install): {wall:.3f} ms wall, {dev_ms:.3f} ms "
              f"device busy ({100 * dev_ms / wall:.1f}%), {n_kern} kernel "
              f"launches; K5 {k5_ms:.4f} ms = {100 * k5_ms / dev_ms:.1f}% of "
              f"device busy; on {card}", flush=True)
    else:
        print(f"[llama] decode step (3 active slots, paged f32): "
              f"{step_ms:.3f} ms wall on the CPU", flush=True)
    del b, prepared
    return {name: {dt: sum(r[name][dt] for r in runs)
                   for dt in ("f32", "bf16", "int8")}
            for name in CACHE_KERNELS}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def kernel_record(name, source, replaces, rows, main_row, launches,
                  **extra):
    """One entry of the kernels line: the f32 case at the main-path shape
    on top, every cache type under by_dtype, launches summed over the
    main-path runs; `extra` entries (rows at other shapes) beside."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    by = {dt: {"launches": launches[dt], **{k: rows[dt][k] for k in keys}}
          for dt in rows}
    top = {k: rows[main_row][k] for k in keys}
    top["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            **top, "by_dtype": by, **extra}


# one turn of --decode-turns, run from a tree's root (its chip_smoke and
# its package): that tree's phases 3 and 4, then its wrappers timed at the
# solo decoder's shape (K6, B=1 S=316 pos 315) and at a decode step's
# short positions (K7, B=4 pos {8, 80, 140, 0}, nb_max=64 blocks of 16);
# prints the kernel times
TURN_CODE = """
import json, torch, chip_smoke as c
from dnn_tpu_torch.ops.cuda import _build
from dnn_tpu_torch.ops.cuda.cached_attention import (
    decode_attention, paged_decode_attention)
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
_build.build(["decode_attention", "paged_decode"])
ms = {kernel: {dt: r["ms"] for dt, r in by.items()} for kernel, by in
      (("K6", c.phase_k6(dev, gen)), ("K7", c.phase_k7(dev, gen)))}
solo = torch.tensor([315], dtype=torch.int32, device=dev)
short = torch.tensor([8, 80, 140, 0], dtype=torch.int32, device=dev)
tables = torch.arange(1, 257, dtype=torch.int32, device=dev).reshape(4, 64)
ms["K6 solo"], ms["K7 short"] = {}, {}
for dt in ("f32", "bf16", "int8"):
    q = torch.randn(c.LAYERS, 4, 12, 1, 64, generator=gen, device=dev)
    k, v, ks, vs = c.kv_cache(gen, (c.LAYERS, 1, 12, 316, 64), dt, dev)
    ms["K6 solo"][dt] = c.time_ms(c.cycling(lambda i: decode_attention(
        q[i, :1], k[i], v[i], solo, **c.scales_at(ks, vs, i)), c.LAYERS))
    k, v, ks, vs = c.kv_cache(gen, (c.LAYERS, 257, 12, 16, 64), dt, dev)
    ms["K7 short"][dt] = c.time_ms(c.cycling(
        lambda i: paged_decode_attention(q[i], k[i], v[i], tables, short,
                                         **c.scales_at(ks, vs, i)),
        c.LAYERS))
print("TURN " + json.dumps(ms))
"""


def decode_turns(parent: str, smi: str):
    """K6/K7 of the tree at `parent` and of this one, timed in turns
    (parent, this tree, this tree, parent) on one card, one process a
    turn; prints each turn's kernel times and the ratio of the means."""
    here = os.path.dirname(os.path.abspath(__file__))
    turns = []
    for label, root in (("parent", parent), ("tree", here), ("tree", here),
                        ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, "-c", TURN_CODE], cwd=root, text=True,
            capture_output=True, timeout=900,
            env={**os.environ, "PYTHONPATH": os.path.abspath(root)})
        if proc.returncode != 0:
            fail(f"decode turn in {root} failed:\n{proc.stdout[-3000:]}\n"
                 f"{proc.stderr[-3000:]}")
        times = json.loads([ln for ln in proc.stdout.splitlines()
                            if ln.startswith("TURN ")][-1][5:])
        turns.append((label, times))
        print(f"[turns] {label} ({root}): {json.dumps(times)}", flush=True)
    for kernel in ("K6", "K7", "K6 solo", "K7 short"):
        for dt, _ in KV_CASES:
            old = [t[kernel][dt] for label, t in turns if label == "parent"]
            new = [t[kernel][dt] for label, t in turns if label == "tree"]
            print(f"[turns] {kernel} {dt:4s}: parent "
                  f"{', '.join(f'{x:.4f}' for x in old)} ms, this tree "
                  f"{', '.join(f'{x:.4f}' for x in new)} ms: parent / tree "
                  f"{sum(old) / sum(new):.2f}; on {smi}", flush=True)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    if sys.argv[1:2] == ["--decode-turns"] and len(sys.argv) == 3:
        decode_turns(sys.argv[2], smi)
        return
    if len(sys.argv) > 1:
        fail(f"unknown arguments {sys.argv[1:]} (none, or --decode-turns "
             "PARENT)")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    phase_build()
    phase_wire(smi)
    k5 = phase_k5(dev, gen)
    k6 = phase_k6(dev, gen)
    k6_solo = phase_k6_solo(dev, gen)
    k7 = phase_k7(dev, gen)
    phase_decode_splits(dev, gen)
    flash = {**phase_flash_fwd(dev, gen), **phase_flash_bwd(dev, gen)}
    launches, prepared, cfg, prompts = phase_main_path(dev, smi)
    text = phase_text(cfg, prepared, dev, smi)
    phase_profile(prepared, cfg, prompts, dev)
    del prepared
    pipe = phase_pipe(dev, smi, prompts[3])
    for counts in (text, pipe):
        for name in CACHE_KERNELS:
            for dt, n in counts[name].items():
                launches[name][dt] += n
    launches.update(phase_train(dev, smi))
    gc.collect()  # the gpt2 phases' tensors go before llama3-8b's 32 GB
    torch.cuda.empty_cache()
    llama_rows = phase_llama_kernels(dev, gen)
    llama_counts = phase_llama(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    for name in CACHE_KERNELS:
        for dt, n in llama_counts[name].items():
            launches[name][dt] += n

    def llama_extra(kernel, rows, **shape):
        """A kernel's [llama] rows, each with the llama runs' launches."""
        return {**shape, "by_dtype": {
            dt: {"launches": llama_counts[kernel][dt], **row}
            for dt, row in rows.items()}}

    src = "dnn_tpu_torch/ops/cuda/csrc/"
    pallas = "dnn_tpu/ops/pallas/cached_attention.py"
    kernels = [
        kernel_record("cached_attention", src + "cached_attention.cu",
                      pallas + ":77",
                      {dt: k5[(dt, 960)] for dt, _ in KV_CASES}, "f32",
                      launches["cached_attention"],
                      llama_shape=llama_extra(
                          "cached_attention", llama_rows["K5"], B=1, H=32,
                          Hk=8, T=64, S=1024, D=128, base=960)),
        kernel_record("decode_attention", src + "decode_attention.cu",
                      pallas + ":296", k6, "f32",
                      launches["decode_attention"],
                      solo_shape={"B": SOLO_B, "Hk": SOLO_HK, "S": SOLO_S,
                                  "by_dtype": k6_solo},
                      llama_solo_shape=llama_extra(
                          "decode_attention", llama_rows["K6 solo"], B=1,
                          Hk=8, R=4, S=LLAMA_SOLO_S, D=128,
                          pos=LLAMA_SOLO_S - 2)),
        kernel_record("paged_decode_attention", src + "paged_decode.cu",
                      pallas + ":459", k7, "f32",
                      launches["paged_decode_attention"],
                      llama_shape=llama_extra(
                          "paged_decode_attention", llama_rows["K7"], B=4,
                          Hk=8, R=4, D=128, bp=16, nb_max=64)),
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
