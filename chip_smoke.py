#!/usr/bin/env python
"""Chip smoke test of the PyTorch/CUDA port: builds the CUDA kernels,
holds each against its plain PyTorch version on the card, then serves
GPT-2 at full width through the LM daemon over gRPC and checks the
greedy tokens against an independent no-cache reference.

    python3 chip_smoke.py        # from the repo root, on a machine with one CUDA card

Phases (any failure exits non-zero and prints no result):
  1. the card's name and power limit (nvidia-smi); TF32 off; kernel build
  2. K5 cached_attention at the prefill shape (B=1 H=12 T=64 S=1024 D=64),
     bases {0, 64, 448, 960}, f32 and bf16 caches
  3. K7 paged_decode_attention at the decode shape (B=4 Hk=12 R=1 D=64,
     bp=16, nb_max=64, 257 pool blocks), permuted table, pos {0,15,16,1023}
  4. the LM daemon in-process (gpt2, random weights from seed 0, 4 slots,
     max_len 1024, prompt_pad 64, paged pool): 4 concurrent gRPC generate
     calls, greedy, checked against a no-cache greedy loop on the card,
     with both kernels' launch counts read over that run
  5. information: a torch.profiler view of a decode step and of one
     prompt's admission (wall, device busy, top kernels)
  6. one JSON line describing the kernels, then the result line.

Timings: warm-up, then the calls are captured in a CUDA graph and the
graph is replayed between CUDA events (device time, no host overhead).
Kernel timings cycle over the 12 layers' slices of a full-model cache,
so each launch reads K/V the previous launches did not leave in the
50 MB L2 — as on the serving path.
Bounds: bytes moved (each input read once, each output written once,
live columns only) at 3.35 TB/s, or f32 FMA work at 67 TFLOP/s.
"""

from __future__ import annotations

import json
import math
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
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


def bound(nbytes: float, flops: float):
    """(bound ms, "bytes" | "operations", bytes ms, operations ms)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, t_bytes, t_ops


def phase_build():
    from dnn_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[build] {len(logs)} kernel libraries built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)


def phase_k5(dev, gen):
    """K5 against its plain version at the prefill-chunk shape."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        cached_attention, reference_cached_attention)

    B, H, T, S, D = 1, 12, 64, 1024, 64
    rows, max_err = {}, 0.0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        q = torch.randn(LAYERS, B, H, T, D, generator=gen, device=dev)
        k = torch.randn(LAYERS, B, H, S, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(LAYERS, B, H, S, D, generator=gen, device=dev).to(dtype)
        el = k.element_size()
        for base in (0, 64, 448, 960):
            pos = torch.full((B,), base, dtype=torch.int32, device=dev)
            got = cached_attention(q[0], k[0], v[0], pos)
            want = reference_cached_attention(q[0], k[0], v[0], pos)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not math.isfinite(err) or err > tol:
                fail(f"K5 {dtype} base {base}: max abs err {err} > {tol}")
            max_err = max(max_err, err)
            live = min(S, base + T)
            nbytes = (2 * B * H * T * D * 4 + 2 * B * H * live * D * el
                      + B * 4)
            flops = 4 * D * B * H * sum(min(S, base + t + 1) for t in range(T))
            b_ms, b_by, byte_ms, op_ms = bound(nbytes, flops)
            ms = time_ms(cycling(
                lambda i: cached_attention(q[i], k[i], v[i], pos), LAYERS))
            plain = time_ms(cycling(
                lambda i: reference_cached_attention(q[i], k[i], v[i], pos),
                LAYERS))
            lib = None
            if dtype == torch.float32:
                cols = torch.arange(S, device=dev)
                mask = cols[None, :] <= (base + torch.arange(T, device=dev))[:, None]
                lib = time_ms(cycling(
                    lambda i: torch.nn.functional.scaled_dot_product_attention(
                        q[i], k[i], v[i], attn_mask=mask), LAYERS))
            rows[(str(dtype), base)] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err)
            print(f"[K5] {str(dtype):14s} base {base:4d}: err {err:.3e} "
                  f"kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                  f"{'none' if lib is None else f'{lib:.4f}'} bound_ms "
                  f"{b_ms:.5f} ({b_by}; bytes {byte_ms:.5f} for "
                  f"{nbytes / 1e6:.2f} MB at 3.35 TB/s, f32 ops {op_ms:.5f})",
                  flush=True)
    return rows, max_err


def phase_k7(dev, gen):
    """K7 against its plain version at the decode-step shape."""
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        paged_decode_attention, reference_paged_decode_attention)

    B, Hk, R, D, bp, nb_max, n_blocks = 4, 12, 1, 64, 16, 64, 257
    pos_list = [0, 15, 16, 1023]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(0))
    tables = (perm[:B * nb_max] + 1).reshape(B, nb_max).to(torch.int32).to(dev)
    rows, max_err = {}, 0.0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        q = torch.randn(LAYERS, B, Hk, R, D, generator=gen, device=dev)
        kp = torch.randn(LAYERS, n_blocks, Hk, bp, D, generator=gen,
                         device=dev).to(dtype)
        vp = torch.randn(LAYERS, n_blocks, Hk, bp, D, generator=gen,
                         device=dev).to(dtype)
        got = paged_decode_attention(q[0], kp[0], vp[0], tables, pos)
        want = reference_paged_decode_attention(q[0], kp[0], vp[0], tables, pos)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not math.isfinite(err) or err > tol:
            fail(f"K7 {dtype}: max abs err {err} > {tol}")
        max_err = max(max_err, err)
        el = kp.element_size()
        live = sum(p + 1 for p in pos_list)
        nbytes = (2 * B * Hk * R * D * 4 + 2 * Hk * live * D * el
                  + sum(p // bp + 1 for p in pos_list) * 4 + B * 4)
        flops = 4 * D * Hk * R * live
        b_ms, b_by, byte_ms, op_ms = bound(nbytes, flops)
        ms = time_ms(cycling(
            lambda i: paged_decode_attention(q[i], kp[i], vp[i], tables, pos),
            LAYERS))
        plain = time_ms(cycling(
            lambda i: reference_paged_decode_attention(
                q[i], kp[i], vp[i], tables, pos), LAYERS))
        rows[str(dtype)] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                bound_ms=b_ms, bound_by=b_by,
                                max_abs_err=err)
        print(f"[K7] {str(dtype):14s} pos {pos_list}: err {err:.3e} "
              f"kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms none "
              f"(no single PyTorch call computes paged attention) bound_ms "
              f"{b_ms:.5f} ({b_by}; bytes {byte_ms:.5f} for "
              f"{nbytes / 1e6:.2f} MB at 3.35 TB/s, f32 ops {op_ms:.5f})",
              flush=True)
    return rows, max_err


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


def phase_main_path(dev, card: str):
    from dnn_tpu_torch.comm.client import NodeClient
    from dnn_tpu_torch.convert import from_jax_params
    from dnn_tpu_torch.models.gpt import PRESETS, init
    from dnn_tpu_torch.ops.cuda.cached_attention import (
        cached_attention, paged_decode_attention)
    from dnn_tpu_torch.runtime.lm_server import start_lm_server_in_background

    cfg = PRESETS["gpt2"]
    t0 = time.perf_counter()
    prepared = from_jax_params(init(0, cfg), cfg, dev)
    torch.cuda.synchronize()
    print(f"[main] gpt2 weights (seed 0) on {dev} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    port = free_port()
    _thread, stop = start_lm_server_in_background(
        cfg, prepared, port=port, slots=4, max_len=1024, prompt_pad=64,
        block_len=16, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 70, 130, 300)]
    n_new = 16
    results, errors = {}, []
    try:
        client = NodeClient(f"127.0.0.1:{port}")
        if not client.wait_healthy(deadline=60):
            fail("LM daemon never became healthy")
        client.generate(prompts[0], max_new_tokens=2, timeout=300)  # warm-up
        torch.cuda.synchronize()
        cached_attention.launches = 0
        paged_decode_attention.launches = 0

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
        launches = {"cached_attention": cached_attention.launches,
                    "paged_decode_attention": paged_decode_attention.launches}
        if errors or len(results) != len(prompts):
            fail(f"generate calls failed: {errors or 'timed out'}")
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
    print(f"[main] launches over the 4-request run: {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was never launched on the main path")
    if len(rest) != n_new - 1:
        fail(f"stream returned {len(rest) + 1} tokens, expected {n_new}")
    n_tokens = sum(len(r) for r in results.values())
    print(f"[main] 4 concurrent requests, {n_tokens} tokens in {wall:.3f} s "
          f"= {n_tokens / wall:.1f} tokens/s; TTFT (300-token prompt, idle "
          f"daemon) {ttft * 1e3:.1f} ms; on {card}", flush=True)

    for i, prompt in enumerate(prompts):
        want, gaps = reference_greedy(prepared, cfg, prompt, n_new, dev)
        got = results[i]
        if len(got) != n_new:
            fail(f"request {i}: {len(got)} tokens, expected {n_new}")
        for j, (a, b) in enumerate(zip(got, want)):
            if a != b:
                if gaps[j] < 1e-4:
                    print(f"[main] request {i} (prompt {len(prompt)}): "
                          f"near-tie at step {j} (top-2 gap {gaps[j]:.2e}), "
                          f"served {a} vs reference {b}; rest not compared",
                          flush=True)
                    break
                fail(f"request {i} (prompt {len(prompt)}) step {j}: served "
                     f"{a} != reference {b} (top-2 gap {gaps[j]:.3e})\n"
                     f"served    {got}\nreference {want}")
        print(f"[main] request {i} (prompt {len(prompt)}): {got[:8]}... "
              f"matches the no-cache reference", flush=True)
    return launches, prepared, cfg, prompts


def _profiled(fn):
    """(wall ms, device ms, top kernels) of fn() under torch.profiler:
    device ms sums the kernels' own device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # kernels only: an operator's row repeats the time of its kernels
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:6]
    return wall, dev_ms, [(e.key[:60], e.self_device_time_total / 1e3,
                           e.count) for e in top]


def phase_profile(prepared, cfg, prompts, dev):
    """Information only: where a decode step's and a prefill's time goes
    (the batcher driven directly, as the daemon's worker drives it)."""
    from dnn_tpu_torch.runtime.serving import ContinuousBatcher

    b = ContinuousBatcher(cfg, prepared, slots=4, max_len=1024,
                          prompt_pad=64, block_len=16, device=dev)
    for p in prompts[:3]:
        b.submit(p, 64)
    for _ in range(4):
        b.step()
    torch.cuda.synchronize()
    steps = 8
    t0 = time.perf_counter()
    for _ in range(steps):
        b.step()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3 / steps

    def decode():
        for _ in range(steps):
            b.step()

    wall, dev_ms, top = _profiled(decode)
    print(f"[profile] decode step (3 active slots): {plain_wall:.3f} ms "
          f"wall; under the profiler {wall / steps:.3f} ms wall, "
          f"{dev_ms / steps:.3f} ms device busy "
          f"({100 * dev_ms / wall:.1f}% of wall)", flush=True)
    for name, ms, n in top:
        print(f"[profile]   decode {ms / steps:.4f} ms/step  x{n // steps}"
              f"  {name}", flush=True)
    wall, dev_ms, top = _profiled(lambda: b.submit(prompts[3], 2))
    print(f"[profile] admission of a {len(prompts[3])}-token prompt "
          f"(5 chunks + install): {wall:.3f} ms wall, {dev_ms:.3f} ms "
          f"device busy ({100 * dev_ms / wall:.1f}%)", flush=True)
    for name, ms, n in top:
        print(f"[profile]   prefill {ms:.4f} ms  x{n}  {name}", flush=True)


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
    k5_rows, k5_err = phase_k5(dev, gen)
    k7_rows, k7_err = phase_k7(dev, gen)
    launches, prepared, cfg, prompts = phase_main_path(dev, smi)
    phase_profile(prepared, cfg, prompts, dev)

    k5 = k5_rows[(str(torch.float32), 960)]
    k7 = k7_rows[str(torch.float32)]
    kernels = [
        {"name": "cached_attention", "route": "cuda",
         "source": "dnn_tpu_torch/ops/cuda/csrc/cached_attention.cu",
         "replaces": "dnn_tpu/ops/pallas/cached_attention.py:77",
         "launches": launches["cached_attention"], "max_abs_err": k5_err,
         "ms": k5["ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": k5["library_ms"]},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "dnn_tpu_torch/ops/cuda/csrc/paged_decode.cu",
         "replaces": "dnn_tpu/ops/pallas/cached_attention.py:459",
         "launches": launches["paged_decode_attention"],
         "max_abs_err": k7_err, "ms": k7["ms"], "plain_ms": k7["plain_ms"],
         "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"],
         "library_ms": None},
    ]
    print(f"{smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
