"""Profiler captures and the device-completion barrier (port of
dnn_tpu/utils/tracing.py).

`trace_to` captures a host + device profile with torch.profiler (CUPTI
on the card) and writes it as a Chrome-trace JSON into `log_dir`, which
Perfetto loads. `device_sync` is the barrier every honest host-clock
timing ends in: torch.cuda.synchronize on each card `out` lives on (a
CPU result needs none). `timed_blocked` runs a callable and times it to
that barrier.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body (CPU, and CUDA where a card is present) and write
    `<log_dir>/trace.json` (Chrome trace events) when it ends; yields the
    torch.profiler.profile, whose key_averages() sums kernel time by
    name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _devices(out, found):
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _devices(v, found)
    return found


def device_sync(out) -> None:
    """Wait for all card work queued before this call on every CUDA
    device a tensor of `out` (a tensor, or a dict / list / tuple of
    them) lives on. The card runs a stream's work in order, so that
    covers everything `out` depends on."""
    for dev in _devices(out, set()):
        torch.cuda.synchronize(dev)


def timed_blocked(fn, *args) -> tuple:
    """Run `fn(*args)`, wait for its card work (`device_sync`), return
    (result, seconds) on the host clock."""
    t0 = time.perf_counter()
    out = fn(*args)
    device_sync(out)
    return out, time.perf_counter() - t0
