"""Profiler captures and the device-completion barrier (port of
dnn_tpu/utils/tracing.py).

`span` / `step_span` re-export obs.profile's `annotation` /
`step_annotation` (obs-gated host ranges, as JAX's shim re-exports
them). `trace_to` captures a host + device profile with torch.profiler
(CUPTI on the card) and writes it as a Chrome-trace JSON into `log_dir`,
which Perfetto loads; it holds the process's one profiler session
(obs.profile.exclusive: ProfilerBusy when a capture records) and marks
itself recording, so `span` ranges land in it. Prefer
obs.profile.capture (a bounded spool, meta.json, flight-logged) for
server use. `device_sync` is the barrier every honest host-clock timing
ends in: torch.cuda.synchronize on each card `out` lives on (a CPU
result needs none). `timed_blocked` runs a callable and times it to
that barrier.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

from dnn_tpu_torch.obs.profile import (  # noqa: F401 — JAX's re-exports
    annotation as span,
    step_annotation as step_span,
)


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body (CPU, and CUDA where a card is present) and write
    `<log_dir>/trace.json` (Chrome trace events) when it ends; yields the
    torch.profiler.profile, whose key_averages() sums kernel time by
    name. Raises obs.profile.ProfilerBusy while another session
    records."""
    from dnn_tpu_torch.obs import profile as _profile

    os.makedirs(log_dir, exist_ok=True)
    with _profile.exclusive():
        prof = _profile.new_session()
        prof.start()
        try:
            with _profile.mark_recording():
                yield prof
        finally:
            prof.stop()
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
