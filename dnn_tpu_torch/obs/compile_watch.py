"""Capture and build telemetry: the card's one-time costs as live
counters (port of dnn_tpu/obs/compile_watch.py).

JAX counts XLA compilations (jax_compilations_total,
jax_compile_seconds_total, jax_trace_seconds_total). The port compiles
no programs at run time: what it pays once is each batcher step's CUDA
graph capture and each kernel library's nvcc build at first use. So the
series are, named after JAX's family for what the card does:

    cuda_graph_captures_total{graph=...}         captures, by graph
    cuda_graph_capture_seconds_total{graph=...}  host seconds they took
    cuda_kernel_builds_total{kernel=...}         kernel libraries built
    cuda_kernel_build_seconds_total{kernel=...}  nvcc seconds (the wall
                                                 of the parallel build
                                                 until that library)

`graph` is the captured step: decode, mixed (decode + a prompt chunk),
constrained and constrained_mixed (the same over a pool that allows
grammar constraints), spec and spec_mixed (the speculative batcher's).
A daemon whose steps are stable sits at a small constant (a capture a
graph, and one more a bucket grow or a cache swap); a climbing counter
is a recapture storm. Each event is also a flight-ring entry (`capture`,
`kernel_build`). Written only when observability is on; never raises.
"""

from __future__ import annotations

import logging

log = logging.getLogger("dnn_tpu_torch.obs")


def _record(counter: str, seconds_counter: str, event: str, label: str,
            value: str, seconds: float):
    try:
        from dnn_tpu_torch import obs
        from dnn_tpu_torch.utils.metrics import labeled

        m = obs.metrics()
        if m is None:
            return
        m.inc(labeled(counter, **{label: value}))
        m.inc(labeled(seconds_counter, **{label: value}), seconds)
        obs.flight.record(event, **{label: value,
                                    "seconds": round(seconds, 4)})
    except Exception:  # noqa: BLE001 — telemetry must never break a step
        log.debug("capture/build telemetry failed", exc_info=True)


def note_capture(graph: str, seconds: float):
    """One CUDA graph captured (`graph`: its name) in `seconds`."""
    _record("cuda_graph_captures_total", "cuda_graph_capture_seconds_total",
            "capture", "graph", graph, seconds)


def note_build(kernel: str, seconds: float):
    """One kernel library built by nvcc (`kernel`: its name)."""
    _record("cuda_kernel_builds_total", "cuda_kernel_build_seconds_total",
            "kernel_build", "kernel", kernel, seconds)
