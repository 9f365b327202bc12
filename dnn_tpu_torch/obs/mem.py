"""Memory observability: the daemon's CUDA device memory and the host's
RSS (port of dnn_tpu/obs/mem.py, with its gauge names), exported through
the shared registry as scrape-time CALLABLE gauges (a stored gauge
freezes on an idle process):

  * device memory (`install_memory_gauges(device=)`): the caching
    allocator's counters of the daemon's card, read through
    `torch.cuda.memory_stats` — host bookkeeping, no device sync —
    as dnn_tpu_device_bytes_in_use / _peak_bytes_in_use and the card's
    total memory as dnn_tpu_device_bytes_limit, labeled {device="cuda:N"}.
    A CPU daemon registers no device gauges and never queries a card;
  * host RSS (`rss_bytes`): /proc-based with a getrusage fallback, as
    the JAX package reads it (process_resident_bytes).

Install is idempotent.
"""

from __future__ import annotations

import os

__all__ = ["rss_bytes", "install_memory_gauges"]


def rss_bytes() -> float:
    """Resident set of this process in bytes; 0.0 when unreadable (a
    gauge must not raise into the scrape)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return float(pages * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        import sys

        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss is KB on Linux, bytes on macOS (peak, not current)
        return float(ru if sys.platform == "darwin" else ru * 1024)
    except Exception:  # noqa: BLE001
        return 0.0


def _device_gauge(dev, key: str):
    import torch

    def read() -> float:
        try:
            if key == "bytes_limit":
                return float(torch.cuda.get_device_properties(dev)
                             .total_memory)
            return float(torch.cuda.memory_stats(dev).get(key, 0))
        except Exception:  # noqa: BLE001 — a dying device must not
            return 0.0     # break every scrape
    return read


def install_memory_gauges(registry=None, device=None) -> list:
    """Register the host gauge and, for a CUDA `device`, the device
    gauges on `registry` (default: the shared obs registry). Returns the
    series registered now. Idempotent: a series already present is left
    as it is, and one a registry.clear() wiped is registered again."""
    from dnn_tpu_torch import obs
    from dnn_tpu_torch.utils.metrics import labeled

    if registry is None:
        registry = obs.metrics()
    if registry is None:  # observability off: nothing to install
        return []
    wanted = {"process_resident_bytes": rss_bytes}
    if device is not None and getattr(device, "type", str(device)) == "cuda":
        import torch

        dev = torch.device(device)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        label = f"{dev.type}:{dev.index}"
        for series, key in (
                ("dnn_tpu_device_bytes_in_use", "allocated_bytes.all.current"),
                ("dnn_tpu_device_peak_bytes_in_use",
                 "allocated_bytes.all.peak"),
                ("dnn_tpu_device_bytes_limit", "bytes_limit")):
            wanted[labeled(series, device=label)] = _device_gauge(dev, key)
    registered = [name for name in wanted if name not in registry.gauges]
    for name in registered:
        registry.set_fn(name, wanted[name])
    return registered
