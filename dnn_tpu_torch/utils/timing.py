"""Device timing on the card (port of dnn_tpu/utils/timing.py).

`device_time` is the port's one timing helper for a callable that
launches work on the card: CUDA events recorded on the current stream
around a run of back-to-back calls, read after one synchronize. PyTorch
returns before the card finishes, so a host clock without a synchronize
would time the enqueue; the events time what the card ran. There is no
CPU fallback: without a card it raises.
"""

from __future__ import annotations

import torch


def device_time(fn, *args, n1: int = 4, n2: int = 12, trials: int = 3) -> float:
    """Seconds per call of `fn(*args)` on the card: after a warm-up of 2 +
    `n1` calls (first-use builds and allocations), `trials` runs of `n2`
    calls each between two CUDA events; the median run's elapsed time
    over `n2`. Raises RuntimeError without a CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time needs a CUDA card (a CPU time is not "
                           "a device time)")
    for _ in range(2 + n1):
        fn(*args)
    torch.cuda.synchronize()
    per_call = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n2):
            fn(*args)
        stop.record()
        stop.synchronize()
        per_call.append(start.elapsed_time(stop) / 1e3 / n2)
    per_call.sort()
    return per_call[len(per_call) // 2]
