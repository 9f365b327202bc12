"""Pipeline relay (port of dnn_tpu/parallel/pipeline.py:58-200).

`RelayExecutor` runs stages in order, stage i on device i mod n, with
each stage's parameters placed on its device once, at construction. A
hop hands the activation to the next stage's device: on one card it is
the same tensor, with no host copy. The JAX package's `spmd_pipeline`
(one program over a device mesh) needs more than one card and is not
ported (ROADMAP Queue 1 item 7's remainder).
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence

import torch


def split_microbatches(x, num_microbatches: int):
    """(B, ...) -> (M, B // M, ...)."""
    b = x.shape[0]
    if b % num_microbatches != 0:
        raise ValueError(
            f"batch {b} not divisible by microbatches {num_microbatches}")
    return x.reshape(num_microbatches, b // num_microbatches, *x.shape[1:])


def merge_microbatches(y):
    return y.reshape(y.shape[0] * y.shape[1], *y.shape[2:])


def place(tree, device):
    """A parameter tree of numpy arrays or tensors -> the same tree of
    tensors on `device` (dtypes kept; numpy arrays are copied, since a
    loaded array may be a read-only view)."""
    if isinstance(tree, dict):
        return {k: place(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.tensor(tree).to(device)


def sync(device):
    """Wait for `device`'s queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class RelayExecutor:
    """Sequential stage relay across explicit devices. `record_timings`
    runs keep each stage's compute seconds in `last_stage_times`, timed
    between device synchronizations."""

    #: how a hop moves the activation: a same-process device hand-over
    transport = "device"

    def __init__(self, stage_fns: Sequence[Callable],
                 stage_params: Sequence[Any], devices: Sequence):
        if len(stage_fns) != len(stage_params):
            raise ValueError("one params tree per stage required")
        devices = [torch.device(d) for d in devices]
        self.devices = [devices[i % len(devices)]
                        for i in range(len(stage_fns))]
        self.stage_params = [place(p, d)
                             for p, d in zip(stage_params, self.devices)]
        self.stage_fns = list(stage_fns)
        self.last_stage_times: Optional[List[float]] = None

    @torch.no_grad()
    def __call__(self, x, *, record_timings: bool = False):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x)
        times = []
        for fn, params, dev in zip(self.stage_fns, self.stage_params,
                                   self.devices):
            x = x.to(dev)
            if record_timings:
                sync(dev)
                t0 = time.perf_counter()
            x = fn(params, x)
            if record_timings:
                sync(dev)
                times.append(time.perf_counter() - t0)
        self.last_stage_times = times if record_timings else None
        return x
