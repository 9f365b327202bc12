"""The stage mesh of one process (port of dnn_tpu/parallel/mesh.py:25-62).

JAX's mesh is a `jax.sharding.Mesh` whose "stage" axis places one
pipeline stage on each device. Here a mesh is the ordered list of stage
devices that one process drives: stage i runs on `mesh.devices[i]`, and
the hop from stage i to i + 1 is a device copy (parallel/pipeline.py).
The same card may appear more than once: `[cuda:0] * 8` is the one-card
form of an 8-stage mesh, each stage with its own CUDA stream.

Only the stage axis is ported. A data axis larger than 1 (dp x pp) needs
`torch.distributed` and raises (ROADMAP Queue 1 item 10); the model,
seq and expert axes of JAX's conventions are that item's too.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from dnn_tpu_torch import resolve_device

STAGE_AXIS = "stage"
DATA_AXIS = "data"


class StageMesh:
    """An ordered list of stage devices with JAX's `shape` view
    ({"stage": S})."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a stage mesh needs at least one device")

    @property
    def shape(self) -> Dict[str, int]:
        return {STAGE_AXIS: len(self.devices)}

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"StageMesh({', '.join(str(d) for d in self.devices)})"


def default_devices():
    """Every CUDA device of this process (raises without a card, as
    resolve_device does: the CPU is asked for by name)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def as_mesh(mesh) -> StageMesh:
    """A StageMesh as it is, or one over a sequence of devices."""
    return mesh if isinstance(mesh, StageMesh) else StageMesh(mesh)


def make_mesh(axes: Dict[str, int],
              devices: Optional[Sequence] = None) -> StageMesh:
    """{"stage": S} -> the first S of `devices` (default: every card).
    Axes other than the stage axis must have size 1."""
    devices = list(devices if devices is not None else default_devices())
    for name, size in axes.items():
        if name != STAGE_AXIS and size != 1:
            raise NotImplementedError(
                f"mesh axis {name!r} of size {size}: only the stage axis is "
                "ported to dnn_tpu_torch (ROADMAP Queue 1 item 10: the data, "
                "model, seq and expert axes need torch.distributed)")
    need = int(axes.get(STAGE_AXIS, 1))
    if len(devices) < need:
        raise ValueError(
            f"mesh {axes} needs {need} devices, have {len(devices)} "
            f"({[str(d) for d in devices[:4]]}...)")
    return StageMesh(devices[:need])


def mesh_from_config(config, devices: Optional[Sequence] = None) -> StageMesh:
    """TopologyConfig -> StageMesh. `num_parts` sizes the stage axis; the
    config's `mesh` key must agree with it (JAX's check)."""
    axes = dict(config.mesh) if config.mesh else {}
    axes.setdefault(STAGE_AXIS, config.num_parts)
    if axes[STAGE_AXIS] != config.num_parts:
        raise ValueError(
            f"config.mesh['stage']={axes[STAGE_AXIS]} conflicts with "
            f"num_parts={config.num_parts}")
    return make_mesh(axes, devices)
