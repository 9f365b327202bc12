"""Topology configuration (port of dnn_tpu/config.py).

The same JSON schema as the JAX package: `nodes[].{id, address,
part_index}`, `num_parts`, `model_weights`, `return_to_node_id`, and the
extended keys `model`, `device_type`, `runtime`, `microbatches`,
`param_placement`, `dtype`, `mesh` and `transport`. Every key parses to
the field the JAX package gives it, and `validate` applies the same
rules.

`device_type` maps to a torch device (`config_device`): "cpu" is the
CPU; any other value — "tpu", the default, included — means the CUDA
card, and raises where there is none. A `distributed` section (a
multi-host job) is not ported and raises NotImplementedError rather
than being ignored.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import torch

from dnn_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class NodeEntry:
    """One entry of `nodes[]`: a stage served by one process."""

    id: str
    part_index: int
    address: Optional[str] = None

    @property
    def port(self) -> Optional[int]:
        if not self.address:
            return None
        try:
            return int(self.address.rsplit(":", 1)[-1])
        except ValueError:
            raise ValueError(
                f"Invalid address '{self.address}' for node '{self.id}'; "
                "expected IP:Port") from None


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    nodes: Tuple[NodeEntry, ...]
    num_parts: int
    model_weights: Optional[str] = None
    return_to_node_id: Optional[str] = None
    model: str = "cifar_cnn"
    device_type: str = "tpu"
    runtime: str = "auto"
    microbatches: int = 0
    param_placement: str = "auto"
    dtype: str = "float32"
    mesh: Dict[str, int] = dataclasses.field(default_factory=dict)
    transport: str = "auto"

    @classmethod
    def from_dict(cls, d: dict) -> "TopologyConfig":
        if d.get("distributed") is not None:
            raise NotImplementedError(
                "the config's `distributed` section (a multi-host job) is "
                "not ported to dnn_tpu_torch yet (ROADMAP Queue 1 item 10, "
                "multihost.py)")
        raw_nodes: List[dict] = d.get("nodes", [])
        nodes = tuple(
            NodeEntry(id=n["id"], part_index=int(n["part_index"]),
                      address=n.get("address"))
            for n in raw_nodes)
        num_parts = d.get("num_parts")
        if num_parts is None:
            num_parts = len(nodes) if nodes else 1
        cfg = cls(
            nodes=nodes,
            num_parts=int(num_parts),
            model_weights=d.get("model_weights"),
            return_to_node_id=d.get("return_to_node_id"),
            model=d.get("model", "cifar_cnn"),
            device_type=d.get("device_type", "tpu"),
            runtime=d.get("runtime", "auto"),
            microbatches=int(d.get("microbatches", 0)),
            param_placement=d.get("param_placement", "auto"),
            dtype=d.get("dtype", "float32"),
            mesh=dict(d.get("mesh", {})),
            transport=d.get("transport", "auto"),
        )
        cfg.validate()
        return cfg

    @classmethod
    def from_json(cls, path: str) -> "TopologyConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def validate(self):
        if self.num_parts < 1:
            raise ValueError(f"num_parts must be >= 1, got {self.num_parts}")
        if self.nodes:
            part_indices = sorted(n.part_index for n in self.nodes)
            if part_indices != list(range(self.num_parts)):
                raise ValueError(
                    "nodes[].part_index must cover exactly 0..num_parts-1; "
                    f"got {part_indices} for num_parts={self.num_parts}")
            ids = [n.id for n in self.nodes]
            if len(set(ids)) != len(ids):
                raise ValueError(f"duplicate node ids in config: {ids}")
        if self.return_to_node_id and self.nodes:
            if all(n.id != self.return_to_node_id for n in self.nodes):
                raise ValueError(f"return_to_node_id "
                                 f"'{self.return_to_node_id}' not among "
                                 "node ids")
        if self.runtime not in ("auto", "spmd", "relay"):
            raise ValueError(
                f"runtime must be auto|spmd|relay, got '{self.runtime}'")
        if self.microbatches < 0:
            raise ValueError("microbatches must be >= 0 (0 = auto)")
        if self.param_placement not in ("auto", "stage", "replicated"):
            raise ValueError("param_placement must be auto|stage|replicated, "
                             f"got '{self.param_placement}'")
        if self.transport not in ("auto", "grpc", "shm", "device"):
            raise ValueError("transport must be auto|grpc|shm|device, got "
                             f"'{self.transport}'")

    def node_by_id(self, node_id: str) -> NodeEntry:
        for n in self.nodes:
            if n.id == node_id:
                return n
        raise KeyError(f"Node ID '{node_id}' not found in config")

    def node_by_part(self, part_index: int) -> NodeEntry:
        for n in self.nodes:
            if n.part_index == part_index:
                return n
        raise KeyError(f"No node with part_index {part_index} in config")

    def next_node(self, node: NodeEntry) -> Optional[NodeEntry]:
        """The node owning part_index + 1, or None for the last stage."""
        if node.part_index == self.num_parts - 1:
            return None
        return self.node_by_part(node.part_index + 1)

    def return_node(self) -> Optional[NodeEntry]:
        if not self.return_to_node_id:
            return None
        return self.node_by_id(self.return_to_node_id)


def config_device(device_type: str) -> torch.device:
    """`device_type` -> the torch device: "cpu" is the CPU, anything else
    the CUDA card (resolve_device raises when there is none)."""
    return resolve_device("cpu" if device_type == "cpu" else "cuda")
