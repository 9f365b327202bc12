"""The pipeline engine (port of dnn_tpu/runtime/engine.py:73-565):
config -> model -> stages -> results.

Roles:
  role="full"  — this process drives the whole pipeline through the
                 relay runtime (`RelayExecutor`: stage i on device i mod
                 n, every hop on one card a hand-over on the device);
  role="stage" — this process serves one stage behind the gRPC edge
                 (`comm/service.StageServer`): only that stage's
                 parameters go to the device, at its first call.

Runtimes: "relay" is ported; "spmd" (one program over a mesh of
devices) is not. `runtime="spmd"` with fewer devices than parts raises
the JAX package's message, and with enough devices NotImplementedError;
"auto" resolves to relay.

Weights come from the config's `model_weights` (`.pth`, `.safetensors`
or `.npz`: a native flat tree, or a foreign state dict through the
family's converter) or, when it is null, from the family's numpy init
with `rng_seed`. The engine runs on the CUDA card unless the config's
`device_type` is "cpu" or `devices` says otherwise.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import numpy as np
import torch

from dnn_tpu_torch.config import TopologyConfig, config_device
from dnn_tpu_torch.parallel.pipeline import RelayExecutor, place
from dnn_tpu_torch.registry import get_model

log = logging.getLogger("dnn_tpu_torch.engine")

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def load_params(config: TopologyConfig, spec, rng_seed: int = 0):
    """The model's parameter tree (numpy leaves): the checkpoint named
    by `model_weights`, or a random init from `rng_seed` when it is
    null."""
    path = config.model_weights
    if not path:
        log.warning("no model_weights in config; using random init "
                    "(seed %d)", rng_seed)
        return spec.init(rng_seed)
    from dnn_tpu_torch.io import checkpoint as ckpt

    sd = ckpt.load_checkpoint(path)
    if ckpt.is_native_flat(sd):
        return ckpt.flat_to_params(sd)
    if spec.convert_state_dict is None:
        raise ValueError(f"checkpoint {path} is in a foreign layout and "
                         f"model '{spec.name}' has no converter")
    return spec.convert_state_dict(sd)


def default_devices(config: TopologyConfig):
    """Every CUDA device, or the CPU when `device_type` is "cpu"."""
    dev = config_device(config.device_type)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class PipelineEngine:
    """Load once, run many: the object behind the node CLI and the gRPC
    stage server."""

    def __init__(self, config: TopologyConfig, *, params: Optional[Any] = None,
                 devices=None, rng_seed: int = 0, role: str = "full",
                 lora_path: Optional[str] = None):
        if role not in ("full", "stage"):
            raise ValueError(f"role must be full|stage, got {role}")
        if lora_path:
            raise NotImplementedError(
                "LoRA adapters are not ported to dnn_tpu_torch yet (ROADMAP "
                "Queue 1 item 8, lora.py)")
        self.config = config
        self.role = role
        self.transport = config.transport
        self.spec = get_model(config.model)
        if config.num_parts not in self.spec.supported_parts:
            raise ValueError(
                f"model '{config.model}' supports num_parts in "
                f"{self.spec.supported_parts}, config asks for "
                f"{config.num_parts}")
        if config.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                             f"{config.dtype}")
        self.compute_dtype = _DTYPES[config.dtype]
        extras = self.spec.extras
        if "make_partition" in extras:
            self.stages = list(extras["make_partition"](
                compute_dtype=self.compute_dtype)(config.num_parts))
        else:
            if self.compute_dtype is not None:
                log.warning("model '%s' has no dtype-aware factories; "
                            "dtype=%s ignored", config.model, config.dtype)
            self.stages = list(self.spec.partition(config.num_parts))
        self.devices = ([torch.device(d) for d in devices]
                        if devices is not None else default_devices(config))
        self.params = (params if params is not None
                       else load_params(config, self.spec, rng_seed))
        self._stage_params = [s.slice_params(self.params)
                              for s in self.stages]
        self._stage_params_on_device: dict = {}
        if role == "stage":
            self.runtime = "stage"
            self._relay = None
        else:
            self.runtime = self._pick_runtime()
            self._relay = RelayExecutor([s.apply for s in self.stages],
                                        self._stage_params, self.devices)
        log.info("engine ready: model=%s parts=%d runtime=%s devices=%s "
                 "dtype=%s", config.model, config.num_parts, self.runtime,
                 ",".join(str(d) for d in self.devices), config.dtype)

    def _pick_runtime(self) -> str:
        rt = self.config.runtime
        if rt == "auto":
            return "relay"
        if rt == "spmd" and len(self.devices) < self.config.num_parts:
            raise ValueError(
                f"runtime=spmd needs >= {self.config.num_parts} devices, "
                f"have {len(self.devices)} (use --serve / role='stage' to "
                "host a single stage on a small host)")
        if rt == "spmd":
            raise NotImplementedError(
                "runtime=spmd (one program over a device mesh) is not ported "
                "to dnn_tpu_torch yet (ROADMAP Queue 1 item 7's remainder); "
                "use runtime relay")
        return rt

    def _input(self, x, device):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.to(device)

    def run(self, x) -> torch.Tensor:
        """The whole pipeline's forward."""
        if self.role == "stage":
            raise RuntimeError(
                "engine was built with role='stage' (serves one part); use "
                "run_stage, or build with role='full'")
        return self._relay(self._input(x, self.devices[0]))

    @torch.no_grad()
    def run_stage(self, part_index: int, x) -> torch.Tensor:
        """One stage only: the work of one gRPC stage server per
        SendTensor."""
        placed = self._stage_params_on_device.get(part_index)
        if placed is None:
            if self._relay is not None:
                placed = (self._relay.stage_params[part_index],
                          self._relay.devices[part_index])
            else:
                placed = (place(self._stage_params[part_index],
                                self.devices[0]), self.devices[0])
            self._stage_params_on_device[part_index] = placed
        params, dev = placed
        return self.stages[part_index].apply(params, self._input(x, dev))

    def predict(self, x) -> int:
        """argmax over the last stage's output (flattened)."""
        return int(torch.argmax(self.run(x).float().flatten()).item())

    # --- generation (the GPT and LLaMA families) ------------------------

    def _require_full_role(self):
        if self.role == "stage":
            raise RuntimeError(
                "generation needs the full pipeline; this engine was built "
                "with role='stage' (serves one part)")

    def _prepared(self):
        """The stacked decode layout on the first device, built once."""
        if not hasattr(self, "_prepared_single"):
            from dnn_tpu_torch.models.gpt import prepare_stacked

            self._prepared_single = prepare_stacked(
                self.params, self.spec.config, self.devices[0])
        return self._prepared_single

    def make_generator(self, *, max_new_tokens: int, temperature: float = 0.0,
                       top_k: Optional[int] = None,
                       top_p: Optional[float] = None):
        """generate(ids, seed=0) -> (B, max_new_tokens) int32 tokens on
        this engine's weights, through the port's make_generate (K5 for
        the prompt, K6 per token on the card; a LLaMA-family model over a
        KV-head cache, K5 with grouped heads). Sampled draws come from a
        torch.Generator seeded with `seed`; greedy draws equal JAX's."""
        from dnn_tpu_torch.models.gpt import GPTConfig
        from dnn_tpu_torch.models.llama import LlamaConfig
        from dnn_tpu_torch.runtime.generate import make_generate

        cfg = self.spec.config
        self._require_full_role()
        if not isinstance(cfg, (GPTConfig, LlamaConfig)):
            raise ValueError(
                f"generation requires a GPT-family or LLaMA-family model; "
                f"'{self.config.model}' has config {type(cfg).__name__}")
        gen = make_generate(cfg, max_new_tokens=max_new_tokens,
                            temperature=temperature, top_k=top_k, top_p=top_p,
                            compute_dtype=self.compute_dtype,
                            device=self.devices[0])
        return lambda ids, seed=0: gen(self._prepared(), ids, seed)

    def generate(self, ids, *, max_new_tokens: int, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 seed: int = 0) -> torch.Tensor:
        """One-call generation; the generator is cached per (max_new_tokens,
        temperature, top_k, top_p)."""
        key = (max_new_tokens, temperature, top_k, top_p)
        cache = self.__dict__.setdefault("_generators", {})
        if key not in cache:
            cache[key] = self.make_generator(
                max_new_tokens=max_new_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p)
        return cache[key](np.asarray(ids, np.int32), seed)

    def stage_times(self, x):
        """One instrumented relay run: (output, per-stage compute
        seconds)."""
        if self._relay is None:
            raise RuntimeError("stage_times needs role='full'")
        y = self._relay(self._input(x, self.devices[0]), record_timings=True)
        return y, list(self._relay.last_stage_times)

