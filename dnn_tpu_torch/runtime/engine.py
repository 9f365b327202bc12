"""The pipeline engine (port of dnn_tpu/runtime/engine.py:73-565):
config -> model -> stages -> results.

Roles:
  role="full"  — this process drives the whole pipeline through the
                 relay runtime (`RelayExecutor`: stage i on device i mod
                 n, every hop on one card a hand-over on the device);
  role="stage" — this process serves one stage behind the gRPC edge
                 (`comm/service.StageServer`): only that stage's
                 parameters go to the device, at its first call.

Runtimes (JAX's rule, `_pick_runtime`): "auto" is relay for one part,
spmd when there are at least as many devices as parts, relay otherwise;
an explicit spmd short of devices raises JAX's message. "spmd" runs the
single-process stage mesh (parallel/pipeline.py: one stream a stage on
`devices`, which may name one card several times): a dense GPT whose
layers divide by the parts takes the stacked path (embed on stage 0,
the head on the last stage, each stage's blocks on its device), every
other model the heterogeneous path with its stages' weights packed a
row a stage ("stage") or on every stage device ("replicated"), as
`param_placement` resolves (`engine.param_placement`). A dense GPT on
spmd decodes pipeline-parallel (runtime/generate.make_pipeline_generate).

Weights come from the config's `model_weights` (`.pth`, `.safetensors`
or `.npz`: a native flat tree, or a foreign state dict through the
family's converter) or, when it is null, from the family's numpy init
with `rng_seed`; `lora_path` merges a LoRA artifact into them at load
(lora.merge_lora). The engine runs on the CUDA card unless the config's
`device_type` is "cpu" or `devices` says otherwise.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Any, Optional

import numpy as np
import torch

from dnn_tpu_torch.config import TopologyConfig, config_device
from dnn_tpu_torch.parallel.mesh import mesh_from_config
from dnn_tpu_torch.parallel.pipeline import RelayExecutor, _leaves, place
from dnn_tpu_torch.registry import get_model

log = logging.getLogger("dnn_tpu_torch.engine")

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def load_params(config: TopologyConfig, spec, rng_seed: int = 0):
    """The model's parameter tree: the checkpoint named by
    `model_weights`, or the family's numpy random init from `rng_seed`
    when it is null."""
    path = config.model_weights
    if not path:
        log.warning("no model_weights in config; using random init "
                    "(seed %d)", rng_seed)
        return spec.init(rng_seed)
    return checkpoint_params(path, spec)


def served_params(config: TopologyConfig, spec, seed: int, device, *,
                  weights: str = "f32", compute_dtype=None,
                  weights_npz: Optional[str] = None,
                  lora: Optional[str] = None):
    """The LM daemon's served (stacked) weights, as `node --serve_lm`
    loads them: `weights_npz`, the config's checkpoint or a random init
    from `seed`, a LoRA artifact merged in, at `compute_dtype`; f32 for
    weights="int8" (the server quantizes them and casts for compute). A
    random init of a spec whose extras hold "init_prepared" (the MoE
    families: Mixtral-8x7B is 187 GB as an f32 tree) is drawn, quantized
    and stacked on `device` one block at a time, in the compute type for
    f32 weights; never whole on the host or the card."""
    from dnn_tpu_torch.convert import from_jax_params, load_npz

    int8 = weights == "int8"
    init_prepared = spec.extras.get("init_prepared")
    if not (weights_npz or config.model_weights or lora) \
            and init_prepared is not None:
        log.warning("no model_weights in config; using random init "
                    "(seed %d), drawn on %s", seed, device)
        return init_prepared(seed, device, weights=weights,
                             compute_dtype=compute_dtype,
                             dtype=None if int8 else compute_dtype)
    tree = (load_npz(weights_npz) if weights_npz
            else load_params(config, spec, seed))
    if lora:
        from dnn_tpu_torch.lora import load_lora, merge_lora

        adapters, alpha = load_lora(lora)
        tree = merge_lora(tree, adapters, alpha=alpha)
    return from_jax_params(tree, spec.config, device,
                           None if int8 else compute_dtype)


def checkpoint_params(path: str, spec):
    """The parameter tree of the checkpoint at `path` (.pth, safetensors
    or .npz): the native flat layout as it is, a foreign one through the
    model's converter."""
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
        if lora_path:
            # merge once (lora.merge_lora): every runtime below serves
            # the adapted weights, as JAX's engine does
            from dnn_tpu_torch.lora import load_lora, merge_lora

            adapters, alpha = load_lora(lora_path)
            self.params = merge_lora(self.params, adapters, alpha=alpha)
            log.info("merged LoRA adapters from %s (%d sites%s)", lora_path,
                     len(adapters),
                     f", alpha={alpha}" if alpha is not None else "")
        self._stage_params = [s.slice_params(self.params)
                              for s in self.stages]
        self._stage_params_on_device: dict = {}
        self.mesh = None
        self._relay = None
        self._pipeline_fn = None
        if role == "stage":
            self.runtime = "stage"
        else:
            self.runtime = self._pick_runtime()
            if self.runtime == "spmd":
                self.mesh = mesh_from_config(config, self.devices)
                self._pipeline_fn = self._build_spmd_fn()
            else:
                self._relay = RelayExecutor([s.apply for s in self.stages],
                                            self._stage_params, self.devices)
        log.info("engine ready: model=%s parts=%d runtime=%s devices=%s "
                 "dtype=%s", config.model, config.num_parts, self.runtime,
                 ",".join(str(d) for d in self.devices), config.dtype)

    def _pick_runtime(self) -> str:
        """JAX's rule (engine.py:198-226, one process): "auto" is relay
        for one part, spmd when there are at least as many devices as
        parts, else relay; spmd short of devices raises."""
        rt = self.config.runtime
        if rt == "auto":
            if self.config.num_parts == 1:
                return "relay"
            rt = ("spmd" if len(self.devices) >= self.config.num_parts
                  else "relay")
        if rt == "spmd" and len(self.devices) < self.config.num_parts:
            raise ValueError(
                f"runtime=spmd needs >= {self.config.num_parts} devices, "
                f"have {len(self.devices)} (use --serve / role='stage' to "
                "host a single stage on a small host)")
        return rt

    # --- the spmd runtime -------------------------------------------------

    def _effective_microbatches(self, batch: int) -> int:
        """The config's microbatches for a batch: as given, or for 0
        (auto) the largest divisor of the batch up to 2 * num_parts (JAX
        :228)."""
        m = self.config.microbatches
        if m != 0:
            return m
        desired = max(2 * self.config.num_parts, 1)
        for cand in range(min(desired, batch), 0, -1):
            if batch % cand == 0:
                return cand
        return 1

    def _gpt_stacked_ready(self) -> bool:
        """The dense-GPT stacked path: equal blocks a stage, more than
        one stage, an exact GPTConfig (JAX :245)."""
        from dnn_tpu_torch.models.gpt import GPTConfig

        cfg = self.spec.config
        return (type(cfg) is GPTConfig
                and cfg.n_layer % self.config.num_parts == 0
                and self.config.num_parts > 1)

    #: below this many parameter bytes "auto" placement replicates (JAX
    #: :260: the per-device saving of a packed row cannot matter there)
    PLACEMENT_AUTO_BYTES = 32 * 1024 * 1024

    def _resolve_param_placement(self) -> str:
        pp = self.config.param_placement
        if pp != "auto":
            return pp
        total = sum(l.numel() * l.element_size()
                    if isinstance(l, torch.Tensor) else np.asarray(l).nbytes
                    for l in _leaves(self._stage_params))
        return "stage" if total > self.PLACEMENT_AUTO_BYTES else "replicated"

    def _build_spmd_fn(self):
        from dnn_tpu_torch.parallel.pipeline import (
            pack_stage_params,
            place_packed,
            place_replicated,
            spmd_pipeline,
        )

        if self._gpt_stacked_ready():
            return self._build_gpt_stacked_fn()
        applies = [s.apply for s in self.stages]
        mesh = self.mesh
        self.param_placement = self._resolve_param_placement()
        if self.param_placement == "replicated":
            placed = place_replicated(self._stage_params, mesh)
            return lambda x: spmd_pipeline(
                applies, self._stage_params, x, mesh=mesh,
                num_microbatches=self._effective_microbatches(x.shape[0]),
                param_placement="replicated", replicated=placed)
        # packed once at load, on the host: each stage device holds only
        # its own row
        packed = place_packed(pack_stage_params(self._stage_params), mesh)
        self._spmd_packed = packed
        return lambda x: spmd_pipeline(
            applies, self._stage_params, x, mesh=mesh,
            num_microbatches=self._effective_microbatches(x.shape[0]),
            packed=packed)

    def _build_gpt_stacked_fn(self):
        """embed on stage 0, each stage's blocks (the einsum attention,
        as the relay's stages) on its device, the head on the last stage:
        a microbatch goes through the same operations as the relay
        engine's run of it. The stage-major layout is also the
        pipeline-parallel decoder's (`_gen_parts`)."""
        from dnn_tpu_torch.models import gpt
        from dnn_tpu_torch.parallel.pipeline import run_stages
        from dnn_tpu_torch.runtime.generate import prepare_pipeline_stacked

        cfg = self.spec.config
        cd = self.compute_dtype
        mesh = self.mesh
        if self.config.param_placement == "replicated":
            log.warning("param_placement='replicated' ignored: the stacked "
                        "GPT runtime always places block weights per stage")
        self.param_placement = "stage"
        stage_blocks, aux = prepare_pipeline_stacked(self.params, cfg, mesh)
        self._gen_parts = (stage_blocks, aux)
        last = mesh.devices[-1]
        head_p = {k: place(aux[k], last) for k in ("ln_f", "lm_head")
                  if k in aux}
        head_p.setdefault("wte", aux["wte"])
        per_stage = cfg.n_layer // self.config.num_parts
        stage_cfg = dataclasses.replace(cfg, n_layer=per_stage)
        n = self.config.num_parts

        def stage(d, blocks, h):
            if d == 0:
                h = gpt.embed(aux, h, cfg=cfg)
                if cd is not None:
                    h = h.to(cd)
            h = gpt.blocks_scan(blocks, h, cfg=stage_cfg, compute_dtype=cd)
            if d == n - 1:
                h = gpt.head(head_p, h.float(), cfg=cfg, compute_dtype=cd)
            return h

        steps = [functools.partial(stage, d, b)
                 for d, b in enumerate(stage_blocks)]
        return lambda ids: run_stages(
            steps, ids.to(torch.int64), mesh=mesh,
            num_microbatches=self._effective_microbatches(ids.shape[0]))

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
        if self.runtime == "spmd":
            return self._pipeline_fn(self._input(x, self.devices[0]))
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
        """The stacked decode layout on the first device, built once, its
        matmul weights in the config's compute type (gpt.for_compute)."""
        if not hasattr(self, "_prepared_single"):
            from dnn_tpu_torch.models.gpt import prepare_stacked

            self._prepared_single = prepare_stacked(
                self.params, self.spec.config, self.devices[0],
                self.compute_dtype)
        return self._prepared_single

    def make_generator(self, *, max_new_tokens: int, temperature: float = 0.0,
                       top_k: Optional[int] = None,
                       top_p: Optional[float] = None, kv_dtype=None):
        """generate(ids, seed=0) -> (B, max_new_tokens) int32 tokens on
        this engine's weights, through the port's make_generate (K5 for
        the prompt, K6 per token on the card; a LLaMA-family model over a
        KV-head cache, K5 with grouped heads), at the config's compute
        type (`"dtype": "bfloat16"`: bf16 compute, a bf16 cache) unless
        `kv_dtype` picks the cache. A GPT-MoE model decodes through
        generate_moe.make_generate_moe, which refuses `kv_dtype` as JAX's
        engine does (:480-493); a Mixtral model through make_generate,
        its experts resolved from the config. A dense GPT on the spmd
        runtime decodes pipeline-parallel (make_pipeline_generate: each
        stage's cache shard on its stage device, K5 and K6 there) and
        refuses `kv_dtype`, as JAX's engine does. Sampled draws come from
        a torch.Generator seeded with `seed`; greedy draws equal JAX's."""
        from dnn_tpu_torch.models.gpt import GPTConfig
        from dnn_tpu_torch.models.gpt_moe import GPTMoEConfig
        from dnn_tpu_torch.models.llama import LlamaConfig
        from dnn_tpu_torch.runtime.generate import make_generate

        cfg = self.spec.config
        self._require_full_role()
        if isinstance(cfg, GPTMoEConfig):
            from dnn_tpu_torch.runtime.generate_moe import make_generate_moe

            if kv_dtype is not None:
                raise ValueError(
                    "kv_dtype is not plumbed through the MoE decoder")
            gen = make_generate_moe(
                cfg, max_new_tokens=max_new_tokens, temperature=temperature,
                sample_top_k=top_k, sample_top_p=top_p,
                compute_dtype=self.compute_dtype, device=self.devices[0])
            return lambda ids, seed=0: gen(self._prepared(), ids, seed)
        if not isinstance(cfg, LlamaConfig) and type(cfg) is not GPTConfig:
            raise ValueError(
                f"generation requires a GPT-family or LLaMA-family model; "
                f"'{self.config.model}' has config {type(cfg).__name__}")
        if self.runtime == "spmd" and self._gpt_stacked_ready():
            # JAX :500-513: the ring keeps its stage shards at the compute
            # type; a cache type goes on a family adapter
            if kv_dtype is not None:
                raise ValueError(
                    "kv_dtype applies to the single-program decoders; "
                    "pass kv_dtype on a family adapter for the "
                    "pipeline-parallel ring (generate.GPTPipelineFamily)")
            from dnn_tpu_torch.runtime.generate import make_pipeline_generate

            gen = make_pipeline_generate(
                cfg, self.mesh, max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p,
                compute_dtype=self.compute_dtype)
            stage_blocks, aux = self._gen_parts
            return lambda ids, seed=0: gen(stage_blocks, aux, ids, seed)
        gen = make_generate(cfg, max_new_tokens=max_new_tokens,
                            temperature=temperature, top_k=top_k, top_p=top_p,
                            compute_dtype=self.compute_dtype,
                            kv_dtype=kv_dtype, device=self.devices[0])
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

    def generate_beam(self, ids, *, max_new_tokens: int, beam_size: int,
                      eos_id: Optional[int] = None,
                      length_penalty: float = 0.0) -> torch.Tensor:
        """Beam search on this engine's weights (runtime/beam.py), dense
        GPT family only, as JAX's engine: the best hypothesis per row,
        (B, max_new_tokens) int32. The search is cached per parameter
        tuple like `generate`'s generators."""
        from dnn_tpu_torch.models.gpt import GPTConfig
        from dnn_tpu_torch.runtime.beam import make_beam_generate

        cfg = self.spec.config
        self._require_full_role()
        if type(cfg) is not GPTConfig:
            raise ValueError(
                f"beam search requires a dense GPT-family model; "
                f"'{self.config.model}' has config {type(cfg).__name__}")
        key = ("beam", max_new_tokens, beam_size, eos_id, length_penalty)
        cache = self.__dict__.setdefault("_generators", {})
        if key not in cache:
            gen = make_beam_generate(
                cfg, max_new_tokens=max_new_tokens, beam_size=beam_size,
                eos_id=eos_id, length_penalty=length_penalty,
                compute_dtype=self.compute_dtype, device=self.devices[0])
            cache[key] = lambda i: gen(self._prepared(), i)
        return cache[key](np.asarray(ids, np.int32))

    def stage_times(self, x):
        """One instrumented relay run: (output, per-stage compute
        seconds)."""
        if self._relay is None:
            raise RuntimeError("stage_times needs the relay runtime "
                               "(role='full', runtime relay)")
        y = self._relay(self._input(x, self.devices[0]), record_timings=True)
        return y, list(self._relay.last_stage_times)

