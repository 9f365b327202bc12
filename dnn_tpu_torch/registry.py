"""Model registry (port of dnn_tpu/registry.py).

A `ModelSpec` knows how to draw parameters, run the whole model and
split itself into `StageSpec`s for a number of pipeline parts. A stage
is a function over the slice of the parameter tree named by its
`param_keys`. Parameters keep the JAX package's tree layout, so one
checkpoint feeds both packages.

Registered here: `cifar_cnn`, `mlp`, the GPT-2 presets, every
LLaMA-family preset (models/llama.py) and the MoE families' presets
(models/gpt_moe.py: gpt2-moe, gpt2-moe-test; models/llama_moe.py:
mixtral-8x7b, mixtral-test, qwen15-moe-a2.7b, qwen2moe-test). A spec
whose extras hold "init_prepared" draws its random weights as the served
stacks, on a device (runtime/engine.served_params).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One pipeline stage: a function plus the parameter keys it owns."""

    name: str
    apply: Callable[[Any, Any], Any]  # (params_slice, activation) -> activation
    param_keys: Tuple[str, ...]

    def slice_params(self, full_params):
        """Only this stage's entries of the full parameter tree."""
        return {k: full_params[k] for k in self.param_keys}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    init: Callable[..., Any]  # (seed) -> parameter tree of numpy arrays
    apply: Callable[[Any, Any], Any]  # (params, x) -> y, the whole model
    partition: Callable[[int], Sequence[StageSpec]]
    example_input: Callable[..., Any]
    supported_parts: Tuple[int, ...] = (1, 2)
    # foreign flat state dict (torch / HF names and layouts) -> this
    # family's parameter tree
    convert_state_dict: Optional[Callable[[Dict[str, Any]], Any]] = None
    config: Optional[Any] = None  # e.g. GPTConfig for the GPT family
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


_REGISTRY: Dict[str, ModelSpec] = {}


def register_model(spec: ModelSpec) -> ModelSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_model(name: str) -> ModelSpec:
    import dnn_tpu_torch.models  # noqa: F401  (registers the families)

    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown model '{name}'. Available: {sorted(_REGISTRY)}"
        ) from None


def available_models():
    import dnn_tpu_torch.models  # noqa: F401

    return sorted(_REGISTRY)
