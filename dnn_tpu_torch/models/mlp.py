"""MLP family (port of dnn_tpu/models/mlp.py): fc layers over flattened
inputs, relu between them, softmax after the last — (784 -> 512 -> 256
-> 10) by default. Partitioned at layer boundaries for any 1 <=
num_parts <= depth, by gpt.layer_ranges (earlier stages take the
remainder)."""

from __future__ import annotations

import math

import numpy as np

from dnn_tpu_torch.ops.nn import linear, relu, softmax
from dnn_tpu_torch.registry import ModelSpec, StageSpec, register_model

DEFAULT_WIDTHS = (784, 512, 256, 10)


def make_spec(name="mlp", widths=DEFAULT_WIDTHS):
    """Build and register an MLP ModelSpec over `widths` (in, hidden...,
    out)."""
    widths = tuple(int(w) for w in widths)
    if len(widths) < 2:
        raise ValueError("widths needs at least (in, out)")
    depth = len(widths) - 1
    layer_names = tuple(f"fc{i}" for i in range(depth))

    def init(seed: int = 0):
        """numpy draws from `seed`, torch nn.Linear's default bounds."""
        rng = np.random.default_rng(seed)
        params = {}
        for i, lname in enumerate(layer_names):
            bound = 1.0 / math.sqrt(widths[i])
            kb = math.sqrt(3.0) * bound
            params[lname] = {
                "kernel": rng.uniform(-kb, kb, (widths[i], widths[i + 1]))
                .astype(np.float32),
                "bias": rng.uniform(-bound, bound, (widths[i + 1],))
                .astype(np.float32)}
        return params

    def _seg(i):
        last = i == depth - 1

        def fn(params, x, _name=layer_names[i], _last=last):
            h = linear(params[_name], x)
            return softmax(h, axis=-1) if _last else relu(h)

        return fn

    segments = tuple(_seg(i) for i in range(depth))

    def apply(params, x):
        for fn in segments:
            x = fn(params, x)
        return x

    def partition(num_parts):
        from dnn_tpu_torch.models.gpt import layer_ranges

        if not 1 <= num_parts <= depth:
            raise ValueError(f"{name} has {depth} layers; num_parts must be "
                             f"in [1, {depth}], got {num_parts}")
        stages = []
        for lo, hi in layer_ranges(depth, num_parts):

            def stage_fn(params, x, _lo=lo, _hi=hi):
                for i in range(_lo, _hi):
                    x = segments[i](params, x)
                return x

            stages.append(StageSpec(name="+".join(layer_names[lo:hi]),
                                    apply=stage_fn,
                                    param_keys=layer_names[lo:hi]))
        return stages

    def example_input(batch_size=1, seed=0):
        rng = np.random.default_rng(seed)
        return rng.standard_normal((batch_size, widths[0]), dtype=np.float32)

    def convert_state_dict(sd):
        """torch nn.Linear (out, in) weights -> (in, out) kernels."""
        params = {}
        for i, lname in enumerate(layer_names):
            w = np.asarray(sd[f"{lname}.weight"])
            if w.shape != (widths[i + 1], widths[i]):
                raise ValueError(f"{lname}.weight shape {w.shape} != "
                                 f"{(widths[i + 1], widths[i])}")
            params[lname] = {"kernel": np.ascontiguousarray(w.T),
                             "bias": np.asarray(sd[f"{lname}.bias"])}
        return params

    return register_model(ModelSpec(
        name=name, init=init, apply=apply, partition=partition,
        example_input=example_input,
        supported_parts=tuple(range(1, depth + 1)),
        convert_state_dict=convert_state_dict))


make_spec()
