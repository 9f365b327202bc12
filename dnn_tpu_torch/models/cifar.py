"""CIFAR-10 CNN family (port of dnn_tpu/models/cifar.py).

    conv1 3->32 k3 s1 SAME, relu, maxpool 2x2
    conv2 32->64 k3 s1 SAME, relu, maxpool 2x2
    flatten -> fc1 4096->512, relu -> fc2 512->10 -> softmax

Activations are NHWC and kernels HWIO, as in the JAX package, so a
3- or 4-way split puts the same NHWC tensors on the wire. The conv->fc
flatten emits the (C, H, W) order of the JAX package's `_seg_conv2`:
the 2-way split's wire activation and fc1's layout are byte-compatible
with a JAX stage's.

Parameter tree: {"conv1": {kernel, bias}, "conv2": {kernel, bias},
"fc1": {kernel, bias}, "fc2": {kernel, bias}}; `init` draws it with
numpy from a seed, within the JAX package's bounds (torch's default
Conv2d/Linear scale).
"""

from __future__ import annotations

import math

import numpy as np

from dnn_tpu_torch.ops.nn import conv2d, linear, max_pool2d, relu, softmax
from dnn_tpu_torch.registry import ModelSpec, StageSpec, register_model

NUM_CLASSES = 10
IMAGE_SHAPE = (32, 32, 3)  # HWC
FLAT_FEATURES = 8 * 8 * 64  # two 2x2 pools: 32 -> 16 -> 8, 64 channels


def _uniform_layer(rng, kernel_shape, fan_in):
    bound = 1.0 / math.sqrt(fan_in)
    kb = math.sqrt(3.0) * bound
    kernel = rng.uniform(-kb, kb, kernel_shape).astype(np.float32)
    bias = rng.uniform(-bound, bound, kernel_shape[-1:]).astype(np.float32)
    return {"kernel": kernel, "bias": bias}


def init(seed: int = 0):
    """Random parameters drawn with numpy from `seed`: kernels uniform in
    +-sqrt(3)/sqrt(fan_in), biases in +-1/sqrt(fan_in). Returns the
    parameter tree of float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return {
        "conv1": _uniform_layer(rng, (3, 3, 3, 32), 3 * 3 * 3),
        "conv2": _uniform_layer(rng, (3, 3, 32, 64), 3 * 3 * 32),
        "fc1": _uniform_layer(rng, (FLAT_FEATURES, 512), FLAT_FEATURES),
        "fc2": _uniform_layer(rng, (512, NUM_CLASSES), 512),
    }


def _seg_conv1(params, x):
    return max_pool2d(relu(conv2d(params["conv1"], x)))


def _seg_conv2(params, x):
    h = max_pool2d(relu(conv2d(params["conv2"], x)))
    # (C, H, W) flatten, as the JAX package's _seg_conv2 (:104-113)
    return h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)


def _seg_fc1(params, x):
    return relu(linear(params["fc1"], x))


def _seg_fc2(params, x):
    return softmax(linear(params["fc2"], x), axis=1)


_SEGMENTS = (
    ("conv1", _seg_conv1, ("conv1",)),
    ("conv2", _seg_conv2, ("conv2",)),
    ("fc1", _seg_fc1, ("fc1",)),
    ("fc2", _seg_fc2, ("fc2",)),
)

# num_parts=2 is the reference's split: convs + flatten | fcs + softmax
_PARTITIONS = {
    1: ((0, 1, 2, 3),),
    2: ((0, 1), (2, 3)),
    3: ((0,), (1,), (2, 3)),
    4: ((0,), (1,), (2,), (3,)),
}


def apply(params, x):
    """Whole model: (B, 32, 32, 3) NHWC -> (B, 10) class probabilities."""
    for _, fn, _ in _SEGMENTS:
        x = fn(params, x)
    return x


def partition(num_parts):
    if num_parts not in _PARTITIONS:
        raise ValueError(f"cifar_cnn supports num_parts in "
                         f"{sorted(_PARTITIONS)}, got {num_parts}")
    stages = []
    for seg_ids in _PARTITIONS[num_parts]:
        segs = tuple(_SEGMENTS[i] for i in seg_ids)

        def stage_fn(params, x, _segs=segs):
            for _, fn, _ in _segs:
                x = fn(params, x)
            return x

        stages.append(StageSpec(
            name="+".join(s[0] for s in segs), apply=stage_fn,
            param_keys=tuple(k for _, _, keys in segs for k in keys)))
    return stages


def example_input(batch_size=1, seed=0):
    """A standard-normal NHWC batch drawn with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch_size, *IMAGE_SHAPE), dtype=np.float32)


def _convert_state_dict(sd):
    from dnn_tpu_torch.io.checkpoint import cifar_params_from_torch_state_dict

    return cifar_params_from_torch_state_dict(sd)


register_model(ModelSpec(
    name="cifar_cnn", init=init, apply=apply, partition=partition,
    example_input=example_input, supported_parts=tuple(sorted(_PARTITIONS)),
    convert_state_dict=_convert_state_dict))
