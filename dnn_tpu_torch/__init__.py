"""dnn_tpu_torch: the PyTorch/CUDA port of dnn_tpu's LM daemon and solo
decoder (the GPT-2 and LLaMA families), single-card training and staged
pipeline.

The JAX package (`dnn_tpu`) stays the reference; this package serves the
same model over the same gRPC wire on an NVIDIA H100 and trains it
(train.py), with every Pallas kernel of the JAX package — the three
cache-attention kernels of serving (chunked prefill, dense decode, paged
decode; float and int8 caches) and the four flash-attention kernels of
training (forward, forward with logsumexp, dQ, dK/dV) — rewritten as
hand-written CUDA kernels (ops/cuda). It imports torch, numpy, grpc and
protobuf — never jax, and nothing of dnn_tpu.

Device policy: every entry point runs on the card unless the caller
asks for the CPU by name. There is no quiet fallback — `resolve_device`
raises when CUDA is asked for (the default) and absent.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` as given, or "cuda"
    when None. Raises RuntimeError when the result is a CUDA device and
    this process has none — callers that want the CPU pass "cpu"."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dnn_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
