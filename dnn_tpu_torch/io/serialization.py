"""Tensor wire triple (port of dnn_tpu/io/serialization.py): an array
or tensor <-> (little-endian payload bytes, shape, dtype name), the
fields of the wire's `Tensor` message. bfloat16 travels as its raw
16-bit words under the name "bfloat16", byte-identical to the JAX
package's ml_dtypes payload, and decodes to torch.bfloat16. The payload
length is checked against shape x itemsize."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from dnn_tpu_torch.comm import wirecodec as wc


def encode_tensor(arr) -> Tuple[bytes, Tuple[int, ...], str]:
    """numpy array or torch tensor -> (payload, shape, dtype_name)."""
    msg = wc.make_tensor(arr)
    return bytes(msg.tensor_data), tuple(msg.shape), msg.dtype


def decode_tensor(payload: bytes, shape: Sequence[int],
                  dtype: str) -> torch.Tensor:
    """(payload, shape, dtype_name) -> a CPU torch tensor of its own.
    Raises ValueError when the payload length does not match."""
    return wc.tensor_torch(wc.Tensor(tensor_data=payload, shape=shape,
                                     dtype=dtype))
