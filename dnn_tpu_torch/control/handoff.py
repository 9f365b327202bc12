"""Prefill->decode KV handoff: the wire format (port of
dnn_tpu/control/handoff.py).

Disaggregated serving moves a prompt's computed KV from a PREFILL
replica to a DECODE replica. The payload is
`ContinuousBatcher.export_prefill`'s dict — the transient row cache's
leaves in the JAX package's pytree order (sorted keys: k, ks, v, vs),
the final chunk's true-last logits row, the prompt length and the
geometry fingerprint — packed here into ONE 1-D uint8 array so that it
rides the SendTensor wire message unchanged.

Format (byte for byte the JAX package's, so either package reads the
other's payloads): the magic, a 4-byte big-endian header length, a JSON
header (`v`, `prompt_len`, `fingerprint`, `leaves`, `logits`; each leaf
spec its shape, its numpy dtype name and its byte count), then the raw
leaf bytes in C order. A bfloat16 leaf ships as its 16-bit words, named
"bfloat16" in the header; numpy has no bfloat16, so this module reads
and writes those words through torch views and never needs ml_dtypes.

`pack` takes torch tensors (any device) or numpy arrays; `unpack`
returns CPU torch tensors (bfloat16 as torch.bfloat16).
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["pack", "unpack", "HandoffFormatError", "host_bytes",
           "as_tensor", "np_dtype_name"]

_MAGIC = b"dnnkv1\n"

# numpy dtype name <-> torch dtype of the leaves a payload may carry
_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "float16": torch.float16, "bfloat16": torch.bfloat16,
          "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
          "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_NAME = {v: k for k, v in _TORCH.items()}


class HandoffFormatError(ValueError):
    """A payload this module cannot pack or parse — corrupt bytes, an
    unsupported cache dtype, or a header/byte-length mismatch. A
    ValueError, so the daemon answers INVALID_ARGUMENT."""


def np_dtype_name(dtype) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16", "int8")."""
    try:
        return _NAME[dtype]
    except KeyError:
        raise HandoffFormatError(
            f"cache dtype {dtype} has no handoff wire form") from None


def host_bytes(x, error=HandoffFormatError) -> Tuple[np.ndarray, str]:
    """A leaf (torch tensor on any device, or numpy array) -> (its C-order
    host storage as a numpy array of a stock dtype, its dtype name). A
    bfloat16 leaf — torch's, or an ml_dtypes numpy array — comes back as
    its uint16 words; anything without a stock numpy form (int4) raises
    `error`."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        if t.dtype not in _NAME:
            raise error(f"cache dtype {t.dtype} has no wire form (int4 "
                        "caches cannot hand off; serve the prefill/decode "
                        "split with f32/bf16/int8 KV)")
        return t.numpy(), _NAME[t.dtype]
    a = np.ascontiguousarray(x)
    name = a.dtype.name
    if name == "bfloat16":
        return a.view(np.uint16), name
    if name not in _TORCH:
        raise error(f"cache dtype {name!r} has no wire form (int4 caches "
                    "cannot hand off; serve the prefill/decode split with "
                    "f32/bf16/int8 KV)")
    return a, name


def as_tensor(x) -> torch.Tensor:
    """A leaf as a CPU torch tensor (a tensor passes through; a numpy
    bfloat16 array is read as its 16-bit words)."""
    if isinstance(x, torch.Tensor):
        return x
    a, name = host_bytes(x)
    t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def pack(payload: Dict) -> np.ndarray:
    """{'row': [leaves], 'logits_row': (V,), 'prompt_len': int,
    'fingerprint': dict} -> one 1-D uint8 array (the wire tensor)."""
    chunks, specs = [], []
    for leaf in list(payload["row"]) + [payload["logits_row"]]:
        host, name = host_bytes(leaf)
        chunks.append(host.tobytes())
        specs.append({"shape": list(host.shape), "dtype": name,
                      "bytes": len(chunks[-1])})
    header = json.dumps({
        "v": 1,
        "prompt_len": int(payload["prompt_len"]),
        "fingerprint": payload.get("fingerprint") or {},
        "leaves": specs[:-1],
        "logits": specs[-1],
    }).encode()
    buf = b"".join([_MAGIC, len(header).to_bytes(4, "big"), header]
                   + chunks)
    return np.frombuffer(buf, np.uint8)


def _read_leaf(body: memoryview, off: int, spec: dict
               ) -> Tuple[torch.Tensor, int]:
    n = int(spec["bytes"])
    if off + n > len(body):
        raise HandoffFormatError(
            "handoff payload truncated: header promises more leaf bytes "
            "than the tensor carries")
    dt = _TORCH.get(spec["dtype"])
    if dt is None:
        raise HandoffFormatError(
            f"handoff payload names unknown dtype {spec['dtype']!r}")
    width = torch.empty((), dtype=dt).element_size()
    if n % width:
        raise HandoffFormatError(
            f"handoff leaf bytes do not match shape {spec['shape']} dtype "
            f"{spec['dtype']}")
    flat = torch.frombuffer(body[off:off + n], dtype=torch.uint8) \
        if n else torch.empty((0,), dtype=torch.uint8)
    try:
        # a copy of its own: the leaf's offset in the payload need not be
        # aligned to its element size
        arr = flat.view(dt).reshape(spec["shape"]).clone()
    except RuntimeError:
        raise HandoffFormatError(
            f"handoff leaf bytes do not match shape {spec['shape']} dtype "
            f"{spec['dtype']}") from None
    return arr, off + n


def unpack(buf) -> Dict:
    """Inverse of pack: the wire tensor -> {'row': [leaves], 'logits_row',
    'prompt_len', 'fingerprint'}, the leaves CPU torch tensors of their
    own. Raises HandoffFormatError (a ValueError) on anything malformed —
    a decode replica answers INVALID_ARGUMENT and never adopts garbage
    KV."""
    if isinstance(buf, torch.Tensor):
        buf = buf.detach().cpu().numpy()
    raw = bytearray(np.asarray(buf, np.uint8).tobytes())
    if not raw.startswith(_MAGIC):
        raise HandoffFormatError(
            "not a KV handoff payload (bad magic) — was this tensor "
            "produced by ContinuousBatcher.export_prefill?")
    at = len(_MAGIC)
    if len(raw) < at + 4:
        raise HandoffFormatError("handoff payload truncated (no header)")
    hlen = int.from_bytes(raw[at:at + 4], "big")
    at += 4
    try:
        head = json.loads(bytes(raw[at:at + hlen]).decode())
        specs: List[dict] = list(head.get("leaves", []))
        logits_spec = head["logits"]
        prompt_len = int(head["prompt_len"])
    except (ValueError, UnicodeDecodeError, KeyError, TypeError):
        raise HandoffFormatError("handoff header is not valid JSON") from None
    body = memoryview(raw)
    leaves, off = [], at + hlen
    for spec in specs:
        leaf, off = _read_leaf(body, off, spec)
        leaves.append(leaf)
    logits, off = _read_leaf(body, off, logits_spec)
    return {"row": leaves, "logits_row": logits, "prompt_len": prompt_len,
            "fingerprint": head.get("fingerprint") or {}}
