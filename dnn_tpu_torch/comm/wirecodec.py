"""Hand-coded proto3 codec for the Tensor-carrying messages (port of
dnn_tpu/comm/wirecodec.py:34-300).

`Tensor`, `TensorRequest` and `TensorResponse` (wire.proto) are
assembled and parsed at the wire-format level, byte-compatible with
protobuf's own encoding; the payload rides as a memoryview of the
array's buffer on the way out and as a read-only numpy view over the
message bytes on the way in (`tensor_torch`: a torch tensor of its
own). Torch tensors encode directly, bfloat16 included: it rides as
raw 16-bit words under the wire name "bfloat16", as the JAX codec's.

crc32c (the optional field 4): `make_tensor` writes the CRC-32C of
every payload, as the JAX codec's `make_tensor(crc=True)` does, and
`tensor_view` verifies one wherever a peer declared it (absent means
"not checksummed"); both through the native CRC-32C of
dnn_tpu_torch/native, which equals the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dnn_tpu_torch.native import crc32c

BytesLike = Union[bytes, memoryview]

_VARINT = 0
_I64 = 1
_LEN = 2
_I32 = 5


class PayloadCorruptError(ValueError):
    """A tensor payload failed its declared crc32c."""


def _encode_varint(n: int) -> bytes:
    if n < 0:
        n &= 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _decode_varint(buf, pos: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint in wire payload")
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint overflows 64 bits")


def _scan(buf: memoryview):
    """Yield (field_no, wire_type, value) over one message's bytes; LEN
    fields yield zero-copy memoryview slices."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _decode_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == _VARINT:
            val, pos = _decode_varint(buf, pos)
        elif wt == _LEN:
            ln, pos = _decode_varint(buf, pos)
            if pos + ln > n:
                raise ValueError("truncated length-delimited field")
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == _I64:
            val = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wt == _I32:
            val = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {field})")
        yield field, wt, val


def _int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


class Tensor:
    """wire.proto `Tensor`."""

    __slots__ = ("tensor_data", "shape", "dtype", "crc32c")

    def __init__(self, tensor_data: BytesLike = b"",
                 shape: Sequence[int] = (), dtype: str = "",
                 crc32c: Optional[int] = None):
        self.tensor_data = tensor_data
        self.shape = list(shape)
        self.dtype = dtype
        self.crc32c = crc32c

    def HasField(self, name: str) -> bool:  # noqa: N802 — pb API
        if name != "crc32c":
            raise ValueError(f"Tensor has no presence field {name!r}")
        return self.crc32c is not None

    def _parts(self) -> List[BytesLike]:
        parts: List[BytesLike] = []
        ln = len(self.tensor_data)
        if ln:
            parts.append(b"\x0a" + _encode_varint(ln))
            parts.append(self.tensor_data)
        if self.shape:
            packed = b"".join(_encode_varint(int(s)) for s in self.shape)
            parts.append(b"\x12" + _encode_varint(len(packed)) + packed)
        if self.dtype:
            d = self.dtype.encode()
            parts.append(b"\x1a" + _encode_varint(len(d)) + d)
        if self.crc32c is not None:
            parts.append(b"\x20" + _encode_varint(self.crc32c & 0xFFFFFFFF))
        return parts

    def ByteSize(self) -> int:  # noqa: N802 — pb API
        """The serialized size (the payload is not copied)."""
        return sum(len(p) for p in self._parts())


def _parse_tensor(buf: memoryview) -> Tensor:
    t = Tensor()
    for field, wt, val in _scan(buf):
        if field == 1 and wt == _LEN:
            t.tensor_data = val
        elif field == 2:
            if wt == _LEN:  # packed repeated int32
                pos = 0
                while pos < len(val):
                    v, pos = _decode_varint(val, pos)
                    t.shape.append(_int32(v))
            elif wt == _VARINT:
                t.shape.append(_int32(val))
        elif field == 3 and wt == _LEN:
            t.dtype = bytes(val).decode()
        elif field == 4 and wt == _VARINT:
            t.crc32c = val & 0xFFFFFFFF
    return t


class TensorRequest:
    __slots__ = ("request_id", "tensor")

    def __init__(self, request_id: str = "", tensor: Optional[Tensor] = None):
        self.request_id = request_id
        self.tensor = tensor if tensor is not None else Tensor()

    def _parts(self) -> List[BytesLike]:
        parts: List[BytesLike] = []
        if self.request_id:
            r = self.request_id.encode()
            parts.append(b"\x0a" + _encode_varint(len(r)) + r)
        sub = self.tensor._parts()
        parts.append(b"\x12" + _encode_varint(sum(len(p) for p in sub)))
        parts.extend(sub)
        return parts

    def ByteSize(self) -> int:  # noqa: N802 — pb API
        """The serialized size (the payload is not copied)."""
        return sum(len(p) for p in self._parts())


class TensorResponse:
    __slots__ = ("status", "result_tensor")

    def __init__(self, status: str = "",
                 result_tensor: Optional[Tensor] = None):
        self.status = status
        self.result_tensor = result_tensor

    def HasField(self, name: str) -> bool:  # noqa: N802 — pb API
        if name != "result_tensor":
            raise ValueError(f"TensorResponse has no presence field {name!r}")
        return self.result_tensor is not None

    def _parts(self) -> List[BytesLike]:
        parts: List[BytesLike] = []
        if self.status:
            s = self.status.encode()
            parts.append(b"\x0a" + _encode_varint(len(s)) + s)
        if self.result_tensor is not None:
            sub = self.result_tensor._parts()
            parts.append(b"\x12" + _encode_varint(sum(len(p) for p in sub)))
            parts.extend(sub)
        return parts

    def ByteSize(self) -> int:  # noqa: N802 — pb API
        """The serialized size (the payload is not copied)."""
        return sum(len(p) for p in self._parts())


def serialize_request(msg: TensorRequest) -> bytes:
    return b"".join(msg._parts())


def serialize_response(msg: TensorResponse) -> bytes:
    return b"".join(msg._parts())


def parse_request(data: bytes) -> TensorRequest:
    req = TensorRequest()
    for field, wt, val in _scan(memoryview(data)):
        if field == 1 and wt == _LEN:
            req.request_id = bytes(val).decode()
        elif field == 2 and wt == _LEN:
            req.tensor = _parse_tensor(val)
    return req


def parse_response(data: bytes) -> TensorResponse:
    resp = TensorResponse()
    for field, wt, val in _scan(memoryview(data)):
        if field == 1 and wt == _LEN:
            resp.status = bytes(val).decode()
        elif field == 2 and wt == _LEN:
            resp.result_tensor = _parse_tensor(val)
    return resp


# wire dtype name -> numpy storage. bfloat16 rides as its raw 16-bit
# words, byte-identical to the JAX codec's ml_dtypes payload (numpy has
# no bfloat16; tensor_torch reads the words back as torch.bfloat16).
_DTYPES = {name: np.dtype(name) for name in (
    "float32", "float64", "float16", "int8", "int16", "int32", "int64",
    "uint8", "bool")}
_DTYPES["bfloat16"] = np.dtype(np.uint16)


def _wire_array(arr) -> Tuple[np.ndarray, str]:
    """array or tensor -> (C-contiguous little-endian numpy storage, wire
    dtype name)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(arr)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return a, a.dtype.name


def make_tensor(arr) -> Tensor:
    """numpy array or torch tensor (any device; bf16 included) -> Tensor
    with a memoryview payload (copied only when the array is not
    C-contiguous little-endian host memory) and its crc32c."""
    a, name = _wire_array(arr)
    shape = tuple(a.shape)
    a = np.ascontiguousarray(a)
    if name not in _DTYPES:
        raise ValueError(f"unsupported wire dtype {a.dtype}")
    view = memoryview(a.reshape(-1).view(np.uint8))
    return Tensor(tensor_data=view, shape=shape, dtype=name,
                  crc32c=crc32c(view))


def tensor_view(msg: Tensor) -> np.ndarray:
    """Tensor -> read-only numpy view over the payload bytes (bfloat16:
    its uint16 words). Verifies a declared crc32c, computed once
    (PayloadCorruptError), and the payload length."""
    if msg.crc32c is not None:
        got = crc32c(msg.tensor_data)
        if got != msg.crc32c:
            raise PayloadCorruptError(
                f"tensor payload corrupt: crc32c {got:#010x} != declared "
                f"{msg.crc32c:#010x}")
    if msg.dtype not in _DTYPES:
        raise ValueError(f"unsupported wire dtype {msg.dtype!r}")
    dt = _DTYPES[msg.dtype].newbyteorder("<")
    shape = tuple(int(s) for s in msg.shape)
    expect = int(np.prod(shape)) * dt.itemsize if shape else dt.itemsize
    if len(msg.tensor_data) != expect:
        raise ValueError(
            f"tensor payload is {len(msg.tensor_data)} bytes but shape "
            f"{shape} dtype {msg.dtype} needs {expect}")
    return np.frombuffer(msg.tensor_data, dtype=dt).reshape(shape)


def tensor_torch(msg: Tensor) -> torch.Tensor:
    """Tensor -> a CPU torch tensor of its own (a copy of the payload);
    "bfloat16" decodes to torch.bfloat16. Checks as tensor_view."""
    a = np.array(tensor_view(msg), dtype=_DTYPES[msg.dtype])
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if msg.dtype == "bfloat16" else t
