"""Native host code of the port: the wire's CRC-32C.

    crc32c(data, seed=0) -> int         # crc32c.cpp through ctypes
    crc32c_sliced(data, seed=0) -> int  # the same, always slice-by-8
    hardware() -> bool                  # crc32c runs on SSE4.2's crc32
    crc32c_plain(data, seed=0) -> int   # the table-driven Python version

`crc32c` is the checksum the wire codec writes and verifies
(comm/wirecodec.py); it equals the JAX package's `dnn_tpu.native.crc32c`
bit for bit, on the crc32 instruction where the CPU has it and through
slice-by-8 tables elsewhere. The library builds with g++ at first use
into build/ beside this file (listed in .gitignore), named by a hash of
its source and flags, so an edited source rebuilds. There is no fallback: a failed build
or load raises with the compiler's output. `crc32c_plain` is the
reference the tests hold the native function against; nothing on the
wire path calls it. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "crc32c.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    """The native library failed to build or to load."""


def lib_path() -> Path:
    """The library: named by a hash of the source's bytes and the flags."""
    h = hashlib.sha1(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libcrc32c-{h.hexdigest()[:12]}.so"


def _build(out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"g++ could not build {SRC.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"g++ failed to build {SRC.name} (rc {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The loaded library, built first if missing. Raises
    NativeBuildError."""
    global _lib
    with _lock:
        if _lib is None:
            out = lib_path()
            if not out.exists():
                _build(out)
            try:
                lib = ctypes.CDLL(str(out))
            except OSError as e:
                raise NativeBuildError(f"cannot load {out}: {e}") from e
            for fn in (lib.dnn_crc32c, lib.dnn_crc32c_sliced):
                fn.restype = ctypes.c_uint32
                fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                               ctypes.c_uint32]
            lib.dnn_crc32c_hardware.restype = ctypes.c_int
            lib.dnn_crc32c_hardware.argtypes = []
            _lib = lib
        return _lib


def _as_buffer(data) -> memoryview:
    """A C-contiguous uint8 memoryview over `data`, copied only when
    `data` is not contiguous (a payload view must not be copied to be
    checksummed)."""
    if isinstance(data, np.ndarray):
        a = data if data.flags.c_contiguous else np.ascontiguousarray(data)
        return memoryview(a.reshape(-1).view(np.uint8))
    view = memoryview(data)
    if not view.c_contiguous:
        view = memoryview(view.tobytes())
    return view.cast("B") if view.ndim else view.cast("B", (1,))


def _call(fn, data, seed: int) -> int:
    buf = _as_buffer(data)
    ptr = np.frombuffer(buf, np.uint8).ctypes.data if len(buf) else None
    return int(fn(ptr, len(buf), seed & 0xFFFFFFFF))


def crc32c(data, seed: int = 0) -> int:
    """CRC-32C (Castagnoli) of bytes, a memoryview or an ndarray,
    continuing from `seed`."""
    return _call(load().dnn_crc32c, data, seed)


def crc32c_sliced(data, seed: int = 0) -> int:
    """crc32c through the slice-by-8 tables whatever the CPU (the route
    crc32c takes without SSE4.2), for the tests and the timings."""
    return _call(load().dnn_crc32c_sliced, data, seed)


def hardware() -> bool:
    """Whether crc32c runs on the SSE4.2 crc32 instruction."""
    return bool(load().dnn_crc32c_hardware())


def _table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _table()


def crc32c_plain(data, seed: int = 0) -> int:
    """The table-driven CRC-32C, one byte at a time (the tests'
    reference)."""
    crc = ~seed & 0xFFFFFFFF
    for byte in _as_buffer(data):
        crc = _TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF
