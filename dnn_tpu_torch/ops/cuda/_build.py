"""Build the CUDA kernels on first use and load them with ctypes.

Each source under csrc/ compiles with nvcc, for sm_90a, into its own
shared library with a plain C interface — no PyTorch headers, so a build
takes seconds. All missing libraries build in parallel (one nvcc per
source, started together). The library's file name carries a hash of its
source and flags, so an edited source rebuilds. Output goes to build/
beside this file (listed in .gitignore); nothing outside the checkout is
read or written apart from the CUDA toolkit itself.

Nothing here runs at import: the tests import every module on hosts with
no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# kernel name -> (source file, C symbol, argtypes). Every pointer and the
# stream are c_void_p (the scale, lse and workspace pointers too, None
# where absent): a default ctypes int would cut them to 32 bits. kv_kind is
# 0 = f32, 1 = bf16, 2 = int8 with scales; q_kind 0 = f32, 1 = bf16. A source and the csrc/
# headers it includes name its library (lib_path); a source may export
# several entry points (flash_backward.cu: K3 and K4), and then one
# library serves them all.
KERNELS = {
    "cached_attention": (
        "cached_attention.cu", "dnn_cached_attention",
        # q k v ks vs pos out ws | BH H G T S D kv_kind q_kind
        # split_tiles | scale window softcap stream (G: query heads a KV
        # head; q_kind: 0 f32, 1 bf16 q and out; ws: the split-KV
        # workspace, None for a single split; window 0 / softcap 0: none)
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         _I, _F, _I, _F, _P]),
    "decode_attention": (
        "decode_attention.cu", "dnn_decode_attention",
        # q k v ks vs pos out ws | B Hk R S D kv_kind q_kind split_keys
        # | scale window softcap stream (ws: the split-KV workspace, None
        # for a single split)
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         _F, _I, _F, _P]),
    "paged_decode": (
        "paged_decode.cu", "dnn_paged_decode_attention",
        # q kp vp ks vs tables pos out ws | B Hk R D bp nb_max kv_kind
        # q_kind split_keys | scale window stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
         _I, _I, _F, _I, _P]),
    "flash_attention": (
        "flash_attention.cu", "dnn_flash_attention",
        # q k v out lse | BH T S D causal kind | scale stream
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]),
    "flash_bwd_dq": (
        "flash_backward.cu", "dnn_flash_bwd_dq",
        # q k v do lse di dq | BH T S D causal kind | scale stream
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]),
    "flash_bwd_dkv": (
        "flash_backward.cu", "dnn_flash_bwd_dkv",
        # q k v do lse di dk dv | BH T S D causal kind | scale stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]),
}

_lock = threading.Lock()
_loaded: dict = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/"
        "bin): the CUDA kernels build from source on first use")


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _inputs(src: str) -> list:
    """`src` and every csrc/ header it includes with #include "...",
    transitively, in the order first met."""
    seen, todo = [], [src]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        try:
            text = (CSRC / name).read_text()
        except FileNotFoundError:  # not a csrc/ header: nvcc finds it
            continue
        seen.append(name)
        todo += _INCLUDE.findall(text)
    return seen


def lib_path(name: str) -> Path:
    """The library of kernel `name`: named by its source and a hash of
    the bytes of the source and of the csrc/ headers it includes, and of
    the flags."""
    src = KERNELS[name][0]
    h = hashlib.sha1()
    for part in _inputs(src):
        h.update(part.encode() + b"\0" + (CSRC / part).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(src).stem}-{h.hexdigest()[:12]}.so"


def build(names=None) -> dict:
    """Compile every listed kernel whose library is missing, all nvcc
    processes in parallel. Returns {name: compiler output} for the ones
    built now (one per source). Raises RuntimeError naming each failed
    build."""
    names = list(KERNELS) if names is None else list(names)
    by_lib = {lib_path(n): n for n in names}
    missing = [n for p, n in by_lib.items() if not p.exists()]
    if not missing:
        return {}
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in missing:
        out = lib_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str):
    """The kernel's C entry point, building its library if needed."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            build([name])
            _src, sym, argtypes = KERNELS[name]
            fn = getattr(ctypes.CDLL(str(lib_path(name))), sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return fn
