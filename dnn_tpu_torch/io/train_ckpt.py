"""Training checkpoint save / resume (port of dnn_tpu/io/train_ckpt.py).

The on-disk layout is the JAX package's: one `step_%08d.npz` per step
plus its `.manifest.json` ({"step", "leaves": {"leaf_i": {"key",
"dtype"}}, "format": 1}); bfloat16 leaves are stored as a uint16 view
with the dtype tag "bfloat16". Saving keeps the same crash-safe order
(both files staged as temps, an existing step's manifest retracted, the
npz renamed into place before the manifest), so a checkpoint is visible
only when complete.

A train state is any nested dict/list/tuple of tensors (or numpy
arrays), and may hold torch optimizers: a parameter leaf is keyed by
its path ("[0]['blocks']['attn']['qkv']['kernel']"), an optimizer's
per-parameter state by its path plus the parameter's index and the
state's name ("[1].state[3].exp_avg"). The keys are the port's own; the
JAX package's optimizer state does not load here.

Restore is template-based, as in JAX, and IN PLACE: `like` is the live
state (parameters built, optimizer bound to them); parameter leaves are
overwritten with copy_ and each optimizer takes its saved state through
load_state_dict, so it stays bound to its parameters. The bf16
compression of saves and the AsyncCheckpointer stay queued (ROADMAP
Queue 1 item 10).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d{8})\.npz$")
_MANIFEST_SUFFIX = ".manifest.json"


def _walk(tree, prefix=""):
    """(key, node) for every leaf of a state tree; an optimizer is one
    node."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _flatten(state) -> dict:
    """key -> tensor or array, optimizer states expanded."""
    flat = {}
    for key, node in _walk(state):
        if isinstance(node, torch.optim.Optimizer):
            for idx, st in node.state_dict()["state"].items():
                for name, val in st.items():
                    flat[f"{key}.state[{idx}].{name}"] = val
        else:
            flat[key] = node
    return flat


def _to_savable(x):
    """(array to store, dtype tag); bf16 -> uint16 view + tag."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(x)
    return arr, arr.dtype.name


def _from_savable(arr: np.ndarray, tag: str) -> torch.Tensor:
    if tag == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.npz")


def save_train_state(ckpt_dir: str, step: int, state, *,
                     compress_bf16: bool = False) -> str:
    """Persist `state` as checkpoint `step` under `ckpt_dir`, atomically.
    Returns the path."""
    if compress_bf16:
        raise NotImplementedError(
            "compress_bf16 checkpoints are not ported to dnn_tpu_torch yet "
            "(ROADMAP Queue 1 item 10)")
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, dtypes = {}, {}
    for i, (key, leaf) in enumerate(_flatten(state).items()):
        arr, tag = _to_savable(leaf)
        arrays[f"leaf_{i}"] = arr
        dtypes[f"leaf_{i}"] = {"key": key, "dtype": tag}

    # Crash-safe ordering (the JAX module's, :95-123): stage both files
    # as temps; retract an existing step's manifest; rename the npz into
    # place, THEN the manifest. Every crash point leaves either the
    # complete new pair or no visible step-N checkpoint.
    path = checkpoint_path(ckpt_dir, step)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".npz.tmp")
    mfd, mtmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".manifest.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        with os.fdopen(mfd, "w") as f:
            json.dump({"step": step, "leaves": dtypes, "format": 1}, f)
        if os.path.exists(path + _MANIFEST_SUFFIX):
            os.unlink(path + _MANIFEST_SUFFIX)
        os.replace(tmp, path)
        os.replace(mtmp, path + _MANIFEST_SUFFIX)
    except BaseException:
        for t in (tmp, mtmp):
            if os.path.exists(t):
                os.unlink(t)
        raise
    return path


def _take(by_key, key, path):
    if key not in by_key:
        raise KeyError(f"checkpoint {path} is missing leaf {key}")
    return by_key.pop(key)


@torch.no_grad()
def restore_train_state(ckpt_dir_or_path: str, like,
                        step: Optional[int] = None):
    """Load a checkpoint into the live state `like`, in place (see the
    module docstring). Returns (like, step)."""
    if os.path.isdir(ckpt_dir_or_path):
        if step is not None:
            path = checkpoint_path(ckpt_dir_or_path, step)
        else:
            found = latest_checkpoint(ckpt_dir_or_path)
            if found is None:
                raise FileNotFoundError(
                    f"no checkpoints under {ckpt_dir_or_path}")
            path, step = found
    else:
        path = ckpt_dir_or_path

    with open(path + _MANIFEST_SUFFIX) as f:
        manifest = json.load(f)
    if step is None:
        step = manifest["step"]
    by_key = {}
    with np.load(path) as zf:
        for member, meta in manifest["leaves"].items():
            by_key[meta["key"]] = _from_savable(zf[member], meta["dtype"])

    for key, node in _walk(like):
        if isinstance(node, torch.optim.Optimizer):
            sd = node.state_dict()
            state = {}
            for idx in (i for g in sd["param_groups"] for i in g["params"]):
                pre = f"{key}.state[{idx}]."
                names = [k[len(pre):] for k in by_key if k.startswith(pre)]
                if names:
                    state[idx] = {n: _take(by_key, pre + n, path)
                                  for n in names}
            sd["state"] = state
            node.load_state_dict(sd)
            continue
        arr = _take(by_key, key, path)
        if not isinstance(node, torch.Tensor):
            raise TypeError(f"template leaf {key} is a {type(node).__name__}; "
                            "restore fills tensors and optimizers in place")
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{tuple(arr.shape)} vs template "
                             f"{tuple(node.shape)}")
        node.copy_(arr.to(node.dtype))
    return like, step


def latest_checkpoint(ckpt_dir: str) -> Optional[Tuple[str, int]]:
    """Newest complete (path, step) under ckpt_dir, or None. An npz
    without its manifest (crash debris) is skipped."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m:
            path = os.path.join(ckpt_dir, name)
            if not os.path.exists(path + _MANIFEST_SUFFIX):
                continue
            s = int(m.group(1))
            if best is None or s > best[1]:
                best = (path, s)
    return best


def cleanup_old_checkpoints(ckpt_dir: str, keep: int = 3) -> int:
    """Delete all but the newest `keep` complete checkpoints, plus crash
    debris (an npz without its manifest or a manifest without its npz).
    Returns the number of files removed."""
    if keep < 1:
        raise ValueError("keep must be >= 1")
    if not os.path.isdir(ckpt_dir):
        return 0
    complete, debris = [], []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m:
            path = os.path.join(ckpt_dir, name)
            if os.path.exists(path + _MANIFEST_SUFFIX):
                complete.append((int(m.group(1)), path))
            else:
                debris.append(path)
        elif name.endswith(_MANIFEST_SUFFIX):
            npz = os.path.join(ckpt_dir, name[: -len(_MANIFEST_SUFFIX)])
            if (_STEP_RE.match(os.path.basename(npz))
                    and not os.path.exists(npz)):
                debris.append(os.path.join(ckpt_dir, name))
    complete.sort(reverse=True)
    removed = 0
    for _, path in complete[keep:]:
        os.unlink(path)
        os.unlink(path + _MANIFEST_SUFFIX)
        removed += 2
    for path in debris:
        os.unlink(path)
        removed += 1
    return removed
