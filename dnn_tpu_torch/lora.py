"""LoRA: low-rank adapters over the parameter tree (port of
dnn_tpu/lora.py).

Adapters are a separate small tree, a flat {path: {"a": (..., in, r),
"b": (..., r, out)}} dict keyed by the "/"-joined path of the kernel
they adapt ("h_0/attn/qkv/kernel" on the per-layer layout,
"blocks/attn/qkv/kernel" on the stacked one; leading stack axes are
kept). Deployment is either:
  * merge once (`merge_lora`): W + (alpha / r) a @ b, then serve the
    merged tree on any path (node --lora, engine lora_path);
  * per request (`stack_loras` + `lora_view`): one base tree, N adapters
    stacked behind an all-zero adapter 0 (the base model), and a view
    whose linears carry {"lora": {a, b, sel}} that ops/nn.linear applies
    as a delta on top of the float or quantized base
    (ContinuousBatcher(lora_adapters=...), node --serve_adapter).

b starts at zero, so an adapter fresh from `init_lora` is the identity.
The artifact format of `save_lora`/`load_lora` is the JAX package's: an
.npz with keys "<path>:a", "<path>:b" and, when trained at a non-default
alpha, "__alpha__"; either package loads what the other saved.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

# kernel-bearing key names adapted by default: GPT's qkv, proj, fc and
# the LLaMA family's q, k, v, o, gate, up, down (JAX's DEFAULT_TARGETS)
DEFAULT_TARGETS = ("qkv", "proj", "fc", "q", "k", "v", "o", "gate", "up",
                   "down")


def _flat(tree, prefix=()):
    """[(keys, leaf)] of a nested dict, in sorted key order (JAX's
    flattening order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat(tree[k], prefix + (str(k),))
        return out
    return [(prefix, tree)]


def _map_with_path(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    return fn(prefix, tree)


def _is_target(keys, leaf, targets) -> bool:
    """A weight (two or more dims) under a targeted name whose own key is
    "kernel" or "embedding" -- or is itself a target (so naming "wte"
    adapts the embedding table)."""
    if getattr(leaf, "ndim", 0) < 2:
        return False
    if not set(keys) & set(targets):
        return False
    return keys[-1] in ("kernel", "embedding") or keys[-1] in targets


def init_lora(seed: int, params, *, rank: int,
              targets: Iterable[str] = DEFAULT_TARGETS,
              dtype=torch.float32, device=None):
    """The adapter tree for `params`: for every targeted kernel leaf, a
    (..., in, r) ~ N(0, 1) / sqrt(r) and b (..., r, out) = 0, drawn from
    a torch.Generator seeded with `seed` (the draws differ from
    jax.random's; tests share adapters through numpy). Leading stack
    axes are kept. `device` defaults to the first leaf's."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    flat = _flat(params)
    if device is None:
        device = next((leaf.device for _, leaf in flat
                       if isinstance(leaf, torch.Tensor)), "cpu")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    adapters: Dict[str, Dict[str, torch.Tensor]] = {}
    for keys, leaf in flat:
        if not _is_target(keys, leaf, tuple(targets)):
            continue
        *lead, d_in, d_out = leaf.shape
        a = torch.randn((*lead, d_in, rank), generator=gen, device=device,
                        dtype=torch.float32).to(dtype) / float(rank) ** 0.5
        b = torch.zeros((*lead, rank, d_out), dtype=dtype, device=device)
        adapters["/".join(keys)] = {"a": a, "b": b}
    if not adapters:
        raise ValueError(
            f"no param leaf matched targets {tuple(targets)}; "
            "check the param tree's key names")
    return adapters


def lora_scaling(adapters, *, alpha: Optional[float] = None) -> float:
    """alpha / rank, the merge scale (alpha defaults to the rank, scale
    1.0; the rank is read off the adapter shapes)."""
    if not adapters:
        raise ValueError("empty adapter dict (nothing was loaded/built)")
    rank = next(iter(adapters.values()))["a"].shape[-1]
    return float(alpha if alpha is not None else rank) / float(rank)


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))


def merge_lora(params, adapters, *, alpha: Optional[float] = None):
    """W + (alpha / r) a @ b on every adapted leaf (leading stack axes
    batch through the matmul); every other leaf passes through. Leaves
    are tensors (autograd flows into the adapters) or numpy arrays (the
    engine's host tree; the merged leaf is numpy again). Raises when an
    adapter matches no leaf: a layout mismatch must not serve the base
    model silently."""
    scale = lora_scaling(adapters, alpha=alpha)
    consumed = set()

    def merge_leaf(keys, w):
        path = "/".join(keys)
        ad = adapters.get(path)
        if ad is None:
            return w
        consumed.add(path)
        delta = torch.matmul(_as_tensor(ad["a"]), _as_tensor(ad["b"])) \
            * scale
        if isinstance(w, torch.Tensor):
            return w + delta.to(device=w.device, dtype=w.dtype)
        w = np.asarray(w)
        return w + delta.detach().cpu().numpy().astype(w.dtype)

    merged = _map_with_path(merge_leaf, params)
    unused = set(adapters) - consumed
    if unused:
        raise ValueError(
            f"{len(unused)} adapter entries matched no param leaf "
            f"(layout mismatch?): {sorted(unused)[:3]}...")
    return merged


def make_lora_loss(loss_fn: Callable, base_params, *,
                   alpha: Optional[float] = None) -> Callable:
    """(adapters, batch) -> loss_fn(merge_lora(base, adapters), batch),
    the base frozen in the closure: autograd reaches only the adapter
    tensors that require a gradient."""

    def lora_loss(adapters, batch):
        return loss_fn(merge_lora(base_params, adapters, alpha=alpha), batch)

    return lora_loss


def adapters_to_stacked(adapters, n_layer: int):
    """Per-layer adapter paths ("h_i/...", the training layout) -> the
    prepare_stacked layout ("blocks/..." with a leading L axis); other
    paths pass through. Raises when a stack would miss a layer."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    groups: Dict[str, Dict[int, dict]] = {}
    for path, ab in adapters.items():
        keys = path.split("/")
        if keys[0].startswith("h_") and keys[0][2:].isdigit():
            groups.setdefault("/".join(keys[1:]), {})[int(keys[0][2:])] = ab
        else:
            out[path] = ab
    for rest, by_layer in groups.items():
        if set(by_layer) != set(range(n_layer)):
            raise ValueError(
                f"adapter covers layers {sorted(by_layer)} of {rest} but "
                f"the model has {n_layer} — a partial stack would "
                "silently zero the missing layers")
        out["blocks/" + rest] = {
            k: torch.stack([_as_tensor(by_layer[i][k])
                            for i in range(n_layer)])
            for k in ("a", "b")}
    return out


def stack_loras(adapter_list, *, alphas=None):
    """N adapter trees of one base (same paths, same rank) -> one stack
    {path: {"a": (N+1, ..., in, r), "b": (N+1, ..., r, out)}}, adapter
    i's merge scale folded into its b slab and an all-zero adapter at
    index 0: the base model, for requests that name none."""
    if not adapter_list:
        raise ValueError("adapter_list must name at least one adapter")
    if alphas is not None and len(alphas) != len(adapter_list):
        raise ValueError(
            f"{len(alphas)} alphas for {len(adapter_list)} adapters")
    paths = set(adapter_list[0])
    for i, ad in enumerate(adapter_list[1:], 1):
        if set(ad) != paths:
            raise ValueError(
                f"adapter {i} targets different leaves than adapter 0: "
                f"{sorted(set(ad) ^ paths)[:3]}...")
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for p in sorted(paths):
        a0 = _as_tensor(adapter_list[0][p]["a"])
        b0 = _as_tensor(adapter_list[0][p]["b"])
        a_stack, b_stack = [torch.zeros_like(a0)], [torch.zeros_like(b0)]
        for i, ad in enumerate(adapter_list):
            a, b = _as_tensor(ad[p]["a"]), _as_tensor(ad[p]["b"])
            if a.shape != a0.shape or b.shape != b0.shape:
                raise ValueError(
                    f"adapter {i} shape mismatch at {p}: "
                    f"{tuple(a.shape)}/{tuple(b.shape)} vs "
                    f"{tuple(a0.shape)}/{tuple(b0.shape)}")
            scale = lora_scaling(
                ad, alpha=None if alphas is None else alphas[i])
            a_stack.append(a.to(a0.device))
            b_stack.append(b.to(b0.device) * scale)
        out[p] = {"a": torch.stack(a_stack), "b": torch.stack(b_stack)}
    return out


def lora_view(params, stacked, sel, *, transposed: bool = False):
    """`params` with, beside every kernel leaf `stacked` names, a
    {"lora": {a, b, sel}} entry that ops/nn.linear applies as a delta on
    top of the base product (the base leaf is untouched: one set of
    weights serves every adapter). `sel` is the (B, N+1) one-hot adapter
    choice per batch row. For a layer-stacked leaf the adapter axis goes
    behind the layer axis (unless `transposed`: the stack already went
    through `transpose_lora_stack`) and sel is broadcast to (L, B, N+1)
    as a VIEW, so a layer's slice reads the caller's sel tensor: a sel
    written in place reaches every view, and a captured CUDA graph,
    without a rebuild. Only dicts are copied; no tensor is.

    An adapter of the embedding table is refused: the lookup would
    ignore it silently (merge it with merge_lora instead)."""

    def _attach(node, keys, ab):
        if len(keys) < 2:
            raise ValueError(
                f"adapter path {'/'.join(keys)!r} names no containing dict")
        k = keys[0]
        if not isinstance(node, dict) or k not in node:
            raise ValueError(
                f"adapter path segment {k!r} not found in params (layout "
                f"mismatch? keys: "
                f"{sorted(node)[:6] if isinstance(node, dict) else type(node)})")
        out = dict(node)
        if len(keys) == 2:
            child = dict(node[k])
            a, b = ab["a"], ab["b"]
            if a.ndim == 4:  # layer-stacked leaf
                if not transposed:
                    a, b = a.movedim(0, 1), b.movedim(0, 1)
                s = sel.expand((a.shape[0],) + tuple(sel.shape))
            else:
                s = sel
            child["lora"] = {"a": a, "b": b, "sel": s}
            out[k] = child
        else:
            out[k] = _attach(node[k], keys[1:], ab)
        return out

    view = params
    for path, ab in stacked.items():
        if path.split("/")[-1] == "embedding":
            raise ValueError(
                f"adapter targets the embedding table ({path}); per-request "
                "serving applies deltas inside linear layers only — an "
                "embedding adapter would be silently ignored. Merge it "
                "(merge_lora) or retrain with linear targets.")
        view = _attach(view, path.split("/"), ab)
    return view


def transpose_lora_stack(stacked):
    """A `stack_loras` result with its layer-stacked slabs in layer order
    ((N, L, ...) -> (L, N, ...)), contiguous, once: every later
    `lora_view(..., transposed=True)` is then dict work only."""
    out = {}
    for path, ab in stacked.items():
        a, b = ab["a"], ab["b"]
        if a.ndim == 4:
            a, b = a.movedim(0, 1).contiguous(), b.movedim(0, 1).contiguous()
        out[path] = {"a": a, "b": b}
    return out


def save_lora(path: str, adapters, *, alpha: Optional[float] = None) -> None:
    """Adapters -> one .npz, JAX's format: keys "<path>:a" / "<path>:b",
    and "__alpha__" (f32 scalar) when a non-default alpha was trained
    with (the merge scale is part of the artifact)."""
    flat = {}
    for k, ab in adapters.items():
        for which in ("a", "b"):
            v = ab[which]
            flat[f"{k}:{which}"] = (v.detach().cpu().float().numpy()
                                    if isinstance(v, torch.Tensor)
                                    else np.asarray(v))
    if alpha is not None:
        flat["__alpha__"] = np.asarray(float(alpha), np.float32)
    np.savez(path, **flat)


def load_lora(path: str) -> Tuple[Dict[str, Dict[str, torch.Tensor]],
                                  Optional[float]]:
    """.npz -> (adapters of CPU tensors, alpha or None when the artifact
    carries none); pass alpha on to merge_lora / stack_loras."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    alpha = None
    if "__alpha__" in flat:
        alpha = float(flat.pop("__alpha__"))
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in flat.items():
        leaf_path, _, which = k.rpartition(":")
        if which not in ("a", "b"):
            raise ValueError(f"malformed LoRA npz key: {k}")
        out.setdefault(leaf_path, {})[which] = torch.from_numpy(
            np.array(v, order="C"))
    for k, ab in out.items():
        if set(ab) != {"a", "b"}:
            raise ValueError(f"LoRA npz missing half of {k}: has {set(ab)}")
    return out, alpha
