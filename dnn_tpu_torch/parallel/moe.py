"""Mixture-of-Experts FFN, the dense (single-device) path (port of
dnn_tpu/parallel/moe.py:43-266).

GShard-style top-k routing with a STATIC capacity, as the JAX package
routes: dispatch and combine are dense one-hot (S, E, cap) tensors
consumed by einsums, and every expert runs as one batched (E, cap, D) x
(E, D, F) product. Tokens past an expert's capacity are dropped (their
combine weight is 0); callers keep the residual, so a dropped token
passes through unchanged.

Routing is f32 whatever the compute type. `route_topk` selects in k
rounds of argmax (the first maximum on a tie, as jnp.argmax), and a
token's slot in an expert is the running count of that expert's earlier
selections: round r's tokens follow every round-(r-1) selection of the
expert, in token order. The combine weights renormalise over the KEPT
selections only (`normalize`; Mixtral's convention), or keep the raw
softmax probabilities (`normalize=False`, Qwen2-MoE's norm_topk_prob).
Everything is built from comparisons with an `arange` and cumulative
sums: no host read-back and no data-dependent shape, so a routed block
rides a captured CUDA graph; the capacity is a Python int from the
static shapes.

The experts accumulate in f32 over operands in the compute type. int8
expert stacks (quant.quantize_tree: `wi`/`wo` or `wg`/`wu`/`wd` int8
with per-(expert, channel) `*_scale` leaves) are cast to the compute
type for the product, and the scales multiply the f32 accumulators
before the activation (JAX :170-180). The products are torch batched
matmuls: the JAX package computes them with XLA einsums, outside any
Pallas kernel.

Tokens route in `groups` independent groups (capacity per group and
expert), the unit the expert-parallel path shards: at groups = n the
dense path is what an n-device EP run computes. The EP builders
themselves (`moe_ffn_local`, `make_moe_ffn_ep`) need a device mesh and
are not ported (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from dnn_tpu_torch.ops.nn import gelu, mm_out_dtype, silu

__all__ = [
    "moe_capacity",
    "init_moe",
    "init_moe_gated",
    "route_topk",
    "load_balance_loss",
    "moe_ffn",
    "moe_ffn_local",
    "make_moe_ffn_ep",
]

_EP_TAG = ("the expert-parallel and pipeline MoE paths need a device mesh "
           "and are not ported to dnn_tpu_torch yet (ROADMAP Queue 1 item "
           "10)")


def moe_capacity(tokens_per_group: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Static per-(group, expert) slot count: the expected k*S/E load times
    the capacity factor, floored at 1 (JAX :43)."""
    return max(1, int(math.ceil(
        top_k * tokens_per_group * capacity_factor / n_experts)))


def _normal(rng, shape, std):
    """A normal draw of `shape` times `std`: float32 numpy from a numpy
    Generator, or a tensor on a torch.Generator's device."""
    if isinstance(rng, torch.Generator):
        return torch.randn(shape, generator=rng, device=rng.device) * std
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)


def _zeros(rng, shape):
    if isinstance(rng, torch.Generator):
        return torch.zeros(shape, device=rng.device)
    return np.zeros(shape, np.float32)


def init_moe(rng, n_embd: int, n_experts: int, d_ff: Optional[int] = None):
    """One two-layer MoE FFN layer's params (JAX's init_moe :50): the
    router (D, E) and expert-major stacks wi (E, D, F), bi (E, F), wo
    (E, F, D), bo (E, D); normal at 1/sqrt(fan-in), zero biases. `rng`
    is a numpy Generator (numpy leaves) or a torch.Generator (tensors on
    its device); the draws differ from jax.random's, and tests share
    weights through convert.from_jax_params."""
    d_ff = 4 * n_embd if d_ff is None else d_ff
    s_in, s_out = 1.0 / math.sqrt(n_embd), 1.0 / math.sqrt(d_ff)
    return {
        "router": {"kernel": _normal(rng, (n_embd, n_experts), s_in)},
        "wi": _normal(rng, (n_experts, n_embd, d_ff), s_in),
        "bi": _zeros(rng, (n_experts, d_ff)),
        "wo": _normal(rng, (n_experts, d_ff, n_embd), s_out),
        "bo": _zeros(rng, (n_experts, n_embd)),
    }


def init_moe_gated(rng, n_embd: int, n_experts: int, d_ff: int):
    """One gated (SwiGLU) MoE layer's params, the Mixtral expert (JAX's
    init_moe_gated :132): router (D, E), wg/wu (E, D, F), wd (E, F, D),
    no biases. `rng` as init_moe's."""
    s_in, s_out = 1.0 / math.sqrt(n_embd), 1.0 / math.sqrt(d_ff)
    return {
        "router": {"kernel": _normal(rng, (n_embd, n_experts), s_in)},
        "wg": _normal(rng, (n_experts, n_embd, d_ff), s_in),
        "wu": _normal(rng, (n_experts, n_embd, d_ff), s_in),
        "wd": _normal(rng, (n_experts, d_ff, n_embd), s_out),
    }


def route_topk(gate_logits, *, top_k: int, capacity: int,
               normalize: bool = True):
    """Routing of one group (S, E), or of G groups (G, S, E), of gate
    logits (JAX's route_topk :70) -> (dispatch, combine, aux):
    dispatch (.., S, E, cap) 0/1, token s in slot c of expert e; combine
    (.., S, E, cap) f32, dispatch weighted by the router probability
    (renormalised over the kept selections under `normalize`); aux
    {"load": (.., E) selections per expert over k*S, "importance": (..,
    E) mean router probability}."""
    one = gate_logits.dim() == 2
    lg = gate_logits[None] if one else gate_logits
    dev = lg.device
    g, s, e = lg.shape
    probs = torch.softmax(lg.float(), dim=-1)
    experts = torch.arange(e, device=dev)
    slots = torch.arange(capacity, device=dev)
    remaining = probs
    counts = torch.zeros((g, 1, e), device=dev)
    dispatch = torch.zeros((g, s, e, capacity), device=dev)
    weight_sum = torch.zeros((g, s, 1), device=dev)
    picked = []
    for _ in range(top_k):
        # argmax takes the first maximum, as jnp.argmax does
        sel = (remaining.argmax(dim=-1, keepdim=True) == experts).float()
        remaining = remaining * (1.0 - sel)
        # slot: tokens before me this round + slots of earlier rounds
        pos = (sel.cumsum(dim=-2) - sel) + counts
        keep = (pos < capacity).float() * sel
        slot = (pos.long()[..., None] == slots).float()
        dispatch = dispatch + keep[..., None] * slot
        kept = probs * keep
        weight_sum = weight_sum + kept.sum(dim=-1, keepdim=True)
        picked.append((keep, kept))
        counts = counts + sel.sum(dim=-2, keepdim=True)
    combine = torch.zeros_like(dispatch)
    denom = weight_sum.clamp(min=1e-9) if normalize else None
    for keep, kept in picked:
        slot_w = (kept / denom if normalize else kept).sum(dim=-1)  # (G, S)
        combine = combine + dispatch * (keep * slot_w[..., None])[..., None]
    aux = {"load": dispatch.sum(dim=(-3, -1)) / (s * top_k),
           "importance": probs.mean(dim=-2)}
    if one:
        return dispatch[0], combine[0], {k: v[0] for k, v in aux.items()}
    return dispatch, combine, aux


def load_balance_loss(aux):
    """Switch-Transformer load-balance term (JAX :122): E * <load,
    importance>, 1.0 under uniform routing for any top_k."""
    e = aux["load"].shape[-1]
    return e * (aux["load"] * aux["importance"]).sum(dim=-1).mean()


def _bmm_f32(x, w):
    """(E, M, K) x (E, K, N), both in one type, -> f32 (E, M, N): JAX's
    einsum with preferred_element_type=f32. bf16 operands go through one
    bf16 x bf16 -> f32 batched product where this torch has it on the
    device (ops/nn.mm_out_dtype), else an f32 product of the operands (a
    bf16 product is exact in f32)."""
    if x.dtype != torch.float32 and mm_out_dtype(x.device):
        return torch.bmm(x, w, out_dtype=torch.float32)
    return torch.bmm(x.float(), w.float())


def _scaled(acc, params, name):
    """The f32 accumulator of product `name`, times its int8 stack's
    per-(expert, channel) scale (E, 1, out) when the stack is int8."""
    scale = params.get(name + "_scale")
    return acc if scale is None else acc * scale.float()


def _expert_ffn_gated(params, expert_in, *, compute_dtype):
    """(E, cap, D) tokens through each expert's SwiGLU, silu(x@wg) *
    (x@wu) @ wd (JAX :150): f32 accumulators, operands in the compute
    type (f32 for an int8 stack without one)."""
    wg, wu, wd = params["wg"], params["wu"], params["wd"]
    cd = compute_dtype if compute_dtype is not None else torch.float32
    x = expert_in.to(cd)
    g = _scaled(_bmm_f32(x, wg.to(cd)), params, "wg")
    u = _scaled(_bmm_f32(x, wu.to(cd)), params, "wu")
    h = silu(g) * u
    if compute_dtype is not None:
        h = h.to(cd)
    return _scaled(_bmm_f32(h, wd.to(cd)), params, "wd")


def _expert_ffn(params, expert_in, *, activation, compute_dtype):
    """(E, cap, D) tokens through each expert's two-layer FFN, or the
    SwiGLU expert when the params carry `wg` (JAX :188): f32 out."""
    if "wg" in params:
        return _expert_ffn_gated(params, expert_in,
                                 compute_dtype=compute_dtype)
    cd = compute_dtype if compute_dtype is not None else expert_in.dtype
    x = expert_in.to(cd)
    h = _scaled(_bmm_f32(x, params["wi"].to(cd)), params, "wi")
    h = activation(h + params["bi"].float()[:, None, :])
    if compute_dtype is not None:
        h = h.to(cd)
    out = _scaled(_bmm_f32(h, params["wo"].to(cd)), params, "wo")
    return out + params["bo"].float()[:, None, :]


def _group_dispatch(params, xg, *, top_k, capacity, normalize):
    """Routing of the groups xg (G, S, D) in f32 (JAX :224)."""
    logits = torch.matmul(xg.float(), params["router"]["kernel"].float())
    return route_topk(logits, top_k=top_k, capacity=capacity,
                      normalize=normalize)


def moe_ffn(params, x, *, top_k: int = 2, capacity_factor: float = 1.25,
            groups: int = 1, activation=gelu, compute_dtype=None,
            return_aux: bool = False, normalize: bool = True):
    """Dense MoE FFN (JAX's moe_ffn :230): x (B, T, D) -> (B, T, D) in
    x's type, without the residual. The B*T tokens (row-major) route in
    `groups` groups (B*T must divide by it); each group's experts run as
    one batched product over the E experts at the static capacity.
    `return_aux` adds the routing aux, averaged over the groups."""
    b, t, d = x.shape
    n_tok = b * t
    if n_tok % groups:
        raise ValueError(f"B*T={n_tok} not divisible by groups={groups}")
    s = n_tok // groups
    e = params["wg" if "wg" in params else "wi"].shape[0]
    capacity = moe_capacity(s, e, top_k, capacity_factor)
    xg = x.reshape(groups, s, d)
    dispatch, combine, aux = _group_dispatch(
        params, xg, top_k=top_k, capacity=capacity, normalize=normalize)
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch, xg.float())
    out = torch.stack([
        _expert_ffn(params, expert_in[i], activation=activation,
                    compute_dtype=compute_dtype) for i in range(groups)])
    y = torch.einsum("gsec,gecd->gsd", combine, out).reshape(b, t, d)
    y = y.to(x.dtype)
    if return_aux:
        return y, {k: v.mean(dim=0) for k, v in aux.items()}
    return y


def unported_ep(name: str, where: str):
    """A builder of JAX's expert-parallel or pipeline-EP path (`name`, at
    `where` in the JAX package) that raises: they need a device mesh."""

    def builder(*_args, **_kwargs):
        raise NotImplementedError(f"{name}: {_EP_TAG}")

    builder.__name__ = name
    builder.__doc__ = f"JAX's {name} ({where}): not ported."
    return builder


moe_ffn_local = unported_ep("moe_ffn_local", "parallel/moe.py:269")
make_moe_ffn_ep = unported_ep("make_moe_ffn_ep", "parallel/moe.py:305")
