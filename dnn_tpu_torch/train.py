"""Single-card training (port of the single-program half of
dnn_tpu/train.py: losses, `make_train_step`, `evaluate`,
`resume_or_init`, `fit`).

The JAX step is a pure function that returns new params and optimizer
state. Here the parameter leaves are updated in place by a torch
optimizer (`dnn_tpu_torch.optim`, optax's defaults), and the step still
returns `(params, opt_state, loss)` so callers read like the JAX ones:

    prepared = prepare_stacked(init(0, cfg), cfg, device)
    opt = adamw(1e-4)
    opt_state = opt.init(prepared)          # sets requires_grad
    apply = make_apply_stacked(cfg, use_flash=True)
    step = make_train_step(lambda p, b: next_token_loss(apply, p, b), opt)
    prepared, opt_state, loss = step(prepared, opt_state, batch)

Batches are moved to the step's device (CUDA unless `device` says
otherwise; no card and no `device` raises). The sharded, ZeRO, FSDP and
pipeline steps, and the trainlens/chaos hooks of `fit`, stay queued
(ROADMAP Queue 1 items 10-12).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from dnn_tpu_torch import resolve_device
from dnn_tpu_torch.io.train_ckpt import (
    cleanup_old_checkpoints,
    restore_train_state,
    save_train_state,
)
from dnn_tpu_torch.optim import tree_leaves


# ----------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------

def _token_nll(logits, targets, ignore_index: Optional[int]):
    """Per-token negative log-likelihood and its keep-mask — the loss
    primitive cross_entropy and the eval step share (JAX's :50)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    targets = targets.long()
    if ignore_index is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=logits.device)
        idx = targets
    else:
        keep = targets != ignore_index
        mask = keep.float()
        idx = torch.where(keep, targets, 0)  # an ignored id may be < 0
    nll = -torch.gather(logp, -1, idx[..., None])[..., 0]
    return nll, mask


def cross_entropy(logits, targets, *, ignore_index: Optional[int] = None):
    """Token-level cross entropy, mean over non-ignored positions.
    logits (..., V); targets (...) int."""
    nll, mask = _token_nll(logits, targets, ignore_index)
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def next_token_loss(apply_fn: Callable, params, tokens, *, ignore_index=None):
    """Causal-LM loss: predict tokens[:, 1:] from tokens[:, :-1]."""
    logits = apply_fn(params, tokens[:, :-1])
    return cross_entropy(logits, tokens[:, 1:], ignore_index=ignore_index)


def distill_loss(student_apply: Callable, teacher_logits, student_params,
                 tokens, *, temperature: float = 2.0, alpha: float = 0.5,
                 ignore_index: Optional[int] = None):
    """Knowledge distillation (JAX's :127): alpha * KL(teacher_T ||
    student_T) * T^2 + (1 - alpha) * CE(student, next tokens), with
    `teacher_logits` (B, T-1, V) precomputed from the same tokens."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    if temperature <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature} "
                         "(logits divide by it)")
    s_logits = student_apply(student_params, tokens[:, :-1]).float()
    t_logits = teacher_logits.float()
    t_p = torch.softmax(t_logits / temperature, dim=-1)
    s_logp = torch.log_softmax(s_logits / temperature, dim=-1)
    t_logp = torch.log_softmax(t_logits / temperature, dim=-1)
    kl = (t_p * (t_logp - s_logp)).sum(dim=-1)  # (B, T-1)
    targets = tokens[:, 1:]
    if ignore_index is not None:
        mask = (targets != ignore_index).float()
        kl_mean = (kl * mask).sum() / mask.sum().clamp(min=1.0)
    else:
        kl_mean = kl.mean()
    hard = cross_entropy(s_logits, targets, ignore_index=ignore_index)
    return alpha * kl_mean * temperature ** 2 + (1.0 - alpha) * hard


# ----------------------------------------------------------------------
# steps
# ----------------------------------------------------------------------

def to_device(batch, device):
    """A batch (array, tensor, or a dict/list/tuple of them) on
    `device`."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_device(v, device) for v in batch)
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    return torch.as_tensor(np.asarray(batch), device=device)


def make_eval_step(apply_fn: Callable, *, ignore_index: Optional[int] = None,
                   device=None):
    """Per-batch evaluation step: (params, tokens (B, T)) -> (nll_sum,
    n_tokens) over the batch's non-ignored next-token targets, with no
    gradient (so flash attention runs its forward kernel K1)."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params, tokens):
        tokens = to_device(tokens, dev)
        nll, mask = _token_nll(apply_fn(params, tokens[:, :-1]),
                               tokens[:, 1:], ignore_index)
        return (nll * mask).sum(), mask.sum()

    return step


def evaluate(apply_fn: Callable, params, batch_iter, *,
             ignore_index: Optional[int] = None, eval_step=None, device=None):
    """Token-weighted mean next-token loss and perplexity over an
    iterable of (B, T) token batches (JAX's :94). Returns {"loss",
    "perplexity", "batches", "tokens"}."""
    step = eval_step or make_eval_step(apply_fn, ignore_index=ignore_index,
                                       device=device)
    total, tokens, n = 0.0, 0.0, 0
    for batch in batch_iter:
        s, m = step(params, batch)
        total += float(s)
        tokens += float(m)
        n += 1
    if n == 0:
        raise ValueError("evaluate needs at least one batch")
    if tokens == 0:
        raise ValueError(
            "evaluate saw no non-ignored target tokens (every position "
            f"matched ignore_index={ignore_index})")
    mean = total / tokens
    return {"loss": mean, "perplexity": math.exp(mean), "batches": n,
            "tokens": int(tokens)}


def make_train_step(loss_fn: Callable, optimizer, *, accum_steps: int = 1,
                    grad_stats: bool = False, device=None):
    """(params, opt_state, batch) -> (params, opt_state, loss) (JAX's
    :208). `loss_fn` is (params, batch) -> scalar; `optimizer` a
    `dnn_tpu_torch.optim` factory whose `init(params)` built `opt_state`.
    The parameter leaves are updated in place (no second copy of the
    weights) and returned. The batch moves to `device` (CUDA by
    default).

    `accum_steps > 1` splits the batch's leading axis into that many
    microbatches, sums their gradients and applies their mean, as JAX's
    scan does: exact against the full batch when the loss is a uniform
    mean over examples."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if grad_stats:
        raise NotImplementedError(
            "grad_stats (the trainlens gradient-health leg) is not ported "
            "to dnn_tpu_torch yet (ROADMAP Queue 1 items 11/12)")
    if not hasattr(optimizer, "init"):
        raise TypeError(f"optimizer must be a dnn_tpu_torch.optim factory, "
                        f"got {optimizer!r}")
    dev = resolve_device(device)

    def step(params, opt_state, batch):
        batch = to_device(batch, dev)
        opt_state.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss = loss_fn(params, batch)
            loss.backward()
            loss = loss.detach()
        else:
            def split(x):
                if x.shape[0] % accum_steps:
                    raise ValueError(
                        f"batch leading dim {x.shape[0]} not divisible by "
                        f"accum_steps {accum_steps}")
                return x.chunk(accum_steps)

            micro = _map_split(split, batch, accum_steps)
            loss = 0.0
            for mb in micro:
                lm = loss_fn(params, mb)
                lm.backward()
                loss = loss + lm.detach()
            scale = 1.0 / accum_steps
            for leaf in tree_leaves(params):
                if leaf.grad is not None:
                    leaf.grad.mul_(scale)
            loss = loss * scale
        opt_state.step()
        return params, opt_state, loss

    return step


def _map_split(split, batch, n):
    """n microbatches of a batch tree, each leaf split on axis 0."""
    if isinstance(batch, dict):
        parts = {k: _map_split(split, v, n) for k, v in batch.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    if isinstance(batch, (list, tuple)):
        parts = [_map_split(split, v, n) for v in batch]
        return [type(batch)(p[i] for p in parts) for i in range(n)]
    return list(split(batch))


# ----------------------------------------------------------------------
# loop
# ----------------------------------------------------------------------

def resume_or_init(ckpt_dir: Optional[str], init_state):
    """Resume from the newest checkpoint under `ckpt_dir` into
    `init_state` (in place: see io/train_ckpt.restore_train_state), or
    start fresh. Returns (state, start_step)."""
    if ckpt_dir:
        try:
            return restore_train_state(ckpt_dir, like=init_state)
        except FileNotFoundError:
            pass
    return init_state, 0


def _sync(loss):
    """Wait for the step whose loss this is (the JAX loop's
    block_until_ready): a fault surfaces at its own step."""
    if isinstance(loss, torch.Tensor) and loss.is_cuda:
        torch.cuda.synchronize(loss.device)
    return loss


def fit(step_fn: Callable, state, batch_iter, *, num_steps: int,
        start_step: int = 0, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 0, keep_checkpoints: int = 3,
        on_step: Optional[Callable] = None, advance_batches: bool = True,
        eval_every: int = 0, eval_fn: Optional[Callable] = None,
        clock=None, sentinel=None):
    """Training loop with periodic checkpointing (JAX's :612).

    `step_fn(state, batch) -> (state, loss)`; the loop waits for each
    step's loss before the next. Saves every `ckpt_every` steps into
    `ckpt_dir` (keeping `keep_checkpoints`); `eval_fn(step, state)` runs
    every `eval_every` steps; `on_step(step, loss)` after each step. On
    resume (`start_step > 0`) `advance_batches=True` skips the first
    `start_step` batches so a deterministic pipeline restarted from
    scratch lines up with the step. Returns (state, last_loss)."""
    if clock is not None or sentinel is not None:
        raise NotImplementedError(
            "fit's trainlens clock and gradient sentinel are not ported to "
            "dnn_tpu_torch yet (ROADMAP Queue 1 items 11/12)")
    if advance_batches:
        for skipped in range(start_step):
            try:
                next(batch_iter)
            except StopIteration:
                raise ValueError(
                    f"batch_iter exhausted after {skipped} batches while "
                    f"skipping to resume step {start_step}; pass an "
                    "iterator that covers the resume point") from None
    loss = None
    for step in range(start_step, num_steps):
        try:
            batch = next(batch_iter)
        except StopIteration:
            raise ValueError(
                f"batch_iter exhausted at step {step} (wanted {num_steps}); "
                "pass an infinite iterator or lower num_steps") from None
        state, loss = step_fn(state, batch)
        _sync(loss)
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            save_train_state(ckpt_dir, step + 1, state)
            cleanup_old_checkpoints(ckpt_dir, keep=keep_checkpoints)
        if eval_fn is not None and eval_every and (step + 1) % eval_every == 0:
            eval_fn(step + 1, state)
        if on_step is not None:
            on_step(step + 1, loss)
    return state, loss
