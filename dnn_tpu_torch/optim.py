"""Optimizers with optax's defaults, over torch.optim.

The JAX package trains with `optax.adamw` / `optax.adam` / `optax.sgd`.
These factories build the torch.optim counterparts with optax's
hyperparameters, so one learning rate means one update in both
packages:

  * `adamw(lr)`: b1=0.9, b2=0.999, eps=1e-8 and weight_decay=1e-4
    (optax's default; torch.optim.AdamW's own is 1e-2), decay on every
    leaf — biases and LayerNorm parameters included (optax mask=None).
  * `adam(lr)`: the same without decay.
  * `sgd(lr, momentum=None)`: plain SGD (optax momentum=None), or
    heavy-ball momentum.

The updates, with g the gradient and t the step count (from 1):

    optax.adamw                              torch.optim.AdamW
    mu = b1 mu + (1 - b1) g                  m = b1 m + (1 - b1) g
    nu = b2 nu + (1 - b2) g^2                v = b2 v + (1 - b2) g^2
    u  = (mu / (1 - b1^t))                   p = p (1 - lr wd)
         / (sqrt(nu / (1 - b2^t)) + eps)     p = p - (lr / (1 - b1^t)) m
         + wd p                                    / (sqrt(v) / sqrt(1 - b2^t)
    p  = p - lr u                                   + eps)

Both are p - lr (mu_hat / (sqrt(nu_hat) + eps) + wd p): the same update
(eps outside the square root, bias correction on both moments), summed
in another order. An element whose gradient is exactly 0 at every step
keeps mu = nu = 0, so its update is the decay alone, as in optax.

An `Optimizer` is a factory: `init(params)` returns the torch optimizer
bound to every leaf of the parameter tree (the port's "optimizer
state"), setting requires_grad on each leaf.
"""

from __future__ import annotations

from typing import Optional

import torch


def tree_leaves(tree):
    """The tensor leaves of a nested dict/list/tuple tree, in key order
    of the dicts as built (the order the optimizer state is indexed
    by)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


class Optimizer:
    """A torch.optim class with its hyperparameters; `init(params)`
    builds the optimizer over the tree's leaves."""

    def __init__(self, cls, **hyper):
        self.cls = cls
        self.hyper = hyper

    def init(self, params) -> torch.optim.Optimizer:
        leaves = tree_leaves(params)
        for leaf in leaves:
            if not leaf.is_leaf:
                raise ValueError("optimizer params must be leaf tensors")
            leaf.requires_grad_(True)
        return self.cls(leaves, **self.hyper)

    def __repr__(self):
        return f"Optimizer({self.cls.__name__}, {self.hyper})"


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> Optimizer:
    """optax.adamw's defaults (weight_decay 1e-4 on every leaf)."""
    return Optimizer(torch.optim.AdamW, lr=learning_rate, betas=(b1, b2),
                     eps=eps, weight_decay=weight_decay)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """optax.adam's defaults."""
    return Optimizer(torch.optim.Adam, lr=learning_rate, betas=(b1, b2),
                     eps=eps, weight_decay=0.0)


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> Optimizer:
    """optax.sgd: p - lr g, or with heavy-ball momentum."""
    return Optimizer(torch.optim.SGD, lr=learning_rate,
                     momentum=momentum or 0.0, nesterov=nesterov)
