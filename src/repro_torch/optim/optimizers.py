"""Optimizers of the port.

``SGD`` is heavy-ball momentum, the paper's client recipe
(SGD(lr=0.01, momentum=0.5), §7.1): the update rule of
``repro.optim.sgd`` without weight decay (no caller sets it),
m ← μ·m + g, then p ← p − lr·m, with m starting at zero; it updates
its parameters in place.

``adamw`` is ``repro.optim.adamw`` with a constant learning rate, the
LLM fine-tune's optimizer: an ``Optimizer(init, update)`` pair on
pytrees, functional like the reference's — ``update`` returns new
parameter and moment tensors and leaves its inputs alone.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.utils import trees


class SGD:
    """Updates ``params`` (tensors with ``.grad``) in place."""

    def __init__(self, params, lr: float = 0.01, momentum: float = 0.0):
        self.params = list(params)
        self.lr = lr
        self.momentum = momentum
        self.m = ([torch.zeros_like(p) for p in self.params]
                  if momentum else None)

    @torch.no_grad()
    def step(self) -> None:
        for i, p in enumerate(self.params):
            d = p.grad
            if self.m is not None:
                self.m[i] = self.momentum * self.m[i] + d
                d = self.m[i]
            p.copy_(p - self.lr * d)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """AdamW with a constant ``lr`` in fp32 moments.  ``update(grads,
    state, params, step)`` → ``(new_params, new_state)``; ``step`` counts
    from 0, so the bias corrections use t = step + 1."""

    def init(params):
        def zeros():
            return trees.tree_map(torch.zeros_like, params)
        return {"m": zeros(), "v": zeros()}

    @torch.no_grad()
    def update(grads, state, params, step):
        t = float(step) + 1.0
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        m = trees.tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                           state["m"], grads)
        v = trees.tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(),
                           state["v"], grads)

        def upd(p, m_, v_):
            step_ = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps) + weight_decay * p.float()
            return (p.float() - lr * step_).to(p.dtype)

        return trees.tree_map(upd, params, m, v), {"m": m, "v": v}

    return Optimizer(init, update)
