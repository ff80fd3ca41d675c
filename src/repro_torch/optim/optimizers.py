"""SGD with heavy-ball momentum — the paper's client recipe
(SGD(lr=0.01, momentum=0.5), §7.1).

Same update rule as ``repro.optim.sgd`` without weight decay (no
caller sets it): m ← μ·m + g, then p ← p − lr·m, with m starting at
zero.
"""
from __future__ import annotations

import torch


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
