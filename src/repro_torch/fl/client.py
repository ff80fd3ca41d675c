"""Client-side FL: local training of the paper MLP and projection-matrix
estimation (the one extra forward epoch the paper budgets in §6).

Parameters travel as lists of ``{"W", "b"}`` dicts of tensors, the
layout aggregation works on; training runs them through the ``MLP``
module.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import projections as proj
from repro_torch.fl import models as pm
from repro_torch.models.layers import softmax_xent
from repro_torch.optim.optimizers import SGD
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LocalTrainConfig:
    epochs: int = 10
    batch_size: int = 64
    lr: float = 0.01
    momentum: float = 0.5         # the paper's client recipe (§7.1)
    max_steps: int = 0            # 0 = epochs * steps_per_epoch
    fedprox_mu: float = 0.0       # FedProx proximal term (ROADMAP A6)
    seed: int = 0


def train_classifier(spec: pm.PaperModelSpec, params, x, y,
                     cfg: LocalTrainConfig, device=None) -> tuple:
    """SGD local training from ``params`` on numpy ``x``/``y``; the
    batch order is the reference's (``np.random.RandomState(cfg.seed)``
    permutation per epoch, last partial batch dropped).  Returns
    (params, final_loss)."""
    if cfg.fedprox_mu:
        raise NotImplementedError(
            "FedProx local training is not ported yet (ROADMAP item A6)")
    dev = resolve_device(device)
    model = pm.MLP(spec, layers=params, device=dev)
    opt = SGD(model.parameters(), cfg.lr, cfg.momentum)
    xd = torch.as_tensor(x, device=dev)
    yd = torch.as_tensor(y, device=dev)
    rng = np.random.RandomState(cfg.seed)
    n, bs = len(x), cfg.batch_size
    t, loss = 0, torch.zeros(())
    for _ in range(cfg.epochs):
        order = torch.as_tensor(rng.permutation(n), device=dev)
        for s in range(0, n - bs + 1, bs):
            ix = order[s:s + bs]
            loss = softmax_xent(model(xd[ix]), yd[ix])
            opt.zero_grad()
            loss.backward()
            opt.step()
            t += 1
            if cfg.max_steps and t >= cfg.max_steps:
                return model.layers(), float(loss.detach())
    return model.layers(), float(loss.detach())


@torch.no_grad()
def evaluate_classifier(spec: pm.PaperModelSpec, params, x, y,
                        batch: int = 512, device=None) -> float:
    """Top-1 accuracy over whole batches of ``batch`` (all of x when it
    is smaller than one batch)."""
    pm._require_mlp(spec)
    dev = resolve_device(device)
    layers = [{k: v.to(dev) for k, v in lay.items()} for lay in params]
    n = (len(x) // batch) * batch or len(x)
    xd = torch.as_tensor(x[:n], device=dev)
    yd = torch.as_tensor(y[:n], device=dev)
    correct = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(0, n, batch):
        logits = pm.mlp_forward(layers, xd[s:s + batch])
        correct += (logits.argmax(-1) == yd[s:s + batch]).sum()
    return int(correct) / n


@torch.no_grad()
def compute_projections(spec: pm.PaperModelSpec, params, x,
                        alpha: float = 1.0, batch: int = 256,
                        max_samples: int = 2048, device=None):
    """Per-layer projectors onto the span of layer-input features.

    Returns a list matching ``params``: each "W" projector is the
    (d_in, d_in) row-space matrix P = I − Q from streaming block-RLS
    over row-normalised features, each "b" projector the scalar full
    rule.  ``alpha`` (the paper's z) is the energy floor.
    """
    pm._require_mlp(spec)
    dev = resolve_device(device)
    layers = [{k: v.to(dev) for k, v in lay.items()} for lay in params]
    n = min(len(x), max_samples)
    xs = x[:n]
    if n == 0:
        # no data: zero rows are RLS no-ops, so P comes out zero
        xs = np.zeros((1,) + tuple(x.shape[1:]), np.float32)
        n = 1
    xd = torch.as_tensor(xs, device=dev)
    Qs = None
    for s in range(0, n, batch):
        _, feats = pm.mlp_forward(layers, xd[s:s + batch],
                                  return_features=True)
        if Qs is None:
            Qs = [proj.null_projector_init(f.shape[-1], device=dev)
                  for f in feats]
        for i, f in enumerate(feats):
            f2 = f.reshape(-1, f.shape[-1])
            f2 = f2 / torch.linalg.vector_norm(f2, dim=-1,
                                               keepdim=True).clamp_min(1e-6)
            Qs[i] = proj.null_projector_from_features_continue(Qs[i], f2, alpha)
    eye = [torch.eye(Q.shape[0], device=dev) for Q in Qs]
    return [{"W": proj.symmetrize(I - Q), "b": torch.ones((), device=dev)}
            for I, Q in zip(eye, Qs)]
