"""Procedurally generated stand-in for the paper's MNIST (numpy only).

K class prototypes in a latent space, Gaussian within-class jitter, a
random tanh layer into a 2·latent hidden space, then a linear lift to
the pixels with a dead-pixel mask — the low effective rank the paper's
null-space projections rely on (paper §6).  The draws are the same
``np.random.RandomState`` sequence as ``repro.data.synthetic.generate``,
so both packages see bit-identical arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str = "mnist-like"
    n_classes: int = 10
    n_train: int = 10_000
    n_test: int = 2_000
    latent: int = 32
    out_dim: int = 784
    class_sep: float = 3.0
    noise: float = 1.0
    seed: int = 0


MNIST_LIKE = DatasetSpec("mnist-like", out_dim=784)


def generate(spec: DatasetSpec, domain: int = 0):
    """Returns dict(train_x, train_y, test_x, test_y) as numpy arrays."""
    rng = np.random.RandomState(spec.seed + 1000 * domain)
    protos = rng.randn(spec.n_classes, spec.latent) * spec.class_sep
    W1 = rng.randn(spec.latent, 2 * spec.latent) / np.sqrt(spec.latent)
    W2 = rng.randn(2 * spec.latent, spec.out_dim) / np.sqrt(2 * spec.latent)
    mask = (rng.rand(spec.out_dim) < 0.6).astype(np.float32)

    def make(n, seed_off):
        r = np.random.RandomState(spec.seed + 7 + seed_off + 1000 * domain)
        y = r.randint(0, spec.n_classes, size=n)
        z = protos[y] + r.randn(n, spec.latent) * spec.noise
        h = np.tanh(z @ W1)
        x = (h @ W2) * mask
        x = (x - x.mean()) / (x.std() + 1e-8)
        if spec.out_dim == 3072:
            x = x.reshape(n, 32, 32, 3)
        return x.astype(np.float32), y.astype(np.int32)

    tx, ty = make(spec.n_train, 0)
    vx, vy = make(spec.n_test, 1)
    return {"train_x": tx, "train_y": ty, "test_x": vx, "test_y": vy}
