"""The paper's MLP (784 → 400 → 200 → 100 → 10, MNIST, §7) as an
``nn.Module``.

Weights are kept (out, in), as in the reference and the paper's
layer-wise algebra; the module exposes them as the list of
``{"W", "b"}`` dicts that aggregation works on (``layers`` /
``load_layers``), and its forward can return each layer's input
features for projector estimation.  The CNN and CVAE are ROADMAP
item A5.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PaperModelSpec:
    name: str
    kind: str                      # mlp | cnn | cvae
    in_shape: tuple
    n_classes: int = 10
    hidden: tuple = (400, 200, 100)
    conv_channels: tuple = (32, 64, 64)
    fc_hidden: tuple = (256, 128)
    latent: int = 30
    cvae_hidden: tuple = (256, 512)


MLP_SPEC = PaperModelSpec("paper-mlp", "mlp", (784,))


def _require_mlp(spec: PaperModelSpec) -> None:
    if spec.kind != "mlp":
        raise NotImplementedError(
            f"model kind {spec.kind!r} is not ported yet (ROADMAP item A5)")


def mlp_forward(layers, x, *, return_features: bool = False):
    """x (B, in) through ``layers`` (list of {"W": (out, in), "b"}).
    Returns logits, and with ``return_features`` each layer's input."""
    feats = []
    h = x
    for i, lay in enumerate(layers):
        feats.append(h)
        h = h @ lay["W"].T + lay["b"]
        if i < len(layers) - 1:
            h = torch.relu(h)
    return (h, feats) if return_features else h


class MLP(nn.Module):
    """The paper MLP with (out, in) weights.  ``layers`` (or ``spec`` +
    ``seed``) set the weights: He-normal W, zero b."""

    def __init__(self, spec: PaperModelSpec = MLP_SPEC, layers=None,
                 seed: int = 0, device=None):
        super().__init__()
        _require_mlp(spec)
        dev = resolve_device(device)
        dims = (spec.in_shape[0],) + tuple(spec.hidden) + (spec.n_classes,)
        gen = torch.Generator().manual_seed(seed)
        self.W = nn.ParameterList()
        self.b = nn.ParameterList()
        for a, b in zip(dims[:-1], dims[1:]):
            self.W.append(nn.Parameter(
                (torch.randn(b, a, generator=gen) * math.sqrt(2.0 / a)).to(dev)))
            self.b.append(nn.Parameter(torch.zeros(b, device=dev)))
        if layers is not None:
            self.load_layers(layers)

    def forward(self, x, *, return_features: bool = False):
        return mlp_forward(self.layers(detach=False), x,
                           return_features=return_features)

    def layers(self, detach: bool = True) -> list[dict]:
        """The weights as the aggregation layout: [{"W", "b"}, …]."""
        return [{"W": W.detach() if detach else W,
                 "b": b.detach() if detach else b}
                for W, b in zip(self.W, self.b)]

    @torch.no_grad()
    def load_layers(self, layers) -> None:
        for W, b, lay in zip(self.W, self.b, layers, strict=True):
            W.copy_(lay["W"])
            b.copy_(lay["b"])


def init(spec: PaperModelSpec, seed: int = 0, device=None) -> list[dict]:
    """Fresh parameters as [{"W", "b"}, …] from a seeded generator.
    (``torch.Generator`` draws differ from ``jax.random``'s: parity
    tests start both packages from the reference's init instead.)"""
    return MLP(spec, seed=seed, device=device).layers()
