"""The paper's experiment models as ``nn.Module``s: the MLP
(784 → 400 → 200 → 100 → 10, MNIST, §7) and the CNN (three stride-2
3×3 convs and three fully-connected layers, CIFAR-10).

Weights are kept as in the reference and the paper's layer-wise
algebra: fully-connected W (out, in), conv W (C_out, C_in, 3, 3).  A
module exposes them as the list of ``{"W", "b"}`` dicts that
aggregation works on (``layers`` / ``load_layers``), and its forward
can return each layer's input features for projector estimation — for
a conv layer the (B·h·w, C_in·9) im2col patches.  Images stay NHWC, as
the reference's data is.  The CVAE is ROADMAP item A5.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
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
CNN_SPEC = PaperModelSpec("paper-cnn", "cnn", (32, 32, 3))


def _require_ported(spec: PaperModelSpec) -> None:
    if spec.kind not in ("mlp", "cnn"):
        raise NotImplementedError(
            f"model kind {spec.kind!r} is not ported yet (ROADMAP item A5)")


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
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


def _mlp_shapes(spec: PaperModelSpec) -> list:
    dims = (spec.in_shape[0],) + tuple(spec.hidden) + (spec.n_classes,)
    return [((b, a), a) for a, b in zip(dims[:-1], dims[1:])]


# --------------------------------------------------------------------------
# CNN (3 conv + 3 fc, CIFAR-10 shaped)
# --------------------------------------------------------------------------
def _same_pads(n: int, k: int, stride: int) -> tuple:
    """XLA's "SAME" padding of one spatial axis: (lo, hi) with
    lo = total // 2 — (0, 1) for even n at k = 3, stride 2, (1, 1) for
    odd n."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv2d(x, W, b, stride: int = 2):
    """The reference's ``lax.conv_general_dilated(..., "SAME")`` on NHWC
    x (B, H, W, C) with W (C_out, C_in, kh, kw); returns NHWC."""
    hlo, hhi = _same_pads(x.shape[1], W.shape[2], stride)
    wlo, whi = _same_pads(x.shape[2], W.shape[3], stride)
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (wlo, whi, hlo, hhi)), W,
                 stride=stride)
    return y.permute(0, 2, 3, 1) + b


def _im2col(x, k: int):
    """k×k patches at stride 2 of NHWC x, padded (1, 1) as the
    reference's ``_im2col`` is (one pixel off from ``_conv2d``'s (0, 1)
    at even H; ROADMAP §C), columns in the order ``c·k² + di·k + dj``:
    (B·⌈H/2⌉·⌈W/2⌉, C·k²)."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    rows = [xp[:, di:di + H:2, dj:dj + W:2, :]
            for di in range(k) for dj in range(k)]
    return torch.stack(rows, dim=-1).reshape(-1, C * k * k)


def cnn_forward(layers, x, *, return_features: bool = False):
    """x (B, H, W, C) through ``layers`` (conv W 4-D, fc W 2-D).  Returns
    logits, and with ``return_features`` each layer's input (im2col
    patches for a conv layer).  The flatten before the first fc layer
    is in the reference's (H, W, C) order."""
    feats = []
    h = x
    n_fc = 0
    for lay in layers:
        if lay["W"].dim() == 4:
            feats.append(_im2col(h, 3))
            h = torch.relu(_conv2d(h, lay["W"], lay["b"]))
        else:
            if h.dim() == 4:
                h = h.reshape(h.shape[0], -1)
            feats.append(h)
            h = h @ lay["W"].T + lay["b"]
            n_fc += 1
            if n_fc < 3:
                h = torch.relu(h)
    return (h, feats) if return_features else h


def _cnn_shapes(spec: PaperModelSpec) -> list:
    H, W, c_prev = spec.in_shape
    shapes = []
    for c in spec.conv_channels:
        shapes.append(((c, c_prev, 3, 3), c_prev * 9))
        c_prev = c
    # after three stride-2 3x3 convs: H/8 x W/8 x c
    dims = ((H // 8) * (W // 8) * c_prev,) + tuple(spec.fc_hidden) + (spec.n_classes,)
    return shapes + [((b, a), a) for a, b in zip(dims[:-1], dims[1:])]


FORWARD = {"mlp": mlp_forward, "cnn": cnn_forward}
_SHAPES = {"mlp": _mlp_shapes, "cnn": _cnn_shapes}


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------
class PaperModel(nn.Module):
    """A paper model with the reference's weight layout.  ``layers`` (or
    ``spec`` + ``seed``) set the weights: He-normal W (fan-in
    C_in·9 for a conv), zero b."""

    kind = ""

    def __init__(self, spec: PaperModelSpec, layers=None, seed: int = 0,
                 device=None):
        super().__init__()
        _require_ported(spec)
        if spec.kind != self.kind:
            raise ValueError(f"{type(self).__name__} takes a {self.kind!r} "
                             f"spec, got kind {spec.kind!r}")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.W = nn.ParameterList()
        self.b = nn.ParameterList()
        for shape, fan_in in _SHAPES[spec.kind](spec):
            self.W.append(nn.Parameter(
                (torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_in)).to(dev)))
            self.b.append(nn.Parameter(torch.zeros(shape[0], device=dev)))
        if layers is not None:
            self.load_layers(layers)

    def forward(self, x, *, return_features: bool = False):
        return FORWARD[self.kind](self.layers(detach=False), x,
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


class MLP(PaperModel):
    kind = "mlp"

    def __init__(self, spec: PaperModelSpec = MLP_SPEC, layers=None,
                 seed: int = 0, device=None):
        super().__init__(spec, layers, seed, device)


class CNN(PaperModel):
    kind = "cnn"

    def __init__(self, spec: PaperModelSpec = CNN_SPEC, layers=None,
                 seed: int = 0, device=None):
        super().__init__(spec, layers, seed, device)


def module(spec: PaperModelSpec, layers=None, seed: int = 0,
           device=None) -> PaperModel:
    """The ``nn.Module`` of ``spec``'s kind."""
    _require_ported(spec)
    return {"mlp": MLP, "cnn": CNN}[spec.kind](spec, layers, seed, device)


def init(spec: PaperModelSpec, seed: int = 0, device=None) -> list[dict]:
    """Fresh parameters as [{"W", "b"}, …] from a seeded generator.
    (``torch.Generator`` draws differ from ``jax.random``'s: parity
    tests start both packages from the reference's init instead.)"""
    return module(spec, seed=seed, device=device).layers()


def forward(spec: PaperModelSpec, layers, x, **kw):
    """``spec``'s forward on the layer list (``return_features=`` as
    :func:`mlp_forward` / :func:`cnn_forward`)."""
    _require_ported(spec)
    return FORWARD[spec.kind](layers, x, **kw)
