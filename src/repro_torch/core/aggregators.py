"""Aggregation operators: the paper's method and the FedAvg baseline.

Each maps ``list[client pytree] -> global pytree``.  OT matching and
MA-Echo+OT are ROADMAP item A6.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.core.maecho import MAEchoConfig, maecho_aggregate
from repro_torch.utils import trees

Pytree = Any


def fedavg(client_weights: list[Pytree],
           sizes: Optional[list[float]] = None) -> Pytree:
    """Vanilla (size-weighted) parameter average [McMahan et al.]."""
    n = len(client_weights)
    w = ([1.0 / n] * n if sizes is None
         else [float(s) / sum(sizes) for s in sizes])
    out = trees.tree_scale(client_weights[0], w[0])
    for i in range(1, n):
        out = trees.tree_add(out, trees.tree_scale(client_weights[i], w[i]))
    return out


def maecho(client_weights, projections=None, cfg: MAEchoConfig = None,
           **kw) -> Pytree:
    return maecho_aggregate(client_weights, projections,
                            cfg or MAEchoConfig(), **kw)
