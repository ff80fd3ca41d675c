"""Compile-once aggregation plans: the routing layer of MA-Echo.

:func:`compile_plan` runs once per (leaf paths, shapes, projector
kinds, convention, backend, client chunk) — memoized, so repeated
aggregations over one model reuse the same :class:`AggPlan` — and
freezes one :class:`LeafPlan` per leaf.  ``core.maecho``'s outer loop
is a pure executor over those plans, and ``dispatch_summary`` is a
view of the same object, so the coverage it reports is the coverage
that runs.  The rules match ``repro.core.plan`` route for route.

Routes in this port:

  ``oracle``   the plain PyTorch reference path (batched over a stacked
               leaf's layer axes).
  ``kernel``   the fused streaming pipeline (2-D leaf, min dim ≥ 128):
               CUDA kernels B1/B4/B7 for dense projectors, B2/B5/B8 for
               factored ones, B3/B6/B9 for scalar and diagonal ones.
  ``stacked``  the same pipeline for a leaf with leading scan-layer
               axes, flattened into the kernel grid: B10/B13/B16 for
               dense projectors, B11/B14/B17 for factored ones,
               B12/B15/B18 for scalar and diagonal ones — one launch
               each per leaf and outer iteration, whatever the layer
               count.

Every route carries the leaf's effective client chunk
(``LeafPlan.client_chunk``, ``MAEchoConfig.client_chunk`` clamped to N,
0 on leaves that never chunk): a chunked leaf sweeps its client axis in
blocks of that many clients (``kernels.ops``' chunked pipeline).

The ``sharded`` / ``sharded2d`` backends (ROADMAP A11) raise
``NotImplementedError``, with or without a chunk.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Any

from repro_torch.utils import trees

BACKENDS = ("oracle", "kernel", "auto", "sharded", "sharded2d")

Pytree = Any


def validate_backend(backend: str) -> None:
    """Reject unknown backend strings with the full choice list, and
    backends this port does not have yet with their ROADMAP item."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; valid choices: "
                         + ", ".join(BACKENDS))
    if backend in ("sharded", "sharded2d"):
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (ROADMAP item A11)")


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Frozen per-leaf routing decision.  ``out_d`` / ``in_d`` are the
    "oi"-native kernel-layout dims (already convention-swapped);
    ``levels`` is the number of leading stacked-layer axes;
    ``client_chunk`` the effective client-axis chunk (0 = unchunked)."""
    path: str
    levels: int
    route: str                  # oracle | kernel | stacked
    kind: str                   # scalar | diag | full | factored | none
    out_d: int = 0
    in_d: int = 0
    client_chunk: int = 0


@dataclasses.dataclass(frozen=True)
class AggPlan:
    """Per-leaf routes in flatten order plus the inputs they came from."""
    backend: str
    convention: str
    leaves: tuple  # tuple[LeafPlan, ...]

    def per_leaf(self) -> list:
        """``dispatch_summary``'s per-leaf view: (path, levels, route)."""
        return [(lp.path, lp.levels, lp.route) for lp in self.leaves]

    def route_counts(self) -> dict:
        counts: dict = {}
        for lp in self.leaves:
            counts[lp.route] = counts.get(lp.route, 0) + 1
        return counts


def kernel_eligible(W, P, levels: int = 0) -> bool:
    """A 2-D weight (plus ``levels`` leading stacked-layer axes) with a
    (client-stacked) scalar / diagonal / dense / factored projector
    whose kind axes shift by the same ``levels``."""
    if len(W.shape) != 2 + levels:
        return False
    if isinstance(P, dict):
        return set(P) == {"U", "s"} and len(P["U"].shape) == 3 + levels
    return len(P.shape) in (1 + levels, 2 + levels, 3 + levels)


def kernel_dims(W, convention: str) -> tuple:
    out_d, in_d = W.shape[-2:]
    return (out_d, in_d) if convention == "oi" else (in_d, out_d)


def proj_kind(P, levels: int = 0) -> str:
    """Kind of a *stacked* (leading client axis) projector leaf with
    ``levels`` leading layer axes."""
    if isinstance(P, dict):
        return "factored"
    return {1: "scalar", 2: "diag"}.get(len(P.shape) - levels, "full")


def _eff_chunk(client_chunk: int, P, eligible: bool) -> int:
    """A leaf's effective client chunk: ``client_chunk`` clamped to the
    client count N (a chunk ≥ N is one chunk), 0 on ineligible leaves —
    1-D biases and other oracle-only shapes never chunk."""
    if not eligible or client_chunk <= 0:
        return 0
    n = P["U"].shape[0] if isinstance(P, dict) else P.shape[0]
    return min(client_chunk, int(n))


def _plan_leaf(path: str, W, P, levels: int, convention: str,
               backend: str, client_chunk: int = 0) -> LeafPlan:
    from repro_torch.kernels import ops

    eligible = kernel_eligible(W, P, levels)
    kind = proj_kind(P, levels) if eligible else "none"
    ck = _eff_chunk(client_chunk, P, eligible)
    if not eligible or backend == "oracle":
        if not eligible and backend != "auto" and backend != "oracle" \
                and len(W.shape) > 1:
            ops.fallback_warn(
                f"leaf {path or '<leaf>'} (shape={tuple(W.shape)}, "
                f"levels={levels}) ineligible for backend={backend!r}: "
                f"falling back to the plain oracle")
        return LeafPlan(path, levels, "oracle", kind, client_chunk=ck)
    out_d, in_d = kernel_dims(W, convention)
    if min(out_d, in_d) >= ops.DEFAULT_BLOCK:
        return LeafPlan(path, levels, "stacked" if levels else "kernel",
                        kind, out_d, in_d, ck)
    if backend != "auto":
        ops.fallback_warn(
            f"{'stacked ' if levels else ''}leaf {path or '<leaf>'} "
            f"(out={out_d}, in={in_d}{f', levels={levels}' if levels else ''})"
            f" below one {ops.DEFAULT_BLOCK}-tile for backend={backend!r}: "
            f"running the plain oracle instead of the streaming kernels")
    return LeafPlan(path, levels, "oracle", kind, out_d, in_d, ck)


def _shape_key(p):
    if isinstance(p, dict):
        return ("factored", tuple(p["U"].shape), tuple(p["s"].shape))
    return ("array", tuple(p.shape))


class _Shape:
    """Shape-only stand-in for a leaf (routing reads nothing else)."""
    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = tuple(shape)


@lru_cache(maxsize=256)
def _compile_cached(leaf_descs, convention, backend, client_chunk):
    leaves = []
    for path, wshape, pkey, levels in leaf_descs:
        P = ({"U": _Shape(pkey[1]), "s": _Shape(pkey[2])}
             if pkey[0] == "factored" else _Shape(pkey[1]))
        leaves.append(_plan_leaf(path, _Shape(wshape), P, levels,
                                 convention, backend, client_chunk))
    return AggPlan(backend=backend, convention=convention,
                   leaves=tuple(leaves))


def compile_plan(W0: Pytree, P: Pytree, levels_tree: Pytree,
                 convention: str = "oi", backend: str = "oracle",
                 client_chunk: int = 0) -> AggPlan:
    """Compile (or fetch the memoized) :class:`AggPlan`.  ``W0`` / ``P``
    are the global-weight and *stacked* (leading client axis) projector
    trees; ``levels_tree`` is the per-leaf stacked-layer-axis count;
    ``client_chunk`` is ``MAEchoConfig.client_chunk`` (part of the memo
    key, so chunked and unchunked plans never collide)."""
    validate_backend(backend)
    leaves_w, treedef = trees.tree_flatten(W0)
    flatP = trees.flatten_up_to(treedef, P)
    flatL = trees.flatten_up_to(treedef, levels_tree)
    paths = [p for p, _ in trees.tree_paths(W0)]
    descs = tuple((path, tuple(w.shape), _shape_key(p), int(lv))
                  for path, w, p, lv in zip(paths, leaves_w, flatP, flatL))
    return _compile_cached(descs, convention, backend, int(client_chunk or 0))
