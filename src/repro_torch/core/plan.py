"""Compile-once aggregation plans: the routing layer of MA-Echo.

:func:`compile_plan` runs once per (leaf paths, shapes, projector
kinds, convention, backend) — memoized, so repeated
aggregations over one model reuse the same :class:`AggPlan` — and
freezes one :class:`LeafPlan` per leaf.  ``core.maecho``'s outer loop
is a pure executor over those plans, and ``dispatch_summary`` is a
view of the same object, so the coverage it reports is the coverage
that runs.  The rules match ``repro.core.plan`` route for route.

Routes in this port:

  ``oracle``   the plain PyTorch reference path.
  ``kernel``   the fused streaming pipeline (2-D leaf, min dim ≥ 128):
               CUDA kernels B1/B4/B7 for dense projectors.

The ``sharded`` / ``sharded2d`` backends (ROADMAP A11) and stacked
leaves (A7) raise ``NotImplementedError``.
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
    "oi"-native kernel-layout dims (already convention-swapped).
    ``levels`` (stacked-layer axes) is always 0 until ROADMAP item A7;
    it is kept so the per-leaf report matches the reference's."""
    path: str
    levels: int
    route: str                  # oracle | kernel
    kind: str                   # scalar | diag | full | factored | none
    out_d: int = 0
    in_d: int = 0


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


def kernel_eligible(W, P) -> bool:
    """A 2-D weight with a (client-stacked) scalar / diagonal / dense /
    factored projector."""
    if len(W.shape) != 2:
        return False
    if isinstance(P, dict):
        return set(P) == {"U", "s"} and len(P["U"].shape) == 3
    return len(P.shape) in (1, 2, 3)


def kernel_dims(W, convention: str) -> tuple:
    out_d, in_d = W.shape[-2:]
    return (out_d, in_d) if convention == "oi" else (in_d, out_d)


def proj_kind(P) -> str:
    """Kind of a *stacked* (leading client axis) projector leaf."""
    if isinstance(P, dict):
        return "factored"
    return {1: "scalar", 2: "diag"}.get(len(P.shape), "full")


def _plan_leaf(path: str, W, P, convention: str, backend: str) -> LeafPlan:
    from repro_torch.kernels import ops

    eligible = kernel_eligible(W, P)
    kind = proj_kind(P) if eligible else "none"
    if not eligible or backend == "oracle":
        if not eligible and backend != "auto" and backend != "oracle" \
                and len(W.shape) > 1:
            ops.fallback_warn(
                f"leaf {path or '<leaf>'} (shape={tuple(W.shape)}) "
                f"ineligible for backend={backend!r}: falling back to the "
                f"plain oracle")
        return LeafPlan(path, 0, "oracle", kind)
    out_d, in_d = kernel_dims(W, convention)
    if min(out_d, in_d) >= ops.DEFAULT_BLOCK:
        return LeafPlan(path, 0, "kernel", kind, out_d, in_d)
    if backend != "auto":
        ops.fallback_warn(
            f"leaf {path or '<leaf>'} (out={out_d}, in={in_d}) below one "
            f"{ops.DEFAULT_BLOCK}-tile for backend={backend!r}: running "
            f"the plain oracle instead of the streaming kernels")
    return LeafPlan(path, 0, "oracle", kind, out_d, in_d)


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
def _compile_cached(leaf_descs, convention, backend):
    leaves = []
    for path, wshape, pkey in leaf_descs:
        P = ({"U": _Shape(pkey[1]), "s": _Shape(pkey[2])}
             if pkey[0] == "factored" else _Shape(pkey[1]))
        leaves.append(_plan_leaf(path, _Shape(wshape), P, convention,
                                 backend))
    return AggPlan(backend=backend, convention=convention,
                   leaves=tuple(leaves))


def compile_plan(W0: Pytree, P: Pytree, levels_tree: Pytree,
                 convention: str = "oi",
                 backend: str = "oracle") -> AggPlan:
    """Compile (or fetch the memoized) :class:`AggPlan`.  ``W0`` / ``P``
    are the global-weight and *stacked* (leading client axis) projector
    trees; ``levels_tree`` is the per-leaf stacked-layer-axis count."""
    validate_backend(backend)
    leaves_w, treedef = trees.tree_flatten(W0)
    flatP = trees.flatten_up_to(treedef, P)
    flatL = trees.flatten_up_to(treedef, levels_tree)
    if any(int(lv) > 0 for lv in flatL):
        raise NotImplementedError(
            "stacked leaves (stack_levels > 0) are not ported yet "
            "(ROADMAP item A7)")
    paths = [p for p, _ in trees.tree_paths(W0)]
    descs = tuple((path, tuple(w.shape), _shape_key(p))
                  for path, w, p in zip(paths, leaves_w, flatP))
    return _compile_cached(descs, convention, backend)
