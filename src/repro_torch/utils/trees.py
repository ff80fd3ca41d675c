"""Pytree utilities for the port.

A tree is nested ``dict`` / ``list`` / ``tuple`` containers with tensor
(or any non-container) leaves — the paper models are lists of
``{"W", "b"}`` dicts.  Flatten order matches JAX's: dict keys sorted,
sequences in order, so leaf lists and dotted paths line up with
``repro.utils.trees`` on the same structure.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

Pytree = Any


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def tree_flatten(tree: Pytree) -> tuple[list, Any]:
    """Return ``(leaves, treedef)``; ``treedef`` rebuilds the structure
    in :func:`tree_unflatten` and drives :func:`flatten_up_to`."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            return (type(node), None, [walk(v) for v in node])
        leaves.append(node)
        return None

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves) -> Pytree:
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, children = d
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, children)}
        return kind(build(c) for c in children)

    return build(treedef)


def flatten_up_to(treedef, tree: Pytree) -> list:
    """Leaves of ``tree`` at the leaf positions of ``treedef`` — a
    subtree sitting where ``treedef`` has a leaf (a factored
    ``{"U", "s"}`` projector under a weight leaf) is returned whole."""
    out: list = []

    def walk(d, node):
        if d is None:
            out.append(node)
            return
        kind, keys, children = d
        if kind == "dict":
            if sorted(node) != keys:
                raise ValueError(f"dict keys {sorted(node)} != {keys}")
            for k, c in zip(keys, children):
                walk(c, node[k])
        else:
            if len(node) != len(children):
                raise ValueError("sequence length mismatch")
            for c, v in zip(children, node):
                walk(c, v)

    walk(treedef, tree)
    return out


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    leaves, treedef = tree_flatten(tree)
    others = [flatten_up_to(treedef, r) for r in rest]
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])


def tree_add(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: Pytree, s) -> Pytree:
    return tree_map(lambda x: x * s, a)


def tree_paths(tree: Pytree) -> list[tuple[str, Any]]:
    """Flatten to (dotted-path, leaf) pairs: dict keys and sequence
    indices joined by '.', in flatten order."""
    out: list[tuple[str, Any]] = []

    def walk(node, parts):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], parts + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, parts + [str(i)])
        else:
            out.append((".".join(parts), node))

    walk(tree, [])
    return out


def map_with_path(fn: Callable[[str, Any], Any], tree: Pytree) -> Pytree:
    """Map ``fn(path, leaf) -> new leaf`` over a tree, preserving its
    structure; ``path`` is the dotted path of :func:`tree_paths`."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(p, leaf) for (p, _), leaf
                                    in zip(tree_paths(tree), leaves)])
