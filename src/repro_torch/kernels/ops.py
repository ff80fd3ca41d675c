"""Dispatch layer of the fused streaming MA-Echo pipeline.

``core.maecho``'s kernel route calls :func:`maecho_streaming_gram`
(the Eq. 6 Gram plus a reuse context) and :func:`maecho_streaming_apply`
(Eq. 7 then Eq. 11) once per leaf per outer iteration.  Both assume
the "oi" layout — ``core.maecho`` transposes "io" leaves first.

On a CUDA tensor, dense (``"full"``) projectors run the CUDA kernels
B1/B4/B7; factored ones ``{"U", "s"}`` B2/B5/B8 (the Gram forms the
compressed residual A and Uᵀ once and hands them to Eq. 7 and Eq. 11
through the reuse context); stacked scalars (N,) and diagonals (N, in)
B3/B6/B9 (the Gram half broadcasts a scalar to an (N, in) diagonal once,
the reference's ``_as_diag``, and hands the diagonal on through the
reuse context).  On a CPU tensor every kernel wrapper runs its plain
version in ``ref``.  Leaves below one 128-tile run the plain oracle.
The CUDA kernels mask ragged edges on out, in and the rank, so no
operand is zero-padded (the reference's ``_pad_to`` /
``_normalize_padded`` / ``_pad_factored`` have no counterpart here).

Stacked leaves — W (L, out, in) with the scan-layer axes flattened to
one L, V and the projector (N, L, …) — take
:func:`maecho_streaming_gram_stacked` and
:func:`maecho_streaming_apply_stacked`: dense projectors run B10/B13/B16,
factored ones ``{"U": (N, L, in, k), "s": (N, L, k)}`` B11/B14/B17 (the
Gram half forms the compressed residual A (N, L, out, k) and Uᵀ once
and hands them on, as the unstacked factored branch does), stacked
scalars (N, L) and diagonals (N, L, in) B12/B15/B18 (the scalar
broadcast once to (N, L, in) in the Gram half), one launch each for all
L layers.
"""
from __future__ import annotations

import warnings

from repro_torch.core.plan import proj_kind
from repro_torch.kernels import ref
from repro_torch.kernels.maecho_gram import (compressed_residual, maecho_gram,
                                             maecho_gram_diag,
                                             maecho_gram_diag_stacked,
                                             maecho_gram_left,
                                             maecho_gram_left_stacked,
                                             maecho_gram_stacked)
from repro_torch.kernels.maecho_update import (maecho_update, maecho_update_diag,
                                               maecho_update_diag_stacked,
                                               maecho_update_left,
                                               maecho_update_left_stacked,
                                               maecho_update_stacked)
from repro_torch.kernels.maecho_v_update import (maecho_v_update,
                                                 maecho_v_update_diag,
                                                 maecho_v_update_diag_stacked,
                                                 maecho_v_update_factored,
                                                 maecho_v_update_factored_stacked,
                                                 maecho_v_update_stacked)

# below this edge a leaf runs the plain oracle (the reference's tile
# rule; core.plan's routing keys off the same constant)
DEFAULT_BLOCK = 128

_warned_fallbacks: set[str] = set()


def fallback_warn(msg: str) -> None:
    """``warnings.warn`` once per distinct message: a leaf the caller
    believes is on the kernel path quietly running the oracle is the
    failure mode this surfaces."""
    if msg not in _warned_fallbacks:
        _warned_fallbacks.add(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def maecho_streaming_gram(W, V, P):
    """Gram half of the fused leaf iteration: returns ``(G, ctx)`` with
    G the (N, N) Eq. 6 Gram and ``ctx`` the reuse context for
    :func:`maecho_streaming_apply`."""
    out_d, in_d = W.shape
    if out_d < DEFAULT_BLOCK or in_d < DEFAULT_BLOCK:
        fallback_warn(
            f"leaf (out={out_d}, in={in_d}) below one {DEFAULT_BLOCK}-tile: "
            f"running the plain oracle instead of the streaming kernels")
        return ref.maecho_gram_ref(W, V, P), ("ref", W, V, P)
    kind = proj_kind(P)
    if kind == "full":
        return maecho_gram(W, V, P), (kind, W, V, P)
    if kind == "factored":
        U, s = P["U"], P["s"]
        A = compressed_residual(W, V, U, s)
        UT = U.transpose(1, 2).contiguous()
        return maecho_gram_left(A, UT), (kind, W, V, (U, s, A, UT))
    p = P[:, None].expand(-1, in_d).contiguous() if kind == "scalar" else P
    return maecho_gram_diag(W, V, p), ("diag", W, V, p)


def maecho_streaming_apply(alpha, ctx, *, eta: float = 1.0,
                           frac: float = 0.5, norm: bool = False,
                           eps: float = 1e-12):
    """Update half of the fused leaf iteration: Eq. 7 then Eq. 11 on
    the context from :func:`maecho_streaming_gram`.  Returns
    ``(W', V')``."""
    kind, W, V, P = ctx
    if kind == "full":
        Wn = maecho_update(W, V, P, alpha, eta)
        return Wn, maecho_v_update(Wn, V, P, frac, norm, eps)
    if kind == "factored":
        U, s, A, UT = P
        Wn = maecho_update_left(W, A, UT, alpha, eta)
        return Wn, maecho_v_update_factored(Wn, V, U, s, frac, norm, eps, UT=UT)
    if kind == "diag":
        Wn = maecho_update_diag(W, V, P, alpha, eta)
        return Wn, maecho_v_update_diag(Wn, V, P, frac, norm, eps)
    Wn = ref.maecho_update_ref_any(W, V, P, alpha, eta)
    return Wn, ref.maecho_v_update_ref(Wn, V, P, frac, norm, eps)


def maecho_streaming_gram_stacked(W, V, P):
    """Stacked Gram half: ``(G, ctx)`` with G the (L, N, N) per-layer
    Eq. 6 Grams from one kernel launch and ``ctx`` the reuse context for
    :func:`maecho_streaming_apply_stacked`.  W (L, out, in), V
    (N, L, out, in), P (N, L) scalars, (N, L, in) diagonals,
    (N, L, in, in) dense or factored {"U": (N, L, in, k), "s": (N, L, k)},
    all in the "oi" layout, any out and in (the kernels mask ragged
    edges; the plan sends leaves below one tile to the oracle before
    they get here)."""
    in_d = W.shape[2]
    kind = proj_kind(P, 1)
    if kind == "factored":
        U, s = P["U"], P["s"]
        A = compressed_residual(W, V, U, s)               # (N, L, out, k)
        UT = U.transpose(-1, -2).contiguous()             # (N, L, k, in)
        return maecho_gram_left_stacked(A, UT), (kind, W, V, (U, s, A, UT))
    if kind == "full":
        return maecho_gram_stacked(W, V, P), (kind, W, V, P)
    p = P[:, :, None].expand(-1, -1, in_d).contiguous() if kind == "scalar" else P
    return maecho_gram_diag_stacked(W, V, p), ("diag", W, V, p)


def maecho_streaming_apply_stacked(alpha, ctx, *, eta: float = 1.0,
                                   frac: float = 0.5, norm: bool = False,
                                   eps: float = 1e-12):
    """Stacked update half: per-layer Eq. 7 then Eq. 11, one launch each,
    on the context from :func:`maecho_streaming_gram_stacked`.
    ``alpha`` is the (L, N) stack of per-layer solves.  Returns
    ``(W', V')``, (L, out, in) and (N, L, out, in)."""
    kind, W, V, P = ctx
    if kind == "full":
        Wn = maecho_update_stacked(W, V, P, alpha, eta)
        return Wn, maecho_v_update_stacked(Wn, V, P, frac, norm, eps)
    if kind == "factored":
        U, s, A, UT = P
        Wn = maecho_update_left_stacked(W, A, UT, alpha, eta)
        return Wn, maecho_v_update_factored_stacked(Wn, V, U, s, frac, norm, eps, UT=UT)
    Wn = maecho_update_diag_stacked(W, V, P, alpha, eta)
    return Wn, maecho_v_update_diag_stacked(Wn, V, P, frac, norm, eps)
