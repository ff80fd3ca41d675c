"""Dispatch layer of the fused streaming MA-Echo pipeline.

``core.maecho``'s kernel route calls :func:`maecho_streaming_gram`
(the Eq. 6 Gram plus a reuse context) and :func:`maecho_streaming_apply`
(Eq. 7 then Eq. 11) once per leaf per outer iteration.  Both assume
the "oi" layout — ``core.maecho`` transposes "io" leaves first.

Dense (``"full"``) projectors run the CUDA kernels B1/B4/B7 on a CUDA
tensor.  The other kinds (stacked scalar, diagonal, factored) have no
CUDA kernel yet: on a CUDA tensor they raise, on a CPU tensor they run
the plain versions in ``ref``.  The CUDA kernels mask ragged edges
themselves, so no operand is zero-padded (the reference's
``_pad_to`` / ``_normalize_padded`` have no counterpart here).
"""
from __future__ import annotations

import warnings

from repro_torch.core.plan import proj_kind
from repro_torch.kernels import ref
from repro_torch.kernels.maecho_gram import maecho_gram
from repro_torch.kernels.maecho_update import maecho_update
from repro_torch.kernels.maecho_v_update import maecho_v_update

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


def _no_kernel_yet(kind: str, W) -> None:
    if W.is_cuda:
        raise NotImplementedError(
            f"projector kind {kind!r} has no CUDA kernel yet (kernels "
            f"B2/B3/B5/B6/B8/B9, ROADMAP item A4); use dense projectors "
            f"or backend='oracle'")


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
    _no_kernel_yet(kind, W)
    return ref.maecho_gram_ref(W, V, P), (kind, W, V, P)


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
    if kind != "ref":
        _no_kernel_yet(kind, W)
    Wn = ref.maecho_update_ref_any(W, V, P, alpha, eta)
    return Wn, ref.maecho_v_update_ref(Wn, V, P, frac, norm, eps)
