"""Plain PyTorch versions of the MA-Echo kernels (the targets the CUDA
kernels are held against, and the CPU path of their wrappers).

Every function accepts every projector kind the core algebra
understands — stacked scalars (N,), diagonals (N, in), dense
(N, in, in) and factored ``{"U": (N, in, k), "s": (N, k)}`` — through
``core.maecho._apply_P`` (imported lazily: ``core`` imports this
package for dispatch).
"""
from __future__ import annotations

import torch


def _residuals(W, V, P, convention: str = "oi"):
    """Rᵢ = (W − Vᵢ)Pᵢ for any projector kind, stacked over clients."""
    from repro_torch.core.maecho import _apply_P

    return _apply_P(W[None] - V, P, convention)


def maecho_gram_ref(W, V, P, convention: str = "oi"):
    """G[i, j] = ⟨Rᵢ, Rⱼ⟩ with Rᵢ = (W − Vᵢ)Pᵢ — any projector kind."""
    R = _residuals(W, V, P, convention)
    Rf = R.reshape(R.shape[0], -1).float()
    return Rf @ Rf.T


def maecho_update_ref_any(W, V, P, alpha, eta: float = 1.0,
                          convention: str = "oi"):
    """Eq. 7: W' = W + η·(−Σᵢ 2αᵢ (W − Vᵢ)Pᵢ), fp32 accumulation."""
    R = _residuals(W, V, P, convention).float()
    D = -2.0 * torch.tensordot(alpha.float(), R, dims=([0], [0]))
    return (W.float() + eta * D).to(W.dtype)


def maecho_v_update_ref(W, V, P, frac: float, norm: bool = False,
                        eps: float = 1e-12, convention: str = "oi"):
    """Eq. 11: Vᵢ' = Vᵢ + Norm(Δᵢ − frac·ΔᵢPᵢ), Δᵢ = W − Vᵢ."""
    from repro_torch.core.maecho import _apply_P

    delta = W[None] - V
    U = delta - frac * _apply_P(delta, P, convention)
    if norm:
        ax = -1 if convention == "oi" else 1
        nrm = torch.linalg.vector_norm(U.float(), dim=ax, keepdim=True)
        U = U / nrm.clamp_min(eps).to(U.dtype)
    return V + U
