"""Null-space projection matrices (paper §4 "Null space projection").

For a layer with input features X ∈ R^{n×d}, the row-space projector is

    P = Xᵀ (X Xᵀ + zI)⁻¹ X ∈ R^{d×d}

As the paper does (citing OWM), the orthogonal projector Q ≈ I − P is
maintained by recursive least squares, here in block form (Woodbury,
exact):

    Q ← Q − Q X_bᵀ (α I_b + X_b Q X_bᵀ)⁻¹ X_b Q

and P = I − Q is recovered at the end.
"""
from __future__ import annotations

import torch


def projection_direct(X, z: float = 1e-3):
    """P = Xᵀ(XXᵀ + zI)⁻¹X — only for small n (tests / tiny layers)."""
    n = X.shape[0]
    G = X @ X.T + z * torch.eye(n, dtype=X.dtype, device=X.device)
    return X.T @ torch.linalg.solve(G, X)


def null_projector_init(d: int, dtype=torch.float32, device=None):
    """Q₀ = I (empty feature set: every direction is null space)."""
    return torch.eye(d, dtype=dtype, device=device)


def block_update(Q, Xb, alpha: float = 1e-3):
    """Block-RLS update with a batch X_b ∈ R^{b×d} (Woodbury, exact)."""
    QX = Q @ Xb.T                                  # (d, b)
    S = alpha * torch.eye(Xb.shape[0], dtype=Q.dtype, device=Q.device) + Xb @ QX
    return Q - QX @ torch.linalg.solve(S, QX.T)


def null_projector_from_features_continue(Q, X, alpha: float = 1e-3,
                                          block: int = 128):
    """Continue an existing Q with more feature rows, ``block`` rows
    per update (the last block zero-padded: zero rows are no-ops)."""
    pad = (-X.shape[0]) % block
    Xp = torch.nn.functional.pad(X, (0, 0, 0, pad))
    for Xb in Xp.reshape(-1, block, X.shape[1]):
        Q = block_update(Q, Xb, alpha)
    return Q


def symmetrize(P):
    return 0.5 * (P + P.T)
