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


def null_projector_from_features(X, alpha: float = 1e-3, block: int = 128):
    """Stream X (n, d) through block-RLS updates from Q₀ = I.  Returns
    Q ≈ I − P."""
    Q = null_projector_init(X.shape[1], X.dtype, X.device)
    return null_projector_from_features_continue(Q, X, alpha, block)


def projection_from_features(X, alpha: float = 1e-3, block: int = 128):
    """P (row-space projector) via the streaming block form."""
    d = X.shape[-1]
    return (torch.eye(d, dtype=X.dtype, device=X.device)
            - null_projector_from_features(X, alpha, block))


def symmetrize(P):
    return 0.5 * (P + P.T)


# --------------------------------------------------------------------------
# SVD compression (paper §7.3 "The SVD decomposition for P")
# --------------------------------------------------------------------------
def svd_compress(P, k: int):
    """Keep the top-k eigencomponents of the (symmetric PSD) projector.

    Returns (U_k, s_k) with P ≈ U_k diag(s_k) U_kᵀ, eigenvalues in
    descending order.  Communication cost drops from d² to k·(d+1) —
    the paper's Table 6 experiment.
    """
    s, U = torch.linalg.eigh(symmetrize(P))
    # the reference's jnp.argsort(s)[::-1]: a stable ascending sort, reversed
    idx = torch.argsort(s, stable=True).flip(0)[:k]
    return U[:, idx], s[idx]


def svd_restore(U_k, s_k):
    return (U_k * s_k) @ U_k.T


def compression_ratio(d: int, k: int) -> float:
    return (k * (d + 1)) / float(d * d)


def factor_projection(P, k: int) -> dict:
    """Factored form {"U", "s"} with P ≈ U·diag(s)·Uᵀ — accepted
    directly by ``core.maecho`` (and run by the kernels B2/B5/B8)."""
    U, s = svd_compress(P, k)
    return {"U": U, "s": s}


def factor_projection_tree(projs, k: int, min_dim: int = 4):
    """Factor every full (d, d) projector leaf with d ≥ ``min_dim`` in a
    projection pytree at rank min(k, d); ``{"U", "s"}`` nodes and other
    leaves are kept as they are."""

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"U", "s"}:
                return node
            return {kk: walk(v) for kk, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if (isinstance(node, torch.Tensor) and node.dim() == 2
                and node.shape[0] == node.shape[1] and node.shape[0] >= min_dim):
            return factor_projection(node, min(k, node.shape[0]))
        return node

    return walk(projs)
