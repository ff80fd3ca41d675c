"""The dual QP of Eq. 6 — a one-class-SVM-shaped problem:

    min_α  ½ αᵀ G α    s.t.  Σᵢ αᵢ = 1,  0 ≤ αᵢ ≤ C

with G the Gram matrix of the per-client gradients gᵢ = 2 Pᵢ (w − vᵢ).

Accelerated projected gradient descent with an exact projection onto
the capped simplex by bisection — the same iteration rule, counts and
fp32 arithmetic as ``repro.core.qp``.  Everything stays on the Gram's
device: no value is read back to the host inside the solve.  Every
solver is batched over leading axes (one (L, N, N) stack → (L, N)).
"""
from __future__ import annotations

import numpy as np
import torch


def project_capped_simplex(x, C: float, iters: int = 60, mask=None):
    """Euclidean projection of the last axis of ``x`` onto
    {α : Σα = 1, 0 ≤ α ≤ C}.

    Solves for τ with Σ clip(x − τ, 0, C) = 1 by ``iters`` bisection
    steps.  ``mask`` (optional boolean, same shape as ``x``) restricts
    the simplex to the masked coordinates: unmasked entries are held at
    exactly 0 and excluded from the Σ = 1 constraint.
    """
    x = x.float()
    if mask is None:
        lo = x.amin(-1) - C - 1.0
        hi = x.amax(-1)
    else:
        inf = torch.tensor(float("inf"), device=x.device)
        lo = torch.where(mask, x, inf).amin(-1) - C - 1.0
        hi = torch.where(mask, x, -inf).amax(-1)
    zero = torch.zeros((), device=x.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        clipped = (x - mid[..., None]).clamp(0.0, C)
        if mask is not None:
            clipped = torch.where(mask, clipped, zero)
        gt = clipped.sum(-1) > 1.0          # τ too small → raise lo
        lo = torch.where(gt, mid, lo)
        hi = torch.where(gt, hi, mid)
    out = (x - (0.5 * (lo + hi))[..., None]).clamp(0.0, C)
    return out if mask is None else torch.where(mask, out, zero)


def _pgd_masked(G, mask, C: float, iters: int):
    """Masked accelerated PGD over a batch: G (..., N, N) with arbitrary
    values in padded rows/columns (zeroed here), mask (..., N) boolean.
    Returns α (..., N) with exact zeros on padded coordinates."""
    pair = mask[..., :, None] & mask[..., None, :]
    zero = torch.zeros((), device=G.device)
    Gm = torch.where(pair, G.float(), zero)
    # Lipschitz bound: masked row-sum norm (padded rows sum to 0)
    L = Gm.abs().sum(-1).amax(-1).clamp_min(1e-12)
    step = (1.0 / L)[..., None]
    n = mask.float().sum(-1).clamp_min(1.0)
    a = project_capped_simplex(
        torch.where(mask, (1.0 / n)[..., None], zero), C, mask=mask)
    y = a
    # the momentum schedule is data-independent: run it in float32 on
    # the host, as the reference's scalar carry does
    t = np.float32(1.0)
    for _ in range(iters):
        grad = (Gm @ y[..., None])[..., 0]
        a_new = project_capped_simplex(y - step * grad, C, mask=mask)
        t_new = np.float32(0.5) * (np.float32(1.0)
                                   + np.sqrt(np.float32(1.0) + np.float32(4.0) * t * t))
        y = a_new + float((t - np.float32(1.0)) / t_new) * (a_new - a)
        a, t = a_new, t_new
    return a


def solve_qp(G, C: float, iters: int = 300, mask=None):
    """Accelerated PGD for min ½αᵀGα on the capped simplex.  G (N, N)
    PSD; ``mask`` (optional (N,) boolean) restricts the simplex to the
    masked-in clients (excluded coordinates come back exactly 0)."""
    if mask is None:
        mask = torch.ones(G.shape[-1], dtype=torch.bool, device=G.device)
    return _pgd_masked(G, torch.as_tensor(mask, dtype=torch.bool,
                                          device=G.device), C, iters)


def solve_qp_batched(G, C: float, iters: int = 300, n_valid=None,
                     mask=None):
    """One batched accelerated-PGD solve for a stack of QPs.

    G: (L, Nmax, Nmax).  ``n_valid`` (L,) gives each QP's true size
    (``None``: all full); ``mask`` (L, Nmax) boolean overrides it with
    arbitrary per-QP validity.  Masked-out α entries come back exactly
    0.  Same iteration rule as :func:`solve_qp`.  Returns (L, Nmax).
    """
    L, Nmax = G.shape[0], G.shape[-1]
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=G.device)
    elif n_valid is None:
        mask = torch.ones((L, Nmax), dtype=torch.bool, device=G.device)
    else:
        n_valid = torch.as_tensor(n_valid, device=G.device)
        mask = (torch.arange(Nmax, device=G.device)[None, :]
                < n_valid[:, None])
    return _pgd_masked(G, mask, C, iters)


def stack_grams(grams):
    """Pad a list of ragged (..., N_l, N_l) Gram stacks to one
    (ΣL_l, Nmax, Nmax) tensor plus its (ΣL_l,) validity vector."""
    flat = [g.reshape((-1,) + tuple(g.shape[-2:])) for g in grams]
    n_max = max(g.shape[-1] for g in flat)
    padded, valid = [], []
    for g in flat:
        n = g.shape[-1]
        if n < n_max:
            g = torch.nn.functional.pad(g, (0, n_max - n, 0, n_max - n))
        padded.append(g)
        valid.extend([n] * g.shape[0])
    return (torch.cat(padded, 0),
            torch.tensor(valid, dtype=torch.int32, device=flat[0].device))


def solve_qp_active_set(G, C: float, tol: float = 1e-10,
                        max_iter: int = 1000):
    """Reference dense solver (numpy, Frank-Wolfe with away steps) —
    the CVXOPT stand-in the tests hold :func:`solve_qp` against."""
    G = np.asarray(G, dtype=np.float64)
    N = G.shape[0]
    a = np.full(N, 1.0 / N)
    a = np.clip(a, 0, C)
    a /= a.sum()
    for _ in range(max_iter):
        g = G @ a
        order = np.argsort(g)
        s = np.zeros(N)
        rem = 1.0
        for i in order:
            s[i] = min(C, rem)
            rem -= s[i]
            if rem <= 0:
                break
        d = s - a
        gap = -g @ d
        if gap < tol:
            break
        dGd = d @ G @ d
        t = 1.0 if dGd <= 0 else min(1.0, gap / dGd)
        a = a + t * d
    return a
