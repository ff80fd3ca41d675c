"""Plain PyTorch versions of the MA-Echo kernels (the targets the CUDA
kernels are held against, and the CPU path of their wrappers).

The functions of ``(W, V, P)`` accept every projector kind the core
algebra understands — stacked scalars (N,), diagonals (N, in), dense
(N, in, in) and factored ``{"U": (N, in, k), "s": (N, k)}`` — through
``core.maecho._apply_P`` (imported lazily: ``core`` imports this
package for dispatch).  The factored-only ones take the projector's
factors, as the kernels B2/B5/B8 do; the diagonal-only ones take the
(N, in) diagonal, as B3/B6/B9 do.  The stacked ones at the end are the
dense, diagonal and factored forms with a layer axis (W (L, out, in), V
and the projectors (N, L, …), α (L, N)), as B10/B13/B16, B12/B15/B18 and
B11/B14/B17 take them: batched products over L, no loop over layers.
Then come the client-chunked pipeline's cross-Gram of two chunks'
residual rows (B19) and the block-RLS projector downdate (B20), and last
the serving path's attention: flash-attention prefill (B21) and decode
over the ring-buffer cache (B22).
"""
from __future__ import annotations

import torch


def _residuals(W, V, P, convention: str = "oi"):
    """Rᵢ = (W − Vᵢ)Pᵢ for any projector kind, stacked over clients."""
    from repro_torch.core.maecho import _apply_P

    return _apply_P(W[None] - V, P, convention)


def _gram(R):
    """(N, N) Gram of a residual stack R (N, …): one partial Gram per row
    of the last axis, then their sum, as the kernels sum per-tile
    partials.  (One product over the whole flat leaf runs each fp32 dot
    over every element in sequence and loses more: on an H100 its
    batched form put the plain stacked Gram 4.7e-2 off the kernel at
    400 x 784 and 55 clients, 12 times the tolerance.)"""
    Rf = R.float()
    Rr = (Rf.reshape(R.shape[0], -1, R.shape[-1]) if R.dim() > 2
          else Rf[:, None]).transpose(0, 1)              # (rows, N, cols)
    return (Rr @ Rr.transpose(-1, -2)).sum(0)


def maecho_gram_ref(W, V, P, convention: str = "oi"):
    """G[i, j] = ⟨Rᵢ, Rⱼ⟩ with Rᵢ = (W − Vᵢ)Pᵢ — any projector kind."""
    return _gram(_residuals(W, V, P, convention))


def maecho_update_ref_any(W, V, P, alpha, eta: float = 1.0,
                          convention: str = "oi"):
    """Eq. 7: W' = W + η·(−Σᵢ 2αᵢ (W − Vᵢ)Pᵢ), fp32 accumulation."""
    R = _residuals(W, V, P, convention).float()
    D = -2.0 * torch.tensordot(alpha.float(), R, dims=([0], [0]))
    return (W.float() + eta * D).to(W.dtype)


def maecho_v_update_ref(W, V, P, frac: float, norm: bool = False,
                        eps: float = 1e-12, convention: str = "oi", nb: int = 1):
    """Eq. 11: Vᵢ' = Vᵢ + Norm(Δᵢ − frac·ΔᵢPᵢ), Δᵢ = W − Vᵢ.  ``V`` and
    ``P`` carry ``nb`` leading batch axes (the client axis, after a
    stacked leaf's layer axis) and ``W`` broadcasts against ``V``; by
    default W is one leaf and gets the client axis in front."""
    from repro_torch.core.maecho import _apply_P

    delta = (W[None] if nb == 1 else W) - V
    U = delta - frac * _apply_P(delta, P, convention, nb)
    if norm:
        ax = -1 if convention == "oi" or delta.dim() == nb + 1 else -2
        nrm = torch.linalg.vector_norm(U.float(), dim=ax, keepdim=True)
        U = U / nrm.clamp_min(eps).to(U.dtype)
    return V + U


# --------------------------------------------------------------------------
# factored projectors Pᵢ = Uᵢ·diag(sᵢ)·Uᵢᵀ, U (N, in, k), s (N, k): the
# residual comes as a left factor Rᵢ = Aᵢ @ UTᵢ with UT = Uᵀ (N, k, in)
# --------------------------------------------------------------------------
def compressed_residual_ref(W, V, U, s):
    """Aᵢ = ((W − Vᵢ)Uᵢ)·diag(sᵢ), the (N, …, out, k) compressed residual,
    formed as W@Uᵢ − Vᵢ@Uᵢ (the reference's order) so the (N, …, out, in)
    residual is never materialized.  Stacked-layer axes ride the
    ellipsis: W (…, out, in), V (N, …, out, in), U (N, …, in, k),
    s (N, …, k)."""
    U = U.float()
    A = W.float() @ U - V.float() @ U
    return A * s.float()[..., None, :]


def maecho_gram_left_ref(A, UT):
    """G[i, j] = ⟨Aᵢ@UTᵢ, Aⱼ@UTⱼ⟩ for A (N, out, k), UT (N, k, in)."""
    return _gram(A.float() @ UT.float())


def maecho_update_left_ref(W, A, UT, alpha, eta: float = 1.0):
    """Eq. 7 from left factors: W' = W + η·(−Σᵢ 2αᵢ Aᵢ@UTᵢ)."""
    R = A.float() @ UT.float()
    D = -2.0 * torch.tensordot(alpha.float(), R, dims=([0], [0]))
    return (W.float() + eta * D).to(W.dtype)


def maecho_v_update_left_ref(B, UT, W, V, frac: float,
                             norm: bool = False, eps: float = 1e-12):
    """Eq. 11 from left factors: Vᵢ' = Vᵢ + Norm((W − Vᵢ) −
    frac·Bᵢ@UTᵢ) for B (N, out, k), UT (N, k, in)."""
    u = (W[None] - V).float() - frac * (B.float() @ UT.float())
    if norm:
        u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True).clamp_min(eps)
    return (V.float() + u).to(V.dtype)


def maecho_v_update_factored_ref(W, V, U, s, frac: float,
                                 norm: bool = False, eps: float = 1e-12):
    """Eq. 11 for factored projectors: :func:`maecho_v_update_left_ref`
    with B = ``compressed_residual_ref(W, V, U, s)`` and UT = Uᵀ."""
    return maecho_v_update_left_ref(compressed_residual_ref(W, V, U, s),
                                    U.transpose(1, 2), W, V, frac, norm, eps)


# --------------------------------------------------------------------------
# diagonal projectors Pᵢ = diag(pᵢ), p (N, in) (scalars arrive broadcast):
# the residual is elementwise, Rᵢ = (W − Vᵢ)·pᵢ[None, :]
# --------------------------------------------------------------------------
def maecho_gram_diag_ref(W, V, p):
    """G[i, j] = ⟨Rᵢ, Rⱼ⟩ with Rᵢ = (W − Vᵢ)·pᵢ, p (N, in)."""
    return _gram((W[None] - V).float() * p.float()[:, None, :])


def maecho_update_diag_ref(W, V, p, alpha, eta: float = 1.0):
    """Eq. 7 elementwise: W' = W + η·Σᵢ(−2αᵢ)(W − Vᵢ)·pᵢ."""
    R = (W[None] - V).float() * p.float()[:, None, :]
    D = -2.0 * torch.tensordot(alpha.float(), R, dims=([0], [0]))
    return (W.float() + eta * D).to(W.dtype)


def maecho_v_update_diag_ref(W, V, p, frac: float, norm: bool = False,
                             eps: float = 1e-12):
    """Eq. 11 elementwise: Vᵢ' = Vᵢ + Norm((W − Vᵢ)·(1 − frac·pᵢ)), the
    TPU kernel's form of Δᵢ − frac·Δᵢ·pᵢ."""
    u = (W[None] - V).float() * (1.0 - frac * p.float()[:, None, :])
    if norm:
        u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True).clamp_min(eps)
    return (V.float() + u).to(V.dtype)


# --------------------------------------------------------------------------
# stacked leaves: W (L, out, in), V (N, L, out, in), dense P (N, L, in, in),
# diagonals p (N, L, in) or factors A (N, L, out, k), UT (N, L, k, in),
# alpha (L, N); one batched product over L
# --------------------------------------------------------------------------
def _gram_stacked(R):
    """(L, N, N) Grams of a residual stack R (N, L, out, in), by rows as
    :func:`_gram`."""
    Rr = R.float().permute(1, 2, 0, 3)                   # (L, out, N, in)
    return (Rr @ Rr.transpose(-1, -2)).sum(1)


def _update_stacked(W, R, alpha, eta: float):
    D = -2.0 * torch.einsum("ln,nloi->loi", alpha.float(), R.float())
    return (W.float() + eta * D).to(W.dtype)


def _v_finish(V, u, norm: bool, eps: float):
    if norm:
        u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True).clamp_min(eps)
    return (V.float() + u).to(V.dtype)


def maecho_gram_stacked_ref(W, V, P):
    """G[l, i, j] = ⟨Rₗᵢ, Rₗⱼ⟩ with Rₗᵢ = (Wₗ − Vᵢₗ)Pᵢₗ, dense P."""
    return _gram_stacked((W[None] - V).float() @ P.float())


def maecho_update_stacked_ref(W, V, P, alpha, eta: float = 1.0):
    """Eq. 7 per layer: Wₗ' = Wₗ + η·(−Σᵢ 2αₗᵢ (Wₗ − Vᵢₗ)Pᵢₗ)."""
    return _update_stacked(W, (W[None] - V).float() @ P.float(), alpha, eta)


def maecho_v_update_stacked_ref(W, V, P, frac: float, norm: bool = False,
                                eps: float = 1e-12):
    """Eq. 11 per layer: Vᵢₗ' = Vᵢₗ + Norm(Δᵢₗ − frac·ΔᵢₗPᵢₗ)."""
    d = (W[None] - V).float()
    return _v_finish(V, d - frac * (d @ P.float()), norm, eps)


def maecho_gram_diag_stacked_ref(W, V, p):
    """G[l, i, j] = ⟨Rₗᵢ, Rₗⱼ⟩ with Rₗᵢ = (Wₗ − Vᵢₗ)·pᵢₗ, p (N, L, in)."""
    return _gram_stacked((W[None] - V).float() * p.float()[:, :, None, :])


def maecho_update_diag_stacked_ref(W, V, p, alpha, eta: float = 1.0):
    """Eq. 7 per layer, elementwise."""
    return _update_stacked(W, (W[None] - V).float() * p.float()[:, :, None, :],
                           alpha, eta)


def maecho_v_update_diag_stacked_ref(W, V, p, frac: float, norm: bool = False,
                                     eps: float = 1e-12):
    """Eq. 11 per layer, elementwise: Vᵢₗ' = Vᵢₗ + Norm((Wₗ − Vᵢₗ)·(1 −
    frac·pᵢₗ))."""
    u = (W[None] - V).float() * (1.0 - frac * p.float()[:, :, None, :])
    return _v_finish(V, u, norm, eps)


def maecho_gram_left_stacked_ref(A, UT):
    """G[l, i, j] = ⟨Aₗᵢ@UTₗᵢ, Aₗⱼ@UTₗⱼ⟩ for A (N, L, out, k), UT (N, L, k, in)."""
    return _gram_stacked(A.float() @ UT.float())


def maecho_update_left_stacked_ref(W, A, UT, alpha, eta: float = 1.0):
    """Eq. 7 per layer from left factors: Wₗ' = Wₗ + η·(−Σᵢ 2αₗᵢ Aₗᵢ@UTₗᵢ)."""
    return _update_stacked(W, A.float() @ UT.float(), alpha, eta)


def maecho_v_update_left_stacked_ref(B, UT, W, V, frac: float, norm: bool = False,
                                     eps: float = 1e-12):
    """Eq. 11 per layer from left factors: Vᵢₗ' = Vᵢₗ + Norm((Wₗ − Vᵢₗ) −
    frac·Bₗᵢ@UTₗᵢ) for B (N, L, out, k), UT (N, L, k, in)."""
    u = (W[None] - V).float() - frac * (B.float() @ UT.float())
    return _v_finish(V, u, norm, eps)


def maecho_v_update_factored_stacked_ref(W, V, U, s, frac: float, norm: bool = False,
                                         eps: float = 1e-12):
    """Eq. 11 per layer for factored projectors, U (N, L, in, k), s (N, L, k):
    :func:`maecho_v_update_left_stacked_ref` with B the compressed residual
    of W and UT = Uᵀ."""
    return maecho_v_update_left_stacked_ref(compressed_residual_ref(W, V, U, s),
                                            U.transpose(-1, -2), W, V, frac, norm, eps)


# --------------------------------------------------------------------------
# the client-chunked Gram's pair block (B19) and the block-RLS downdate (B20)
# --------------------------------------------------------------------------
def maecho_gram_cross_ref(Ra, Rb):
    """G = Ra @ Rbᵀ in fp32 for the flat residual rows of two client
    chunks, Ra (ca, D) and Rb (cb, D): one partial product per slab of
    1024 columns (the last one zero-padded, which adds zero), then
    their sum, as the kernel sums per-slab partials.  (One product over
    all of D runs each fp32 dot over up to millions of terms; see
    :func:`_gram`.)"""
    Ra, Rb = Ra.float(), Rb.float()
    D, slab = Ra.shape[-1], 1024
    if D <= slab:
        return Ra @ Rb.T
    pad = (-D) % slab
    A = torch.nn.functional.pad(Ra, (0, pad)).reshape(Ra.shape[0], -1, slab)
    B = torch.nn.functional.pad(Rb, (0, pad)).reshape(Rb.shape[0], -1, slab)
    return (A.transpose(0, 1) @ B.permute(1, 2, 0)).sum(0)


def rank_downdate_ref(Q, U, A):
    """Q − U·A·Uᵀ for Q (d, d), U (d, b), A (b, b)."""
    return Q - U @ A @ U.T



# --------------------------------------------------------------------------
# attention: the flash-attention prefill kernel (B21) and the ring-buffer
# decode kernel (B22)
# --------------------------------------------------------------------------
NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, q_block: int = 256):
    """What B21 computes, for q (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D):
    q, k and v upcast to fp32, scores and p·v in fp32, key t masked for
    query row s when t > s (causal) with NEG_INF, the sum clamped at
    1e-30, the output in q's dtype.  Kv head = q head // group.  Exact
    softmax over all keys, ``q_block`` query rows at a time (the online
    softmax of the kernel is the same function)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    kpos = torch.arange(Sk, device=q.device)
    outs = []
    for q0 in range(0, Sq, q_block):
        qc = q[:, q0:q0 + q_block].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kf) * (1.0 / D ** 0.5)
        if causal:
            qpos = q0 + torch.arange(qc.shape[1], device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)                    # key 0 is never masked: m is finite
        o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
        outs.append(o / p.sum(-1).clamp_min(1e-30).transpose(1, 2)[..., None])
    return torch.cat(outs, 1).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, valid_mask):
    """What B22 computes, for q (B, 1, Hq, D), caches (B, W, Hkv, D) and a
    mask (B, W): the masked softmax of ``decode_attention.py``'s kernel
    in fp32 — invalid slots scored NEG_INF and zeroed in p, the sum
    clamped at 1e-30 — so a row with no valid slot returns **zeros**.
    (The dense oracle ``models.layers.decode_attention_oracle`` returns
    mean(v) there; the two agree on every other row.)  Output in q's
    dtype; head h = hkv · group + g."""
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    qg = q.float().reshape(B, Hkv, Hq // Hkv, D)
    valid = (valid_mask != 0)[:, None, None, :]                       # (B, 1, 1, W)
    s = torch.einsum("bhgd,bwhd->bhgw", qg, k_cache.float()) * (1.0 / D ** 0.5)
    s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * valid
    o = torch.einsum("bhgw,bwhd->bhgd", p, v_cache.float())
    o = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(B, 1, Hq, D).to(q.dtype)
