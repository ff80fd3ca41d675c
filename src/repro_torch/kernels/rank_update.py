"""The block-RLS projector downdate: B20 (``csrc/rank_downdate.cu``, port
of ``repro/kernels/rank_update.py::rank_downdate``) and the block-RLS
step around it (port of ``rank_update.block_rls_update``).

The recursion of ``core.projections`` is

    Q ← Q − U A Uᵀ,   U = Q X_bᵀ (d, b),   A = (αI_b + X_b Q X_bᵀ)⁻¹

The d × d downdate is the kernel; as in the reference, ``U``, the b × b
inverse and its symmetrization stay outside it as torch calls.  The
reference's client never calls this step (``fl/client.compute_projections``
runs ``core.projections.block_update``), so neither does the port's: it
is the ``ops.block_rls_update`` entry point, held against
``block_update``.

On a CUDA tensor :func:`rank_downdate` launches the kernel (or raises); on
a CPU tensor it runs the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_SIGS = {
    "rank_downdate_launch": (ctypes.c_int, [ctypes.c_void_p] * 4
                             + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
}


def rank_downdate(Q, U, A):
    """B20: Q − U·A·Uᵀ as a new tensor, for Q (d, d), U (d, b) and a
    symmetric A (b, b) float32 — any d and b (ragged edges are masked in
    the kernel)."""
    if Q.device.type == "cpu":
        return ref.rank_downdate_ref(Q, U, A)
    build.check_f32_cuda("rank_downdate", Q=Q, U=U, A=A)
    build.require(Q.dim() == 2 and U.dim() == 2 and A.dim() == 2,
                  f"rank_downdate: Q, U, A must be 2-D, got {tuple(Q.shape)}, "
                  f"{tuple(U.shape)}, {tuple(A.shape)}")
    d, b = U.shape
    build.require(tuple(Q.shape) == (d, d) and tuple(A.shape) == (b, b) and min(d, b) >= 1,
                  f"rank_downdate: shapes Q {tuple(Q.shape)}, U {tuple(U.shape)}, "
                  f"A {tuple(A.shape)} do not match (d, d), (d, b), (b, b)")
    lib = build.load("rank_downdate", _SIGS)
    out = torch.empty_like(Q)
    err = lib.rank_downdate_launch(build.ptr(Q), build.ptr(U), build.ptr(A),
                                   build.ptr(out), d, b, build.stream())
    build.check(err, "rank_downdate")
    rank_downdate.launches += 1
    return out


rank_downdate.launches = 0


def block_rls_update(Q, Xb, alpha: float = 1.0):
    """One block-RLS step through :func:`rank_downdate`: equal to
    ``core.projections.block_update(Q, Xb, alpha)``."""
    QX = Q @ Xb.T                                            # (d, b)
    S = alpha * torch.eye(Xb.shape[0], dtype=Q.dtype, device=Q.device) + Xb @ QX
    A = torch.linalg.inv(S)
    A = 0.5 * (A + A.T)
    return rank_downdate(Q, QX, A.contiguous())
