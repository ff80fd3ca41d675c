"""Eq. 7 global update W' = W + η·(−Σᵢ 2αᵢ Rᵢ): B4 for dense Pᵢ
(Rᵢ = (W − Vᵢ)Pᵢ, ``csrc/maecho_update.cu``, port of
``repro/kernels/maecho_update.py::maecho_update``) and B5 for factored
Pᵢ (Rᵢ = Aᵢ @ UTᵢ, ``csrc/maecho_update_left.cu``, port of
``maecho_update_left``), and B6 for diagonal Pᵢ = diag(pᵢ)
(Rᵢ = (W − Vᵢ)·pᵢ, ``csrc/maecho_update_diag.cu``, port of
``maecho_update_diag``).

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_SIGS = {
    "maecho_update_launch": (ctypes.c_int, [ctypes.c_void_p] * 5
                             + [ctypes.c_int] * 3
                             + [ctypes.c_float, ctypes.c_void_p]),
}


def maecho_update(W, V, P, alpha, eta: float = 1.0):
    """W (out, in), V (N, out, in), P (N, in, in), alpha (N,) float32
    → W' (out, in).  alpha stays on the device (no host sync)."""
    if W.device.type == "cpu":
        return ref.maecho_update_ref_any(W, V, P, alpha, eta)
    build.check_f32_cuda("maecho_update", W=W, V=V, P=P, alpha=alpha)
    build.require(V.dim() == 3, f"maecho_update: V must be (N, out, in), got {tuple(V.shape)}")
    N, out_d, in_d = V.shape
    build.require(tuple(W.shape) == (out_d, in_d) and tuple(P.shape) == (N, in_d, in_d)
                  and tuple(alpha.shape) == (N,),
                  f"maecho_update: shapes W {tuple(W.shape)}, V {tuple(V.shape)}, "
                  f"P {tuple(P.shape)}, alpha {tuple(alpha.shape)} do not match "
                  f"(out, in), (N, out, in), (N, in, in), (N,)")
    lib = build.load("maecho_update", _SIGS)
    out = torch.empty_like(W)
    err = lib.maecho_update_launch(build.ptr(W), build.ptr(V), build.ptr(P),
                                   build.ptr(alpha), build.ptr(out), N, out_d,
                                   in_d, float(eta), build.stream())
    build.check(err, "maecho_update")
    maecho_update.launches += 1
    return out


maecho_update.launches = 0

_LEFT_SIGS = {
    "maecho_update_left_launch": (ctypes.c_int, [ctypes.c_void_p] * 5
                                  + [ctypes.c_int] * 4
                                  + [ctypes.c_float, ctypes.c_void_p]),
}


def maecho_update_left(W, A, UT, alpha, eta: float = 1.0):
    """B5, the wrapper of ``csrc/maecho_update_left.cu`` (port of
    ``repro/kernels/maecho_update.py::maecho_update_left``): Eq. 7 from
    left factors, W' = W + η·(−Σᵢ 2αᵢ Aᵢ@UTᵢ), for W (out, in),
    A (N, out, k), UT (N, k, in), alpha (N,) float32.  alpha stays on
    the device (no host sync)."""
    if W.device.type == "cpu":
        return ref.maecho_update_left_ref(W, A, UT, alpha, eta)
    build.check_f32_cuda("maecho_update_left", W=W, A=A, UT=UT, alpha=alpha)
    build.require(A.dim() == 3, f"maecho_update_left: A must be (N, out, k), got {tuple(A.shape)}")
    N, out_d, kd = A.shape
    in_d = W.shape[-1]
    build.require(tuple(W.shape) == (out_d, in_d) and tuple(UT.shape) == (N, kd, in_d)
                  and tuple(alpha.shape) == (N,) and kd >= 1,
                  f"maecho_update_left: shapes W {tuple(W.shape)}, A {tuple(A.shape)}, "
                  f"UT {tuple(UT.shape)}, alpha {tuple(alpha.shape)} do not match "
                  f"(out, in), (N, out, k), (N, k, in), (N,)")
    lib = build.load("maecho_update_left", _LEFT_SIGS)
    out = torch.empty_like(W)
    err = lib.maecho_update_left_launch(build.ptr(W), build.ptr(A), build.ptr(UT),
                                        build.ptr(alpha), build.ptr(out), N, out_d,
                                        in_d, kd, float(eta), build.stream())
    build.check(err, "maecho_update_left")
    maecho_update_left.launches += 1
    return out


maecho_update_left.launches = 0

_DIAG_SIGS = {
    "maecho_update_diag_launch": (ctypes.c_int, [ctypes.c_void_p] * 5
                                  + [ctypes.c_int] * 3
                                  + [ctypes.c_float, ctypes.c_void_p]),
}


def maecho_update_diag(W, V, p, alpha, eta: float = 1.0):
    """B6, the wrapper of ``csrc/maecho_update_diag.cu`` (port of
    ``repro/kernels/maecho_update.py::maecho_update_diag``): Eq. 7
    elementwise, W' = W + η·Σᵢ(−2αᵢ)(W − Vᵢ)·pᵢ, for W (out, in),
    V (N, out, in), p (N, in), alpha (N,) float32.  alpha stays on the
    device (no host sync)."""
    if W.device.type == "cpu":
        return ref.maecho_update_diag_ref(W, V, p, alpha, eta)
    build.check_f32_cuda("maecho_update_diag", W=W, V=V, p=p, alpha=alpha)
    build.require(V.dim() == 3, f"maecho_update_diag: V must be (N, out, in), got {tuple(V.shape)}")
    N, out_d, in_d = V.shape
    build.require(N >= 1, f"maecho_update_diag: N={N} clients, need at least 1")
    build.require(tuple(W.shape) == (out_d, in_d) and tuple(p.shape) == (N, in_d)
                  and tuple(alpha.shape) == (N,),
                  f"maecho_update_diag: shapes W {tuple(W.shape)}, V {tuple(V.shape)}, "
                  f"p {tuple(p.shape)}, alpha {tuple(alpha.shape)} do not match "
                  f"(out, in), (N, out, in), (N, in), (N,)")
    lib = build.load("maecho_update_diag", _DIAG_SIGS)
    out = torch.empty_like(W)
    err = lib.maecho_update_diag_launch(build.ptr(W), build.ptr(V), build.ptr(p),
                                        build.ptr(alpha), build.ptr(out), N, out_d,
                                        in_d, float(eta), build.stream())
    build.check(err, "maecho_update_diag")
    maecho_update_diag.launches += 1
    return out


maecho_update_diag.launches = 0
