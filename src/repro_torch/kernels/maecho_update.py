"""Eq. 7 global update W' = W + η·(−Σᵢ 2αᵢ Rᵢ): B4 for dense Pᵢ
(Rᵢ = (W − Vᵢ)Pᵢ, ``csrc/maecho_update.cu``, port of
``repro/kernels/maecho_update.py::maecho_update``) and B5 for factored
Pᵢ (Rᵢ = Aᵢ @ UTᵢ, ``csrc/maecho_update_left.cu``, port of
``maecho_update_left``), and B6 for diagonal Pᵢ = diag(pᵢ)
(Rᵢ = (W − Vᵢ)·pᵢ, ``csrc/maecho_update_diag.cu``, port of
``maecho_update_diag``); and their stacked twins for scan-stacked
leaves, one launch for all layers: B13 (``csrc/maecho_update_stacked.cu``,
port of ``maecho_update_stacked``), B14
(``csrc/maecho_update_left_stacked.cu``, port of
``maecho_update_left_stacked``) and B15
(``csrc/maecho_update_diag_stacked.cu``, port of
``maecho_update_diag_stacked``).

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_SIGS = {
    "maecho_update_workspace_floats": (ctypes.c_longlong, [ctypes.c_int] * 3),
    "maecho_update_launch": (ctypes.c_int, [ctypes.c_void_p] * 6
                             + [ctypes.c_int] * 3
                             + [ctypes.c_float, ctypes.c_void_p]),
}


def maecho_update(W, V, P, alpha, eta: float = 1.0):
    """W (out, in), V (N, out, in), P (N, in, in), alpha (N,) float32
    → W' (out, in), the products as 3xTF32 on the tensor cores with the
    depth split across the card (the workspace holds two partial
    128 x 128 tiles per SM).  alpha stays on the device (no host sync)."""
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
    build.require(N >= 1, f"maecho_update: N={N} clients, need at least 1")
    lib = build.load("maecho_update", _SIGS)
    n_ws = lib.maecho_update_workspace_floats(N, out_d, in_d)
    if n_ws < 0:
        raise RuntimeError("maecho_update: cannot read the device's multiprocessor count")
    ws = torch.empty(n_ws, dtype=torch.float32, device=W.device)
    out = torch.empty_like(W)
    err = lib.maecho_update_launch(build.ptr(W), build.ptr(V), build.ptr(P),
                                   build.ptr(alpha), build.ptr(ws), build.ptr(out), N,
                                   out_d, in_d, float(eta), build.stream())
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

_STACKED_ARGS = (ctypes.c_int, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                 + [ctypes.c_float, ctypes.c_void_p])


def _update_stacked_launch(name: str, W, V, P, alpha, eta: float, kind: str):
    """Launch B13 or B15 (``name``) on a checked stacked leaf and return
    the (L, out, in) update."""
    build.check_f32_cuda(name, W=W, V=V, P=P, alpha=alpha)
    N, L, out_d, in_d = build.stacked_dims(name, W, V, P, kind, alpha)
    build.require(L <= 65535, f"{name}: L={L} layers exceeds the grid's limit")
    lib = build.load(name, {f"{name}_launch": _STACKED_ARGS})
    out = torch.empty_like(W)
    err = getattr(lib, f"{name}_launch")(build.ptr(W), build.ptr(V), build.ptr(P),
                                         build.ptr(alpha), build.ptr(out), N, L,
                                         out_d, in_d, float(eta), build.stream())
    build.check(err, name)
    return out


def maecho_update_stacked(W, V, P, alpha, eta: float = 1.0):
    """B13, the wrapper of ``csrc/maecho_update_stacked.cu`` (port of
    ``repro/kernels/maecho_update.py::maecho_update_stacked``): Eq. 7
    per layer, Wₗ' = Wₗ + η·(−Σᵢ 2αₗᵢ (Wₗ − Vᵢₗ)Pᵢₗ), for W (L, out, in),
    V (N, L, out, in), P (N, L, in, in), alpha (L, N) float32, one launch
    for all layers, its products as 3xTF32 on the tensor cores.  alpha
    stays on the device (no host sync)."""
    if W.device.type == "cpu":
        return ref.maecho_update_stacked_ref(W, V, P, alpha, eta)
    out = _update_stacked_launch("maecho_update_stacked", W, V, P, alpha, eta, "full")
    maecho_update_stacked.launches += 1
    return out


maecho_update_stacked.launches = 0


def maecho_update_diag_stacked(W, V, p, alpha, eta: float = 1.0):
    """B15, the wrapper of ``csrc/maecho_update_diag_stacked.cu`` (port of
    ``repro/kernels/maecho_update.py::maecho_update_diag_stacked``):
    Eq. 7 per layer, elementwise, for W (L, out, in), V (N, L, out, in),
    p (N, L, in), alpha (L, N) float32, one launch for all layers."""
    if W.device.type == "cpu":
        return ref.maecho_update_diag_stacked_ref(W, V, p, alpha, eta)
    out = _update_stacked_launch("maecho_update_diag_stacked", W, V, p, alpha, eta,
                                 "diag")
    maecho_update_diag_stacked.launches += 1
    return out


maecho_update_diag_stacked.launches = 0

_LEFT_STACKED_SIGS = {
    "maecho_update_left_stacked_launch": (ctypes.c_int, [ctypes.c_void_p] * 5
                                          + [ctypes.c_int] * 5
                                          + [ctypes.c_float, ctypes.c_void_p]),
}


def maecho_update_left_stacked(W, A, UT, alpha, eta: float = 1.0):
    """B14, the wrapper of ``csrc/maecho_update_left_stacked.cu`` (port of
    ``repro/kernels/maecho_update.py::maecho_update_left_stacked``): Eq. 7
    per layer from left factors, Wₗ' = Wₗ + η·(−Σᵢ 2αₗᵢ Aₗᵢ@UTₗᵢ), for
    W (L, out, in), A (N, L, out, k), UT (N, L, k, in), alpha (L, N)
    float32, one launch for all layers.  alpha stays on the device (no
    host sync)."""
    if W.device.type == "cpu":
        return ref.maecho_update_left_stacked_ref(W, A, UT, alpha, eta)
    name = "maecho_update_left_stacked"
    build.check_f32_cuda(name, W=W, A=A, UT=UT, alpha=alpha)
    N, L, out_d, kd, in_d = build.stacked_left_dims(name, A, UT, W=W, alpha=alpha)
    lib = build.load(name, _LEFT_STACKED_SIGS)
    out = torch.empty_like(W)
    err = lib.maecho_update_left_stacked_launch(
        build.ptr(W), build.ptr(A), build.ptr(UT), build.ptr(alpha), build.ptr(out),
        N, L, out_d, in_d, kd, float(eta), build.stream())
    build.check(err, name)
    maecho_update_left_stacked.launches += 1
    return out


maecho_update_left_stacked.launches = 0
