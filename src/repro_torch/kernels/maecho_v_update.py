"""Eq. 11 anchor update Vᵢ' = Vᵢ + Norm(Δᵢ − frac·ΔᵢPᵢ), Δᵢ = W' − Vᵢ:
B7 for dense Pᵢ (``csrc/maecho_v_update.cu``, port of
``repro/kernels/maecho_v_update.py::maecho_v_update``) and B8 for
factored Pᵢ (``csrc/maecho_v_update_factored.cu``, port of
``maecho_v_update_factored``), and B9 for diagonal Pᵢ = diag(pᵢ)
(``csrc/maecho_v_update_diag.cu``, port of ``maecho_v_update_diag``);
and the stacked twins of B7, B8 and B9 for scan-stacked leaves, one
launch for all layers: B16 (``csrc/maecho_v_update_stacked.cu``, port of
``maecho_v_update_stacked``), B17
(``csrc/maecho_v_update_factored_stacked.cu``, port of
``maecho_v_update_factored_stacked``) and B18
(``csrc/maecho_v_update_diag_stacked.cu``, port of
``maecho_v_update_diag_stacked``).

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.maecho_gram import compressed_residual

_SIGS = {
    "maecho_v_update_workspace_floats": (ctypes.c_longlong, [ctypes.c_int] * 4),
    "maecho_v_update_launch": (ctypes.c_int, [ctypes.c_void_p] * 5
                               + [ctypes.c_int] * 3
                               + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_float, ctypes.c_void_p]),
}


def maecho_v_update(W, V, P, frac: float, norm: bool = False,
                    eps: float = 1e-12):
    """W (out, in) updated global, V (N, out, in), P (N, in, in) float32
    → V' (N, out, in).  ``frac`` is μ/(1+μ); ``norm`` row-normalises
    the update over the in-axis."""
    if W.device.type == "cpu":
        return ref.maecho_v_update_ref(W, V, P, frac, norm, eps)
    build.check_f32_cuda("maecho_v_update", W=W, V=V, P=P)
    build.require(V.dim() == 3, f"maecho_v_update: V must be (N, out, in), got {tuple(V.shape)}")
    N, out_d, in_d = V.shape
    build.require(tuple(W.shape) == (out_d, in_d) and tuple(P.shape) == (N, in_d, in_d),
                  f"maecho_v_update: shapes W {tuple(W.shape)}, V {tuple(V.shape)}, "
                  f"P {tuple(P.shape)} do not match (out, in), (N, out, in), (N, in, in)")
    build.require(N <= 65535, f"maecho_v_update: N={N} exceeds the grid's z limit")
    lib = build.load("maecho_v_update", _SIGS)
    ws = torch.empty(lib.maecho_v_update_workspace_floats(N, out_d, in_d, int(norm)),
                     dtype=torch.float32, device=W.device)
    out = torch.empty_like(V)
    err = lib.maecho_v_update_launch(build.ptr(W), build.ptr(V), build.ptr(P),
                                     build.ptr(out), build.ptr(ws), N, out_d, in_d,
                                     float(frac), int(norm), float(eps),
                                     build.stream())
    build.check(err, "maecho_v_update")
    maecho_v_update.launches += 1
    return out


maecho_v_update.launches = 0

_FACTORED_SIGS = {
    "maecho_v_update_factored_workspace_floats": (ctypes.c_longlong,
                                                  [ctypes.c_int] * 4),
    "maecho_v_update_factored_launch": (ctypes.c_int, [ctypes.c_void_p] * 6
                                        + [ctypes.c_int] * 4
                                        + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]),
}


def maecho_v_update_factored(W, V, U, s, frac: float, norm: bool = False,
                             eps: float = 1e-12, UT=None):
    """B8 on the reference's operands (port of
    ``repro/kernels/maecho_v_update.py::maecho_v_update_factored``):
    Eq. 11 for factored Pᵢ = Uᵢ·diag(sᵢ)·Uᵢᵀ, V' (N, out, in) from W
    (out, in) updated global, V (N, out, in), U (N, in, k), s (N, k)
    float32.  As in the reference it forms B, the compressed residual
    of W, itself (one fp32 GEMM, not a kernel), and hands B and Uᵀ
    (``UT`` (N, k, in) when the caller already holds it) to the kernel
    through :func:`maecho_v_update_left`."""
    if W.device.type == "cpu":
        return ref.maecho_v_update_factored_ref(W, V, U, s, frac, norm, eps)
    build.check_f32_cuda("maecho_v_update_factored", W=W, V=V, U=U, s=s)
    build.require(V.dim() == 3, f"maecho_v_update_factored: V must be (N, out, in), "
                                f"got {tuple(V.shape)}")
    N, out_d, in_d = V.shape
    kd = U.shape[-1] if U.dim() == 3 else 0
    build.require(tuple(W.shape) == (out_d, in_d) and tuple(U.shape) == (N, in_d, kd)
                  and tuple(s.shape) == (N, kd) and kd >= 1,
                  f"maecho_v_update_factored: shapes W {tuple(W.shape)}, V {tuple(V.shape)}, "
                  f"U {tuple(U.shape)}, s {tuple(s.shape)} do not match "
                  f"(out, in), (N, out, in), (N, in, k), (N, k)")
    if UT is None:
        UT = U.transpose(1, 2).contiguous()
    return maecho_v_update_left(compressed_residual(W, V, U, s), UT, W, V,
                                frac, norm, eps)


def maecho_v_update_left(B, UT, W, V, frac: float, norm: bool = False,
                         eps: float = 1e-12):
    """The B8 kernel, ``csrc/maecho_v_update_factored.cu``, on the
    operands of the reference's ``pallas_call``: V' (N, out, in) from B
    (N, out, k) compressed residual of W, UT (N, k, in), W (out, in)
    updated global and V (N, out, in) float32.  Its launches count in
    ``maecho_v_update_factored.launches``."""
    if W.device.type == "cpu":
        return ref.maecho_v_update_left_ref(B, UT, W, V, frac, norm, eps)
    build.check_f32_cuda("maecho_v_update_left", B=B, UT=UT, W=W, V=V)
    build.require(V.dim() == 3 and B.dim() == 3,
                  f"maecho_v_update_left: V must be (N, out, in) and B (N, out, k), "
                  f"got {tuple(V.shape)}, {tuple(B.shape)}")
    N, out_d, in_d = V.shape
    kd = B.shape[-1]
    build.require(tuple(W.shape) == (out_d, in_d) and tuple(B.shape) == (N, out_d, kd)
                  and tuple(UT.shape) == (N, kd, in_d) and kd >= 1,
                  f"maecho_v_update_left: shapes B {tuple(B.shape)}, UT {tuple(UT.shape)}, "
                  f"W {tuple(W.shape)}, V {tuple(V.shape)} do not match "
                  f"(N, out, k), (N, k, in), (out, in), (N, out, in)")
    build.require(N <= 65535, f"maecho_v_update_left: N={N} exceeds the grid's z limit")
    lib = build.load("maecho_v_update_factored", _FACTORED_SIGS)
    ws = torch.empty(lib.maecho_v_update_factored_workspace_floats(N, out_d, in_d,
                                                                   int(norm)),
                     dtype=torch.float32, device=W.device)
    out = torch.empty_like(V)
    err = lib.maecho_v_update_factored_launch(
        build.ptr(B), build.ptr(UT), build.ptr(W), build.ptr(V), build.ptr(out),
        build.ptr(ws), N, out_d, in_d, kd, float(frac), int(norm), float(eps),
        build.stream())
    build.check(err, "maecho_v_update_factored")
    maecho_v_update_factored.launches += 1
    return out


maecho_v_update_factored.launches = 0

_DIAG_SIGS = {
    "maecho_v_update_diag_launch": (ctypes.c_int, [ctypes.c_void_p] * 4
                                    + [ctypes.c_int] * 3
                                    + [ctypes.c_float, ctypes.c_int,
                                       ctypes.c_float, ctypes.c_void_p]),
}


def maecho_v_update_diag(W, V, p, frac: float, norm: bool = False,
                         eps: float = 1e-12):
    """B9, the wrapper of ``csrc/maecho_v_update_diag.cu`` (port of
    ``repro/kernels/maecho_v_update.py::maecho_v_update_diag``): Eq. 11
    elementwise, Vᵢ' = Vᵢ + Norm((W − Vᵢ)·(1 − frac·pᵢ)), V' (N, out, in)
    from W (out, in) updated global, V (N, out, in) and p (N, in)
    float32; ``norm`` row-normalises the update over the in-axis."""
    if W.device.type == "cpu":
        return ref.maecho_v_update_diag_ref(W, V, p, frac, norm, eps)
    build.check_f32_cuda("maecho_v_update_diag", W=W, V=V, p=p)
    build.require(V.dim() == 3, f"maecho_v_update_diag: V must be (N, out, in), "
                                f"got {tuple(V.shape)}")
    N, out_d, in_d = V.shape
    build.require(N >= 1, f"maecho_v_update_diag: N={N} clients, need at least 1")
    build.require(tuple(W.shape) == (out_d, in_d) and tuple(p.shape) == (N, in_d),
                  f"maecho_v_update_diag: shapes W {tuple(W.shape)}, V {tuple(V.shape)}, "
                  f"p {tuple(p.shape)} do not match (out, in), (N, out, in), (N, in)")
    lib = build.load("maecho_v_update_diag", _DIAG_SIGS)
    out = torch.empty_like(V)
    err = lib.maecho_v_update_diag_launch(build.ptr(W), build.ptr(V), build.ptr(p),
                                          build.ptr(out), N, out_d, in_d,
                                          float(frac), int(norm), float(eps),
                                          build.stream())
    build.check(err, "maecho_v_update_diag")
    maecho_v_update_diag.launches += 1
    return out


maecho_v_update_diag.launches = 0

_STACKED_SIGS = {
    "maecho_v_update_stacked_workspace_floats": (ctypes.c_longlong,
                                                 [ctypes.c_int] * 5),
    "maecho_v_update_stacked_launch": (ctypes.c_int, [ctypes.c_void_p] * 5
                                       + [ctypes.c_int] * 4
                                       + [ctypes.c_float, ctypes.c_int,
                                          ctypes.c_float, ctypes.c_void_p]),
}


def maecho_v_update_stacked(W, V, P, frac: float, norm: bool = False,
                            eps: float = 1e-12):
    """B16, the wrapper of ``csrc/maecho_v_update_stacked.cu`` (port of
    ``repro/kernels/maecho_v_update.py::maecho_v_update_stacked``):
    Eq. 11 per layer, V' (N, L, out, in) from W (L, out, in) updated
    global, V (N, L, out, in) and P (N, L, in, in) float32, one launch
    for all layers; ``norm`` row-normalises each update over in."""
    if W.device.type == "cpu":
        return ref.maecho_v_update_stacked_ref(W, V, P, frac, norm, eps)
    name = "maecho_v_update_stacked"
    build.check_f32_cuda(name, W=W, V=V, P=P)
    N, L, out_d, in_d = build.stacked_dims(name, W, V, P, "full")
    build.require(N * L <= 65535, f"{name}: N*L={N * L} exceeds the grid's z limit")
    lib = build.load(name, _STACKED_SIGS)
    ws = torch.empty(lib.maecho_v_update_stacked_workspace_floats(
        N, L, out_d, in_d, int(norm)), dtype=torch.float32, device=W.device)
    out = torch.empty_like(V)
    err = lib.maecho_v_update_stacked_launch(
        build.ptr(W), build.ptr(V), build.ptr(P), build.ptr(out), build.ptr(ws),
        N, L, out_d, in_d, float(frac), int(norm), float(eps), build.stream())
    build.check(err, name)
    maecho_v_update_stacked.launches += 1
    return out


maecho_v_update_stacked.launches = 0

_DIAG_STACKED_SIGS = {
    "maecho_v_update_diag_stacked_launch": (ctypes.c_int, [ctypes.c_void_p] * 4
                                            + [ctypes.c_int] * 4
                                            + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_void_p]),
}


def maecho_v_update_diag_stacked(W, V, p, frac: float, norm: bool = False,
                                 eps: float = 1e-12):
    """B18, the wrapper of ``csrc/maecho_v_update_diag_stacked.cu`` (port
    of ``repro/kernels/maecho_v_update.py::maecho_v_update_diag_stacked``):
    Eq. 11 per layer, elementwise, V' (N, L, out, in) from W (L, out, in)
    updated global, V (N, L, out, in) and p (N, L, in) float32, one
    launch for all layers."""
    if W.device.type == "cpu":
        return ref.maecho_v_update_diag_stacked_ref(W, V, p, frac, norm, eps)
    name = "maecho_v_update_diag_stacked"
    build.check_f32_cuda(name, W=W, V=V, p=p)
    N, L, out_d, in_d = build.stacked_dims(name, W, V, p, "diag")
    lib = build.load(name, _DIAG_STACKED_SIGS)
    out = torch.empty_like(V)
    err = lib.maecho_v_update_diag_stacked_launch(
        build.ptr(W), build.ptr(V), build.ptr(p), build.ptr(out), N, L, out_d, in_d,
        float(frac), int(norm), float(eps), build.stream())
    build.check(err, name)
    maecho_v_update_diag_stacked.launches += 1
    return out


maecho_v_update_diag_stacked.launches = 0

_FACTORED_STACKED_SIGS = {
    "maecho_v_update_factored_stacked_workspace_floats": (ctypes.c_longlong,
                                                          [ctypes.c_int] * 5),
    "maecho_v_update_factored_stacked_launch": (ctypes.c_int, [ctypes.c_void_p] * 6
                                                + [ctypes.c_int] * 5
                                                + [ctypes.c_float, ctypes.c_int,
                                                   ctypes.c_float, ctypes.c_void_p]),
}


def maecho_v_update_factored_stacked(W, V, U, s, frac: float, norm: bool = False,
                                     eps: float = 1e-12, UT=None):
    """B17 on the reference's operands (port of
    ``repro/kernels/maecho_v_update.py::maecho_v_update_factored_stacked``):
    Eq. 11 per layer for factored Pₗᵢ = Uₗᵢ·diag(sₗᵢ)·Uₗᵢᵀ, V'
    (N, L, out, in) from W (L, out, in) updated global, V (N, L, out, in),
    U (N, L, in, k), s (N, L, k) float32.  As in the reference it forms B,
    the compressed residual of W, itself (one fp32 GEMM, not a kernel),
    and hands B and Uᵀ (``UT`` (N, L, k, in) when the caller already holds
    it) to the kernel through :func:`maecho_v_update_left_stacked`."""
    if W.device.type == "cpu":
        return ref.maecho_v_update_factored_stacked_ref(W, V, U, s, frac, norm, eps)
    name = "maecho_v_update_factored_stacked"
    build.check_f32_cuda(name, W=W, V=V, U=U, s=s)
    build.require(V.dim() == 4 and U.dim() == 4 and s.dim() == 3,
                  f"{name}: V must be (N, L, out, in), U (N, L, in, k) and s (N, L, k), "
                  f"got {tuple(V.shape)}, {tuple(U.shape)}, {tuple(s.shape)}")
    N, L, out_d, in_d = V.shape
    kd = U.shape[-1]
    build.require(tuple(W.shape) == (L, out_d, in_d) and tuple(U.shape) == (N, L, in_d, kd)
                  and tuple(s.shape) == (N, L, kd) and kd >= 1,
                  f"{name}: shapes W {tuple(W.shape)}, V {tuple(V.shape)}, "
                  f"U {tuple(U.shape)}, s {tuple(s.shape)} do not match "
                  f"(L, out, in), (N, L, out, in), (N, L, in, k), (N, L, k)")
    if UT is None:
        UT = U.transpose(-1, -2).contiguous()
    return maecho_v_update_left_stacked(compressed_residual(W, V, U, s), UT, W, V,
                                        frac, norm, eps)


def maecho_v_update_left_stacked(B, UT, W, V, frac: float, norm: bool = False,
                                 eps: float = 1e-12):
    """The B17 kernel, ``csrc/maecho_v_update_factored_stacked.cu``, on the
    operands of the reference's ``pallas_call``: V' (N, L, out, in) from B
    (N, L, out, k) compressed residual of W, UT (N, L, k, in), W
    (L, out, in) updated global and V (N, L, out, in) float32, one launch
    for all layers: a persistent grid of 3xTF32 ``wgmma`` CTAs walking
    the (layer, tile, client) units (plus a row-norm pass when ``norm``).
    Its launches count in ``maecho_v_update_factored_stacked.launches``."""
    if W.device.type == "cpu":
        return ref.maecho_v_update_left_stacked_ref(B, UT, W, V, frac, norm, eps)
    name = "maecho_v_update_left_stacked"
    build.check_f32_cuda(name, B=B, UT=UT, W=W, V=V)
    N, L, out_d, kd, in_d = build.stacked_left_dims(name, B, UT, W=W, V=V)
    lib = build.load("maecho_v_update_factored_stacked", _FACTORED_STACKED_SIGS)
    ws = torch.empty(lib.maecho_v_update_factored_stacked_workspace_floats(
        N, L, out_d, in_d, int(norm)), dtype=torch.float32, device=W.device)
    out = torch.empty_like(V)
    err = lib.maecho_v_update_factored_stacked_launch(
        build.ptr(B), build.ptr(UT), build.ptr(W), build.ptr(V), build.ptr(out),
        build.ptr(ws), N, L, out_d, in_d, kd, float(frac), int(norm), float(eps),
        build.stream())
    build.check(err, "maecho_v_update_factored_stacked")
    maecho_v_update_factored_stacked.launches += 1
    return out


maecho_v_update_factored_stacked.launches = 0
