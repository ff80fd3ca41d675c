"""Eq. 6 Gram of projected residuals, G[i, j] = ⟨Rᵢ, Rⱼ⟩: B1 for dense
Pᵢ (Rᵢ = (W − Vᵢ)Pᵢ, ``csrc/maecho_gram.cu``, port of
``repro/kernels/maecho_gram.py::maecho_gram``) and B2 for factored
Pᵢ = Uᵢ·diag(sᵢ)·Uᵢᵀ (Rᵢ = Aᵢ @ UTᵢ, ``csrc/maecho_gram_left.cu``, port
of ``maecho_gram_left``), plus the compressed residual A both factored
passes start from; and B3 for diagonal Pᵢ = diag(pᵢ) (Rᵢ = (W − Vᵢ)·pᵢ,
``csrc/maecho_gram_diag.cu``, port of ``maecho_gram_diag``); and the
stacked twins of B1, B2 and B3 for scan-stacked leaves, one launch for
all layers: B10 (``csrc/maecho_gram_stacked.cu``, port of
``maecho_gram_stacked``), B11 (``csrc/maecho_gram_left_stacked.cu``, port
of ``maecho_gram_left_stacked``) and B12
(``csrc/maecho_gram_diag_stacked.cu``, port of
``maecho_gram_diag_stacked``).

And B19 (``csrc/maecho_gram_cross.cu``, port of ``maecho_gram_cross``):
the cross-Gram block ⟨Raᵢ, Rbⱼ⟩ of two client chunks' flat residual rows,
the pair contraction of the client-chunked Gram (``ops``' chunked
pipeline).

Every Gram kernel takes any number of clients N.  B1 forms its residual
tiles by 3xTF32 ``wgmma`` (``csrc/maecho_tf32.cuh``) with the depth split
across the card (``csrc/maecho_splitk.cuh``, shared with B4), then sums
the pairs in fp64 (``csrc/maecho_gram_pairs.cuh``): up to 8 clients each
tile's fix-up and pair sums in one pass, above that B19's fixed-order
contraction (``csrc/maecho_cross.cuh``) of the residual stack.  B2 takes
B1's route on the left form of the stage (Aᵢ and UTᵢ, depth k), a CTA a
(tile, client) unit when the units fit one wave.  B3, B11 and
B12: up to 54 clients one CTA per tile parks them all, above that the
client axis is cut into blocks of at most 27 and one CTA takes each pair
of blocks (``csrc/maecho_tile.cuh``).  B10 takes its own route up to 54 clients:
residual tiles formed by 3xTF32 ``wgmma`` (shared with B13 and B16) in a
persistent grid that contracts them against a per-CTA scratch slab, and
the blocked route above.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_SIGS = {
    "maecho_gram_workspace_floats": (ctypes.c_longlong, [ctypes.c_int] * 3),
    "maecho_gram_launch": (ctypes.c_int, [ctypes.c_void_p] * 5
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
}


def maecho_gram(W, V, P):
    """W (out, in), V (N, out, in), P (N, in, in) float32 → the fp32
    (N, N) Gram.  Any out/in (ragged edges are masked in the kernel)
    and any N.  The workspace holds the residual tiles, two partial
    128 x 128 tiles per SM and the pair sums' partials."""
    if W.device.type == "cpu":
        return ref.maecho_gram_ref(W, V, P)
    build.check_f32_cuda("maecho_gram", W=W, V=V, P=P)
    build.require(V.dim() == 3, f"maecho_gram: V must be (N, out, in), got {tuple(V.shape)}")
    N, out_d, in_d = V.shape
    build.require(tuple(W.shape) == (out_d, in_d) and tuple(P.shape) == (N, in_d, in_d),
                  f"maecho_gram: shapes W {tuple(W.shape)}, V {tuple(V.shape)}, "
                  f"P {tuple(P.shape)} do not match (out, in), (N, out, in), (N, in, in)")
    build.require(N >= 1, f"maecho_gram: N={N} clients, need at least 1")
    lib = build.load("maecho_gram", _SIGS)
    n_ws = lib.maecho_gram_workspace_floats(N, out_d, in_d)
    if n_ws < 0:
        raise RuntimeError("maecho_gram: cannot read the device's multiprocessor count")
    ws = torch.empty(n_ws, dtype=torch.float32, device=W.device)
    G = torch.empty((N, N), dtype=torch.float32, device=W.device)
    err = lib.maecho_gram_launch(build.ptr(W), build.ptr(V), build.ptr(P),
                                 build.ptr(ws), build.ptr(G), N, out_d, in_d,
                                 build.stream())
    build.check(err, "maecho_gram")
    maecho_gram.launches += 1
    return G


maecho_gram.launches = 0


# The one GEMM of the factored path that is not a kernel: the reference
# leaves it to XLA as an einsum outside any Pallas kernel, so the port
# leaves it to torch.matmul (fp32; callers keep TF32 off).
compressed_residual = ref.compressed_residual_ref

_LEFT_SIGS = {
    "maecho_gram_left_workspace_floats": (ctypes.c_longlong, [ctypes.c_int] * 4),
    "maecho_gram_left_launch": (ctypes.c_int, [ctypes.c_void_p] * 4
                                + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
}


def maecho_gram_left(A, UT):
    """B2, the wrapper of ``csrc/maecho_gram_left.cu`` (port of
    ``repro/kernels/maecho_gram.py::maecho_gram_left``): the (N, N)
    Gram of Rᵢ = Aᵢ @ UTᵢ from A (N, out, k) and UT (N, k, in) float32.
    Any out/in/k (ragged edges are masked in the kernel) and any N: the
    residual tiles by 3xTF32 ``wgmma`` as B1's, then B1's pair sums in
    fp64.  The workspace holds the residual tiles, partial tiles where
    a CTA's share of the stages cuts a tile, and the pair sums'
    partials."""
    if A.device.type == "cpu":
        return ref.maecho_gram_left_ref(A, UT)
    build.check_f32_cuda("maecho_gram_left", A=A, UT=UT)
    build.require(A.dim() == 3, f"maecho_gram_left: A must be (N, out, k), got {tuple(A.shape)}")
    N, out_d, kd = A.shape
    build.require(UT.dim() == 3 and tuple(UT.shape[:2]) == (N, kd) and kd >= 1,
                  f"maecho_gram_left: shapes A {tuple(A.shape)}, UT {tuple(UT.shape)} "
                  f"do not match (N, out, k), (N, k, in)")
    in_d = UT.shape[2]
    build.require(N >= 1, f"maecho_gram_left: N={N} clients, need at least 1")
    lib = build.load("maecho_gram_left", _LEFT_SIGS)
    n_ws = lib.maecho_gram_left_workspace_floats(N, out_d, in_d, kd)
    if n_ws < 0:
        raise RuntimeError("maecho_gram_left: cannot read the device's multiprocessor count")
    ws = torch.empty(n_ws, dtype=torch.float32, device=A.device)
    G = torch.empty((N, N), dtype=torch.float32, device=A.device)
    err = lib.maecho_gram_left_launch(build.ptr(A), build.ptr(UT), build.ptr(ws),
                                      build.ptr(G), N, out_d, in_d, kd,
                                      build.stream())
    build.check(err, "maecho_gram_left")
    maecho_gram_left.launches += 1
    return G


maecho_gram_left.launches = 0

_DIAG_SIGS = {
    "maecho_gram_diag_workspace_floats": (ctypes.c_longlong, [ctypes.c_int] * 3),
    "maecho_gram_diag_launch": (ctypes.c_int, [ctypes.c_void_p] * 5
                                + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
}


def maecho_gram_diag(W, V, p):
    """B3, the wrapper of ``csrc/maecho_gram_diag.cu`` (port of
    ``repro/kernels/maecho_gram.py::maecho_gram_diag``): the (N, N)
    Gram of Rᵢ = (W − Vᵢ)·pᵢ from W (out, in), V (N, out, in) and the
    diagonals p (N, in) float32.  Any out/in and any N."""
    if W.device.type == "cpu":
        return ref.maecho_gram_diag_ref(W, V, p)
    build.check_f32_cuda("maecho_gram_diag", W=W, V=V, p=p)
    build.require(V.dim() == 3, f"maecho_gram_diag: V must be (N, out, in), got {tuple(V.shape)}")
    N, out_d, in_d = V.shape
    build.require(tuple(W.shape) == (out_d, in_d) and tuple(p.shape) == (N, in_d),
                  f"maecho_gram_diag: shapes W {tuple(W.shape)}, V {tuple(V.shape)}, "
                  f"p {tuple(p.shape)} do not match (out, in), (N, out, in), (N, in)")
    build.require(N >= 1, f"maecho_gram_diag: N={N} clients, need at least 1")
    lib = build.load("maecho_gram_diag", _DIAG_SIGS)
    ws = torch.empty(lib.maecho_gram_diag_workspace_floats(N, out_d, in_d),
                     dtype=torch.float32, device=W.device)
    G = torch.empty((N, N), dtype=torch.float32, device=W.device)
    err = lib.maecho_gram_diag_launch(build.ptr(W), build.ptr(V), build.ptr(p),
                                      build.ptr(ws), build.ptr(G), N, out_d, in_d,
                                      build.stream())
    build.check(err, "maecho_gram_diag")
    maecho_gram_diag.launches += 1
    return G


maecho_gram_diag.launches = 0

_STACKED_SIGS = {
    "maecho_gram_stacked_workspace_floats": (ctypes.c_longlong, [ctypes.c_int] * 4),
    "maecho_gram_stacked_launch": (ctypes.c_int, [ctypes.c_void_p] * 5
                                   + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
}


def _gram_stacked_launch(name: str, sigs: dict, W, V, P, kind: str):
    """Launch B10 or B12 (``name``) on a checked stacked leaf and return
    the (L, N, N) Grams."""
    build.check_f32_cuda(name, W=W, V=V, P=P)
    N, L, out_d, in_d = build.stacked_dims(name, W, V, P, kind)
    build.require(L <= 65535, f"{name}: L={L} layers exceeds the grid's limit")
    lib = build.load(name, sigs)
    n_ws = getattr(lib, f"{name}_workspace_floats")(N, L, out_d, in_d)
    if n_ws < 0:
        raise RuntimeError(f"{name}: cannot read the device's multiprocessor count")
    ws = torch.empty(n_ws, dtype=torch.float32, device=W.device)
    G = torch.empty((L, N, N), dtype=torch.float32, device=W.device)
    err = getattr(lib, f"{name}_launch")(build.ptr(W), build.ptr(V), build.ptr(P),
                                         build.ptr(ws), build.ptr(G), N, L, out_d,
                                         in_d, build.stream())
    build.check(err, name)
    return G


def maecho_gram_stacked(W, V, P):
    """B10, the wrapper of ``csrc/maecho_gram_stacked.cu`` (port of
    ``repro/kernels/maecho_gram.py::maecho_gram_stacked``): the
    (L, N, N) per-layer Grams of Rₗᵢ = (Wₗ − Vᵢₗ)Pᵢₗ from W (L, out, in),
    V (N, L, out, in) and dense P (N, L, in, in) float32, one launch for
    all L layers.  Any out/in and any N: up to 54 clients the residual
    products run as 3xTF32 on the tensor cores (the workspace then holds
    the tile partials and one (N - 1)-tile scratch slab per SM), past 54
    the SIMT client-blocked route."""
    if W.device.type == "cpu":
        return ref.maecho_gram_stacked_ref(W, V, P)
    G = _gram_stacked_launch("maecho_gram_stacked", _STACKED_SIGS, W, V, P, "full")
    maecho_gram_stacked.launches += 1
    return G


maecho_gram_stacked.launches = 0

_DIAG_STACKED_SIGS = {
    "maecho_gram_diag_stacked_workspace_floats": (ctypes.c_longlong,
                                                  [ctypes.c_int] * 4),
    "maecho_gram_diag_stacked_launch": (ctypes.c_int, [ctypes.c_void_p] * 5
                                        + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
}


def maecho_gram_diag_stacked(W, V, p):
    """B12, the wrapper of ``csrc/maecho_gram_diag_stacked.cu`` (port of
    ``repro/kernels/maecho_gram.py::maecho_gram_diag_stacked``): the
    (L, N, N) per-layer Grams of Rₗᵢ = (Wₗ − Vᵢₗ)·pᵢₗ from W (L, out, in),
    V (N, L, out, in) and the diagonals p (N, L, in) float32, one launch
    for all L layers.  Any out/in and any N."""
    if W.device.type == "cpu":
        return ref.maecho_gram_diag_stacked_ref(W, V, p)
    G = _gram_stacked_launch("maecho_gram_diag_stacked", _DIAG_STACKED_SIGS,
                             W, V, p, "diag")
    maecho_gram_diag_stacked.launches += 1
    return G


maecho_gram_diag_stacked.launches = 0

_LEFT_STACKED_SIGS = {
    "maecho_gram_left_stacked_workspace_floats": (ctypes.c_longlong, [ctypes.c_int] * 4),
    "maecho_gram_left_stacked_launch": (ctypes.c_int, [ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
}


def maecho_gram_left_stacked(A, UT):
    """B11, the wrapper of ``csrc/maecho_gram_left_stacked.cu`` (port of
    ``repro/kernels/maecho_gram.py::maecho_gram_left_stacked``): the
    (L, N, N) per-layer Grams of Rₗᵢ = Aₗᵢ @ UTₗᵢ from the compressed
    residual A (N, L, out, k) and UT (N, L, k, in) float32, one launch
    for all L layers.  Any out/in/k and any N."""
    if A.device.type == "cpu":
        return ref.maecho_gram_left_stacked_ref(A, UT)
    name = "maecho_gram_left_stacked"
    build.check_f32_cuda(name, A=A, UT=UT)
    N, L, out_d, kd, in_d = build.stacked_left_dims(name, A, UT)
    lib = build.load(name, _LEFT_STACKED_SIGS)
    ws = torch.empty(lib.maecho_gram_left_stacked_workspace_floats(N, L, out_d, in_d),
                     dtype=torch.float32, device=A.device)
    G = torch.empty((L, N, N), dtype=torch.float32, device=A.device)
    err = lib.maecho_gram_left_stacked_launch(build.ptr(A), build.ptr(UT), build.ptr(ws),
                                              build.ptr(G), N, L, out_d, in_d, kd,
                                              build.stream())
    build.check(err, name)
    maecho_gram_left_stacked.launches += 1
    return G


maecho_gram_left_stacked.launches = 0

_CROSS_SIGS = {
    "maecho_gram_cross_workspace_floats": (ctypes.c_longlong, [ctypes.c_int] * 2
                                           + [ctypes.c_longlong]),
    "maecho_gram_cross_launch": (ctypes.c_int, [ctypes.c_void_p] * 4
                                 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                                 + [ctypes.c_void_p]),
}


def maecho_gram_cross(Ra, Rb):
    """B19, the wrapper of ``csrc/maecho_gram_cross.cu`` (port of
    ``repro/kernels/maecho_gram.py::maecho_gram_cross``): the fp32
    (ca, cb) block G[i, j] = ⟨Raᵢ, Rbⱼ⟩ of two client chunks' flat
    residual rows Ra (ca, D) and Rb (cb, D) float32 — any ca, cb and D
    (the ragged end of D is masked, not padded); Ra and Rb may be the
    same tensor."""
    if Ra.device.type == "cpu":
        return ref.maecho_gram_cross_ref(Ra, Rb)
    build.check_f32_cuda("maecho_gram_cross", Ra=Ra, Rb=Rb)
    build.require(Ra.dim() == 2 and Rb.dim() == 2 and Ra.shape[1] == Rb.shape[1],
                  f"maecho_gram_cross: shapes Ra {tuple(Ra.shape)}, Rb {tuple(Rb.shape)} "
                  f"do not match (ca, D), (cb, D)")
    (ca, D), cb = Ra.shape, Rb.shape[0]
    build.require(min(ca, cb, D) >= 1 and ca * cb < 2 ** 31,
                  f"maecho_gram_cross: ca={ca}, cb={cb}, D={D}: need each >= 1 "
                  f"and ca*cb < 2**31")
    lib = build.load("maecho_gram_cross", _CROSS_SIGS)
    ws = torch.empty(lib.maecho_gram_cross_workspace_floats(ca, cb, D),
                     dtype=torch.float32, device=Ra.device)
    G = torch.empty((ca, cb), dtype=torch.float32, device=Ra.device)
    err = lib.maecho_gram_cross_launch(build.ptr(Ra), build.ptr(Rb), build.ptr(ws),
                                       build.ptr(G), ca, cb, D, build.stream())
    build.check(err, "maecho_gram_cross")
    maecho_gram_cross.launches += 1
    return G


maecho_gram_cross.launches = 0
