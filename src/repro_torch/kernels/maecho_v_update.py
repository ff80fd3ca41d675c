"""B7: Eq. 11 anchor update Vᵢ' = Vᵢ + Norm(Δᵢ − frac·ΔᵢPᵢ),
Δᵢ = W' − Vᵢ, with dense Pᵢ — the wrapper of
``csrc/maecho_v_update.cu`` (port of
``repro/kernels/maecho_v_update.py::maecho_v_update``).

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version, ``ref.maecho_v_update_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

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
