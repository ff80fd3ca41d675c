"""B4: Eq. 7 global update W' = W + η·(−Σᵢ 2αᵢ (W − Vᵢ)Pᵢ) with dense
Pᵢ — the wrapper of ``csrc/maecho_update.cu`` (port of
``repro/kernels/maecho_update.py::maecho_update``).

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version, ``ref.maecho_update_ref_any``.
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
