"""B1: Eq. 6 Gram of projected residuals, G[i, j] = ⟨Rᵢ, Rⱼ⟩ with
Rᵢ = (W − Vᵢ)Pᵢ and dense Pᵢ — the wrapper of ``csrc/maecho_gram.cu``
(port of ``repro/kernels/maecho_gram.py::maecho_gram``).

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version, ``ref.maecho_gram_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_SIGS = {
    "maecho_gram_workspace_floats": (ctypes.c_longlong, [ctypes.c_int] * 3),
    "maecho_gram_max_clients": (ctypes.c_int, []),
    "maecho_gram_launch": (ctypes.c_int, [ctypes.c_void_p] * 5
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
}


def maecho_gram(W, V, P):
    """W (out, in), V (N, out, in), P (N, in, in) float32 → the fp32
    (N, N) Gram.  Any out/in (ragged edges are masked in the kernel);
    N up to the kernel's shared-memory cap (54)."""
    if W.device.type == "cpu":
        return ref.maecho_gram_ref(W, V, P)
    build.check_f32_cuda("maecho_gram", W=W, V=V, P=P)
    build.require(V.dim() == 3, f"maecho_gram: V must be (N, out, in), got {tuple(V.shape)}")
    N, out_d, in_d = V.shape
    build.require(tuple(W.shape) == (out_d, in_d) and tuple(P.shape) == (N, in_d, in_d),
                  f"maecho_gram: shapes W {tuple(W.shape)}, V {tuple(V.shape)}, "
                  f"P {tuple(P.shape)} do not match (out, in), (N, out, in), (N, in, in)")
    lib = build.load("maecho_gram", _SIGS)
    build.require(1 <= N <= lib.maecho_gram_max_clients(),
                  f"maecho_gram: N={N} clients outside 1..{lib.maecho_gram_max_clients()}")
    ws = torch.empty(lib.maecho_gram_workspace_floats(N, out_d, in_d),
                     dtype=torch.float32, device=W.device)
    G = torch.empty((N, N), dtype=torch.float32, device=W.device)
    err = lib.maecho_gram_launch(build.ptr(W), build.ptr(V), build.ptr(P),
                                 build.ptr(ws), build.ptr(G), N, out_d, in_d,
                                 build.stream())
    build.check(err, "maecho_gram")
    maecho_gram.launches += 1
    return G


maecho_gram.launches = 0
