"""Flash attention for prefill: B21 (``csrc/flash_attention.cu``, port of
``repro/kernels/flash_attention.py::flash_attention``).

Causal or non-causal GQA attention over q (B, Sq, Hq, D) and k, v
(B, Sk, Hkv, D), float32 or bfloat16, fp32 scores and sums, the output
in q's dtype.  bfloat16 runs on the tensor cores (q·kᵀ exact with fp32
accumulation, p·v with the fp32 p split into three bf16 terms); float32
runs a SIMT fp32 body.  The kernel reads the (B, S, H, D) layout
through its strides and masks ragged sequence lengths itself, so
nothing is transposed or padded; D ≤ 128.

The reference has no backward kernel (``flash_attention.py`` defines no
``custom_vjp``), so B21 is forward-only: it is reached through a
``torch.autograd.Function`` whose backward raises.  Training runs
``attn_backend="oracle"``.

On a CUDA tensor :func:`flash_attention` launches the kernel (or
raises); on a CPU tensor it runs the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_SIGS = {
    "flash_attention_launch": (ctypes.c_int, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                               + [ctypes.c_longlong] * 9 + [ctypes.c_void_p]),
}


def _forward(q, k, v, causal: bool):
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    dtype = build.check_attention_cuda("flash_attention", q=q, k=k, v=v)
    build.require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
                  f"flash_attention: q must be (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D), got "
                  f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    build.require(k.shape[0] == B and k.shape[3] == D and min(B, Sq, Sk, Hkv) >= 1
                  and Hq % Hkv == 0 and 1 <= D <= 128,
                  f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)} need one "
                  f"B and D, Hq a multiple of Hkv and 1 <= D <= 128")
    lib = build.load("flash_attention", _SIGS)
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    err = lib.flash_attention_launch(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), B, Sq, Sk, Hq, Hkv, D,
        int(causal), dtype, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], build.stream())
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "flash_attention (B21) has no backward: the reference kernel "
            "(src/repro/kernels/flash_attention.py) has no backward kernel either; "
            "train with attn_backend='oracle'")


def flash_attention(q, k, v, *, causal: bool = True):
    """B21: attention of q (B, Sq, Hq, D) over k, v (B, Sk, Hkv, D), kv
    head = q head // (Hq / Hkv), causal or not; returns (B, Sq, Hq, D) in
    q's dtype.  Forward only."""
    return _FlashAttention.apply(q, k, v, causal)


flash_attention.launches = 0
