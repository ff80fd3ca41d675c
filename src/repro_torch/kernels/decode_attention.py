"""One-token decode attention over the KV ring buffer: B22
(``csrc/decode_attention.cu``, port of
``repro/kernels/decode_attention.py::decode_attention``).

q (B, 1, Hq, D) against caches (B, W, Hkv, D) under a boolean validity
mask (B, W), float32 or bfloat16, fp32 math, the output in q's dtype; a
row with no valid slot returns zeros, as the reference kernel does.  The
kernel splits the window into 128-slot blocks (blocks with no valid slot
are skipped) and combines the blocks' partial softmax states in a second
launch, in a fixed order.  Caches and mask are read through their
strides, so a view cropped along W (the serving loop's ``w_live``) is
read in place, with no copy; any W is taken.

On a CUDA tensor :func:`decode_attention` launches the kernel (or
raises); on a CPU tensor it runs the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_SIGS = {
    "decode_attention_workspace_floats": (ctypes.c_longlong, [ctypes.c_int] * 5),
    "decode_attention_launch": (ctypes.c_int, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                                + [ctypes.c_longlong] * 9 + [ctypes.c_void_p]),
}


def decode_attention(q, k_cache, v_cache, valid_mask):
    """B22: q (B, 1, Hq, D) attends k_cache, v_cache (B, W, Hkv, D) where
    ``valid_mask`` (B, W) is true; head h = hkv · group + g.  Returns
    (B, 1, Hq, D) in q's dtype."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, valid_mask)
    dtype = build.check_attention_cuda("decode_attention", q=q, k_cache=k_cache,
                                       v_cache=v_cache)
    build.require(q.dim() == 4 and k_cache.dim() == 4 and v_cache.shape == k_cache.shape,
                  f"decode_attention: q must be (B, 1, Hq, D) and the caches (B, W, Hkv, D), "
                  f"got {tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, one, Hq, D = q.shape
    _, W, Hkv, _ = k_cache.shape
    build.require(one == 1 and k_cache.shape[0] == B and k_cache.shape[3] == D
                  and min(B, W, Hkv) >= 1 and Hq % Hkv == 0 and Hq // Hkv <= 64
                  and 1 <= D <= 128,
                  f"decode_attention: shapes q {tuple(q.shape)}, caches "
                  f"{tuple(k_cache.shape)} need one token, one B and D, Hq a multiple "
                  f"of Hkv, a group of at most 64 and 1 <= D <= 128")
    build.require(valid_mask.device == q.device and valid_mask.dtype == torch.bool
                  and tuple(valid_mask.shape) == (B, W)
                  and (valid_mask.stride(1) == 1 or W == 1),
                  f"decode_attention: valid_mask must be a bool ({B}, {W}) tensor on "
                  f"{q.device} with contiguous slots, got {valid_mask.dtype} "
                  f"{tuple(valid_mask.shape)} on {valid_mask.device}, strides "
                  f"{valid_mask.stride()}")
    lib = build.load("decode_attention", _SIGS)
    ws = torch.empty(lib.decode_attention_workspace_floats(B, W, Hq, Hkv, D),
                     dtype=torch.float32, device=q.device)
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    err = lib.decode_attention_launch(
        build.ptr(q), build.ptr(k_cache), build.ptr(v_cache), build.ptr(valid_mask),
        build.ptr(ws), build.ptr(out), B, W, Hq, Hkv, D, dtype, q.stride(0), q.stride(2),
        *k_cache.stride()[:3], *v_cache.stride()[:3], valid_mask.stride(0), build.stream())
    build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
