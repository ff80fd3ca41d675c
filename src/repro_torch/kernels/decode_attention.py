"""One-token decode attention over the KV ring buffer: B22
(``csrc/decode_attention.cu``, port of
``repro/kernels/decode_attention.py::decode_attention``).

q (B, 1, Hq, D) against caches (B, W, Hkv, D) under a boolean validity
mask (B, W), float32 or bfloat16, fp32 math, the output in q's dtype; a
row with no valid slot returns zeros, as the reference kernel does.  One
launch: a thread block cluster per (batch row, kv head) whose CTAs cut
the window into contiguous runs (:func:`window_split`), each walking its
run with an online softmax (sub-blocks with no valid slot are skipped),
then combine their softmax states through distributed shared memory in
rank order.  No workspace, no second launch.  Caches and mask are read
through their strides, so a view cropped along W (the serving loop's
``w_live``) is read in place, with no copy; any W is taken.

On a CUDA tensor :func:`decode_attention` launches the kernel (or
raises); on a CPU tensor it runs the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_SIGS = {
    "decode_attention_launch": (ctypes.c_int, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                                + [ctypes.c_longlong] * 9 + [ctypes.c_void_p]),
}

MAX_CLUSTER = 8      # the portable cluster size
RUN_SLOTS = 64       # slots a CTA aims for before the cluster grows


def window_split(W: int) -> tuple[int, int]:
    """(CTAs a cluster, slots a CTA) for a window of W slots: CTA rank r
    owns the slots [r · run, (r + 1) · run)."""
    ctas = max(1, min(MAX_CLUSTER, -(-W // RUN_SLOTS)))
    return ctas, -(-W // ctas)


def sub_block(D: int, itemsize: int) -> int:
    """Slots a CTA stages at once: 128, or 64 where a row of D zero-filled
    to 64 or 128 takes more than 256 bytes (fp32 at D > 64)."""
    return 128 if (64 if D <= 64 else 128) * itemsize <= 256 else 64


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
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    ctas, run = window_split(W)
    err = lib.decode_attention_launch(
        build.ptr(q), build.ptr(k_cache), build.ptr(v_cache), build.ptr(valid_mask),
        build.ptr(out), B, W, Hq, Hkv, D, ctas, run, dtype, q.stride(0), q.stride(2),
        *k_cache.stride()[:3], *v_cache.stride()[:3], valid_mask.stride(0), build.stream())
    build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
