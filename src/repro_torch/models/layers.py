"""Shared neural-net building blocks (pure functions on tensors), the
port of ``repro.models.layers`` used by the dense family.

Attention is the flash-style chunked online softmax in plain PyTorch
(:func:`chunked_attention`); :func:`prefill_attention` dispatches on
``ModelConfig.attn_backend``, and its kernel, the flash-attention
kernel B21, is ROADMAP item A10 (with serving, the decode attention
B22 and the KV ring buffer).  Initialisers draw from an explicit
``torch.Generator`` and put the tensor on the generator's device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# --------------------------------------------------------------------------
# initialisers
# --------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None, lead: tuple = ()):
    """N(0, scale²) weights of shape ``lead + (d_in, d_out)`` (``scale``
    defaults to 1/√d_in), on ``gen``'s device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    x = torch.randn(tuple(lead) + (d_in, d_out), generator=gen, device=gen.device)
    return (x * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype):
    return (torch.randn((vocab, d), generator=gen, device=gen.device) * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rms_norm(x, gamma, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * gamma.to(dt)


# --------------------------------------------------------------------------
# rotary position embedding (half-split rotation)
# --------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S) integer."""
    D = x.shape[-1]
    freqs = rope_frequencies(D, theta, x.device)               # (D/2,)
    angles = positions[..., None].float() * freqs              # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).to(x.dtype)


# --------------------------------------------------------------------------
# attention — chunked online-softmax (training / prefill)
# --------------------------------------------------------------------------
def _repeat_kv(k, n_rep: int):
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D)."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def chunked_attention(q, k, v, *, causal: bool = True, q_chunk: int = 512,
                      k_chunk: int = 1024, q_offset: int = 0):
    """Flash-style attention in plain PyTorch, fp32 scores and sums.

    q: (B, Sq, Hq, D);  k, v: (B, Sk, Hkv, D) with Hq % Hkv == 0.
    ``q_offset`` is the absolute position of q[0].  Returns
    (B, Sq, Hq, D) in q's dtype.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    n_rep = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    q_chunk, k_chunk = min(q_chunk, Sq), min(k_chunk, Sk)
    k_r, v_r = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    if q_chunk >= Sq and k_chunk >= Sk:
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_r.float()) * scale
        if causal:
            q_pos = q_offset + torch.arange(Sq, device=dev)
            mask = q_pos[:, None] >= torch.arange(Sk, device=dev)[None, :]
            s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v_r.float())
        return out.to(q.dtype)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        q_c = q[:, q0:q0 + q_chunk].float()
        qpos = q_offset + q0 + torch.arange(q_c.shape[1], device=dev)
        acc = torch.zeros((B, Hq, q_c.shape[1], D), device=dev)
        m = torch.full((B, Hq, q_c.shape[1]), NEG_INF, device=dev)
        l = torch.zeros((B, Hq, q_c.shape[1]), device=dev)
        for k0 in range(0, Sk, k_chunk):
            k_c = k_r[:, k0:k0 + k_chunk]
            v_c = v_r[:, k0:k0 + k_chunk]
            s = torch.einsum("bqhd,bkhd->bhqk", q_c, k_c.float()) * scale
            if causal:
                kpos = k0 + torch.arange(k_c.shape[1], device=dev)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v_c.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append((acc / l[..., None].clamp_min(1e-30)).transpose(1, 2))
    return torch.cat(outs, 1).to(q.dtype)


def prefill_attention(q, k, v, *, causal: bool = True, q_chunk: int = 512,
                      k_chunk: int = 1024, q_offset: int = 0,
                      backend: str = "auto"):
    """Prefill/train attention with backend dispatch (the contract of
    :func:`chunked_attention`).  ``backend="oracle"`` runs the plain
    chunked path, as does ``"auto"`` on the CPU (the reference's
    interpret rule).  ``"kernel"``, and ``"auto"`` on a CUDA device,
    would take the flash-attention kernel B21, which is not ported: they
    raise rather than run the plain path in its place."""
    if backend not in ("oracle", "auto", "kernel"):
        raise ValueError(f"unknown attention backend {backend!r}; valid "
                         f"choices: oracle, auto, kernel")
    if backend == "kernel" or (backend == "auto" and q.device.type == "cuda"):
        raise NotImplementedError(
            f"attn_backend={backend!r} on {q.device.type} needs the flash-"
            f"attention kernel B21, which is not ported yet (ROADMAP item "
            f"A10); use attn_backend='oracle'")
    return chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                             k_chunk=k_chunk, q_offset=q_offset)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def softmax_xent(logits, labels, mask=None):
    """Mean token-level cross entropy; labels (…,) integer; mask same
    shape as labels."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
