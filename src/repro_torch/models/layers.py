"""Shared neural-net building blocks (pure functions on tensors), the
port of ``repro.models.layers`` used by the dense family.

Attention is the flash-style chunked online softmax in plain PyTorch
(:func:`chunked_attention`); :func:`prefill_attention` dispatches on
``ModelConfig.attn_backend`` to it or to the flash-attention kernel B21,
and :func:`decode_attention` to the dense decode oracle or to the
ring-buffer decode kernel B22.  The KV ring buffer
(:func:`init_kv_cache`, :func:`update_kv_cache`) is updated in place.
Initialisers draw from an explicit ``torch.Generator`` and put the
tensor on the generator's device.
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


BACKENDS = ("oracle", "auto", "kernel")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; valid choices: "
                         + ", ".join(BACKENDS))


def prefill_attention(q, k, v, *, causal: bool = True, q_chunk: int = 512,
                      k_chunk: int = 1024, q_offset: int = 0,
                      backend: str = "auto"):
    """Prefill/train attention with backend dispatch (the contract of
    :func:`chunked_attention`).

    ``backend`` (``ModelConfig.attn_backend``): ``"oracle"`` always runs
    the plain chunked path; ``"kernel"`` runs the flash kernel B21
    (``ops.flash_attention_auto``) whenever the shape is expressible;
    ``"auto"`` takes it on a CUDA tensor and stays on the plain chunked
    path on a CPU one (the reference's interpret rule: the interpreted
    kernel never wins there).  Expressible, as in the reference: causal
    self-attention with Sq == Sk and no query offset, or non-causal with
    Sk a block multiple.  ``"kernel"`` on another shape warns once and
    runs the plain path on a CPU tensor (the reference's behaviour) and
    raises ``ValueError`` on a CUDA one.  B21 has no backward (nor has
    the reference's kernel): train with ``"oracle"``."""
    from repro_torch.kernels import ops

    _check_backend(backend)
    on_card = q.device.type == "cuda"
    if backend == "kernel" or (backend == "auto" and on_card):
        Sq, Sk = q.shape[1], k.shape[1]
        eligible = ((causal and Sq == Sk and q_offset == 0)
                    or (not causal and Sk % ops.DEFAULT_BLOCK == 0))
        if eligible:
            return ops.flash_attention_auto(q, k, v, causal=causal)
        if backend == "kernel":
            msg = (f"prefill attention (Sq={Sq}, Sk={Sk}, causal={causal}, "
                   f"q_offset={q_offset}) is not expressible by the flash kernel B21")
            if on_card:
                raise ValueError(f"{msg}; use attn_backend='oracle' or 'auto'")
            ops.fallback_warn(f"{msg}: running the plain chunked path")
    return chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                             k_chunk=k_chunk, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, valid_mask, *, backend: str = "auto",
                     w_live: int | None = None):
    """Single-token attention against a (ring-buffer) KV cache, with
    backend dispatch.

    q: (B, 1, Hq, D); caches: (B, W, Hkv, D); valid_mask: (B, W) bool.
    ``backend``: ``"oracle"`` runs the dense full-window oracle;
    ``"kernel"`` runs the decode kernel B22 (``ops.decode_attention_auto``)
    whenever W is a block multiple; ``"auto"`` takes it when the window
    is blocked and spans at least two blocks (on a CPU tensor, as under
    the reference's interpreter, only with a ``w_live`` crop).
    ``"kernel"`` on an unblocked W warns once and runs the oracle on a
    CPU tensor and raises ``ValueError`` on a CUDA one.  ``w_live`` is
    the serving loop's bound on written slots: the kernel path crops the
    cache read to it; the oracle ignores it.  A row with no valid slot
    gives zeros on the kernel path and mean(v) on the oracle, as in the
    reference."""
    from repro_torch.kernels import ops

    _check_backend(backend)
    if backend != "oracle":
        W = k_cache.shape[1]
        on_card = q.device.type == "cuda"
        blocked = W % ops.DEFAULT_BLOCK == 0
        wins = W >= 2 * ops.DEFAULT_BLOCK and (on_card or w_live is not None)
        if blocked and (backend == "kernel" or wins):
            return ops.decode_attention_auto(q, k_cache, v_cache, valid_mask, w_live=w_live)
        if backend == "kernel":
            msg = f"decode window W={W} is not a {ops.DEFAULT_BLOCK}-multiple"
            if on_card:
                raise ValueError(f"{msg}: the decode kernel B22 does not take it; use "
                                 f"attn_backend='oracle' or a window from round_window")
            ops.fallback_warn(f"{msg}: running the dense decode oracle")
    return decode_attention_oracle(q, k_cache, v_cache, valid_mask)


def decode_attention_oracle(q, k_cache, v_cache, valid_mask):
    """Dense full-window decode attention (the oracle: one product over
    all W slots whatever the fill), scores in fp32, p cast to the
    cache's dtype before p·v, as the reference's.  A row with no valid
    slot gives mean(v) (softmax over equal NEG_INF scores).

    q: (B, 1, Hq, D); caches: (B, W, Hkv, D); valid_mask: (B, W) bool.
    """
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
    s = torch.where(valid_mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)


# --------------------------------------------------------------------------
# KV cache (ring buffer for sliding-window decode)
# --------------------------------------------------------------------------
def init_kv_cache(batch: int, window: int, n_kv: int, head_dim: int, dtype, device=None):
    shape = (batch, window, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def update_kv_cache(cache, k_new, v_new, position):
    """Insert one token per row at ``position % W`` (ring buffer), **in
    place**: ``cache["k"]`` and ``cache["v"]`` (B, W, Hkv, D), or views
    of a layer-stacked cache, are written where they lie (the reference
    returns a new cache; writing in place saves a copy of the cache per
    layer and step), and the same dict is returned.

    k_new/v_new: (B, 1, Hkv, D); position: a scalar (every row at the same
    absolute position — the lockstep fixed batch) or (B,) per-row
    positions (the continuous-batching slot loop).  Returns
    ``(cache, valid_mask (B, W) bool)``: slot i holds the latest absolute
    position p ≤ position with p ≡ i (mod W), valid iff p ≥ 0 and
    p > position − W.
    """
    kc, vc = cache["k"], cache["v"]
    B, W = kc.shape[0], kc.shape[1]
    pos = torch.as_tensor(position, device=kc.device).long()
    if pos.dim() == 0:
        slot = torch.remainder(pos, W).reshape(1)
        kc.index_copy_(1, slot, k_new.to(kc.dtype))
        vc.index_copy_(1, slot, v_new.to(vc.dtype))
        pos = pos.reshape(1)
    else:
        rows = torch.arange(B, device=kc.device)
        slot = torch.remainder(pos, W)
        kc[rows, slot] = k_new[:, 0].to(kc.dtype)
        vc[rows, slot] = v_new[:, 0].to(vc.dtype)
    pos = pos[:, None]
    idx = torch.arange(W, device=kc.device)[None, :]
    last_abs = pos - torch.remainder(pos - idx, W)       # latest abs position per slot
    valid = (last_abs >= 0) & (last_abs > pos - W)
    return cache, valid.expand(B, W)


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
