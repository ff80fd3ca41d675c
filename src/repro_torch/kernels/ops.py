"""Dispatch layer of the fused streaming MA-Echo pipeline.

``core.maecho``'s kernel route calls :func:`maecho_streaming_gram`
(the Eq. 6 Gram plus a reuse context) and :func:`maecho_streaming_apply`
(Eq. 7 then Eq. 11) once per leaf per outer iteration.  Both assume
the "oi" layout — ``core.maecho`` transposes "io" leaves first.

On a CUDA tensor, dense (``"full"``) projectors run the CUDA kernels
B1/B4/B7; factored ones ``{"U", "s"}`` B2/B5/B8 (the Gram forms the
compressed residual A and Uᵀ once and hands them to Eq. 7 and Eq. 11
through the reuse context); stacked scalars (N,) and diagonals (N, in)
B3/B6/B9 (the Gram half broadcasts a scalar to an (N, in) diagonal once,
the reference's ``_as_diag``, and hands the diagonal on through the
reuse context).  On a CPU tensor every kernel wrapper runs its plain
version in ``ref``.  Leaves below one 128-tile run the plain oracle.
The CUDA kernels mask ragged edges on out, in and the rank, so no
operand is zero-padded (the reference's ``_pad_to`` /
``_normalize_padded`` / ``_pad_factored`` have no counterpart here).

Stacked leaves — W (L, out, in) with the scan-layer axes flattened to
one L, V and the projector (N, L, …) — take
:func:`maecho_streaming_gram_stacked` and
:func:`maecho_streaming_apply_stacked`: dense projectors run B10/B13/B16,
factored ones ``{"U": (N, L, in, k), "s": (N, L, k)}`` B11/B14/B17 (the
Gram half forms the compressed residual A (N, L, out, k) and Uᵀ once
and hands them on, as the unstacked factored branch does), stacked
scalars (N, L) and diagonals (N, L, in) B12/B15/B18 (the scalar
broadcast once to (N, L, in) in the Gram half), one launch each for all
L layers.

Leaves with a client chunk (``MAEchoConfig.client_chunk``, the
large-cohort mode) take :func:`maecho_streaming_gram_chunked` /
:func:`maecho_streaming_apply_chunked` and their ``_stacked`` forms: the
(N, N) Gram is assembled from chunk-pair blocks with at most two chunks'
residuals alive at once, and Eq. 7 / Eq. 11 sweep the chunks again, so
the (N, out, in) residual never exists.  The residuals and the apply are
torch products, as the reference leaves them to XLA; unstacked
kernel-route leaves contract each chunk pair with B19
(:func:`maecho_gram_cross`), every other chunked leaf with a torch
product.  The last chunk is cut short instead of padded (B19 takes two
chunk sizes).  :func:`rank_downdate` (B20) and :func:`block_rls_update`
are the block-RLS entry points.

The serving path's attention front ends come last:
:func:`flash_attention_auto` (B21, prefill) and
:func:`decode_attention_auto` (B22, one token over the ring-buffer
cache), with the reference's eligibility rules.  Both kernels mask
ragged edges themselves, so nothing is padded (the reference's route
pads to a block multiple and crops, which gives the same result); a
shape the reference's kernel cannot express runs the plain path on a
CPU tensor and raises ``ValueError`` on a CUDA one.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.core.plan import proj_kind
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.maecho_gram import (compressed_residual, maecho_gram,
                                             maecho_gram_cross, maecho_gram_diag,
                                             maecho_gram_diag_stacked,
                                             maecho_gram_left,
                                             maecho_gram_left_stacked,
                                             maecho_gram_stacked)
from repro_torch.kernels.maecho_update import (maecho_update, maecho_update_diag,
                                               maecho_update_diag_stacked,
                                               maecho_update_left,
                                               maecho_update_left_stacked,
                                               maecho_update_stacked)
from repro_torch.kernels.maecho_v_update import (maecho_v_update,
                                                 maecho_v_update_diag,
                                                 maecho_v_update_diag_stacked,
                                                 maecho_v_update_factored,
                                                 maecho_v_update_factored_stacked,
                                                 maecho_v_update_stacked)
from repro_torch.kernels.rank_update import block_rls_update, rank_downdate

# below this edge a leaf runs the plain oracle (the reference's tile
# rule; core.plan's routing keys off the same constant)
DEFAULT_BLOCK = 128

_warned_fallbacks: set[str] = set()


def fallback_warn(msg: str) -> None:
    """``warnings.warn`` once per distinct message: a leaf the caller
    believes is on the kernel path quietly running the oracle is the
    failure mode this surfaces."""
    if msg not in _warned_fallbacks:
        _warned_fallbacks.add(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def maecho_streaming_gram(W, V, P):
    """Gram half of the fused leaf iteration: returns ``(G, ctx)`` with
    G the (N, N) Eq. 6 Gram and ``ctx`` the reuse context for
    :func:`maecho_streaming_apply`."""
    out_d, in_d = W.shape
    if out_d < DEFAULT_BLOCK or in_d < DEFAULT_BLOCK:
        fallback_warn(
            f"leaf (out={out_d}, in={in_d}) below one {DEFAULT_BLOCK}-tile: "
            f"running the plain oracle instead of the streaming kernels")
        return ref.maecho_gram_ref(W, V, P), ("ref", W, V, P)
    kind = proj_kind(P)
    if kind == "full":
        return maecho_gram(W, V, P), (kind, W, V, P)
    if kind == "factored":
        U, s = P["U"], P["s"]
        A = compressed_residual(W, V, U, s)
        UT = U.transpose(1, 2).contiguous()
        return maecho_gram_left(A, UT), (kind, W, V, (U, s, A, UT))
    p = P[:, None].expand(-1, in_d).contiguous() if kind == "scalar" else P
    return maecho_gram_diag(W, V, p), ("diag", W, V, p)


def maecho_streaming_apply(alpha, ctx, *, eta: float = 1.0,
                           frac: float = 0.5, norm: bool = False,
                           eps: float = 1e-12):
    """Update half of the fused leaf iteration: Eq. 7 then Eq. 11 on
    the context from :func:`maecho_streaming_gram`.  Returns
    ``(W', V')``."""
    kind, W, V, P = ctx
    if kind == "full":
        Wn = maecho_update(W, V, P, alpha, eta)
        return Wn, maecho_v_update(Wn, V, P, frac, norm, eps)
    if kind == "factored":
        U, s, A, UT = P
        Wn = maecho_update_left(W, A, UT, alpha, eta)
        return Wn, maecho_v_update_factored(Wn, V, U, s, frac, norm, eps, UT=UT)
    if kind == "diag":
        Wn = maecho_update_diag(W, V, P, alpha, eta)
        return Wn, maecho_v_update_diag(Wn, V, P, frac, norm, eps)
    Wn = ref.maecho_update_ref_any(W, V, P, alpha, eta)
    return Wn, ref.maecho_v_update_ref(Wn, V, P, frac, norm, eps)


def maecho_streaming_gram_stacked(W, V, P):
    """Stacked Gram half: ``(G, ctx)`` with G the (L, N, N) per-layer
    Eq. 6 Grams from one kernel launch and ``ctx`` the reuse context for
    :func:`maecho_streaming_apply_stacked`.  W (L, out, in), V
    (N, L, out, in), P (N, L) scalars, (N, L, in) diagonals,
    (N, L, in, in) dense or factored {"U": (N, L, in, k), "s": (N, L, k)},
    all in the "oi" layout, any out and in (the kernels mask ragged
    edges; the plan sends leaves below one tile to the oracle before
    they get here)."""
    in_d = W.shape[2]
    kind = proj_kind(P, 1)
    if kind == "factored":
        U, s = P["U"], P["s"]
        A = compressed_residual(W, V, U, s)               # (N, L, out, k)
        UT = U.transpose(-1, -2).contiguous()             # (N, L, k, in)
        return maecho_gram_left_stacked(A, UT), (kind, W, V, (U, s, A, UT))
    if kind == "full":
        return maecho_gram_stacked(W, V, P), (kind, W, V, P)
    p = P[:, :, None].expand(-1, -1, in_d).contiguous() if kind == "scalar" else P
    return maecho_gram_diag_stacked(W, V, p), ("diag", W, V, p)


def maecho_streaming_apply_stacked(alpha, ctx, *, eta: float = 1.0,
                                   frac: float = 0.5, norm: bool = False,
                                   eps: float = 1e-12):
    """Stacked update half: per-layer Eq. 7 then Eq. 11, one launch each,
    on the context from :func:`maecho_streaming_gram_stacked`.
    ``alpha`` is the (L, N) stack of per-layer solves.  Returns
    ``(W', V')``, (L, out, in) and (N, L, out, in)."""
    kind, W, V, P = ctx
    if kind == "full":
        Wn = maecho_update_stacked(W, V, P, alpha, eta)
        return Wn, maecho_v_update_stacked(Wn, V, P, frac, norm, eps)
    if kind == "factored":
        U, s, A, UT = P
        Wn = maecho_update_left_stacked(W, A, UT, alpha, eta)
        return Wn, maecho_v_update_factored_stacked(Wn, V, U, s, frac, norm, eps, UT=UT)
    Wn = maecho_update_diag_stacked(W, V, P, alpha, eta)
    return Wn, maecho_v_update_diag_stacked(Wn, V, P, frac, norm, eps)


# --------------------------------------------------------------------------
# client-chunked pipeline (the reference's _chunked_* family)
# --------------------------------------------------------------------------
def _chunks(N: int, chunk: int) -> list:
    """[start, stop) client ranges of ``chunk`` clients; the last may be
    short."""
    return [(a, min(a + chunk, N)) for a in range(0, N, chunk)]


def _take(P, a: int, b: int):
    """Clients [a, b) of a stacked projector (factored dicts per entry)."""
    return {k: v[a:b] for k, v in P.items()} if isinstance(P, dict) else P[a:b]


def _chunked_resid(W, Va, Pa, kind: str):
    """Rᵢ = (W − Vᵢ)Pᵢ in fp32 for one client chunk, any projector kind
    in the "oi" layout; a stacked leaf's layer axis rides after the client
    axis.  The only place the chunked pipeline forms residual rows —
    (chunk, […,] out, in), never the whole client axis."""
    delta = (W[None] - Va).float()
    if kind == "full":
        return delta @ Pa.float()
    if kind == "diag":
        return delta * Pa.float()[..., None, :]
    if kind == "scalar":
        return delta * Pa.float()[..., None, None]
    U = Pa["U"].float()
    A = (delta @ U) * Pa["s"].float()[..., None, :]
    return A @ U.transpose(-1, -2)


def _pair_stacked(Ra, Rb):
    """⟨Rₐ, R_b⟩ per layer: (ca, L, D) × (cb, L, D) → (L, ca, cb), one
    batched product (the reference's layer-batched dot_general)."""
    return Ra.transpose(0, 1) @ Rb.permute(1, 2, 0)


def _chunked_gram_core(W, V, P, kind: str, chunk: int, pair):
    """Triangular chunk-pair sweep: the (…, N, N) Gram from (chunk,
    chunk) blocks with at most two chunks' residuals alive — row chunk
    a's residual is formed once and held across its row, each column
    chunk's is dropped after its pair, and the strict lower triangle
    mirrors the upper (an (a, a) block equals its transpose bit for
    bit)."""
    N = V.shape[0]
    lead = 2 if W.dim() == 3 else 1
    shape = tuple(W.shape[:1]) * (lead - 1) + (N, N)
    G = torch.empty(shape, dtype=torch.float32, device=W.device)

    def resid(a, b):
        R = _chunked_resid(W, V[a:b], _take(P, a, b), kind)
        return R.reshape(tuple(R.shape[:lead]) + (-1,))

    bounds = _chunks(N, chunk)
    for ia, (a0, a1) in enumerate(bounds):
        Ra = resid(a0, a1)
        G[..., a0:a1, a0:a1] = pair(Ra, Ra)
        for b0, b1 in bounds[ia + 1:]:
            blk = pair(Ra, resid(b0, b1))
            G[..., a0:a1, b0:b1] = blk
            G[..., b0:b1, a0:a1] = blk.transpose(-1, -2)
        del Ra
    return G


def _chunked_apply_core(alpha, W, V, P, kind: str, chunk: int, *, eta: float,
                        frac: float, norm: bool, eps: float):
    """Chunk-wise Eq. 7 then Eq. 11: the Eq. 7 step accumulates over the
    chunk residuals of the original W, then a second sweep rebuilds each
    chunk's anchors from W'.  ``alpha`` is (N,), or (L, N) on a stacked
    leaf.  Returns (W', V')."""
    N = V.shape[0]
    af = alpha.float()
    acc = torch.zeros(W.shape, dtype=torch.float32, device=W.device)
    for a0, a1 in _chunks(N, chunk):
        Ra = _chunked_resid(W, V[a0:a1], _take(P, a0, a1), kind)
        if W.dim() == 3:
            acc += torch.einsum("la,aloi->loi", af[:, a0:a1], Ra)
        else:
            acc += torch.tensordot(af[a0:a1], Ra, dims=([0], [0]))
        del Ra
    W_new = (W.float() - 2.0 * eta * acc).to(W.dtype)
    del acc
    V_new = torch.empty_like(V)
    for a0, a1 in _chunks(N, chunk):
        Va, Pa = V[a0:a1], _take(P, a0, a1)
        u = (W_new[None] - Va).float() - frac * _chunked_resid(W_new, Va, Pa, kind)
        if norm:
            u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True).clamp_min(eps)
        V_new[a0:a1] = (Va.float() + u).to(V.dtype)
    return W_new, V_new


def maecho_streaming_gram_chunked(W, V, P, *, chunk: int, use_kernel: bool = False):
    """Client-chunked Gram half, the contract of
    :func:`maecho_streaming_gram`: ``(G, ctx)`` with the (N, N) Gram
    accumulated over chunk pairs, so at most two chunks' residuals
    (O(chunk·out·in)) are alive.  ``use_kernel`` contracts each pair with
    B19 (:func:`maecho_gram_cross`), else with its plain version.  "oi"
    layout."""
    kind = proj_kind(P)
    G = _chunked_gram_core(W, V, P, kind, chunk,
                           maecho_gram_cross if use_kernel else ref.maecho_gram_cross_ref)
    return G, (kind, W, V, P, chunk)


def maecho_streaming_apply_chunked(alpha, ctx, *, eta: float = 1.0, frac: float = 0.5,
                                   norm: bool = False, eps: float = 1e-12):
    """Chunked update half on the context from
    :func:`maecho_streaming_gram_chunked`.  Returns ``(W', V')``."""
    kind, W, V, P, chunk = ctx
    return _chunked_apply_core(alpha, W, V, P, kind, chunk, eta=eta, frac=frac,
                               norm=norm, eps=eps)


def maecho_streaming_gram_chunked_stacked(W, V, P, *, chunk: int):
    """Stacked client-chunked Gram half: W (L, out, in), V (N, L, out, in),
    P stacked per kind.  Returns the (L, N, N) Grams (pair blocks batch
    the layer axis through one torch product) and the apply context."""
    kind = proj_kind(P, 1)
    return _chunked_gram_core(W, V, P, kind, chunk, _pair_stacked), (kind, W, V, P, chunk)


# the stacked update half is the same sweep: ``alpha`` is then the (L, N)
# stack of per-layer solves
maecho_streaming_apply_chunked_stacked = maecho_streaming_apply_chunked


# --------------------------------------------------------------------------
# serving attention: B21 (prefill) and B22 (decode)
# --------------------------------------------------------------------------
def _inexpressible(t, msg: str, plain):
    """A shape the reference's kernel cannot express: the reference
    warns once and runs its oracle; the port does so on a CPU tensor and
    raises on a CUDA one (no plain path in the kernel's place)."""
    if t.device.type == "cuda":
        raise ValueError(f"{msg} (on {t.device}; the port runs no plain path in its place)")
    fallback_warn(f"{msg}: running the plain path")
    return plain()


def flash_attention_auto(q, k, v, *, causal: bool = True):
    """Front end of the flash kernel B21 (the reference's pad-to-block
    front end, with no padding: the kernel masks ragged q and kv rows, so
    the reference's ``bq`` / ``bk`` and its non-causal block-multiple
    rule have no counterpart).  Non-causal attention and causal
    self-attention (Sq == Sk) run the kernel at any length; causal with
    Sq != Sk runs the plain chunked attention on a CPU tensor (the
    reference's oracle) and raises on a CUDA one.  Which shapes take the
    kernel at all is decided by the caller, ``layers.prefill_attention``."""
    Sq, Sk = q.shape[1], k.shape[1]
    if not causal or Sq == Sk:
        return flash_attention(q, k, v, causal=causal)

    def plain():
        from repro_torch.models.layers import chunked_attention

        return chunked_attention(q, k, v, causal=causal, q_chunk=min(128, Sq),
                                 k_chunk=min(128, Sk))

    return _inexpressible(q, f"flash attention (Sq={Sq}, Sk={Sk}, causal={causal}) is not "
                             f"expressible by the flash kernel B21", plain)


def decode_window_block(W: int) -> int | None:
    """Largest supported window block dividing W (None: ineligible), the
    reference's rule.  B22 itself works in 128-slot blocks whatever W
    is; this decides eligibility."""
    for bw in (512, 256, DEFAULT_BLOCK):
        if W % bw == 0:
            return bw
    return None


def live_window(w_live: int, W: int) -> int:
    """Round a live-slot upper bound up to a block multiple, capped at W:
    the serving loop's crop of the cache read (every valid slot of a
    ring buffer whose highest written slot is below ``w_live`` lies in
    ``[0, w_live)``)."""
    return min(W, -(-int(w_live) // DEFAULT_BLOCK) * DEFAULT_BLOCK)


def decode_attention_auto(q, k_cache, v_cache, valid_mask, *, w_live: int | None = None):
    """Single-token KV-cache attention through B22 when the window is a
    block multiple.  ``w_live`` (the serving loop's bucketed bound on
    written slots) crops the cache and mask to ``live_window(w_live, W)``
    slots as **views**: their batch stride stays W·Hkv·D, the kernel
    reads them through their strides, and nothing is copied.  An
    unblocked window runs the dense oracle on a CPU tensor (warn-once,
    the reference's fallback) and raises on a CUDA one."""
    W = k_cache.shape[1]
    if w_live is not None:
        wl = live_window(w_live, W)
        if wl < W:
            k_cache, v_cache, valid_mask = k_cache[:, :wl], v_cache[:, :wl], valid_mask[:, :wl]
            W = wl
    if decode_window_block(W) is not None:
        return decode_attention(q, k_cache, v_cache, valid_mask)

    def plain():
        from repro_torch.models.layers import decode_attention_oracle

        return decode_attention_oracle(q, k_cache, v_cache, valid_mask)

    return _inexpressible(q, f"decode window W={W} is not a {DEFAULT_BLOCK}-multiple: "
                             f"the decode kernel B22 does not take it", plain)
