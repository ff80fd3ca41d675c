"""MA-Echo — Algorithm 1 of the paper, on PyTorch tensors.

Operates on *pytrees of layers*: each client contributes a pytree of
weight leaves plus a structurally matching pytree of projector leaves.

  W⁽⁰⁾ = init (vanilla average by default);  Vᵢ = Wᵢ
  repeat τ times, per layer l:
      Rᵢ  = (W − Vᵢ) Pᵢ                    (residual in client i's row space)
      α*  = argmin ½‖Σᵢ 2αᵢ Rᵢ‖²  on the capped simplex   (Eq. 6)
      W  += η · ( −Σᵢ 2αᵢ* Rᵢ )                            (Eq. 7)
      Vᵢ += Norm( (W − Vᵢ)(I − μ/(1+μ) Pᵢ) )              (Eq. 11)

Projector leaves may be a scalar (the bias rule), 1-D diagonal on the
in-axis, a dense (in, in) matrix (the paper's form) or factored
``{"U": (in, k), "s": (k,)}`` with P = U·diag(s)·Uᵀ.  Weight leaves
follow ``convention="oi"`` (W is (out, in), the paper models) or
``"io"``.

Backends (:func:`maecho_aggregate`'s ``backend``):

  - ``"oracle"``: the plain PyTorch reference path — materializes the
    (N, out, in) residual per leaf per iteration.
  - ``"kernel"``: leaves with min(out, in) ≥ 128 run the fused
    streaming pipeline (``kernels.ops``): on a CUDA tensor the
    hand-written kernels B1 (Gram), B4 (Eq. 7) and B7 (Eq. 11) for
    dense projectors, B2, B5 and B8 for factored ones, B3, B6 and B9
    for scalar and diagonal ones; on a leaf with leading stacked-layer
    axes (``stack_levels``) their stacked twins B10/B13/B16, B11/B14/B17
    and B12/B15/B18, one launch per leaf for all its layers.  Smaller
    leaves and 1-D biases run the oracle, batched over layer axes.
  - ``"auto"``: the same routing without fallback warnings.

``MAEchoConfig.client_chunk`` > 0 (the large-cohort mode) sweeps every
eligible leaf's client axis in chunks on any route (``kernels.ops``'
chunked pipeline): at most two chunks' residuals are alive, and
unstacked kernel-route leaves contract chunk pairs with B19.

Routing is compiled once by ``core.plan.compile_plan``; the τ-loop
below is a plain Python loop over that plan.  With
``MAEchoConfig.qp_batched`` (default) each iteration stacks every
leaf's (and every scanned layer's) (N, N) Gram and solves all QPs in
one batched PGD; otherwise one PGD per leaf.  Nothing inside the loop
reads a value back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core import qp as qp_mod
from repro_torch.core.plan import LeafPlan, compile_plan, validate_backend
from repro_torch.kernels import ops, ref
from repro_torch.utils import trees
from repro_torch.utils.device import resolve_device

Pytree = Any


@dataclasses.dataclass(frozen=True)
class MAEchoConfig:
    tau: int = 30                 # outer iterations
    eta: float = 1.0              # step size on W
    C: float = 1.0                # simplex cap (paper: C ∈ [1/N, 1])
    mu: float = 1.0               # Eq. 8 penalty; factor μ/(1+μ)
    norm: bool = False            # Norm(·) row-normalisation of V updates
    qp_iters: int = 200
    init: str = "average"         # average | first | random
    eps: float = 1e-12
    qp_batched: bool = True       # one stacked PGD solve per outer iter
    mesh_axis: str = "data"       # sharded backends (ROADMAP A11)
    mesh_in_axis: str = "model"   # sharded2d backend (ROADMAP A11)
    # the reference's Pallas tile edge; no effect here — the CUDA
    # kernels tile at their own 32-wide edge and mask ragged edges
    kernel_block: int = 0
    # client-axis chunk of the Gram/apply sweeps; 0 = unchunked.  Clamped to N per leaf at plan time.
    client_chunk: int = 0


# --------------------------------------------------------------------------
# per-leaf algebra
# --------------------------------------------------------------------------
def _apply_P(delta, P, convention: str, nb: int = 1):
    """Δᵢ·Pᵢ for every client at once.  ``delta`` carries ``nb`` leading
    batch axes — the client axis, preceded on a stacked leaf by its
    layer axis — and ``P`` the same ones before its kind axes: scalars
    (…,), diagonals (…, in), dense (…, in, in) or factored
    {"U": (…, in, k), "s": (…, k)}.  1-D per-client leaves (biases)
    contract their only axis."""
    vec = delta.dim() == nb + 1
    if isinstance(P, dict):
        U, s = P["U"], P["s"]
        Ut = U.transpose(-1, -2)
        if vec:
            return (((delta.unsqueeze(-2) @ U) * s.unsqueeze(-2)) @ Ut).squeeze(-2)
        if convention == "oi":
            return ((delta @ U) * s.unsqueeze(-2)) @ Ut   # (out,k)·(k)·(k,in)
        return U @ (s.unsqueeze(-1) * (Ut @ delta))
    kd = P.dim() - nb
    if kd == 0:                                         # scalar (bias rule)
        return delta * P.reshape(P.shape + (1,) * (delta.dim() - nb))
    if kd == 1:                                         # diagonal on in-axis
        if vec:
            return delta * P
        return delta * (P.unsqueeze(-2) if convention == "oi" else P.unsqueeze(-1))
    if vec:                                             # dense
        return (delta.unsqueeze(-2) @ P).squeeze(-2)
    return delta @ P if convention == "oi" else P @ delta


def _flatten_stack(W, V, P, levels: int):
    """Collapse ``levels`` leading stacked-layer axes into one flat L
    axis (one reshape).  Returns ``(Wf, Vf, Pf, lead)`` with Wf (L, …),
    Vf (N, L, …), Pf stacked per kind, and ``lead`` the original
    leading shape for un-flattening."""
    lead = tuple(W.shape[:levels])
    Wf = W.reshape((-1,) + tuple(W.shape[levels:]))

    def flat(x):
        return x.reshape(tuple(x.shape[:1]) + (-1,) + tuple(x.shape[1 + levels:]))

    Pf = {k: flat(v) for k, v in P.items()} if isinstance(P, dict) else flat(P)
    return Wf, flat(V), Pf, lead


def _layer_major(x):
    """(N, L, …) → a (L, N, …) view (factored dicts per entry)."""
    if isinstance(x, dict):
        return {k: v.transpose(0, 1) for k, v in x.items()}
    return x.transpose(0, 1)


def _to_kernel_layout(W, V, P, convention: str, levels: int = 0):
    """The streaming kernels are "oi"-native and need contiguous
    operands: "io" leaves are transposed (and copied) around the call;
    stacked leaves transpose their trailing two axes only.  A leaf whose
    last kernel call returned its outputs as transposed views is already
    contiguous in the kernel layout and is not copied again."""
    if convention != "io":
        return W, V, P
    Pk = (P.transpose(-1, -2).contiguous()
          if not isinstance(P, dict) and P.dim() == 3 + levels else P)
    return (W.transpose(-1, -2).contiguous(), V.transpose(-1, -2).contiguous(), Pk)


def _oracle_gram(W, V, P, convention: str, levels: int):
    """Plain Gram half: the residual R, batched over a stacked leaf's
    (flattened) layer axis, and G = R·Rᵀ per layer.  Returns ``(G, R)``
    with G (lead…, N, N) and R the reuse context ((L, N, …) if
    stacked)."""
    if levels == 0:
        R = _apply_P(W[None] - V, P, convention)
        Rf = R.reshape(R.shape[0], -1).float()
        return Rf @ Rf.T, R
    Wf, Vf, Pf, lead = _flatten_stack(W, V, P, levels)
    R = _apply_P(Wf[:, None] - _layer_major(Vf), _layer_major(Pf), convention, nb=2)
    Rf = R.reshape(R.shape[0], R.shape[1], -1).float()
    return (Rf @ Rf.transpose(1, 2)).reshape(lead + tuple(Rf.shape[1:2]) * 2), R


def _oracle_apply(W, V, P, R, alpha, convention: str, levels: int, *,
                  eta: float, frac: float, norm: bool, eps: float):
    """Plain apply half: Eq. 7 from the cached residual, then Eq. 11,
    batched over a stacked leaf's (flattened) layer axis."""
    if levels == 0:
        D = -2.0 * torch.tensordot(alpha, R.float(), dims=([0], [0]))
        W_new = (W.float() + eta * D).to(W.dtype)
        return W_new, ref.maecho_v_update_ref(W_new, V, P, frac, norm, eps,
                                              convention)
    Wf, Vf, Pf, lead = _flatten_stack(W, V, P, levels)
    af = alpha.reshape(-1, alpha.shape[-1]).float()
    D = -2.0 * (af.reshape(af.shape + (1,) * (R.dim() - 2)) * R.float()).sum(1)
    Wn = (Wf.float() + eta * D).to(W.dtype)
    Vn = ref.maecho_v_update_ref(Wn[:, None], _layer_major(Vf), _layer_major(Pf),
                                 frac, norm, eps, convention, nb=2)
    Vn = Vn.transpose(0, 1)
    return (Wn.reshape(lead + tuple(Wn.shape[1:])),
            Vn.reshape(tuple(Vn.shape[:1]) + lead + tuple(Vn.shape[2:])))


def _leaf_gram_chunked(W, V, P, lp: LeafPlan, convention: str):
    """Gram half of a leaf with a client chunk: the Gram accumulates
    over chunk pairs (O(chunk) residuals alive), on the "oi" kernel
    layout whatever the route; only unstacked kernel-route leaves
    contract the pairs with B19."""
    if lp.levels:
        Wf, Vf, Pf, lead = _flatten_stack(W, V, P, lp.levels)
        G, ctx = ops.maecho_streaming_gram_chunked_stacked(
            *_to_kernel_layout(Wf, Vf, Pf, convention, levels=1), chunk=lp.client_chunk)
        return G.reshape(lead + tuple(G.shape[-2:])), (lead, ctx)
    return ops.maecho_streaming_gram_chunked(
        *_to_kernel_layout(W, V, P, convention), chunk=lp.client_chunk,
        use_kernel=lp.route == "kernel")


def _leaf_gram(W, V, P, lp: LeafPlan, convention: str):
    """Gram phase for one leaf on its compiled route: returns ``(G,
    ctx)`` — the Gram, (lead…, N, N) on a stacked leaf, and the reuse
    payload for :func:`_leaf_apply` (the oracle's residual, or the
    kernel pipeline's context)."""
    if lp.client_chunk:
        return _leaf_gram_chunked(W, V, P, lp, convention)
    if lp.route == "oracle":
        return _oracle_gram(W, V, P, convention, lp.levels)
    if lp.route == "kernel":
        return ops.maecho_streaming_gram(*_to_kernel_layout(W, V, P, convention))
    Wf, Vf, Pf, lead = _flatten_stack(W, V, P, lp.levels)
    G, ctx = ops.maecho_streaming_gram_stacked(
        *_to_kernel_layout(Wf, Vf, Pf, convention, levels=1))
    return G.reshape(lead + tuple(G.shape[-2:])), (lead, ctx)


def _apply_stacked(apply, alpha, ctx, kw):
    """A stacked leaf's update half through ``apply`` on its flattened
    layer axis, reshaped back to the leaf's lead axes."""
    lead, inner = ctx
    W_new, V_new = apply(alpha.reshape(-1, alpha.shape[-1]), inner, **kw)
    return (W_new.reshape(lead + tuple(W_new.shape[1:])),
            V_new.reshape(tuple(V_new.shape[:1]) + lead + tuple(V_new.shape[2:])))


def _leaf_apply_chunked(alpha, ctx, lp: LeafPlan, kw):
    """Update half of a leaf with a client chunk, on the context of
    :func:`_leaf_gram_chunked` ("oi" layout)."""
    if lp.levels:
        return _apply_stacked(ops.maecho_streaming_apply_chunked_stacked, alpha, ctx, kw)
    return ops.maecho_streaming_apply_chunked(alpha, ctx, **kw)


def _leaf_apply(W, V, P, ctx, alpha, lp: LeafPlan, cfg: MAEchoConfig,
                convention: str):
    """Apply phase for one leaf: Eq. 7 then Eq. 11.  ``alpha`` carries
    a stacked leaf's layer axes before its trailing N.  Returns
    (W', V')."""
    kw = dict(eta=cfg.eta, frac=cfg.mu / (1.0 + cfg.mu), norm=cfg.norm,
              eps=cfg.eps)
    if lp.client_chunk:
        W_new, V_new = _leaf_apply_chunked(alpha, ctx, lp, kw)
    elif lp.route == "oracle":
        return _oracle_apply(W, V, P, ctx, alpha, convention, lp.levels, **kw)
    elif lp.route == "kernel":
        W_new, V_new = ops.maecho_streaming_apply(alpha, ctx, **kw)
    else:
        W_new, V_new = _apply_stacked(ops.maecho_streaming_apply_stacked, alpha, ctx, kw)
    if convention == "io":
        return W_new.transpose(-1, -2), V_new.transpose(-1, -2)
    return W_new, V_new


def _outer(W, V, P, plan, cfg: MAEchoConfig, convention: str, masks):
    """One Algorithm-1 iteration over every leaf (flat leaf lists)."""
    if cfg.qp_batched:
        gc = [_leaf_gram(w, v, p, lp, convention)
              for w, v, p, lp in zip(W, V, P, plan.leaves)]
        grams = [g for g, _ in gc]
        Gstack, n_valid = qp_mod.stack_grams(grams)
        counts = [math.prod(g.shape[:-2]) for g in grams]
        if masks is None:
            alphas = qp_mod.solve_qp_batched(Gstack, cfg.C, cfg.qp_iters,
                                             n_valid)
        else:
            # a leaf's mask holds for every one of its scanned layers
            rows = [m.expand(c, m.shape[0]) for m, c in zip(masks, counts)]
            alphas = qp_mod.solve_qp_batched(Gstack, cfg.C, cfg.qp_iters,
                                             mask=torch.cat(rows, 0))
        out, ofs = [], 0
        for w, v, p, lp, (g, ctx), c in zip(W, V, P, plan.leaves, gc, counts):
            a = alphas[ofs:ofs + c].reshape(tuple(g.shape[:-1]))
            ofs += c
            out.append(_leaf_apply(w, v, p, ctx, a, lp, cfg, convention))
    else:
        out = []
        for l, (w, v, p, lp) in enumerate(zip(W, V, P, plan.leaves)):
            G, ctx = _leaf_gram(w, v, p, lp, convention)
            alpha = qp_mod.solve_qp(G, cfg.C, cfg.qp_iters,
                                    None if masks is None else masks[l])
            out.append(_leaf_apply(w, v, p, ctx, alpha, lp, cfg, convention))
    W2 = [w for w, _ in out]
    V2 = [v for _, v in out]
    if masks is not None:
        # non-participants contribute nothing (α = 0) and their anchors
        # stay put — the run matches aggregating the subset alone
        V2 = [torch.where(m.reshape((-1,) + (1,) * (v1.dim() - 1)), v2, v1)
              for v2, v1, m in zip(V2, V, masks)]
    return W2, V2


# --------------------------------------------------------------------------
# full aggregation
# --------------------------------------------------------------------------
def default_projections(client_weights: list[Pytree]) -> list[Pytree]:
    """Scalar full projectors everywhere (a consensus pull; used when a
    leaf has no feature statistics)."""
    return [trees.tree_map(lambda x: torch.ones((), dtype=x.dtype,
                                                device=x.device), w)
            for w in client_weights]


def init_global(client_weights: list[Pytree], how: str,
                rng: Optional[int] = None) -> Pytree:
    """The starting point W⁽⁰⁾: ``average``, ``first``, or ``random``
    (normal draws scaled by each leaf's std, seeded by ``rng``).

    ``random`` matches the reference's distribution but not its draws:
    one ``torch.Generator`` feeds every leaf in turn, where the reference
    splits a JAX key per leaf.  No parity test may use it."""
    n = len(client_weights)
    if how == "average":
        out = client_weights[0]
        for w in client_weights[1:]:
            out = trees.tree_add(out, w)
        return trees.tree_scale(out, 1.0 / n)
    if how == "first":
        return trees.tree_map(lambda x: x.clone(), client_weights[0])
    if how == "random":
        gen = torch.Generator().manual_seed(0 if rng is None else int(rng))
        return trees.tree_map(
            lambda x: (torch.randn(x.shape, generator=gen, dtype=x.dtype)
                       .to(x.device) * (x.std(correction=0) + 1e-8)),
            client_weights[0])
    raise ValueError(f"unknown init {how!r}")


def dispatch_summary(W0: Pytree, P: Pytree, levels_tree: Pytree,
                     cfg: MAEchoConfig = MAEchoConfig(),
                     convention: str = "oi", backend: str = "oracle"):
    """Per-leaf compute-path report, a view of the compiled plan.
    ``P`` is the *stacked* (leading client axis) projector tree; of
    ``cfg`` only ``client_chunk`` enters the plan.
    Returns ``(per_leaf, counts)``: ``(path, levels, route)`` per leaf
    and route → leaf count, plus ``"chunked"`` (the leaves that sweep
    their client axis in chunks) when chunking is on."""
    plan = compile_plan(W0, P, levels_tree, convention, backend, cfg.client_chunk)
    counts = plan.route_counts()
    chunked = sum(1 for lp in plan.leaves if lp.client_chunk)
    if chunked:
        counts["chunked"] = chunked
    return plan.per_leaf(), counts


def _normalize_client_mask(mask, W0: Pytree, n_clients: int) -> list:
    """Per-leaf (N,) boolean masks aligned with the flattened ``W0``.
    Accepts one (N,) mask for every leaf or a pytree of them matching
    the weights; rejects wrong shapes and all-False leaves."""
    leaves, treedef = trees.tree_flatten(W0)
    dev = leaves[0].device
    if (hasattr(mask, "shape")
            or (isinstance(mask, (list, tuple))
                and not any(isinstance(x, (list, tuple, dict)) for x in mask))):
        m = torch.as_tensor(mask, dtype=torch.bool, device=dev)
        masks = [m] * len(leaves)
    else:
        masks = [torch.as_tensor(x, dtype=torch.bool, device=dev)
                 for x in trees.flatten_up_to(treedef, mask)]
    for m in masks:
        if tuple(m.shape) != (n_clients,):
            raise ValueError(
                f"client_mask leaves must be ({n_clients},) booleans, "
                f"got shape {tuple(m.shape)}")
        # an all-False leaf makes Σα = 1 unsatisfiable and would silently
        # return the init point — surface the participation bug instead
        if not bool(m.any()):
            raise ValueError(
                "client_mask excludes every client for some leaf — "
                "at least one participant is required")
    return masks


def maecho_aggregate(
    client_weights: list[Pytree],
    projections: Optional[list[Pytree]] = None,
    cfg: MAEchoConfig = MAEchoConfig(),
    convention: str = "oi",
    init_point: Optional[Pytree] = None,
    rng: Optional[int] = None,
    stack_levels=None,
    return_anchors: bool = False,
    backend: str = "oracle",
    client_mask=None,
    device=None,
):
    """Run Algorithm 1.  Returns the global model pytree (and the
    stacked anchors V with ``return_anchors``).

    client_weights: list over clients of structurally identical pytrees.
    projections:    matching list of projector pytrees; ``None`` means
                    scalar full projectors.
    stack_levels:   per-leaf count of leading stacked-layer axes —
                    ``None`` (all 0), a pytree of ints matching the
                    weights, or a callable ``path -> int`` (the LLM
                    scan-over-layers layout).  Projector leaves carry
                    the same leading axes after their client axis.
    backend:        ``"oracle"`` | ``"kernel"`` | ``"auto"``.
    client_mask:    one (N,) boolean mask or a pytree of them: masked-out
                    clients get α = 0 and frozen anchors.
    device:         where the aggregation runs; ``None`` means CUDA.
                    Inputs are moved there.
    """
    validate_backend(backend)
    dev = resolve_device(device)

    def to_dev(tree):
        return trees.tree_map(lambda x: torch.as_tensor(x).to(dev), tree)

    client_weights = [to_dev(w) for w in client_weights]
    if projections is None:
        projections = default_projections(client_weights)
    projections = [to_dev(p) for p in projections]
    W0 = (to_dev(init_point) if init_point is not None
          else init_global(client_weights, cfg.init, rng))
    leaves_w, treedef = trees.tree_flatten(W0)
    masks = (None if client_mask is None else
             _normalize_client_mask(client_mask, W0,
                                    len(client_weights)))
    if stack_levels is None:
        levels_tree = trees.tree_map(lambda _: 0, W0)
    elif callable(stack_levels):
        levels_tree = trees.map_with_path(lambda path, _: stack_levels(path), W0)
    else:
        levels_tree = stack_levels
    V0 = trees.tree_map(lambda *xs: torch.stack(xs, 0), *client_weights)
    P = trees.tree_map(lambda *xs: torch.stack(xs, 0), *projections)
    plan = compile_plan(W0, P, levels_tree, convention, backend, cfg.client_chunk)

    W = leaves_w
    V = trees.flatten_up_to(treedef, V0)
    flatP = trees.flatten_up_to(treedef, P)
    for _ in range(cfg.tau):
        W, V = _outer(W, V, flatP, plan, cfg, convention, masks)
    W = trees.tree_unflatten(treedef, W)
    if return_anchors:
        return W, trees.tree_unflatten(treedef, V)
    return W
