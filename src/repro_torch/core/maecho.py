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
    for scalar and diagonal ones.  Smaller leaves and 1-D biases run
    the oracle.
  - ``"auto"``: the same routing without fallback warnings.

Routing is compiled once by ``core.plan.compile_plan``; the τ-loop
below is a plain Python loop over that plan.  With
``MAEchoConfig.qp_batched`` (default) each iteration stacks every
leaf's (N, N) Gram and solves all QPs in one batched PGD; otherwise
one PGD per leaf.  Nothing inside the loop reads a value back to the
host.
"""
from __future__ import annotations

import dataclasses
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
    client_chunk: int = 0         # client-axis chunking (ROADMAP A8)


# --------------------------------------------------------------------------
# per-leaf algebra
# --------------------------------------------------------------------------
def _apply_P(delta, P, convention: str):
    """Δᵢ·Pᵢ for every client at once: ``delta`` (N, …) and ``P`` the
    stacked projector — (N,) scalars, (N, in) diagonals, (N, in, in)
    dense or factored {"U": (N, in, k), "s": (N, k)}.  1-D per-client
    leaves (biases) contract their only axis."""
    if isinstance(P, dict):
        U, s = P["U"], P["s"]
        Ut = U.transpose(1, 2)
        if delta.dim() == 2:
            return ((((delta[:, None, :] @ U) * s[:, None, :]) @ Ut))[:, 0]
        if convention == "oi":
            return ((delta @ U) * s[:, None, :]) @ Ut     # (out,k)·(k)·(k,in)
        return U @ (s[:, :, None] * (Ut @ delta))
    if P.dim() == 1:                                    # scalar (bias rule)
        return delta * P.reshape((-1,) + (1,) * (delta.dim() - 1))
    if P.dim() == 2:                                    # diagonal on in-axis
        if delta.dim() == 2:
            return delta * P
        return delta * (P[:, None, :] if convention == "oi" else P[:, :, None])
    if delta.dim() == 2:                                # dense
        return (delta[:, None, :] @ P)[:, 0]
    return delta @ P if convention == "oi" else P @ delta


def _to_kernel_layout(W, V, P, convention: str):
    """The streaming kernels are "oi"-native and need contiguous
    operands: "io" leaves are transposed (and copied) around the call."""
    if convention != "io":
        return W, V, P
    Pk = (P.transpose(-1, -2).contiguous()
          if not isinstance(P, dict) and P.dim() == 3 else P)
    return W.T.contiguous(), V.transpose(1, 2).contiguous(), Pk


def _leaf_gram(W, V, P, lp: LeafPlan, convention: str):
    """Gram phase for one leaf on its compiled route: returns ``(G,
    ctx)`` — the (N, N) Gram and the reuse payload for
    :func:`_leaf_apply` (the oracle's residual, or the kernel
    pipeline's context)."""
    if lp.route == "oracle":
        R = _apply_P(W[None] - V, P, convention)
        Rf = R.reshape(R.shape[0], -1).float()
        return Rf @ Rf.T, R
    return ops.maecho_streaming_gram(*_to_kernel_layout(W, V, P, convention))


def _leaf_apply(W, V, P, ctx, alpha, lp: LeafPlan, cfg: MAEchoConfig,
                convention: str):
    """Apply phase for one leaf: Eq. 7 then Eq. 11.  Returns (W', V')."""
    frac = cfg.mu / (1.0 + cfg.mu)
    if lp.route == "oracle":
        D = -2.0 * torch.tensordot(alpha, ctx.float(), dims=([0], [0]))
        W_new = (W.float() + cfg.eta * D).to(W.dtype)
        return W_new, ref.maecho_v_update_ref(W_new, V, P, frac, cfg.norm,
                                              cfg.eps, convention)
    W_new, V_new = ops.maecho_streaming_apply(
        alpha, ctx, eta=cfg.eta, frac=frac, norm=cfg.norm, eps=cfg.eps)
    if convention == "io":
        return W_new.T, V_new.transpose(1, 2)
    return W_new, V_new


def _outer(W, V, P, plan, cfg: MAEchoConfig, convention: str, masks):
    """One Algorithm-1 iteration over every leaf (flat leaf lists)."""
    if cfg.qp_batched:
        gc = [_leaf_gram(w, v, p, lp, convention)
              for w, v, p, lp in zip(W, V, P, plan.leaves)]
        Gstack, n_valid = qp_mod.stack_grams([g for g, _ in gc])
        if masks is None:
            alphas = qp_mod.solve_qp_batched(Gstack, cfg.C, cfg.qp_iters,
                                             n_valid)
        else:
            alphas = qp_mod.solve_qp_batched(Gstack, cfg.C, cfg.qp_iters,
                                             mask=torch.stack(masks))
        out = [_leaf_apply(w, v, p, ctx, alphas[l], lp, cfg, convention)
               for l, (w, v, p, lp, (_, ctx))
               in enumerate(zip(W, V, P, plan.leaves, gc))]
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
    (normal draws scaled by each leaf's std, seeded by ``rng``)."""
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
    ``P`` is the *stacked* (leading client axis) projector tree; ``cfg``
    does not change routing in this port (kept for the reference's
    signature).
    Returns ``(per_leaf, counts)``: ``(path, levels, route)`` per leaf
    and route → leaf count."""
    plan = compile_plan(W0, P, levels_tree, convention, backend)
    return plan.per_leaf(), plan.route_counts()


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
    stack_levels:   ``None`` or all-zero (a pytree or ``path -> int``);
                    stacked leaves are ROADMAP item A7.
    backend:        ``"oracle"`` | ``"kernel"`` | ``"auto"``.
    client_mask:    one (N,) boolean mask or a pytree of them: masked-out
                    clients get α = 0 and frozen anchors.
    device:         where the aggregation runs; ``None`` means CUDA.
                    Inputs are moved there.
    """
    validate_backend(backend)
    if cfg.client_chunk:
        raise NotImplementedError(
            "MAEchoConfig.client_chunk is not ported yet (ROADMAP item A8)")
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
        levels_tree = trees.tree_unflatten(
            treedef, [stack_levels(p) for p, _ in trees.tree_paths(W0)])
    else:
        levels_tree = stack_levels
    V0 = trees.tree_map(lambda *xs: torch.stack(xs, 0), *client_weights)
    P = trees.tree_map(lambda *xs: torch.stack(xs, 0), *projections)
    plan = compile_plan(W0, P, levels_tree, convention, backend)

    W = leaves_w
    V = trees.flatten_up_to(treedef, V0)
    flatP = trees.flatten_up_to(treedef, P)
    for _ in range(cfg.tau):
        W, V = _outer(W, V, flatP, plan, cfg, convention, masks)
    W = trees.tree_unflatten(treedef, W)
    if return_anchors:
        return W, trees.tree_unflatten(treedef, V)
    return W
