"""MA-Echo over the LLM zoo — cross-silo fine-tuning aggregation (the
port of ``repro.fl.llm_adapter`` for the dense family).

Maps every parameter leaf onto one of the projector rules of
``core.maecho``:

  full    — (d_in, d_in) projector from captured layer-input features
  diag    — the embedding table: its input space is the one-hot vocab,
            so P is the client's token-support indicator
  scalar  — biases, norms and every leaf without a captured feature
            stream (the attention output wo and the MLP's w_down): the
            bias rule

Feature capture (:func:`probe_features`) re-runs the forward as a
Python loop over layers, collecting the exact input stream of each
matmul.  Weights are "io" (x @ W) throughout, and every ``layers.*``
leaf carries one leading stacked-layer axis, which MA-Echo's stacked
kernels fold into their grids.  The probes of the MoE, SSM, hybrid and
encoder-decoder families are ROADMAP item A9.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import projections as proj
from repro_torch.core.maecho import MAEchoConfig, maecho_aggregate
from repro_torch.models import dense
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.utils import trees


# --------------------------------------------------------------------------
# stack levels: how many leading layer axes each leaf carries
# --------------------------------------------------------------------------
def stack_levels_fn(cfg: ModelConfig) -> Callable[[str], int]:
    def fn(path: str) -> int:
        if cfg.family == "hybrid":
            return 2 if path.startswith("mamba.") else 0
        if _expert_leaf(path):
            return 2                    # (L, E) — per-layer, per-expert
        if path.startswith(("layers.", "enc_layers.", "dec_layers.")):
            return 1
        return 0
    return fn


def _expert_leaf(path: str) -> bool:
    return any(k in path for k in ("we_gate", "we_up", "we_down"))


# --------------------------------------------------------------------------
# projector construction
# --------------------------------------------------------------------------
def _full_P(feats, alpha):
    f = feats.reshape(-1, feats.shape[-1]).float()
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp_min(1e-6)
    return proj.projection_from_features(f, alpha)


def _lead_shape(cfg: ModelConfig, path: str, leaf):
    return tuple(leaf.shape[:stack_levels_fn(cfg)(path)])


def default_llm_projections(cfg: ModelConfig, params, alpha: float = 1.0,
                            token_support=None):
    """Scalar rule everywhere, diag on the embedding if ``token_support``
    ((vocab,) 0/1) is given.  The fallback when no probe exists."""
    def mk(path, leaf):
        if path == "embed" and token_support is not None:
            return torch.as_tensor(token_support, device=leaf.device).to(leaf.dtype)
        return torch.ones(_lead_shape(cfg, path, leaf), dtype=torch.float32,
                          device=leaf.device)
    return trees.map_with_path(mk, params)


def build_projections(cfg: ModelConfig, params, batches, alpha: float = 1.0):
    """Capture features over ``batches`` and build the projector pytree.

    Leaves with a captured feature stream get full per-layer P, stacked
    (L, d_in, d_in); the embedding gets the diag token-support rule;
    everything else the scalar rule.  Leaves that share a feature
    stream (wq/wk/wv, w_gate/w_up) share one projector tensor."""
    feats, support = probe_features(cfg, params, batches)
    built: dict = {}

    def build(f):
        if id(f) not in built:
            built[id(f)] = (torch.stack([_full_P(x, alpha) for x in f])
                            if isinstance(f, list) else _full_P(f, alpha))
        return built[id(f)]

    def mk(path, leaf):
        if path in feats:
            return build(feats[path])
        if path == "embed" and support is not None:
            return support.float()
        return torch.ones(_lead_shape(cfg, path, leaf), dtype=torch.float32,
                          device=leaf.device)

    return trees.map_with_path(mk, params)


# --------------------------------------------------------------------------
# feature probes (Python loop over layers)
# --------------------------------------------------------------------------
def probe_features(cfg: ModelConfig, params, batches):
    if cfg.family == "dense":
        return _probe_dense(cfg, params, batches)
    raise NotImplementedError(
        f"the feature probe of family {cfg.family!r} is not ported yet "
        f"(ROADMAP item A9)")


def _collect(store, key, val, max_rows: int = 1024):
    v = val.reshape(-1, val.shape[-1])
    if v.shape[0] > max_rows:
        v = v[:: max(1, v.shape[0] // max_rows)][:max_rows]
    store.setdefault(key, []).append(v)


def _token_support(cfg: ModelConfig, batches, device=None):
    sup = np.zeros(cfg.vocab, np.float32)
    for b in batches:
        if "tokens" in b:
            sup[np.unique(np.asarray(torch.as_tensor(b["tokens"]).cpu()))] = 1.0
    return torch.from_numpy(sup).to(device)


@torch.no_grad()
def _probe_dense(cfg: ModelConfig, params, batches):
    nL = cfg.n_layers
    dev = params["embed"].device
    per_layer: dict = {}
    final_feats = []
    for batch in batches:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        x, positions = dense.embed_inputs(cfg, params, batch)
        for l in range(nL):
            lp = dense.layer_params(params, l)
            h1 = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
            _collect(per_layer, ("qkv", l), h1)
            x = x + dense.attn_block(lp, h1, positions, cfg)
            h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
            _collect(per_layer, ("mlp_in", l), h2)
            x = x + dense.mlp_block(lp, h2, cfg)
        xf = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
        final_feats.append(xf.reshape(-1, cfg.d_model)[:1024])

    feats = {}
    for name, param_keys in (("qkv", ("layers.wq", "layers.wk", "layers.wv")),
                             ("mlp_in", ("layers.w_gate", "layers.w_up"))):
        stacked = [torch.cat(per_layer[(name, l)], 0) for l in range(nL)]
        for pk in param_keys:
            feats[pk] = stacked
    if not cfg.tie_embeddings:
        feats["lm_head"] = torch.cat(final_feats, 0)
    return feats, _token_support(cfg, batches, dev)


# --------------------------------------------------------------------------
# aggregation entry point
# --------------------------------------------------------------------------
def aggregate_llm(cfg: ModelConfig, client_params: list, client_projs: list = None,
                  macfg: MAEchoConfig = MAEchoConfig(tau=20, eta=0.5),
                  backend: str = "auto", device=None):
    """One-shot MA-Echo over fine-tuned LLM checkpoints ("io" weights,
    ``layers.*`` leaves stacked over layers).  ``backend="auto"``
    promotes every leaf big enough to tile to the CUDA kernels — the
    scan-stacked transformer leaves to the stacked ones, one launch per
    leaf for all layers; smoke-scale models (dims below one 128-tile)
    run the plain oracle with identical results.  ``device=None`` means
    CUDA."""
    if client_projs is None:
        client_projs = [default_llm_projections(cfg, p) for p in client_params]
    return maecho_aggregate(client_params, client_projs, macfg, convention="io",
                            stack_levels=stack_levels_fn(cfg), backend=backend,
                            device=device)
