"""Dense decoder-only transformer (llama/qwen family), the port of
``repro.models.dense``: training, prefill and decode.

Parameters are stored **stacked over layers** (a leading L axis on
every ``layers.*`` leaf, the reference's scan layout, which is also the
layout MA-Echo's stacked kernels aggregate); the forward pass is a
Python loop over that axis.  Weights are "io" (x @ W).  With
``cfg.remat`` each layer is recomputed in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.
:func:`prefill` and :func:`decode_step` serve: the decode cache is
stacked over layers, (nL, B, W, Hkv, D) in the compute dtype, and each
decode step writes its layer slices in place.  The VLM variant is
ROADMAP item A9.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


# --------------------------------------------------------------------------
# init (explicit generator; tensors land on the generator's device)
# --------------------------------------------------------------------------
def _stacked(gen, n_layers: int, d_in: int, d_out: int, cfg: ModelConfig):
    return L.dense_init(gen, d_in, d_out, cfg.pdtype, lead=(n_layers,))


def attn_init(gen, cfg: ModelConfig, n_layers: int):
    d, hd = cfg.d_model, cfg.hd()
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": _stacked(gen, n_layers, d, Hq * hd, cfg),
        "wk": _stacked(gen, n_layers, d, Hkv * hd, cfg),
        "wv": _stacked(gen, n_layers, d, Hkv * hd, cfg),
        "wo": _stacked(gen, n_layers, Hq * hd, d, cfg),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", Hq * hd), ("bk", Hkv * hd), ("bv", Hkv * hd)):
            p[name] = torch.zeros((n_layers, width), dtype=cfg.pdtype,
                                  device=gen.device)
    return p


def mlp_init(gen, cfg: ModelConfig, n_layers: int):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": _stacked(gen, n_layers, d, f, cfg),
        "w_up": _stacked(gen, n_layers, d, f, cfg),
        "w_down": _stacked(gen, n_layers, f, d, cfg),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP item A9)")
    nL, d = cfg.n_layers, cfg.d_model
    ones = dict(dtype=cfg.pdtype, device=gen.device)
    params = {
        "embed": L.embed_init(gen, cfg.vocab, d, cfg.pdtype),
        "layers": {
            "ln1": torch.ones((nL, d), **ones),
            "ln2": torch.ones((nL, d), **ones),
            **attn_init(gen, cfg, nL),
            **mlp_init(gen, cfg, nL),
        },
        "ln_f": torch.ones((d,), **ones),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, d, cfg.vocab, cfg.pdtype)
    return params


# --------------------------------------------------------------------------
# per-layer blocks (operate on one layer's param slice ``lp``)
# --------------------------------------------------------------------------
def _qkv(lp, x, cfg: ModelConfig):
    B, S, _ = x.shape
    hd, ct = cfg.hd(), cfg.cdtype
    q = x @ lp["wq"].to(ct)
    k = x @ lp["wk"].to(ct)
    v = x @ lp["wv"].to(ct)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(ct)
        k = k + lp["bk"].to(ct)
        v = v + lp["bv"].to(ct)
    return (q.reshape(B, S, cfg.n_heads, hd), k.reshape(B, S, cfg.n_kv_heads, hd),
            v.reshape(B, S, cfg.n_kv_heads, hd))


def attn_block(lp, x, positions, cfg: ModelConfig, *, causal: bool = True):
    """Full-sequence self attention (train / prefill)."""
    B, S, _ = x.shape
    q, k, v = _qkv(lp, x, cfg)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = L.prefill_attention(q, k, v, causal=causal, q_chunk=cfg.attn_chunk_q,
                            k_chunk=cfg.attn_chunk_k, backend=cfg.attn_backend)
    return o.reshape(B, S, cfg.n_heads * cfg.hd()) @ lp["wo"].to(cfg.cdtype)


def attn_block_decode(lp, x, cache, position, cfg: ModelConfig, *,
                      w_live: int | None = None):
    """One-token self attention against a ring-buffer KV cache.

    cache: {"k": (B, W, Hkv, hd), "v": ...}, updated in place; position:
    a scalar (lockstep fixed batch) or (B,) per-slot positions (the
    continuous-batching serve loop).  ``w_live`` is the loop's live-slot
    bound for the cropped decode path.  Returns (y, cache)."""
    B = x.shape[0]
    q, k, v = _qkv(lp, x, cfg)
    position = torch.as_tensor(position, device=x.device)
    pos = position.expand(B)[:, None] if position.dim() == 0 else position[:, None]
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    cache, valid = L.update_kv_cache(cache, k, v, position)
    o = L.decode_attention(q, cache["k"], cache["v"], valid, backend=cfg.attn_backend,
                           w_live=w_live)
    return o.reshape(B, 1, cfg.n_heads * cfg.hd()) @ lp["wo"].to(cfg.cdtype), cache


def mlp_block(lp, x, cfg: ModelConfig):
    ct = cfg.cdtype
    return L.swiglu(x, lp["w_gate"].to(ct), lp["w_up"].to(ct), lp["w_down"].to(ct))


def layer_fn(lp, x, positions, cfg: ModelConfig):
    x = x + attn_block(lp, L.rms_norm(x, lp["ln1"], cfg.norm_eps), positions, cfg)
    return x + mlp_block(lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)


def layer_fn_decode(lp, x, cache, position, cfg: ModelConfig, *,
                    w_live: int | None = None):
    a, cache = attn_block_decode(lp, L.rms_norm(x, lp["ln1"], cfg.norm_eps), cache,
                                 position, cfg, w_live=w_live)
    x = x + a
    return x + mlp_block(lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg), cache


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------
def embed_inputs(cfg: ModelConfig, params, batch):
    """Token embedding.  Returns (x, positions)."""
    x = params["embed"][batch["tokens"].long()].to(cfg.cdtype)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    return x, positions


def layer_params(params, l: int) -> dict:
    """Layer ``l``'s slice of the stacked ``params["layers"]``."""
    return {k: v[l] for k, v in params["layers"].items()}


def forward(cfg: ModelConfig, params, batch):
    """Returns logits (B, S, V) in the compute dtype."""
    x, positions = embed_inputs(cfg, params, batch)
    for l in range(cfg.n_layers):
        lp = layer_params(params, l)
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(layer_fn, lp, x, positions, cfg, use_reentrant=False)
        else:
            x = layer_fn(lp, x, positions, cfg)
    return _head(cfg, params, x)


def loss_fn(cfg: ModelConfig, params, batch):
    logits = forward(cfg, params, batch)
    return L.softmax_xent(logits, batch["labels"], batch.get("loss_mask"))


def _head(cfg: ModelConfig, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps) @ head.to(cfg.cdtype)


@torch.no_grad()
def prefill(cfg: ModelConfig, params, batch):
    """Forward over the prompt, returning ``(last_logits (B, 1, V),
    kv_cache)``.  Only the final position's logits are formed; each
    layer's roped K and V become the decode cache, {"k", "v"} of
    (nL, B, S, Hkv, hd) in the compute dtype.  Inference only."""
    x, positions = embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd())
    cache = {"k": torch.empty(shape, dtype=cfg.cdtype, device=x.device),
             "v": torch.empty(shape, dtype=cfg.cdtype, device=x.device)}
    for l in range(cfg.n_layers):
        lp = layer_params(params, l)
        q, k, v = _qkv(lp, L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        o = L.prefill_attention(q, k, v, causal=True, q_chunk=cfg.attn_chunk_q,
                                k_chunk=cfg.attn_chunk_k, backend=cfg.attn_backend)
        x = x + o.reshape(B, S, cfg.n_heads * cfg.hd()) @ lp["wo"].to(cfg.cdtype)
        x = x + mlp_block(lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
        cache["k"][l], cache["v"][l] = k, v
    return _head(cfg, params, x[:, -1:]), cache


# ----- decode -------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, window: int, device=None):
    """Zero decode cache {"k", "v"} of (nL, batch, window, Hkv, hd) in the
    compute dtype on ``device`` (a torch device; no default)."""
    shape = (cfg.n_layers, batch, window, cfg.n_kv_heads, cfg.hd())
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, token, position, *,
                w_live: int | None = None):
    """token: (B, 1) integer; position: a scalar (absolute, lockstep) or
    (B,) per-slot positions (continuous batching).  Returns
    ``(logits (B, 1, V), cache)``, with the cache written **in place**
    (the same dict comes back).  ``w_live`` is the serving loop's
    live-slot bound (see ``layers.decode_attention``).  Inference only."""
    x = params["embed"][token.long()].to(cfg.cdtype)
    position = torch.as_tensor(position, device=x.device)
    for l in range(cfg.n_layers):
        layer_cache = {"k": cache["k"][l], "v": cache["v"][l]}
        x, _ = layer_fn_decode(layer_params(params, l), x, layer_cache, position, cfg,
                               w_live=w_live)
    return _head(cfg, params, x), cache
