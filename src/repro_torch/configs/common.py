"""Helpers shared by the architecture config modules."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


def smoke_reduce(cfg: ModelConfig, **extra) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests:
    2 layers, d_model <= 512, <= 4 experts, tiny vocab, f32 numerics."""
    d = min(cfg.d_model, 256)
    hd = 32
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = max(1, min(n_heads, cfg.n_kv_heads if cfg.n_kv_heads else 1))
    if n_heads % n_kv:
        n_kv = 1
    kw = dict(
        n_layers=2, d_model=d, n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=hd, d_ff=min(cfg.d_ff, 4 * d) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        param_dtype="float32", compute_dtype="float32",
        attn_chunk_q=64, attn_chunk_k=64, window=128,
        fsdp=False, remat=False, microbatches=1, seq_shard=False,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(2, cfg.moe.top_k),
            n_shared_experts=min(1, cfg.moe.n_shared_experts),
            group_size=64)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=min(cfg.ssm.d_state, 16),
            head_dim=min(cfg.ssm.head_dim, 32))
    if cfg.hybrid is not None:
        kw["n_layers"] = 2
        kw["hybrid"] = dataclasses.replace(cfg.hybrid, attn_every=2)
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(
            cfg.encdec, n_enc_layers=2, enc_seq=64, dec_seq=32)
    if cfg.vlm is not None:
        kw["vlm"] = dataclasses.replace(cfg.vlm, n_patches=8, d_vision=64)
    kw.update(extra)
    return cfg.replace(name=cfg.name + "-smoke", **kw)
