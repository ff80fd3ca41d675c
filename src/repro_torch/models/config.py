"""Model configuration shared by every architecture family (the port's
own copy of ``repro.models.config``, field for field; the parameter counts and the input-shape suite of
the roofline and dry-run tools are not ported).

One dataclass covers all six families (dense / moe / ssm / hybrid /
encdec / vlm); family-specific sub-configs are optional fields, kept
here as plain data (only the dense family's modules are ported; the
others are ROADMAP item A9).  ``pdtype`` and ``cdtype`` return torch
dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8            # routed experts
    top_k: int = 2
    n_shared_experts: int = 0     # always-on shared experts (qwen2-moe)
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2
    # token group size for grouped dispatch (keeps dispatch FLOPs local);
    # see roofline §Perf for the hillclimb on this knob.
    group_size: int = 4096
    # "einsum": Switch-style one-hot dispatch/combine matmuls (paper-era
    # baseline); "gather": scatter/gather dispatch with zero matmul
    # FLOPs (§Perf hillclimb H1 — 6.6× dispatch-FLOPs removal)
    dispatch_mode: str = "einsum"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2               # d_inner = expand * d_model
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)  (mamba1)
    version: int = 1              # 1 = mamba1 (falcon-mamba), 2 = mamba2 (zamba2)
    head_dim: int = 64            # mamba2 only
    chunk: int = 256              # mamba2 SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def dt_rank_(self, d_model: int) -> int:
        return self.dt_rank or max(1, (d_model + 15) // 16)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """zamba2-style: shared attention block interleaved with mamba2."""
    attn_every: int = 6           # one shared-attn call per this many ssm layers
    shared_attn_blocks: int = 1   # number of distinct shared blocks (round-robin)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """whisper-style encoder-decoder backbone (conv frontend stubbed)."""
    n_enc_layers: int = 4
    enc_seq: int = 1500           # encoder positions (whisper 30s -> 1500)
    dec_seq: int = 448            # decoder text positions for train/prefill


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """phi-3-vision style: LM backbone consumes stub patch embeddings."""
    n_patches: int = 1024         # vision tokens prepended to text
    d_vision: int = 1024          # stub vision-encoder output dim (projected)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""              # citation for the config numbers

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # attention memory policy
    attn_chunk_q: int = 512       # flash-style query block
    attn_chunk_k: int = 1024      # flash-style kv block
    window: int = 8192            # sliding-window size used for long-context decode
    # attention backend: "oracle" (the plain paths); "kernel" (the flash
    # kernel B21 in prefill, the decode kernel B22); "auto" (the kernels on
    # a CUDA device where the reference's rule takes them)
    attn_backend: str = "auto"

    # distribution policy
    fsdp: bool = False            # shard weights over the data axis too
    remat: bool = True            # checkpoint per scanned layer
    microbatches: int = 1         # grad-accumulation steps per train_step
    seq_shard: bool = False       # shard train activations over seq (model ax)

    # roofline-probe knobs (see repro.roofline.probe): unrolled scans and
    # associative SSM scan give loop-free HLO whose cost_analysis is exact
    unroll_layers: bool = False
    ssm_assoc: bool = False

    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# One input shape of a model workload (train, prefill or decode).
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode
