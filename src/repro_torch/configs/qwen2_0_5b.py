"""qwen2-0.5b — dense GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.common import smoke_reduce
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab=151936, head_dim=64, qkv_bias=True,
        rope_theta=1000000.0, tie_embeddings=True,
        microbatches=2,
        source="arXiv:2407.10671",
    )


def smoke_config() -> ModelConfig:
    return smoke_reduce(config(), n_heads=4, n_kv_heads=2)
