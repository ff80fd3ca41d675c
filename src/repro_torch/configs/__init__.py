"""Architecture config registry (the port's copy of ``repro.configs``).

``get_config(arch_id)`` returns the exact published config;
``get_smoke_config(arch_id)`` the reduced same-family variant the CPU
tests use (2 layers, d_model <= 512).  Ported: the dense family's
Qwen2-0.5B and the paper's MLP and CNN (``PaperModelSpec``s); the CVAE
raises ``NotImplementedError`` naming ROADMAP item A5, the other
architectures naming A9.
"""
from __future__ import annotations

import importlib

from repro_torch.fl.models import PaperModelSpec
from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "llama3_8b", "qwen2_1_5b", "whisper_tiny", "falcon_mamba_7b",
    "phi3_vision_4_2b", "qwen2_moe_a2_7b", "llama3_405b", "zamba2_2_7b",
    "qwen2_0_5b", "grok1_314b",
    # paper's own experiment configs
    "paper_mlp", "paper_cnn", "paper_cvae",
]
PORTED = ("qwen2_0_5b", "paper_mlp", "paper_cnn")

# public ids use dashes (CLI --arch); module names use underscores
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({
    "llama3-8b": "llama3_8b", "qwen2-1.5b": "qwen2_1_5b",
    "whisper-tiny": "whisper_tiny", "falcon-mamba-7b": "falcon_mamba_7b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b", "llama3-405b": "llama3_405b",
    "zamba2-2.7b": "zamba2_2_7b", "qwen2-0.5b": "qwen2_0_5b",
    "grok-1-314b": "grok1_314b",
})


def _module(arch: str):
    name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; known: "
                         + ", ".join(ARCH_IDS))
    if name not in PORTED:
        item = "A5" if name == "paper_cvae" else "A9"
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet (ROADMAP item {item}); "
            f"ported: " + ", ".join(PORTED))
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig | PaperModelSpec:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig | PaperModelSpec:
    return _module(arch).smoke_config()
