"""The paper's MNIST MLP (784 -> 400 -> 200 -> 100 -> 10), §7."""
import dataclasses

from repro_torch.fl.models import MLP_SPEC, PaperModelSpec


def config() -> PaperModelSpec:
    return MLP_SPEC


def smoke_config() -> PaperModelSpec:
    return dataclasses.replace(MLP_SPEC, in_shape=(64,), hidden=(32, 16))
