"""The paper's CIFAR-10 CNN (3 conv + 3 fc), §7."""
import dataclasses

from repro_torch.fl.models import CNN_SPEC, PaperModelSpec


def config() -> PaperModelSpec:
    return CNN_SPEC


def smoke_config() -> PaperModelSpec:
    return dataclasses.replace(CNN_SPEC, in_shape=(8, 8, 3), conv_channels=(8, 8, 8),
                               fc_hidden=(16, 16))
