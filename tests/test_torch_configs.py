"""The port's config registry against the reference's (``repro.configs``):
the paper's MLP and CNN specs and their smoke variants field by field,
and the labels of the architectures it does not port yet."""
import dataclasses

import pytest

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke
from repro_torch.configs import get_config, get_smoke_config


@pytest.mark.parametrize("smoke", (False, True), ids=("full", "smoke"))
@pytest.mark.parametrize("arch", ("paper_mlp", "paper_cnn", "paper-mlp", "paper-cnn"))
def test_paper_specs_equal_reference(arch, smoke):
    got = (get_smoke_config if smoke else get_config)(arch)
    want = (j_get_smoke if smoke else j_get_config)(arch)
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(want)])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("smoke", (False, True), ids=("full", "smoke"))
@pytest.mark.parametrize("arch, item", (("paper_cvae", "A5"), ("paper-cvae", "A5"),
                                        ("llama3_8b", "A9"), ("qwen2-moe-a2.7b", "A9")))
def test_unported_configs_name_their_item(arch, item, smoke):
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        (get_smoke_config if smoke else get_config)(arch)
