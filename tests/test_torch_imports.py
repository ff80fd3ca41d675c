"""Import guard of the PyTorch port: ``repro_torch`` and
``chip_smoke.py`` import neither ``jax`` nor anything of ``repro``, and
an entry point called without ``device`` on a machine without CUDA
raises instead of running on the CPU."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    "repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py")


def test_import_pulls_in_no_jax_and_no_reference():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert len(MODULES) >= 20
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_name_no_jax_or_reference(path):
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                         re.MULTILINE)
    assert not pattern.findall(path.read_text())


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch import interop
    from repro_torch.core.maecho import maecho_aggregate
    from repro_torch.fl import client, models

    layers = models.init(models.MLP_SPEC, device="cpu")
    x = np.zeros((4, 784), np.float32)
    y = np.zeros(4, np.int32)
    calls = [lambda: models.init(models.MLP_SPEC),
             lambda: client.train_classifier(models.MLP_SPEC, layers, x, y,
                                             client.LocalTrainConfig(epochs=1)),
             lambda: client.evaluate_classifier(models.MLP_SPEC, layers, x, y),
             lambda: client.compute_projections(models.MLP_SPEC, layers, x),
             lambda: maecho_aggregate([layers, layers]),
             lambda: interop.params_from_numpy({"a": x})]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
