"""Shared fixtures, optional-dependency shims and marker registration.

`hypothesis` is an **optional dev dependency** (it is not in the
runtime container image).  When it is missing, the deterministic stub
in ``tests/_hypothesis_stub.py`` is installed into ``sys.modules``
before collection so the property-test modules still collect and run
on a small fixed sample per strategy.  ``pip install hypothesis``
restores full property search.

Markers:
  slow — heaviest smoke/sweep tests.  ``pytest -m "not slow"`` is the
  fast inner loop; tier-1 (plain ``pytest``) still runs everything.
"""
import pathlib
import sys

import jax
import numpy as np
import pytest

# tests/ on sys.path unconditionally: the shared strategy module
# (tests/strategies.py) is imported by name from the property-test
# modules whether or not the real hypothesis is installed
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import _hypothesis_stub

    sys.modules["hypothesis"] = _hypothesis_stub
    sys.modules["hypothesis.strategies"] = _hypothesis_stub.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy model-zoo smoke / sweep tests; deselect with "
        "-m \"not slow\" for a fast inner loop (tier-1 runs all)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA kernels); "
        "skips without one")


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_executables():
    """Drop JAX's jit caches after each test module.

    Every XLA:CPU executable pins a handful of ``mmap`` regions for its
    code pages.  A full-suite run in a single process accumulates tens
    of thousands of mappings and eventually crosses the kernel's
    ``vm.max_map_count`` ceiling (65530 by default) — at which point the
    next compile's ``mmap`` fails and XLA segfaults mid-suite.  Clearing
    at module boundaries bounds the live-map count to the heaviest
    single module; cross-module cache reuse is negligible because each
    module compiles its own shapes.
    """
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(0)
