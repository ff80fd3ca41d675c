"""PyTorch/CUDA port of ``repro`` (one-shot federated learning with
MA-Echo) for NVIDIA Hopper.

The package mirrors ``repro``'s sub-package layout.  It imports
``torch`` and numpy only — never ``jax`` and nothing of ``repro``.
Entry points take ``device=None``, which means ``"cuda"``; without a
card they raise instead of running on the CPU (pass ``device="cpu"``
explicitly for the plain-PyTorch path the CPU tests use).
"""
