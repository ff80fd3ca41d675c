"""Move parameter and projector pytrees between numpy and the port.

The reference (``repro``) keeps pytrees of arrays; tests hand them to
the port as numpy.  Containers (dicts, lists, tuples) keep their
structure; leaves become tensors on the given device and back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import trees
from repro_torch.utils.device import resolve_device


def params_from_numpy(tree, device=None):
    """Array-like leaves → float32/int tensors on ``device`` (``None``
    means CUDA)."""
    dev = resolve_device(device)
    return trees.tree_map(
        lambda x: torch.from_numpy(np.array(x, copy=True)).to(dev), tree)


def params_to_numpy(tree):
    """Tensor leaves → numpy arrays (copied to the host)."""
    return trees.tree_map(lambda t: t.detach().cpu().numpy(), tree)
