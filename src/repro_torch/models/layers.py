"""Losses shared by the port's models (the LLM-zoo layers of
``repro.models.layers`` are ROADMAP item A9)."""
from __future__ import annotations

import torch


def softmax_xent(logits, labels, mask=None):
    """Mean token-level cross entropy; labels (…,) integer; mask same
    shape as labels."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
