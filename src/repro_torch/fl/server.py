"""Server-side one-shot aggregation (no training — the paper's setting)."""
from __future__ import annotations

from typing import Optional

from repro_torch.core import aggregators
from repro_torch.core.maecho import MAEchoConfig
from repro_torch.fl import models as pm
from repro_torch.utils import trees
from repro_torch.utils.device import resolve_device


def one_shot_aggregate(
    spec: pm.PaperModelSpec,
    client_params: list,
    projections: Optional[list] = None,
    method: str = "maecho",
    cfg: MAEchoConfig = None,
    device=None,
    **kw,
):
    """Run one aggregation operator on the clients' parameters
    (projections from ``fl.client.compute_projections``).  ``method`` is
    ``"fedavg"`` or ``"maecho"``; extra ``**kw`` (``backend``,
    ``client_mask``, …) flows to ``core.maecho.maecho_aggregate``."""
    pm._require_mlp(spec)
    dev = resolve_device(device)
    if method in ("ot", "maecho+ot"):
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP item A6)")
    if method == "fedavg":
        return aggregators.fedavg(
            [trees.tree_map(lambda x: x.to(dev), p) for p in client_params])
    if method == "maecho":
        return aggregators.maecho(client_params, projections, cfg,
                                  device=dev, **kw)
    raise ValueError(f"unknown method {method!r}")
