"""Server-side one-shot aggregation (no training — the paper's setting).
Handles the conv-kernel reshape (paper §5.2: ``(C_out, C_in, h, w) ->
(C_out, C_in·h·w)``) so the layer-wise algebra in ``core`` only ever
sees 2-D weight leaves."""
from __future__ import annotations

from typing import Optional

from repro_torch.core import aggregators
from repro_torch.core.maecho import MAEchoConfig
from repro_torch.fl import models as pm
from repro_torch.utils import trees
from repro_torch.utils.device import resolve_device


def _flatten_convs(params):
    """4-D conv weights reshaped to (C_out, C_in·h·w); returns the
    flattened params and ``{layer index: 4-D shape}``."""
    shapes = {}

    def walk(layers):
        out = []
        for i, lay in enumerate(layers):
            if lay["W"].ndim == 4:
                shapes[i] = tuple(lay["W"].shape)
                out.append({**lay, "W": lay["W"].reshape(shapes[i][0], -1)})
            else:
                out.append(lay)
        return out

    if isinstance(params, dict) and "dec" in params:
        return {"dec": walk(params["dec"])}, shapes
    return walk(params), shapes


def _unflatten_convs(params, shapes):
    """Inverse of :func:`_flatten_convs`."""
    def walk(layers):
        return [{**lay, "W": lay["W"].reshape(shapes[i])} if i in shapes else lay
                for i, lay in enumerate(layers)]

    if isinstance(params, dict) and "dec" in params:
        return {"dec": walk(params["dec"])}
    return walk(params)


def one_shot_aggregate(
    spec: pm.PaperModelSpec,
    client_params: list,
    projections: Optional[list] = None,
    method: str = "maecho",
    cfg: MAEchoConfig = None,
    device=None,
    **kw,
):
    """Run one aggregation operator on the clients' parameters (model
    layout, conv weights 4-D; projections from
    ``fl.client.compute_projections``).  ``method`` is ``"fedavg"`` or
    ``"maecho"``; extra ``**kw`` (``backend``, ``client_mask``, …) flows
    to ``core.maecho.maecho_aggregate``."""
    pm._require_ported(spec)
    dev = resolve_device(device)
    if method in ("ot", "maecho+ot"):
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP item A6)")
    flat, shapes = zip(*[_flatten_convs(p) for p in client_params])
    if method == "fedavg":
        out = aggregators.fedavg(
            [trees.tree_map(lambda x: x.to(dev), p) for p in flat])
    elif method == "maecho":
        out = aggregators.maecho(list(flat), projections, cfg, device=dev, **kw)
    else:
        raise ValueError(f"unknown method {method!r}")
    return _unflatten_convs(out, shapes[0])
