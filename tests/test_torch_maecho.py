"""Port parity: ``repro_torch.core.maecho.maecho_aggregate`` against
``repro.core.maecho.maecho_aggregate`` (1e-3 on W and the anchors, the
reference's aggregate tolerance) on the reference's own case builder —
every projector kind, both conventions, ragged client masks, batched
and sequential QP — plus route-for-route equality of the compiled plan
and the not-yet-ported options raising with their ROADMAP item."""
import dataclasses

import jax
import numpy as np
import pytest

import strategies as strat
from repro.core import maecho as jm
from repro_torch import interop
from repro_torch.core import maecho as tm

JCFG = jm.MAEchoConfig(tau=2, eta=0.5, qp_iters=60)
TCFG = tm.MAEchoConfig(tau=2, eta=0.5, qp_iters=60)


def to_port(tree):
    return interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _case(seed, n, kind, convention, shape, masked):
    clients, projs, _, mask = strat.build_case(seed, n, kind, convention, (),
                                               shape, masked)
    return clients, projs, mask


def _assert_close(got, want, tol=1e-3):
    for key in ("W", "b"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=tol)


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("convention", strat.CONVENTIONS)
@pytest.mark.parametrize("kind", strat.KINDS)
def test_aggregate_matches_reference(kind, convention, masked):
    """Port oracle and kernel backends (CPU: plain versions) against the
    reference oracle, anchors included."""
    clients, projs, mask = _case(3, 3, kind, convention, (200, 140), masked)
    want_w, want_v = jm.maecho_aggregate(
        clients, projs, JCFG, convention=convention, client_mask=mask,
        return_anchors=True)
    tmask = None if mask is None else np.asarray(mask)
    for backend in ("oracle", "kernel"):
        got_w, got_v = tm.maecho_aggregate(
            to_port(clients), to_port(projs), TCFG, convention=convention,
            client_mask=tmask, return_anchors=True, backend=backend,
            device="cpu")
        _assert_close(got_w, want_w)
        _assert_close(got_v, want_v)


@pytest.mark.parametrize("kind", ("full", "factored"))
def test_sequential_qp_matches_reference(kind):
    clients, projs, _ = _case(8, 3, kind, "oi", (140, 200), False)
    want = jm.maecho_aggregate(clients, projs,
                               dataclasses.replace(JCFG, qp_batched=False))
    got = tm.maecho_aggregate(to_port(clients), to_port(projs),
                              dataclasses.replace(TCFG, qp_batched=False),
                              backend="kernel", device="cpu")
    _assert_close(got, want)


def test_kernel_backend_matches_reference_kernel_backend():
    """Against the reference's Pallas pipeline (interpret mode) on a
    dense, padded leaf, with the row-norm on."""
    clients, projs, _ = _case(5, 3, "full", "oi", (140, 200), False)
    jcfg = dataclasses.replace(JCFG, norm=True, mu=2.0)
    tcfg = dataclasses.replace(TCFG, norm=True, mu=2.0)
    want = jm.maecho_aggregate(clients, projs, jcfg, backend="kernel")
    got = tm.maecho_aggregate(to_port(clients), to_port(projs), tcfg,
                              backend="kernel", device="cpu")
    _assert_close(got, want)


@pytest.mark.parametrize("init", ("average", "first"))
def test_default_projections_and_init(init):
    clients, _, _ = _case(9, 2, "scalar", "oi", (48, 64), False)
    jcfg = dataclasses.replace(JCFG, init=init)
    tcfg = dataclasses.replace(TCFG, init=init)
    _assert_close(tm.maecho_aggregate(to_port(clients), None, tcfg,
                                      device="cpu"),
                  jm.maecho_aggregate(clients, None, jcfg))


@pytest.mark.parametrize("backend", ("oracle", "kernel", "auto"))
@pytest.mark.parametrize("convention", strat.CONVENTIONS)
def test_dispatch_summary_matches_reference(backend, convention):
    """Route for route on a mixed tree: a tiled, a padded and a sub-tile
    weight with every projector kind, plus scalar-rule biases."""
    tree_w, tree_p = [], []
    for i, (kind, shape) in enumerate(zip(strat.KINDS, ((128, 128), (200, 140),
                                                       (48, 64), (256, 140)))):
        W, _, P = strat.build_layer(i, 3, kind, shape)
        tree_w.append({"W": W if convention == "oi" else W.T,
                       "b": np.zeros(shape[0], np.float32)})
        tree_p.append({"W": P, "b": np.ones(3, np.float32)})
    levels = jax.tree_util.tree_map(lambda _: 0, tree_w)
    want = jm.dispatch_summary(tree_w, tree_p, levels, JCFG, convention, backend)
    got = tm.dispatch_summary(to_port(tree_w), to_port(tree_p), levels, TCFG,
                              convention, backend)
    assert got == want


def test_paper_mlp_routes():
    """The paper MLP on the kernel backend: W0 and W1 take the kernel
    route, everything else the oracle — the main path's three kernels
    each launch twice per outer iteration."""
    dims = (784, 400, 200, 100, 10)
    W0 = [{"W": np.zeros((b, a), np.float32), "b": np.zeros(b, np.float32)}
          for a, b in zip(dims[:-1], dims[1:])]
    P = [{"W": np.zeros((4, a, a), np.float32), "b": np.ones(4, np.float32)}
         for a in dims[:-1]]
    levels = jax.tree_util.tree_map(lambda _: 0, W0)
    per_leaf, counts = tm.dispatch_summary(to_port(W0), to_port(P), levels,
                                           TCFG, "oi", "kernel")
    assert [p for p, _, r in per_leaf if r == "kernel"] == ["0.W", "1.W"]
    assert counts == {"kernel": 2, "oracle": 6}
    assert (per_leaf, counts) == jm.dispatch_summary(W0, P, levels, JCFG,
                                                     "oi", "kernel")


@pytest.mark.parametrize("what", ("sharded", "sharded2d", "stacked", "chunk"))
def test_unported_options_raise(what):
    clients, projs, _ = _case(1, 2, "full", "oi", (48, 64), False)
    kw, cfg = {"device": "cpu"}, TCFG
    if what.startswith("sharded"):
        kw["backend"] = what
    elif what == "stacked":
        kw["stack_levels"] = {"W": 1, "b": 0}
    else:
        cfg = dataclasses.replace(TCFG, client_chunk=2)
    with pytest.raises(NotImplementedError, match="ROADMAP item A"):
        tm.maecho_aggregate(to_port(clients), to_port(projs), cfg, **kw)


@pytest.mark.parametrize("bad", ("backend", "mask_shape", "mask_empty"))
def test_bad_arguments_raise(bad):
    clients, projs, _ = _case(1, 2, "full", "oi", (48, 64), False)
    kw = {"backend": "gpu"} if bad == "backend" else {
        "client_mask": [True] if bad == "mask_shape" else [False, False]}
    with pytest.raises(ValueError):
        tm.maecho_aggregate(to_port(clients), to_port(projs), TCFG,
                            device="cpu", **kw)
