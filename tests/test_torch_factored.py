"""Port parity on the factored-projector path (paper Table 6,
Pᵢ = Uᵢ·diag(sᵢ)·Uᵢᵀ): the SVD compression of projectors, the plain
versions of B2/B5/B8 (the CPU path of their wrappers) against the
reference's Pallas kernels in interpret mode, the streaming dispatch's
factored branch, and the one-shot aggregate of factored clients.

Inputs come from fixed numpy seeds (no hypothesis draws).  Tolerances
are the reference's kernel tests' (tests/test_maecho_kernels.py): Gram
atol 1e-2 / rtol 1e-4, Eq. 7 and Eq. 11 1e-4, aggregate 1e-3.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.core import projections as jproj
from repro.core.maecho import MAEchoConfig as JCfg
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.fl import client as jc
from repro.fl import models as jpm
from repro.fl.server import one_shot_aggregate as j_aggregate
from repro.kernels import maecho_gram as jmg
from repro.kernels import maecho_update as jmu
from repro.kernels import maecho_v_update as jmv
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.core import plan as tplan
from repro_torch.core import projections as tproj
from repro_torch.core.maecho import MAEchoConfig as TCfg
from repro_torch.fl import models as tpm
from repro_torch.fl.server import one_shot_aggregate as t_aggregate
from repro_torch.kernels import ops, ref
from repro_torch.kernels.maecho_gram import compressed_residual, maecho_gram_left
from repro_torch.kernels.maecho_update import maecho_update_left
from repro_torch.kernels.maecho_v_update import (maecho_v_update_factored,
                                                 maecho_v_update_left)

GRAM_TOL = dict(atol=1e-2, rtol=1e-4)
APPLY_TOL = dict(atol=1e-4, rtol=1e-4)


def to_port(tree):
    return interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _leaf(seed, n, out_d, in_d, k):
    """W (out, in), V (N, out, in), orthonormal U (N, in, k), s (N, k)
    in [0.1, 1] and alpha on the simplex, float32 numpy."""
    r = np.random.RandomState(seed)
    W = (r.randn(out_d, in_d) * 0.5).astype(np.float32)
    V = (W + r.randn(n, out_d, in_d) * 0.5).astype(np.float32)
    U = np.stack([np.linalg.qr(r.randn(in_d, k))[0] for _ in range(n)])
    s = r.uniform(0.1, 1.0, (n, k))
    a = r.rand(n) + 0.1
    return (W, V, U.astype(np.float32), s.astype(np.float32),
            (a / a.sum()).astype(np.float32))


def _psd_with_gap(seed, d, k):
    """Symmetric PSD (d, d) whose top k eigenvalues are distinct and
    well apart (1.1 … 2.0) and the rest distinct below 0.5: the top-k
    eigenvectors are unique up to sign, so two eigensolvers agree."""
    r = np.random.RandomState(seed)
    Q = np.linalg.qr(r.randn(d, d))[0]
    lam = np.concatenate([np.linspace(2.0, 1.1, k),
                          np.linspace(0.5, 0.01, d - k)])
    return ((Q * lam) @ Q.T).astype(np.float32)


@pytest.mark.parametrize("d,k", ((16, 4), (40, 10), (64, 20)))
def test_svd_compress_matches_reference(d, k):
    P = _psd_with_gap(d + k, d, k)
    Uj, sj = (np.asarray(x) for x in jproj.svd_compress(P, k))
    Ut, st = tproj.svd_compress(torch.from_numpy(P), k)
    np.testing.assert_allclose(st.numpy(), sj, atol=1e-5)
    np.testing.assert_allclose(tproj.svd_restore(Ut, st).numpy(),
                               np.asarray(jproj.svd_restore(Uj, sj)), atol=1e-5)
    # columns agree up to sign (an eigenvector's sign is the solver's choice)
    sign = np.sign(np.sum(Ut.numpy() * Uj, axis=0))
    np.testing.assert_allclose(Ut.numpy() * sign, Uj, atol=1e-4)
    assert tproj.compression_ratio(d, k) == jproj.compression_ratio(d, k)


def test_factor_projection_tree_matches_reference():
    """Square leaves of at least ``min_dim`` are factored at min(k, d);
    an existing {"U", "s"} node, scalars, vectors, non-square and small
    matrices are kept as they are."""
    fact = {"U": np.ones((6, 2), np.float32), "s": np.ones(2, np.float32)}
    tree = {"big": _psd_with_gap(1, 24, 8), "small": np.eye(3, dtype=np.float32),
            "rect": np.ones((4, 5), np.float32), "bias": np.float32(1.0),
            "layers": [{"W": _psd_with_gap(2, 12, 8), "fact": fact},
                       (np.ones(7, np.float32),)]}
    want = jproj.factor_projection_tree(tree, 8, min_dim=4)
    got = tproj.factor_projection_tree(to_port(tree), 8, min_dim=4)
    got_np = interop.params_to_numpy(got)
    assert jax.tree_util.tree_structure(got_np) == jax.tree_util.tree_structure(want)
    assert got["big"]["U"].shape == (24, 8) and got["layers"][0]["W"]["U"].shape == (12, 8)
    for path in (("big",), ("layers", 0, "W")):
        g, w = got, want
        for key in path:
            g, w = g[key], w[key]
        np.testing.assert_allclose(tproj.svd_restore(g["U"], g["s"]).numpy(),
                                   np.asarray(jproj.svd_restore(w["U"], w["s"])),
                                   atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(got_np["small"])
                    + jax.tree_util.tree_leaves(got_np["rect"])
                    + jax.tree_util.tree_leaves(got_np["layers"][0]["fact"]),
                    jax.tree_util.tree_leaves(tree["small"])
                    + jax.tree_util.tree_leaves(tree["rect"])
                    + jax.tree_util.tree_leaves(fact)):
        np.testing.assert_array_equal(a, b)


def test_compressed_residual_matches_reference():
    W, V, U, s, _ = _leaf(3, 3, 96, 80, 12)
    _close(compressed_residual(*to_port((W, V, U, s))),
           jmg.compressed_residual(W, V, U, s), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("norm", (False, True))
@pytest.mark.parametrize("k", (20, 128))
def test_left_plain_versions_match_pallas_interpret(k, norm):
    """ref.maecho_gram_left_ref / maecho_update_left_ref /
    maecho_v_update_factored_ref (and so the B2/B5/B8 wrappers on CPU
    tensors) against the reference's Pallas kernels in interpret mode,
    out 128, in 256, N = 3."""
    W, V, U, s, a = _leaf(7 + k, 3, 128, 256, k)
    A = jmg.compressed_residual(W, V, U, s)
    UT = np.ascontiguousarray(np.swapaxes(U, 1, 2))
    At, UTt, Wt, Vt, Ut, st, at = to_port((A, UT, W, V, U, s, a))
    want_g = jmg.maecho_gram_left(A, UT)
    _close(ref.maecho_gram_left_ref(At, UTt), want_g, **GRAM_TOL)
    _close(maecho_gram_left(At, UTt), want_g, **GRAM_TOL)
    Wn = jmu.maecho_update_left(W, A, UT, a, eta=0.7)
    _close(ref.maecho_update_left_ref(Wt, At, UTt, at, 0.7), Wn, **APPLY_TOL)
    _close(maecho_update_left(Wt, At, UTt, at, 0.7), Wn, **APPLY_TOL)
    want_v = jmv.maecho_v_update_factored(Wn, V, U, s, frac=0.8, norm=norm,
                                          bi=256)
    Wnt = to_port(Wn)
    _close(ref.maecho_v_update_factored_ref(Wnt, Vt, Ut, st, 0.8, norm), want_v,
           **APPLY_TOL)
    _close(maecho_v_update_factored(Wnt, Vt, Ut, st, 0.8, norm), want_v,
           **APPLY_TOL)
    B = jmg.compressed_residual(Wn, V, U, s)
    _close(maecho_v_update_left(to_port(B), UTt, Wnt, Vt, 0.8, norm), want_v,
           **APPLY_TOL)


@pytest.mark.parametrize("norm", (False, True))
@pytest.mark.parametrize("shape", ((200, 140, 20), (128, 200, 150), (256, 130, 78)))
def test_streaming_factored_matches_reference(shape, norm):
    """gram → apply of one factored leaf through ``ops`` (CPU) against
    the reference's streaming pipeline, which pads ragged in-dims and
    ranks above one tile where the port masks them."""
    out_d, in_d, k = shape
    W, V, U, s, a = _leaf(sum(shape), 4, out_d, in_d, k)
    P = {"U": U, "s": s}
    G, ctx = ops.maecho_streaming_gram(*to_port((W, V, P)))
    assert ctx[0] == "factored"
    Wn, Vn = ops.maecho_streaming_apply(to_port(a), ctx, eta=0.5, frac=0.9,
                                        norm=norm)
    Gj, cj = jops.maecho_streaming_gram(W, V, P)
    Wj, Vj = jops.maecho_streaming_apply(a, cj, eta=0.5, frac=0.9, norm=norm)
    _close(G, Gj, **GRAM_TOL)
    _close(Wn, Wj, **APPLY_TOL)
    _close(Vn, Vj, **APPLY_TOL)


def test_factored_wrappers_count_only_kernel_launches():
    """On CPU tensors B2/B5/B8 run their plain versions, so the launch
    counters do not move."""
    W, V, U, s, a = to_port(_leaf(5, 2, 64, 48, 10))
    A = compressed_residual(W, V, U, s)
    UT = U.transpose(1, 2).contiguous()
    fns = (maecho_gram_left, maecho_update_left, maecho_v_update_factored)
    before = tuple(f.launches for f in fns)
    maecho_gram_left(A, UT)
    Wn = maecho_update_left(W, A, UT, a)
    maecho_v_update_factored(Wn, V, U, s, 0.5, True)
    maecho_v_update_left(compressed_residual(Wn, V, U, s), UT, Wn, V, 0.5)
    assert tuple(f.launches for f in fns) == before


def test_paper_mlp_factored_routes_match_reference():
    """Factored W0 (400×784) and W1 (200×400) take the kernel route; W2,
    W3 (below one 128-tile) and the biases stay on the oracle — in both
    packages, at table6_svd's k = 78."""
    n, k = 4, 78
    params = tpm.init(tpm.MLP_SPEC, seed=0, device="cpu")
    W0 = interop.params_to_numpy(params)
    P = [{"W": {"U": np.zeros((n, l["W"].shape[1], min(k, l["W"].shape[1])),
                              np.float32),
                "s": np.zeros((n, min(k, l["W"].shape[1])), np.float32)},
          "b": np.ones(n, np.float32)} for l in W0]
    levels = jax.tree_util.tree_map(lambda _: 0, W0)
    want = jplan.compile_plan(W0, P, levels, JCfg(), "oi", "kernel").per_leaf()
    got = tplan.compile_plan(to_port(W0), to_port(P), levels, "oi",
                             "kernel").per_leaf()
    assert got == want
    routes = {path: route for path, _, route in got}
    assert routes == {"0.W": "kernel", "1.W": "kernel", "2.W": "oracle",
                      "3.W": "oracle", "0.b": "oracle", "1.b": "oracle",
                      "2.b": "oracle", "3.b": "oracle"}


# a narrow MLP whose first layer (128 x 160) still takes the kernel route
JSPEC = jpm.PaperModelSpec("narrow", "mlp", (160,), hidden=(128, 16))
TSPEC = tpm.PaperModelSpec("narrow", "mlp", (160,), hidden=(128, 16))


def test_factored_aggregate_matches_reference():
    """The slice end to end: the reference's trained clients and
    projectors, factored by the reference at k = 20 and carried across
    (so both packages see the same (U, s): P = I − Q has near-degenerate
    eigenvalue clusters, where two eigensolvers may pick different
    bases), aggregated on the kernel backend in both — the port's plain
    versions on CPU against the reference's Pallas kernels in interpret
    mode."""
    data = jsyn.generate(jsyn.DatasetSpec("narrow", n_train=600, n_test=200,
                                          latent=8, out_dim=160, seed=2))
    parts = jpart.dirichlet_partition(data["train_y"], 3, 0.1, seed=1)
    cfg = jc.LocalTrainConfig(epochs=2, max_steps=20, seed=5)
    clients, projs = [], []
    for i, ix in enumerate(parts):
        p, _ = jc.train_classifier(JSPEC, jpm.init(JSPEC, jax.random.PRNGKey(i)),
                                   data["train_x"][ix], data["train_y"][ix], cfg)
        clients.append(p)
        projs.append(jproj.factor_projection_tree(
            jc.compute_projections(JSPEC, p, data["train_x"][ix]), 20))
    assert projs[0][0]["W"]["U"].shape == (160, 20)
    want = j_aggregate(JSPEC, clients, projs, "maecho",
                       cfg=JCfg(tau=3, eta=0.5, mu=20.0), backend="kernel")
    got = t_aggregate(TSPEC, to_port(clients), to_port(projs), "maecho",
                      cfg=TCfg(tau=3, eta=0.5, mu=20.0), backend="kernel",
                      device="cpu")
    g = jax.tree_util.tree_leaves(interop.params_to_numpy(got))
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        np.testing.assert_allclose(x, np.asarray(y), atol=1e-3)
