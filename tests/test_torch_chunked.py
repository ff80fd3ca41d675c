"""Port parity on the client-chunked path (the large-cohort mode,
``MAEchoConfig.client_chunk``): B19's plain version (the CPU path of
``maecho_gram_cross``) against the reference's Pallas kernel in interpret
mode, B20's (``rank_downdate`` / ``block_rls_update``) against the
reference's, the blocked QP, the chunked Gram/apply ops for every
projector kind, unstacked and stacked, the chunked aggregate on every
route, the plan's chunk, and the chunked Gram's O(chunk) residual
residency.

Inputs come from fixed numpy seeds (or the reference's own case
builder).  Tolerances: Grams 1e-5·max|G| (fp32 sums in another order),
Eq. 7 / Eq. 11 outputs 1e-4 and B20 1e-3 (the reference's kernel tests),
QP α 1e-5 (the reference's blocked-QP tests), aggregates 1e-3 on W and
the anchors.
"""
import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strategies as strat
from repro.core import maecho as jm
from repro.core import plan as jplan
from repro.core import qp as jqp
from repro.kernels import maecho_gram as jmg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.core import maecho as tm
from repro_torch.core import plan as tplan
from repro_torch.core import projections as tproj
from repro_torch.core import qp as tqp
from repro_torch.kernels import maecho_gram as tmg
from repro_torch.kernels import ops, ref

JCFG = jm.MAEchoConfig(tau=2, eta=0.5, qp_iters=60)
TCFG = tm.MAEchoConfig(tau=2, eta=0.5, qp_iters=60)
APPLY_TOL = dict(atol=1e-4, rtol=1e-4)


def to_port(tree):
    return interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _gram_close(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _tree_close(got, want, tol=1e-3):
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want),
                                 strict=True):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=tol,
                                   err_msg=f"leaf {path}")


def _chunked(cfg, chunk):
    return dataclasses.replace(cfg, client_chunk=chunk)


# --------------------------------------------------------------------------
# B19: the chunk-pair cross-Gram
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ca,cb,D", ((5, 3, 1024), (8, 8, 2048), (1, 7, 512)))
def test_gram_cross_matches_pallas_interpret(ca, cb, D):
    """ref.maecho_gram_cross_ref and the CPU wrapper against the
    reference's Pallas kernel (bd = 512, interpret mode)."""
    r = np.random.RandomState(ca * 100 + cb + D)
    Ra = r.randn(ca, D).astype(np.float32)
    Rb = r.randn(cb, D).astype(np.float32)
    want = jmg.maecho_gram_cross(jnp.asarray(Ra), jnp.asarray(Rb), bd=512,
                                 interpret=True)
    ta, tb = torch.from_numpy(Ra), torch.from_numpy(Rb)
    _gram_close(ref.maecho_gram_cross_ref(ta, tb), want)
    _gram_close(tmg.maecho_gram_cross(ta, tb), want)
    _gram_close(ops.maecho_gram_cross(ta, tb), want)


@pytest.mark.parametrize("ca,cb,D", ((5, 3, 1000), (4, 6, 5001), (3, 3, 3073)))
def test_gram_cross_plain_ragged(ca, cb, D):
    """A D the reference's kernel refuses (not a multiple of bd) against
    a float64 product, through both the one-slab and the slabbed form,
    and with Ra the same tensor as Rb (a diagonal block)."""
    r = np.random.RandomState(D)
    Ra = r.randn(ca, D).astype(np.float32)
    Rb = r.randn(cb, D).astype(np.float32)
    ta, tb = torch.from_numpy(Ra), torch.from_numpy(Rb)
    _gram_close(ref.maecho_gram_cross_ref(ta, tb), Ra.astype(np.float64) @ Rb.T)
    _gram_close(ref.maecho_gram_cross_ref(ta, ta), Ra.astype(np.float64) @ Ra.T)


# --------------------------------------------------------------------------
# B20: the block-RLS downdate
# --------------------------------------------------------------------------
def _rls_inputs(d, b):
    r = np.random.RandomState(d + b)
    Q0 = r.randn(d, d)
    Q = (Q0 @ Q0.T / d + np.eye(d)).astype(np.float32)
    return Q, r.randn(b, d).astype(np.float32)


@pytest.mark.parametrize("d,b", ((128, 16), (256, 32), (512, 8)))
def test_block_rls_update_matches_reference(d, b):
    """ops.block_rls_update (the B20 route) and core.projections'
    block_update against the reference's ops.block_rls_update (Pallas,
    interpret) and ref.block_rls_update_ref, as tests/test_kernels.py
    holds them."""
    Q, Xb = _rls_inputs(d, b)
    want = jops.block_rls_update(jnp.asarray(Q), jnp.asarray(Xb), 1.0, bo=128)
    want_ref = jref.block_rls_update_ref(jnp.asarray(Q), jnp.asarray(Xb), 1.0)
    tQ, tX = torch.from_numpy(Q), torch.from_numpy(Xb)
    for got in (ops.block_rls_update(tQ, tX, 1.0), tproj.block_update(tQ, tX, 1.0)):
        for w in (want, want_ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("d,b", ((128, 16), (96, 40)))
def test_rank_downdate_matches_reference(d, b):
    """ops.rank_downdate on the CPU against the reference's Pallas
    rank_downdate (interpret) and its plain Q − U A Uᵀ; a d that is no
    multiple of a tile against the plain form only."""
    r = np.random.RandomState(d * b)
    Q = r.randn(d, d).astype(np.float32)
    U = r.randn(d, b).astype(np.float32)
    A0 = r.randn(b, b)
    A = (0.5 * (A0 + A0.T)).astype(np.float32)
    got = ops.rank_downdate(torch.from_numpy(Q), torch.from_numpy(U), torch.from_numpy(A))
    np.testing.assert_allclose(got.numpy(), jref.rank_downdate_ref(Q, U, A),
                               atol=1e-3, rtol=1e-3)
    if d % 128 == 0:
        want = jops.rank_downdate(jnp.asarray(Q), jnp.asarray(U), jnp.asarray(A), bo=128,
                                  bj=128)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-3)


def test_block_rls_chain_matches_null_projector():
    """A client's null-space projector built by chaining
    ops.block_rls_update over its 128-row feature blocks equals
    core.projections.null_projector_from_features."""
    r = np.random.RandomState(7)
    X = r.randn(300, 96).astype(np.float32) @ r.randn(96, 160).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    tX = torch.from_numpy(X)
    want = tproj.null_projector_from_features(tX, 1e-3, 128)
    Q = tproj.null_projector_init(160)
    Xp = torch.nn.functional.pad(tX, (0, 0, 0, (-300) % 128))
    for Xb in Xp.reshape(-1, 128, 160):
        Q = ops.block_rls_update(Q, Xb, 1e-3)
    np.testing.assert_allclose(Q.numpy(), want.numpy(), atol=1e-3)


# --------------------------------------------------------------------------
# the blocked QP
# --------------------------------------------------------------------------
@pytest.mark.parametrize("use_mask", (False, True))
@pytest.mark.parametrize("n,rb", ((5, 2), (8, 3), (16, 16), (12, 64), (17, 7)))
def test_solve_qp_blocked_matches_reference(n, rb, use_mask):
    r = np.random.RandomState(n * 31 + rb)
    X = (r.randn(n, n + 3) * 0.5).astype(np.float32)
    G = X @ X.T + np.float32(0.1) * np.eye(n, dtype=np.float32)
    mask = (np.arange(n) % 3 != 1) if use_mask else None
    want = jqp.solve_qp_blocked(jnp.asarray(G), 0.6, iters=200,
                                mask=None if mask is None else jnp.asarray(mask),
                                row_block=rb)
    tG = torch.from_numpy(G)
    tmask = None if mask is None else torch.from_numpy(mask)
    for got in (tqp.solve_qp_blocked(tG, 0.6, iters=200, mask=tmask, row_block=rb),
                tqp.solve_qp(tG, 0.6, iters=200, mask=tmask, row_block=rb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(tqp.solve_qp(tG, 0.6, iters=200, mask=tmask).numpy(),
                               np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("masked", (False, True))
def test_solve_qp_batched_row_block_matches_reference(masked):
    r = np.random.RandomState(3)
    X = (r.randn(4, 9, 12) * 0.5).astype(np.float32)
    G = np.einsum("bnd,bmd->bnm", X, X) + np.float32(0.1) * np.eye(9, dtype=np.float32)
    mask = (r.rand(4, 9) < 0.7) | (np.arange(9) == 0) if masked else None
    kw = {} if mask is None else {"mask": mask}
    want = jqp.solve_qp_batched(jnp.asarray(G), 0.6, iters=150, row_block=4,
                                **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tqp.solve_qp_batched(torch.from_numpy(G), 0.6, iters=150, row_block=4,
                               **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    flat = tqp.solve_qp_batched(torch.from_numpy(G), 0.6, iters=150,
                                **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), flat.numpy(), atol=1e-5)


# --------------------------------------------------------------------------
# the chunked Gram / apply ops
# --------------------------------------------------------------------------
def _leaf(seed, n, kind, lead, out_d=128, in_d=136, rank=24):
    """W (lead…, out, in), V (N, lead…, out, in), the stacked projector
    of ``kind`` and α on the simplex (lead…, N), float32 numpy."""
    r = np.random.RandomState(seed)
    W = (r.randn(*lead, out_d, in_d) * 0.5).astype(np.float32)
    V = (W + r.randn(n, *lead, out_d, in_d) * 0.5).astype(np.float32)
    if kind == "scalar":
        P = r.rand(n, *lead).astype(np.float32)
    elif kind == "diag":
        P = r.rand(n, *lead, in_d).astype(np.float32)
    else:
        U = np.linalg.qr(r.randn(n, *lead, in_d, rank))[0].astype(np.float32)
        s = (0.1 + 0.9 * r.rand(n, *lead, rank)).astype(np.float32)
        P = ({"U": U, "s": s} if kind == "factored" else
             np.einsum("...ik,...k,...jk->...ij", U, s, U).astype(np.float32))
    a = r.rand(*lead, n) + 0.1
    return W, V, P, (a / a.sum(-1, keepdims=True)).astype(np.float32)


def _j(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def _t(x):
    return jax.tree_util.tree_map(torch.from_numpy, x)


@pytest.mark.parametrize("n,chunk", ((6, 3), (5, 2)))
@pytest.mark.parametrize("stacked", (False, True))
@pytest.mark.parametrize("kind", strat.KINDS)
def test_chunked_ops_match_reference(kind, stacked, n, chunk):
    """ops.maecho_streaming_{gram,apply}_chunked{,_stacked} against the
    reference's (its unstacked Gram through the Pallas cross-Gram in
    interpret mode, as a kernel-route leaf runs it) and against the
    port's own unchunked oracle, at a chunk that divides N and one that
    does not."""
    lead = (2,) if stacked else ()
    W, V, P, alpha = _leaf(n * 10 + len(kind), n, kind, lead)
    kw = dict(eta=0.5, frac=20.0 / 21.0, norm=True, eps=1e-12)
    if stacked:
        Gj, cj = jops.maecho_streaming_gram_chunked_stacked(_j(W), _j(V), _j(P), chunk=chunk)
        Wj, Vj = jops.maecho_streaming_apply_chunked_stacked(jnp.asarray(alpha), cj, **kw)
        G, ctx = ops.maecho_streaming_gram_chunked_stacked(_t(W), _t(V), _t(P), chunk=chunk)
        Wt, Vt = ops.maecho_streaming_apply_chunked_stacked(torch.from_numpy(alpha), ctx, **kw)
    else:
        Gj, cj = jops.maecho_streaming_gram_chunked(_j(W), _j(V), _j(P), chunk=chunk,
                                                    use_kernel=True, interpret=True)
        Wj, Vj = jops.maecho_streaming_apply_chunked(jnp.asarray(alpha), cj, **kw)
        G, ctx = ops.maecho_streaming_gram_chunked(_t(W), _t(V), _t(P), chunk=chunk,
                                                   use_kernel=True)
        Wt, Vt = ops.maecho_streaming_apply_chunked(torch.from_numpy(alpha), ctx, **kw)
    _gram_close(G, Gj)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), **APPLY_TOL)
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), **APPLY_TOL)
    levels = len(lead)
    Gu, R = tm._oracle_gram(_t(W), _t(V), _t(P), "oi", levels)
    Wu, Vu = tm._oracle_apply(_t(W), _t(V), _t(P), R, torch.from_numpy(alpha), "oi",
                              levels, **kw)
    _gram_close(G, Gu)
    np.testing.assert_allclose(Wt.numpy(), Wu.numpy(), **APPLY_TOL)
    np.testing.assert_allclose(Vt.numpy(), Vu.numpy(), **APPLY_TOL)


def test_chunked_gram_holds_at_most_two_chunk_residuals(monkeypatch):
    """At N = 64, 128 x 128, chunk 8, no more than two chunks' residuals
    are alive at any point of the chunked Gram (the port's stand-in for
    the reference's compiled-temp-bytes check): every residual the sweep
    forms is tracked, and when the next one is made at most one other
    may still exist."""
    N, chunk = 64, 8
    W, V, P, _ = _leaf(11, N, "diag", (), 128, 128)
    alive, made, worst = [], [0], [0]
    inner = ops._chunked_resid

    def tracked(*args):
        alive[:] = [r for r in alive if r() is not None]
        worst[0] = max(worst[0], len(alive) + 1)
        R = inner(*args)
        assert R.shape[0] <= chunk
        alive.append(weakref.ref(R))
        made[0] += 1
        return R

    monkeypatch.setattr(ops, "_chunked_resid", tracked)
    G, _ = ops.maecho_streaming_gram_chunked(_t(W), _t(V), _t(P), chunk=chunk,
                                             use_kernel=True)
    nc = N // chunk
    assert made[0] == nc * (nc + 1) // 2          # row chunks once, column chunks per pair
    assert worst[0] <= 2
    _gram_close(G, ref.maecho_gram_ref(_t(W), _t(V), _t(P)))


# --------------------------------------------------------------------------
# the chunked aggregate
# --------------------------------------------------------------------------
def _check_chunked_aggregate(kind, convention, lead, chunk, qp_batched=True):
    """The port's chunked aggregate (oracle and kernel backends; CPU:
    plain versions) against the reference's at the same chunk, anchors
    included: N = 6, with a mask at chunk 3, so chunk 2 and 3 divide N
    and, on the masked-in clients' dead chunks, leave them empty."""
    shape = (128, 128) if lead else (140, 130)
    clients, projs, levels, mask = strat.build_case(5 + chunk, 6, kind, convention, lead,
                                                    shape, chunk == 3)
    cfg_j = dataclasses.replace(_chunked(JCFG, chunk), qp_batched=qp_batched)
    cfg_t = dataclasses.replace(_chunked(TCFG, chunk), qp_batched=qp_batched)
    want_w, want_v = jm.maecho_aggregate(clients, projs, cfg_j, convention=convention,
                                         stack_levels=levels, client_mask=mask,
                                         return_anchors=True)
    tmask = None if mask is None else np.asarray(mask)
    for backend in ("oracle", "kernel"):
        got_w, got_v = tm.maecho_aggregate(
            to_port(clients), to_port(projs), cfg_t, convention=convention,
            stack_levels=levels, client_mask=tmask, return_anchors=True,
            backend=backend, device="cpu")
        _tree_close(got_w, want_w)
        _tree_close(got_v, want_v)


@pytest.mark.parametrize("chunk", (2, 3))
@pytest.mark.parametrize("lead", ((), (2,), (2, 2)))
@pytest.mark.parametrize("convention", strat.CONVENTIONS)
@pytest.mark.parametrize("kind", strat.KINDS)
def test_chunked_aggregate_matches_reference(kind, convention, lead, chunk):
    _check_chunked_aggregate(kind, convention, lead, chunk)


@pytest.mark.parametrize("chunk", (2, 3))
@pytest.mark.parametrize("lead", ((2,), (2, 2)))
@pytest.mark.parametrize("kind", strat.KINDS)
def test_chunked_stacked_sequential_qp_matches_reference(kind, lead, chunk):
    """A stacked leaf's QP solved per leaf (``qp_batched=False``): one
    (lead…, N, N) Gram stack with the leaf's (N,) mask (chunk 3) or none
    (chunk 2), as the reference vmaps its sequential solve over the
    layers."""
    _check_chunked_aggregate(kind, "oi", lead, chunk, qp_batched=False)


@pytest.mark.parametrize("kind", strat.KINDS)
def test_chunked_kernel_aggregate_matches_reference_kernel_backend(kind):
    """N = 5 at chunk 2 (the last chunk short) on the kernel route,
    against the reference's kernel backend (its chunk pairs through the
    Pallas cross-Gram in interpret mode), with the row norm on and a
    sequential-QP run beside the batched one."""
    clients, projs, levels, _ = strat.build_case(13, 5, kind, "oi", (), (140, 130), False)
    for qp_batched in (True, False):
        cfg_j = dataclasses.replace(JCFG, client_chunk=2, norm=True, mu=2.0,
                                    qp_batched=qp_batched)
        cfg_t = dataclasses.replace(TCFG, client_chunk=2, norm=True, mu=2.0,
                                    qp_batched=qp_batched)
        want = jm.maecho_aggregate(clients, projs, cfg_j, stack_levels=levels,
                                   backend="kernel")
        got = tm.maecho_aggregate(to_port(clients), to_port(projs), cfg_t,
                                  stack_levels=levels, backend="kernel", device="cpu")
        _tree_close(got, want)


@pytest.mark.parametrize("mask,n,chunk", [
    ([True, False, False, True, True, True], 6, 2),
    ([True, True, False, False, True, True], 6, 2),
    ([True, True, True, True, False], 5, 2),
    ([True, False, False, False, True, True, False], 7, 3),
])
def test_chunked_mask_edges_match_reference(mask, n, chunk):
    """The reference's chunk-boundary mask edges: a singleton chunk, a
    dead chunk, a dead ragged tail — W and the anchors against the
    reference's chunked aggregate and the port's unchunked one."""
    clients, projs, levels, _ = strat.build_case(11, n, "full", "oi", (), (48, 64), False)
    mask = np.asarray(mask)
    want_w, want_v = jm.maecho_aggregate(clients, projs, _chunked(JCFG, chunk),
                                         stack_levels=levels, client_mask=mask,
                                         return_anchors=True)
    for cfg in (_chunked(TCFG, chunk), TCFG):
        got_w, got_v = tm.maecho_aggregate(to_port(clients), to_port(projs), cfg,
                                           stack_levels=levels, client_mask=mask,
                                           return_anchors=True, device="cpu")
        _tree_close(got_w, want_w)
        _tree_close(got_v, want_v)


def test_chunk_at_least_n_is_unchunked():
    clients, projs, levels, _ = strat.build_case(11, 4, "factored", "oi", (), (140, 130),
                                                 False)
    want = tm.maecho_aggregate(to_port(clients), to_port(projs), TCFG, stack_levels=levels,
                               backend="kernel", device="cpu")
    for chunk in (4, 64):
        got = tm.maecho_aggregate(to_port(clients), to_port(projs), _chunked(TCFG, chunk),
                                  stack_levels=levels, backend="kernel", device="cpu")
        _tree_close(got, want, tol=1e-5)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------
def _plan_args(n=4):
    W0 = {"W": np.zeros((256, 128), np.float32), "b": np.zeros((256,), np.float32)}
    P = {"W": np.zeros((n, 128, 128), np.float32), "b": np.zeros((n,), np.float32)}
    return W0, P, {"W": 0, "b": 0}


def test_plan_records_clamped_chunk():
    W0, P, levels = _plan_args(4)
    plan = tplan.compile_plan(to_port(W0), to_port(P), levels, "oi", "kernel", 64)
    by_path = {lp.path: lp for lp in plan.leaves}
    assert by_path["W"].client_chunk == 4          # clamped to N
    assert by_path["b"].client_chunk == 0          # a bias never chunks
    want = jplan.compile_plan(W0, P, levels, _chunked(JCFG, 64), "oi", "kernel")
    assert [lp.client_chunk for lp in plan.leaves] == [lp.client_chunk
                                                        for lp in want.leaves]


def test_plan_memoizes_on_chunk():
    W0, P, levels = _plan_args(4)
    args = (to_port(W0), to_port(P), levels, "oi", "kernel")
    p1, p2 = tplan.compile_plan(*args, 2), tplan.compile_plan(*args, 2)
    assert p1 is p2
    p3 = tplan.compile_plan(*args, 0)
    assert p3 is not p1
    assert all(lp.client_chunk == 0 for lp in p3.leaves)
    assert [lp.client_chunk for lp in p1.leaves] == [2, 0]


@pytest.mark.parametrize("chunk", (0, 2))
@pytest.mark.parametrize("backend", ("oracle", "kernel", "auto"))
def test_dispatch_summary_chunked_count_matches_reference(backend, chunk):
    """Route for route and the "chunked" count on a mixed tree: a tiled
    and a sub-tile weight, a stacked leaf and scalar-rule biases."""
    tree_w, tree_p = [], []
    for i, (kind, shape) in enumerate((("full", (128, 128)), ("factored", (48, 64)))):
        W, _, P = strat.build_layer(i, 3, kind, shape)
        tree_w.append({"W": W, "b": np.zeros(shape[0], np.float32)})
        tree_p.append({"W": P, "b": np.ones(3, np.float32)})
    tree_w.append({"W": np.zeros((2, 128, 128), np.float32)})
    tree_p.append({"W": np.ones((3, 2, 128), np.float32)})
    levels = [{"W": 0, "b": 0}, {"W": 0, "b": 0}, {"W": 1}]
    want = jm.dispatch_summary(tree_w, tree_p, levels, _chunked(JCFG, chunk), "oi", backend)
    got = tm.dispatch_summary(to_port(tree_w), to_port(tree_p), levels,
                              _chunked(TCFG, chunk), "oi", backend)
    assert got == want
    assert got[1].get("chunked", 0) == (3 if chunk else 0)
