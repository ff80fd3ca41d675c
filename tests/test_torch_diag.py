"""Port parity on the scalar/diagonal-projector path: the plain versions
of B3/B6/B9 (the CPU path of their wrappers) against the reference's
Pallas kernels in interpret mode, the streaming dispatch's scalar and
diagonal branches, and the aggregate with the default scalar
projectors (``projections=None``) on the kernel backend.

Inputs come from fixed numpy seeds.  Tolerances are the reference's
kernel tests' (tests/test_maecho_kernels.py): Gram atol 1e-2 / rtol
1e-4, Eq. 7 and Eq. 11 1e-4, aggregate 1e-3.
"""
import jax
import numpy as np
import pytest

from repro.core import maecho as jm
from repro.kernels import maecho_gram as jmg
from repro.kernels import maecho_update as jmu
from repro.kernels import maecho_v_update as jmv
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.core import maecho as tm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.maecho_gram import maecho_gram_diag
from repro_torch.kernels.maecho_update import maecho_update_diag
from repro_torch.kernels.maecho_v_update import maecho_v_update_diag

GRAM_TOL = dict(atol=1e-2, rtol=1e-4)
APPLY_TOL = dict(atol=1e-4, rtol=1e-4)


def to_port(tree):
    return interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _leaf(seed, n, out_d, in_d, kind="diag"):
    """W (out, in), V (N, out, in), a non-uniform projector in [0, 1] —
    (N, in) diagonals or (N,) scalars — and alpha on the simplex,
    float32 numpy."""
    r = np.random.RandomState(seed)
    W = (r.randn(out_d, in_d) * 0.5).astype(np.float32)
    V = (W + r.randn(n, out_d, in_d) * 0.5).astype(np.float32)
    p = r.rand(n, in_d) if kind == "diag" else r.rand(n)
    a = r.rand(n) + 0.1
    return W, V, p.astype(np.float32), (a / a.sum()).astype(np.float32)


@pytest.mark.parametrize("norm", (False, True))
@pytest.mark.parametrize("n", (1, 3))
def test_diag_plain_versions_match_pallas_interpret(n, norm):
    """ref.maecho_{gram,update,v_update}_diag_ref and the B3/B6/B9
    wrappers on CPU tensors against the reference's Pallas kernels in
    interpret mode (tile-multiple out 128, in 256)."""
    W, V, p, a = _leaf(5 + n, n, 128, 256)
    Wt, Vt, pt, at = to_port((W, V, p, a))
    want_g = jmg.maecho_gram_diag(W, V, p)
    _close(ref.maecho_gram_diag_ref(Wt, Vt, pt), want_g, **GRAM_TOL)
    _close(maecho_gram_diag(Wt, Vt, pt), want_g, **GRAM_TOL)
    Wn = jmu.maecho_update_diag(W, V, p, a, eta=0.7)
    _close(ref.maecho_update_diag_ref(Wt, Vt, pt, at, 0.7), Wn, **APPLY_TOL)
    _close(maecho_update_diag(Wt, Vt, pt, at, 0.7), Wn, **APPLY_TOL)
    want_v = jmv.maecho_v_update_diag(Wn, V, p, frac=0.8, norm=norm, bi=256)
    Wnt = to_port(Wn)
    _close(ref.maecho_v_update_diag_ref(Wnt, Vt, pt, 0.8, norm), want_v, **APPLY_TOL)
    _close(maecho_v_update_diag(Wnt, Vt, pt, 0.8, norm), want_v, **APPLY_TOL)


@pytest.mark.parametrize("norm", (False, True))
@pytest.mark.parametrize("shape", ((128, 256), (200, 140)))
@pytest.mark.parametrize("kind", ("scalar", "diag"))
def test_streaming_scalar_diag_matches_reference(kind, shape, norm):
    """gram → apply of one leaf through ``ops``' dispatch against the
    reference's streaming pipeline (which pads the ragged (200, 140)
    leaf to the tile; the port masks it); a scalar projector reaches
    the apply half as the broadcast (N, in) diagonal."""
    W, V, P, a = _leaf(17, 3, *shape, kind=kind)
    G, ctx = ops.maecho_streaming_gram(*to_port((W, V, P)))
    assert ctx[0] == "diag" and tuple(ctx[3].shape) == (3, shape[1])
    Wn, Vn = ops.maecho_streaming_apply(to_port(a), ctx, eta=0.5, frac=0.8,
                                        norm=norm)
    Gj, cj = jops.maecho_streaming_gram(W, V, P)
    Wj, Vj = jops.maecho_streaming_apply(a, cj, eta=0.5, frac=0.8, norm=norm)
    _close(G, Gj, **GRAM_TOL)
    _close(Wn, Wj, **APPLY_TOL)
    _close(Vn, Vj, **APPLY_TOL)


def test_diag_wrappers_count_only_kernel_launches():
    """On CPU tensors the B3/B6/B9 wrappers run the plain version, so
    their launch counters do not move."""
    W, V, p, a = to_port(_leaf(3, 2, 128, 128))
    before = (maecho_gram_diag.launches, maecho_update_diag.launches,
              maecho_v_update_diag.launches)
    maecho_gram_diag(W, V, p)
    maecho_v_update_diag(maecho_update_diag(W, V, p, a), V, p, 0.5, True)
    assert (maecho_gram_diag.launches, maecho_update_diag.launches,
            maecho_v_update_diag.launches) == before


def _mlp_clients(seed, n, dims):
    """``n`` clients of an MLP with layer widths ``dims``, as [{"W", "b"}]."""
    r = np.random.RandomState(seed)
    base = [{"W": r.randn(b, a).astype(np.float32) * np.float32(np.sqrt(2.0 / a)),
             "b": np.zeros(b, np.float32)} for a, b in zip(dims[:-1], dims[1:])]
    return [[{"W": lay["W"] + r.randn(*lay["W"].shape).astype(np.float32) * 0.1,
              "b": lay["b"] + r.randn(*lay["b"].shape).astype(np.float32) * 0.1}
             for lay in base] for _ in range(n)]


def test_paper_mlp_scalar_routes_match_reference():
    """With the default scalar projectors the paper MLP's W0 and W1 take
    the kernel route (B3/B6/B9) and W2, W3 and the biases the oracle,
    route for route as in the reference."""
    shapes = ((400, 784), (200, 400), (100, 200), (10, 100))
    W0 = [{"W": np.zeros(s, np.float32), "b": np.zeros(s[0], np.float32)}
          for s in shapes]
    P = [{"W": np.ones(4, np.float32), "b": np.ones(4, np.float32)} for _ in shapes]
    levels = jax.tree_util.tree_map(lambda _: 0, W0)
    want = jm.dispatch_summary(W0, P, levels, backend="kernel")
    got = tm.dispatch_summary(to_port(W0), to_port(P), levels, backend="kernel")
    assert got == want
    assert [path for path, _, route in got[0] if route == "kernel"] == ["0.W", "1.W"]


@pytest.mark.parametrize("norm", (False, True))
def test_scalar_aggregate_matches_reference(norm):
    """``maecho_aggregate(projections=None, backend="kernel")`` — the
    scalar rule, broadcast to diagonals on the kernel leaf (128 x 160)
    — against the reference's kernel backend at τ = 2."""
    clients = _mlp_clients(4, 3, (160, 128, 16))
    jcfg = jm.MAEchoConfig(tau=2, eta=0.5, mu=20.0, norm=norm, qp_iters=60)
    tcfg = tm.MAEchoConfig(tau=2, eta=0.5, mu=20.0, norm=norm, qp_iters=60)
    want = jm.maecho_aggregate(clients, None, jcfg, backend="kernel")
    got = tm.maecho_aggregate(to_port(clients), None, tcfg, backend="kernel",
                              device="cpu")
    for g, w in zip(got, want):
        for key in ("W", "b"):
            _close(g[key], w[key], atol=1e-3)
