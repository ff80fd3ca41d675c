"""Port parity: the Eq. 6 capped-simplex QP (``repro_torch.core.qp``)
against ``repro.core.qp`` (1e-6 — same iteration rule, same fp32
arithmetic) and against the numpy Frank-Wolfe reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qp as jqp
from repro_torch.core import qp


def _gram(n, d, seed):
    A = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    return A @ A.T


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("C", (1.0, 0.4))
@pytest.mark.parametrize("n", (2, 7, 20))
def test_projection_matches_reference(n, C, masked):
    r = np.random.RandomState(n)
    x = (r.randn(n) * 3).astype(np.float32)
    mask = (r.rand(n) < 0.7) if masked else None
    if masked:
        mask[0] = True
        C = max(C, 1.0 / mask.sum() + 1e-3)
    else:
        C = max(C, 1.0 / n + 1e-3)
    got = qp.project_capped_simplex(
        torch.from_numpy(x), C,
        mask=None if mask is None else torch.from_numpy(mask))
    want = jqp.project_capped_simplex(
        jnp.asarray(x), C, mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert abs(float(got.sum()) - 1.0) < 1e-4


@pytest.mark.parametrize("C", (1.0, 0.5, 0.25))
@pytest.mark.parametrize("n", (2, 5, 12))
def test_solve_qp_matches_reference_and_active_set(n, C):
    C = max(C, 1.0 / n + 1e-6)
    G = _gram(n, 2 * n, n + int(C * 100))
    got = qp.solve_qp(torch.from_numpy(G), C, iters=200).numpy()
    want = np.asarray(jqp.solve_qp(jnp.asarray(G), C, iters=200))
    np.testing.assert_allclose(got, want, atol=1e-6)
    a_ref = qp.solve_qp_active_set(G, C)
    np.testing.assert_allclose(a_ref, jqp.solve_qp_active_set(G, C))

    def obj(a):
        return 0.5 * a @ G.astype(np.float64) @ a

    assert obj(got) <= obj(a_ref) * 1.05 + 1e-6
    assert abs(got.sum() - 1) < 1e-4 and got.max() <= C + 1e-4


def test_solve_qp_masked_matches_reference():
    G = _gram(6, 9, 3)
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    got = qp.solve_qp(torch.from_numpy(G), 1.0, 150,
                      mask=torch.from_numpy(mask)).numpy()
    want = np.asarray(jqp.solve_qp(jnp.asarray(G), 1.0, 150,
                                   mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got[~mask] == 0).all()


@pytest.mark.parametrize("mode", ("full", "n_valid", "mask"))
def test_solve_qp_batched_matches_reference(mode):
    r = np.random.RandomState(0)
    grams = [_gram(n, 8, s) for s, n in enumerate((5, 3, 5, 4))]
    Gt, valid = qp.stack_grams([torch.from_numpy(g) for g in grams])
    Gj, valid_j = jqp.stack_grams([jnp.asarray(g) for g in grams])
    np.testing.assert_array_equal(Gt.numpy(), np.asarray(Gj))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    kw_t, kw_j = {}, {}
    if mode == "n_valid":
        kw_t, kw_j = {"n_valid": valid}, {"n_valid": valid_j}
    elif mode == "mask":
        m = r.rand(4, 5) < 0.6
        m[:, 0] = True
        kw_t, kw_j = {"mask": torch.from_numpy(m)}, {"mask": jnp.asarray(m)}
    got = qp.solve_qp_batched(Gt, 0.6, 120, **kw_t).numpy()
    want = np.asarray(jqp.solve_qp_batched(Gj, 0.6, 120, **kw_j))
    np.testing.assert_allclose(got, want, atol=1e-6)
    if mode == "n_valid":
        for l, n in enumerate((5, 3, 5, 4)):
            single = qp.solve_qp(torch.from_numpy(grams[l]), 0.6, 120).numpy()
            np.testing.assert_allclose(got[l, :n], single, atol=1e-6)
            assert (got[l, n:] == 0).all()
