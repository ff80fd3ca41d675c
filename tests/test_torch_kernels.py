"""Port parity: the plain versions of the MA-Echo kernels (the CPU path
of the B1/B4/B7 wrappers) and the streaming dispatch, held against the
JAX package — its jnp oracles (``repro.kernels.ref``) over every
projector kind, and its Pallas wrappers (``ops.*_auto``, interpret
mode) on tiled, padded and sub-tile shapes.  Inputs come from the
reference's own builders and cross over as numpy.

Tolerances are the reference's kernel tests': Gram atol 1e-2 /
rtol 1e-4, update and v_update 1e-4.
"""
import jax
import numpy as np
import pytest

import strategies as strat
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.kernels import ops, ref
from repro_torch.kernels.maecho_gram import maecho_gram
from repro_torch.kernels.maecho_update import maecho_update
from repro_torch.kernels.maecho_v_update import maecho_v_update

# (out, in): direct tiling, padded to the 128-tile, below one tile
SHAPES = ((128, 128), (200, 140), (48, 64))


def to_port(tree):
    return interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _alpha(n, seed):
    return jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(seed + 1), (n,)))


def _close(got, want, atol, rtol=1e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("n", (1, 2, 5))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", strat.KINDS)
def test_plain_versions_match_reference_oracles(kind, shape, n):
    W, V, P = strat.build_layer(11 + n, n, kind, shape)
    a = _alpha(n, n)
    Wt, Vt, Pt, at = to_port((W, V, P, a))
    _close(ref.maecho_gram_ref(Wt, Vt, Pt), jref.maecho_gram_ref(W, V, P),
           atol=1e-2)
    _close(ref.maecho_update_ref_any(Wt, Vt, Pt, at, 0.7),
           jref.maecho_update_ref_any(W, V, P, a, 0.7), atol=1e-4)
    for norm in (False, True):
        _close(ref.maecho_v_update_ref(Wt, Vt, Pt, 0.5, norm),
               jref.maecho_v_update_ref(W, V, P, 0.5, norm), atol=1e-4)


@pytest.mark.parametrize("norm", (False, True))
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_dense_wrappers_match_pallas_interpret(shape, norm):
    """B1/B4/B7 wrappers on CPU tensors against the reference's Pallas
    kernels run in interpret mode (dense projectors, N = 2)."""
    W, V, P = strat.build_layer(5, 2, "full", shape)
    a = _alpha(2, 5)
    Wt, Vt, Pt, at = to_port((W, V, P, a))
    _close(maecho_gram(Wt, Vt, Pt), jops.maecho_gram_auto(W, V, P), atol=1e-2)
    Wn = jops.maecho_update_auto(W, V, P, a, eta=0.7)
    _close(maecho_update(Wt, Vt, Pt, at, 0.7), Wn, atol=1e-4)
    _close(maecho_v_update(to_port(Wn), Vt, Pt, 0.5, norm),
           jops.maecho_v_update_auto(Wn, V, P, frac=0.5, norm=norm), atol=1e-4)


@pytest.mark.parametrize("kind", strat.KINDS)
def test_streaming_pipeline_matches_reference(kind):
    """gram → apply of one leaf through ``ops``' dispatch (every kind on
    CPU tensors) against the reference's streaming pipeline."""
    W, V, P = strat.build_layer(23, 3, kind, (200, 140))
    a = _alpha(3, 23)
    G, ctx = ops.maecho_streaming_gram(*to_port((W, V, P)))
    Wn, Vn = ops.maecho_streaming_apply(to_port(a), ctx, eta=0.5, frac=0.8)
    Gj, cj = jops.maecho_streaming_gram(W, V, P)
    Wj, Vj = jops.maecho_streaming_apply(a, cj, eta=0.5, frac=0.8)
    _close(G, Gj, atol=1e-2)
    _close(Wn, Wj, atol=1e-4)
    _close(Vn, Vj, atol=1e-4)


def test_sub_tile_leaf_runs_oracle_and_warns():
    W, V, P = strat.build_layer(37, 2, "full", (6, 4))
    with pytest.warns(RuntimeWarning, match="below one"):
        G, ctx = ops.maecho_streaming_gram(*to_port((W, V, P)))
    assert ctx[0] == "ref"
    _close(G, jref.maecho_gram_ref(W, V, P), atol=1e-6, rtol=1e-6)


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain version, so the launch
    counters do not move."""
    W, V, P = to_port(strat.build_layer(3, 2, "full", (128, 128)))
    before = (maecho_gram.launches, maecho_update.launches,
              maecho_v_update.launches)
    maecho_gram(W, V, P)
    Wn = maecho_update(W, V, P, to_port(_alpha(2, 3)))
    maecho_v_update(Wn, V, P, 0.5)
    assert (maecho_gram.launches, maecho_update.launches,
            maecho_v_update.launches) == before
