"""Port parity on the stacked-leaf path (scan-stacked layers, the LLM
layout): the plain versions of B10/B13/B16, B11/B14/B17 and B12/B15/B18
(the CPU path of their wrappers) against the reference's stacked Pallas
kernels in interpret mode, the compressed residual of a stacked factored
leaf, the stacked streaming dispatch, the plan's per-leaf routes at one
and two layer axes, and the aggregate with ``stack_levels`` on the
kernel backend against the reference's.

Inputs come from fixed numpy seeds (or the reference's own case
builder).  Tolerances are the reference's kernel tests'
(tests/test_maecho_kernels.py): Gram atol 1e-2 / rtol 1e-4, Eq. 7 and
Eq. 11 1e-4, aggregate 1e-3.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import strategies as strat
from repro.core import maecho as jm
from repro.kernels import maecho_gram as jmg
from repro.kernels import maecho_update as jmu
from repro.kernels import maecho_v_update as jmv
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.core import maecho as tm
from repro_torch.kernels import maecho_gram as tmg
from repro_torch.kernels import maecho_update as tmu
from repro_torch.kernels import maecho_v_update as tmv
from repro_torch.kernels import ops, ref

GRAM_TOL = dict(atol=1e-2, rtol=1e-4)
APPLY_TOL = dict(atol=1e-4, rtol=1e-4)
JCFG = jm.MAEchoConfig(tau=3, eta=0.5, mu=20.0, qp_iters=60)
TCFG = tm.MAEchoConfig(tau=3, eta=0.5, mu=20.0, qp_iters=60)
STACKED = (tmg.maecho_gram_stacked, tmu.maecho_update_stacked,
           tmv.maecho_v_update_stacked, tmg.maecho_gram_diag_stacked,
           tmu.maecho_update_diag_stacked, tmv.maecho_v_update_diag_stacked,
           tmg.maecho_gram_left_stacked, tmu.maecho_update_left_stacked,
           tmv.maecho_v_update_factored_stacked)


def to_port(tree):
    return interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _stacked_leaf(seed, n, L, out_d, in_d, kind, rank=40):
    """W (L, out, in), V (N, L, out, in), the projector — dense
    (N, L, in, in) rank-in/2 projectors, factored {"U": (N, L, in, rank)
    orthonormal, "s": (N, L, rank) in [0.1, 1]}, (N, L, in) diagonals in
    [0, 1] or (N, L) scalars — and alpha (L, N) on the simplex, float32."""
    r = np.random.RandomState(seed)
    W = (r.randn(L, out_d, in_d) * 0.5).astype(np.float32)
    V = (W + r.randn(n, L, out_d, in_d) * 0.5).astype(np.float32)
    if kind in ("full", "factored"):
        U = np.linalg.qr(r.randn(n, L, in_d, in_d // 2 if kind == "full" else rank))[0]
        P = (U @ np.swapaxes(U, -1, -2) if kind == "full" else
             {"U": U.astype(np.float32),
              "s": (0.1 + 0.9 * r.rand(n, L, rank)).astype(np.float32)})
    elif kind == "diag":
        P = r.rand(n, L, in_d)
    else:
        P = r.rand(n, L)
    if not isinstance(P, dict):
        P = P.astype(np.float32)
    a = r.rand(L, n) + 0.1
    return W, V, P, (a / a.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("norm", (False, True))
@pytest.mark.parametrize("kind", ("full", "diag", "factored"))
def test_stacked_plain_versions_match_pallas_interpret(kind, norm):
    """ref.maecho_*_stacked_ref and the nine stacked wrappers on CPU
    tensors against the reference's stacked Pallas kernels in interpret
    mode (L = 2, N = 3, out 128, in 256; factored rank 40); the wrappers
    count nothing on the CPU."""
    W, V, P, a = _stacked_leaf(11 + norm, 3, 2, 128, 256, kind)
    Wt, Vt, Pt, at = to_port((W, V, P, a))
    frac = 20.0 / 21.0
    for fn in STACKED:
        fn.launches = 0
    if kind == "factored":
        _check_factored_stacked(W, V, P, a, Wt, Vt, Pt, at, frac, norm)
        assert [fn.launches for fn in STACKED] == [0] * 9
        return
    if kind == "full":
        gram, update, v_update = STACKED[:3]
        want_g = jmg.maecho_gram_stacked(W, V, P)
        want_w = jmu.maecho_update_stacked(W, V, P, a, eta=0.5)
        want_v = jmv.maecho_v_update_stacked(want_w, V, P, frac=frac, norm=norm,
                                             bi=256)
        plain = (ref.maecho_gram_stacked_ref, ref.maecho_update_stacked_ref,
                 ref.maecho_v_update_stacked_ref)
    else:
        gram, update, v_update = STACKED[3:6]
        want_g = jmg.maecho_gram_diag_stacked(W, V, P)
        want_w = jmu.maecho_update_diag_stacked(W, V, P, a, eta=0.5)
        want_v = jmv.maecho_v_update_diag_stacked(want_w, V, P, frac=frac,
                                                  norm=norm, bi=256)
        plain = (ref.maecho_gram_diag_stacked_ref, ref.maecho_update_diag_stacked_ref,
                 ref.maecho_v_update_diag_stacked_ref)
    Wn = to_port(np.asarray(want_w))
    for g_fn in (plain[0], gram):
        _close(g_fn(Wt, Vt, Pt), want_g, **GRAM_TOL)
    for u_fn in (plain[1], update):
        _close(u_fn(Wt, Vt, Pt, at, 0.5), want_w, **APPLY_TOL)
    for v_fn in (plain[2], v_update):
        _close(v_fn(Wn, Vt, Pt, frac, norm), want_v, **APPLY_TOL)
    assert [fn.launches for fn in STACKED] == [0] * 9


def _check_factored_stacked(W, V, P, a, Wt, Vt, Pt, at, frac, norm):
    """B11/B14/B17's plain versions and wrappers (the latter's CPU path)
    against ``maecho_gram_left_stacked``, ``maecho_update_left_stacked``
    and ``maecho_v_update_factored_stacked`` in interpret mode, on the
    reference's own compressed residual A and Uᵀ; B17 also on its kernel
    operands (B, Uᵀ, W', V)."""
    U, s = P["U"], P["s"]
    A = jmg.compressed_residual(W, V, U, s)
    UT = np.ascontiguousarray(np.swapaxes(U, 2, 3))
    want_g = jmg.maecho_gram_left_stacked(A, UT)
    want_w = jmu.maecho_update_left_stacked(W, A, UT, a, eta=0.5)
    want_v = jmv.maecho_v_update_factored_stacked(want_w, V, U, s, frac=frac, norm=norm,
                                                  bi=256)
    At, UTt, Wn = to_port((np.asarray(A), UT, np.asarray(want_w)))
    Ut, st = Pt["U"], Pt["s"]
    _close(tmg.compressed_residual(Wt, Vt, Ut, st), A, **APPLY_TOL)
    for g_fn in (ref.maecho_gram_left_stacked_ref, tmg.maecho_gram_left_stacked):
        _close(g_fn(At, UTt), want_g, **GRAM_TOL)
    for u_fn in (ref.maecho_update_left_stacked_ref, tmu.maecho_update_left_stacked):
        _close(u_fn(Wt, At, UTt, at, 0.5), want_w, **APPLY_TOL)
    for v_fn in (ref.maecho_v_update_factored_stacked_ref,
                 tmv.maecho_v_update_factored_stacked):
        _close(v_fn(Wn, Vt, Ut, st, frac, norm), want_v, **APPLY_TOL)
    B = tmg.compressed_residual(Wn, Vt, Ut, st)
    for v_fn in (ref.maecho_v_update_left_stacked_ref, tmv.maecho_v_update_left_stacked):
        _close(v_fn(B, UTt, Wn, Vt, frac, norm), want_v, **APPLY_TOL)


def _tf32_rna(x):
    """fp32 x rounded to tf32 as ``cvt.rna.tf32.f32`` does: to nearest
    with ties away from zero, on 10 explicit significand bits; the low
    13 bits of the result are zero."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32(x):
    """B16's split of fp32 x into two tf32 terms: hi = tf32_rna(x),
    lo = tf32_rna(x - hi)."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


@given(st.integers(-100, 100), st.integers(0, 2 ** 23 - 1), st.booleans())
@settings(max_examples=200, deadline=None)
def test_tf32_split_is_within_2_pow_minus_22(exponent, mantissa, negative):
    """Any fp32 x of magnitude 2^-100 .. 2^101 is hi + lo to 2^-22·|x|,
    hi and lo each a tf32 value (low 13 bits zero, hi the nearest tf32
    to x): the error bound of the three products B16 keeps."""
    x = np.ldexp(1.0 + mantissa / 2.0 ** 23, exponent) * (-1.0 if negative else 1.0)
    xt = torch.tensor([x, 1.0, -3.0, 2.0 ** -100], dtype=torch.float32)
    hi, lo = _split_tf32(xt)
    for t in (hi, lo):
        assert torch.equal(t.view(torch.int32) & 0x1FFF, torch.zeros_like(t, dtype=torch.int32))
    err = (xt.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * xt.double().abs()).all())
    assert bool(((xt.double() - hi.double()).abs() <= 2.0 ** -11 * xt.double().abs()).all())


def _stage_parts(d, P, small_first=False):
    """The 3xTF32 residual products of B10/B13/B16 in torch: d and P split
    into tf32 hi and lo, and for each 32-deep stage of the depth a fresh
    accumulator summing the stage's products (the wgmma's sum inside a
    k-step of 8 is fp32 here): B16 takes, k-step by k-step, hi·hi + hi·lo
    + lo·hi; B10 and B13 (``small_first``) hi·lo + lo·hi of each k-step,
    then the four hi·hi.  Yields each stage's part of d·P."""
    dh, dl = _split_tf32(d)
    ph, pl = _split_tf32(P)
    depth = P.shape[-1]
    for k0 in range(0, depth, 32):
        steps = [slice(k8, k8 + 8) for k8 in range(k0, min(k0 + 32, depth), 8)]
        if small_first:
            terms = ([t for k in steps for t in ((dh, pl, k), (dl, ph, k))]
                     + [(dh, ph, k) for k in steps])
        else:
            terms = [t for k in steps for t in ((dh, ph, k), (dh, pl, k), (dl, ph, k))]
        part = torch.zeros(d.shape[:-1] + P.shape[-1:])
        for a, b, k in terms:
            part = part + a[..., k] @ b[..., k, :]
        yield part


def _fma(a, b, c):
    """fp32 fmaf(a, b, c): the product exact in float64, one rounding to
    float32 (up to the rare double rounding)."""
    return (a.double() * b.double() + c.double()).float()


def _emulated_residual_3xtf32(W, V, P, small_first=False):
    """R = (W - V)·P as the kernels form it: each stage's fresh part added
    to the running sum in fp32."""
    acc = torch.zeros(V.shape[:-1] + P.shape[-1:])
    for part in _stage_parts(W[None] - V, P, small_first):
        acc = acc + part
    return acc


def _emulated_v_update_3xtf32(W, V, P, frac, norm, eps=1e-12):
    """B16's scheme in torch on the CPU: D = W' - V in fp32, D·P by
    :func:`_emulated_residual_3xtf32`; then u = D - frac·acc, the row
    norm, V + u."""
    d = W[None] - V
    u = d - frac * _emulated_residual_3xtf32(W, V, P)
    if norm:
        u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True).clamp_min(eps)
    return V + u


def _emulated_update_3xtf32(W, V, P, alpha, eta):
    """B13's scheme: clients in order, each client's stages in order (small
    products first), each stage's fresh part added to one running sum by
    an fp32 FMA times m_i = -2 alpha_i; then fmaf(eta, acc, W)."""
    parts = list(_stage_parts(W[None] - V, P, small_first=True))   # (N, L, out, in)
    acc = torch.zeros_like(W)
    for i in range(V.shape[0]):
        m = (-2.0 * alpha[:, i])[:, None, None]
        for part in parts:
            acc = _fma(m, part[i], acc)
    return _fma(torch.tensor(eta), acc, W)


def _fragments(R):
    """R (..., out, in) cut into B10's 128 x 128 tiles (zero outside the
    leaf), each as the 256 threads' accumulator registers: (..., tiles,
    warp 8, lane 32, register 64), tiles in (out tile, in tile) order.
    Register 4n + 2i + j of lane 4g + t in warp 4wg + w4 holds row
    64wg + 16w4 + 8i + g, column 8n + 2t + j."""
    *lead, out_d, in_d = R.shape
    ro, ri = -(-out_d // 128), -(-in_d // 128)
    X = torch.zeros(*lead, ro * 128, ri * 128)
    X[..., :out_d, :in_d] = R
    X = X.reshape(*lead, ro, 2, 4, 2, 8, ri, 16, 4, 2)    # (ro, wg, w4, i, g, ri, n, t, j)
    k = len(lead)
    X = X.permute(*range(k), k, k + 5, k + 1, k + 2, k + 4, k + 7, k + 6, k + 3, k + 8)
    return X.reshape(*lead, ro * ri, 8, 32, 64)


def _emulated_gram_3xtf32(W, V, P):
    """B10's scheme: each R_i by :func:`_emulated_residual_3xtf32` (small
    products first); each pair's tile partial a sequential fmaf over each
    thread's 64 registers, an xor butterfly over the lanes (16, 8, 4, 2,
    1), the warps summed in index order; each layer's tiles summed in tile
    order in float64, rounded once (the reduce)."""
    frag = _fragments(_emulated_residual_3xtf32(W, V, P, small_first=True))
    N, L = V.shape[:2]
    lanes = torch.arange(32)
    G = torch.zeros(L, N, N)
    for i in range(N):
        for j in range(i + 1):
            s = torch.zeros(frag.shape[1:-1])
            for e in range(64):
                s = _fma(frag[i, ..., e], frag[j, ..., e], s)
            for off in (16, 8, 4, 2, 1):
                s = s + s[..., lanes ^ off]
            tile = torch.zeros(s.shape[:2])
            for w in range(8):
                tile = tile + s[..., w, 0]
            g = torch.zeros(L, dtype=torch.float64)
            for t in range(tile.shape[1]):
                g = g + tile[:, t].double()
            G[:, i, j] = G[:, j, i] = g.float()
    return G


SCHEME_SHAPES = ((2, 3, 128, 256), (2, 2, 33, 65), (1, 2, 200, 300), (3, 1, 64, 96))


@pytest.mark.parametrize("norm", (False, True))
@pytest.mark.parametrize("shape", SCHEME_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_3xtf32_scheme_matches_reference_kernel(shape, norm):
    """The emulated 3xTF32 scheme of B16 against the reference's
    ``maecho_v_update_stacked`` in interpret mode (one block a leaf, so
    ragged leaves need no padding) at the fp32 tolerance 1e-4, norm on
    and off."""
    L, n, out_d, in_d = shape
    W, V, P, _ = _stacked_leaf(31 + out_d + norm, n, L, out_d, in_d, "full")
    frac = 20.0 / 21.0
    want = jmv.maecho_v_update_stacked(W, V, P, frac=frac, norm=norm, bo=out_d, bi=in_d,
                                       bk=in_d)
    got = _emulated_v_update_3xtf32(*to_port((W, V, P)), frac, norm)
    _close(got, want, **APPLY_TOL)


@pytest.mark.parametrize("shape", SCHEME_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_3xtf32_update_scheme_matches_reference_kernel(shape):
    """B13's scheme (per-stage parts, FMA'd into one running sum times
    -2 alpha_i, clients in order) against the reference's
    ``maecho_update_stacked`` in interpret mode at 1e-4."""
    L, n, out_d, in_d = shape
    W, V, P, a = _stacked_leaf(41 + out_d, n, L, out_d, in_d, "full")
    want = jmu.maecho_update_stacked(W, V, P, a, eta=0.5, bo=out_d, bi=in_d, bk=in_d)
    got = _emulated_update_3xtf32(*to_port((W, V, P, a)), 0.5)
    _close(got, want, **APPLY_TOL)


@pytest.mark.parametrize("shape", SCHEME_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_3xtf32_gram_scheme_matches_reference_kernel(shape):
    """B10's scheme (3xTF32 residual tiles, fixed-order pair contraction
    over threads, lanes, warps and tiles) against the reference's
    ``maecho_gram_stacked`` in interpret mode at the Gram tolerance
    (rtol 1e-4), and symmetric."""
    L, n, out_d, in_d = shape
    W, V, P, _ = _stacked_leaf(51 + out_d, n, L, out_d, in_d, "full")
    want = jmg.maecho_gram_stacked(W, V, P, bo=out_d, bi=in_d, bk=in_d)
    got = _emulated_gram_3xtf32(*to_port((W, V, P)))
    assert torch.equal(got, got.transpose(1, 2))
    _close(got, want, **GRAM_TOL)


def test_fragment_layout_is_a_permutation():
    """:func:`_fragments` puts each element of a tile in exactly one
    thread's register, where the accumulator layout says: row ra + 8i,
    column 8n + 2t + j."""
    R = torch.arange(128 * 128, dtype=torch.float32).reshape(128, 128)
    frag = _fragments(R)[0]                              # (8, 32, 64)
    assert torch.equal(frag.flatten().sort().values, R.flatten())
    for warp, lane, e in ((0, 0, 0), (5, 17, 39), (7, 31, 63), (3, 6, 2)):
        ra = 64 * (warp // 4) + 16 * (warp % 4) + lane // 4
        n, i, j = e // 4, (e // 2) % 2, e % 2
        assert frag[warp, lane, e] == R[ra + 8 * i, 8 * n + 2 * (lane % 4) + j]


@pytest.mark.parametrize("lead", ((), (3,), (2, 2)), ids=("levels0", "levels1", "levels2"))
def test_compressed_residual_matches_reference_on_stacked_s(lead):
    """ref.compressed_residual_ref broadcasts s over out as the
    reference's ellipsis form does, for a per-client s (N, k) and a
    stacked s (N, …, k) alike."""
    r = np.random.RandomState(5 + len(lead))
    n, out_d, in_d, k = 3, 24, 40, 7
    W = r.randn(*lead, out_d, in_d).astype(np.float32)
    V = r.randn(n, *lead, out_d, in_d).astype(np.float32)
    U = r.randn(n, *lead, in_d, k).astype(np.float32)
    s = r.rand(n, *lead, k).astype(np.float32)
    got = ref.compressed_residual_ref(*to_port((W, V, U, s)))
    assert tuple(got.shape) == (n, *lead, out_d, k)
    _close(got, jmg.compressed_residual(W, V, U, s), **APPLY_TOL)


@pytest.mark.parametrize("kind,shape,norm", (("full", (128, 256), False),
                                             ("full", (200, 140), True),
                                             ("diag", (128, 256), True),
                                             ("diag", (200, 140), False),
                                             ("scalar", (128, 256), False),
                                             ("scalar", (200, 140), True),
                                             ("factored", (128, 256), True),
                                             ("factored", (200, 140), False)))
def test_streaming_stacked_matches_reference(kind, shape, norm):
    """ops.maecho_streaming_{gram,apply}_stacked (CPU: plain versions;
    the reference pads, the port masks) against the reference's stacked
    streaming pipeline in interpret mode, on tile and ragged leaves."""
    W, V, P, a = _stacked_leaf(23, 3, 2, *shape, kind)
    kw = dict(eta=0.5, frac=20.0 / 21.0, norm=norm, eps=1e-12)
    want_g, jctx = jops.maecho_streaming_gram_stacked(W, V, P)
    want_w, want_v = jops.maecho_streaming_apply_stacked(a, jctx, **kw)
    got_g, ctx = ops.maecho_streaming_gram_stacked(*to_port((W, V, P)))
    assert ctx[0] == (kind if kind in ("full", "factored") else "diag")
    got_w, got_v = ops.maecho_streaming_apply_stacked(to_port(a), ctx, **kw)
    _close(got_g, want_g, **GRAM_TOL)
    _close(got_w, want_w, **APPLY_TOL)
    _close(got_v, want_v, **APPLY_TOL)


def _routing_tree(lead):
    """A stacked model of leaves on every route: tileable dense and
    scalar leaves, a sub-tile diagonal one and a 1-D bias."""
    n = 3
    W = {"a": np.zeros(lead + (256, 140), np.float32),
         "b": np.zeros(lead + (64, 300), np.float32),
         "c": np.zeros(lead + (256,), np.float32),
         "d": np.zeros(lead + (300, 200), np.float32)}
    P = {"a": np.zeros((n,) + lead + (140, 140), np.float32),
         "b": np.zeros((n,) + lead + (300,), np.float32),
         "c": np.zeros((n,) + lead, np.float32),
         "d": np.zeros((n,) + lead, np.float32)}
    return W, P, {k: len(lead) for k in W}


@pytest.mark.parametrize("backend", ("oracle", "kernel", "auto"))
@pytest.mark.parametrize("convention", ("oi", "io"))
@pytest.mark.parametrize("lead", ((4,), (2, 3)), ids=("levels1", "levels2"))
def test_dispatch_summary_matches_reference(lead, convention, backend):
    W, P, levels = _routing_tree(lead)
    want = jm.dispatch_summary(W, P, levels, JCFG, convention, backend)
    got = tm.dispatch_summary(to_port(W), to_port(P), levels, TCFG, convention,
                              backend)
    assert got == want
    if backend != "oracle":
        assert ("a", len(lead), "stacked") in got[0]


def _factored_routing_tree(lead):
    """A stacked model whose factored leaves take every route: a
    tileable one (stacked), a sub-tile one (oracle), and a 1-D bias."""
    n, k = 3, 16
    W = {"f": np.zeros(lead + (256, 140), np.float32),
         "g": np.zeros(lead + (64, 300), np.float32),
         "c": np.zeros(lead + (256,), np.float32)}
    P = {"f": {"U": np.zeros((n,) + lead + (140, k), np.float32),
               "s": np.zeros((n,) + lead + (k,), np.float32)},
         "g": {"U": np.zeros((n,) + lead + (300, k), np.float32),
               "s": np.zeros((n,) + lead + (k,), np.float32)},
         "c": np.zeros((n,) + lead, np.float32)}
    return W, P, {key: len(lead) for key in W}


@pytest.mark.parametrize("backend", ("oracle", "kernel", "auto"))
@pytest.mark.parametrize("convention", ("oi", "io"))
@pytest.mark.parametrize("lead", ((4,), (2, 3)), ids=("levels1", "levels2"))
def test_dispatch_summary_factored_stacked_matches_reference(lead, convention, backend):
    """A factored stacked leaf of at least one tile takes the stacked
    route (B11/B14/B17) on the kernel backends, as in the reference."""
    W, P, levels = _factored_routing_tree(lead)
    want = jm.dispatch_summary(W, P, levels, JCFG, convention, backend)
    got = tm.dispatch_summary(to_port(W), to_port(P), levels, TCFG, convention,
                              backend)
    assert got == want
    if backend != "oracle":
        assert ("f", len(lead), "stacked") in got[0]


@pytest.mark.parametrize("kind,convention,lead,masked", (
    ("full", "io", (2,), False), ("full", "oi", (2, 2), True),
    ("scalar", "io", (3,), False), ("diag", "oi", (2,), False),
    ("diag", "io", (2, 2), False), ("factored", "oi", (2,), False),
    ("factored", "io", (3,), False), ("factored", "oi", (2, 2), True),
    ("factored", "io", (2, 2), False)))
def test_stacked_aggregate_matches_reference(kind, convention, lead, masked):
    """maecho_aggregate(stack_levels=...) on the port's kernel backend
    (CPU: the stacked plain versions) and oracle backend against the
    reference's kernel backend at τ = 3, anchors included, within 1e-3;
    the sequential QP too on the masked case."""
    clients, projs, levels, mask = strat.build_case(7, 3, kind, convention, lead,
                                                    (160, 136), masked)
    want_w, want_v = jm.maecho_aggregate(clients, projs, JCFG, convention=convention,
                                         stack_levels=levels, client_mask=mask,
                                         return_anchors=True, backend="kernel")
    cfgs = [TCFG] + ([dataclasses.replace(TCFG, qp_batched=False)] if masked else [])
    tmask = None if mask is None else np.asarray(mask)
    for cfg in cfgs:
        for backend in ("kernel", "oracle"):
            got_w, got_v = tm.maecho_aggregate(
                to_port(clients), to_port(projs), cfg, convention=convention,
                stack_levels=levels, client_mask=tmask, return_anchors=True,
                backend=backend, device="cpu")
            for key in ("W", "b"):
                _close(got_w[key], want_w[key], atol=1e-3)
                _close(got_v[key], want_v[key], atol=1e-3)
