"""The schemes of B2 (Eq. 6 Gram of Rᵢ = Aᵢ·UTᵢ) and B17 (stacked Eq. 11
from compressed residuals) on 3xTF32 ``wgmma``, the left form of
``csrc/maecho_tf32.cuh``'s stage (Aᵢ and UTᵢ, the depth the rank k),
emulated in torch on the CPU: Aᵢ and UTᵢ split into tf32 hi and lo, each
32-deep stage of the rank (the last one short) a fresh accumulator of
its small products first (hi·lo and lo·hi of each k-step of 8, then the
hi·hi), added in fp32 to a running sum.  B2 runs B1's route
(``csrc/maecho_splitk.cuh``, ``csrc/maecho_gram_pairs.cuh``): a (tile,
client) unit a CTA when the units fit one wave, else the stages cut into
equal shares and a split unit summed from its shares in CTA order; then
the pairs in fp64, rounding once.  B17's unit, one (layer, tile,
client), ends in W' − frac·acc (Vᵢ + (W' − Vᵢ) − frac·acc, Vᵢ cancelled)
with the row norm off, in B16's epilogue with it on: u = (W' − Vᵢ) −
frac·acc, the row norm, Vᵢ + u.  Each is held against the reference's Pallas
``maecho_gram_left`` / ``maecho_v_update_factored_stacked`` in interpret
mode at the fp32 tolerances (Gram atol 1e-2 / rtol 1e-4, Eq. 11 1e-4).
B17's persistent walk over the units (CTA b takes units b, b + C, ...,
clients fastest, stepped by a cursor) and B2's one-CTA-a-unit plan are
checked exactly.  The kernels themselves run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import maecho_gram as jmg
from repro.kernels import maecho_v_update as jmv
from repro_torch.kernels import maecho_gram as tmg
from test_torch_dense_tf32 import MIN_SHARE, _kernel_slots, _share_begin, _unit_segments
from test_torch_stacked import _close, _fma, _split_tf32, _stacked_leaf, to_port

GRAM_TOL = dict(atol=1e-2, rtol=1e-4)
APPLY_TOL = dict(atol=1e-4, rtol=1e-4)
SMS = (132, 7)          # an H100's SMs, and a card too small for one wave of units


def _left_stage_parts(A, UT):
    """The 3xTF32 products of A·UT over the depth k = UT.shape[-2], one
    fresh part a 32-deep stage (the last one short), small products
    first.  Yields each stage's part."""
    ah, al = _split_tf32(A)
    uh, ul = _split_tf32(UT)
    depth = UT.shape[-2]
    for k0 in range(0, depth, 32):
        steps = [slice(k8, min(k8 + 8, depth)) for k8 in range(k0, min(k0 + 32, depth), 8)]
        terms = ([t for k in steps for t in ((ah, ul, k), (al, uh, k))]
                 + [(ah, uh, k) for k in steps])
        part = torch.zeros(A.shape[:-1] + UT.shape[-1:])
        for a, b, k in terms:
            part = part + a[..., k] @ b[..., k, :]
        yield part


def _left_plan(N, out_d, in_d, k, sms):
    """maecho_splitk.cuh's splitk_plan for B2 (whole_units): (stages T,
    CTAs C, stages a unit nk, in tiles ct)."""
    nk, ct = -(-k // 32), -(-in_d // 128)
    units = -(-out_d // 128) * ct * N
    T = units * nk
    C = units if units <= sms else min(sms, max(1, T // MIN_SHARE))
    return T, C, nk, ct


def _emulated_gram_left(A, UT, sms):
    """B2's G: the residual stack R (N, out, in) as the share kernel (and,
    for split units, the fix-up) forms it, then R·Rᵀ in float64 rounded
    once."""
    N, out_d, k = A.shape
    in_d = UT.shape[-1]
    parts = list(_left_stage_parts(A, UT))                 # nk x (N, out, in)
    T, C, nk, ct = _left_plan(N, out_d, in_d, k, sms)
    R = torch.zeros(N, out_d, in_d)
    for u in range(T // nk):
        tile, i = divmod(u, N)
        rows = slice(128 * (tile // ct), 128 * (tile // ct) + 128)
        cols = slice(128 * (tile % ct), 128 * (tile % ct) + 128)
        total = None
        for first, end in _unit_segments(u, T, C, nk):
            acc = torch.zeros(R[i, rows, cols].shape)
            for g in range(first, end):
                acc = acc + parts[g - u * nk][i][rows, cols]
            total = acc if total is None else total + acc
        R[i, rows, cols] = total
    Rf = R.reshape(N, -1).double()
    return (Rf @ Rf.T).float()


def _left_operands(seed, n, L, out_d, in_d, k):
    """W (L, out, in), V (N, L, out, in), U (N, L, in, k), s (N, L, k) as
    numpy float32, and the reference's compressed residual A (N, L, out,
    k) with Uᵀ, as numpy too (both sides take the same A and Uᵀ)."""
    W, V, P, _ = _stacked_leaf(seed, n, L, out_d, in_d, "factored", rank=k)
    A = np.asarray(jmg.compressed_residual(W, V, P["U"], P["s"]))
    UT = np.ascontiguousarray(np.swapaxes(P["U"], -1, -2))
    return W, V, P["U"], P["s"], A, UT


# (out, in, k, N): a multiple of the 128-tile with k % 4 == 0, ragged
# out/in with the MLP's rank 78 (a short last stage), everything ragged
# with one stage, and a rank past three stages above 8 clients
GRAM_SHAPES = ((128, 256, 40, 3), (200, 300, 78, 5), (33, 65, 7, 2), (64, 160, 130, 9))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", GRAM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gram_left_scheme_matches_reference_kernel(shape, sms):
    """B2's scheme against the reference's ``maecho_gram_left`` in
    interpret mode (one block a leaf) at the Gram tolerance, and exactly
    symmetric."""
    out_d, in_d, k, n = shape
    *_, A, UT = _left_operands(81 + out_d, n, 1, out_d, in_d, k)
    A, UT = np.array(A[:, 0]), np.array(UT[:, 0])
    want = jmg.maecho_gram_left(jnp.asarray(A), jnp.asarray(UT), bo=out_d, bi=in_d, bk=k)
    got = _emulated_gram_left(torch.from_numpy(A), torch.from_numpy(UT), sms)
    assert torch.equal(got, got.T)
    _close(got, want, **GRAM_TOL)


def _emulated_v_update_left(B, UT, W, V, frac, norm, eps=1e-12):
    """B17's scheme: each (layer, client) residual B·UT from fresh stage
    parts added in fp32; then, norm off, W' − frac·acc by one fmaf (V +
    (W' − V) − frac·acc, with V cancelled), norm on, u = (W' − V) −
    frac·acc, the row norm, V + u."""
    acc = torch.zeros(V.shape)
    for part in _left_stage_parts(B, UT):
        acc = acc + part
    if not norm:        # V + (W' - V) - frac acc, V never read: fmaf(-frac, acc, W')
        return _fma(torch.tensor(-frac), acc, W[None].expand_as(V))
    u = (W[None] - V) - frac * acc
    u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True).clamp_min(eps)
    return V + u


# (L, N, out, in, k): a multiple of the 128-tile, ragged out/in/rank with
# one stage, Qwen2-0.5B's rank 89 on a ragged leaf, and a rank of five
# stages
V_SHAPES = ((2, 3, 128, 256, 40), (2, 2, 33, 65, 7), (1, 2, 200, 300, 89), (3, 1, 64, 160, 130))


@pytest.mark.parametrize("norm", (False, True))
@pytest.mark.parametrize("shape", V_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_v_update_left_scheme_matches_reference_kernel(shape, norm):
    """B17's scheme against the reference's
    ``maecho_v_update_factored_stacked`` in interpret mode (one block a
    leaf, so the row norm sees whole rows) at 1e-4, norm on and off."""
    L, n, out_d, in_d, k = shape
    W, V, U, s, _, _ = _left_operands(91 + out_d + norm, n, L, out_d, in_d, k)
    frac = 20.0 / 21.0
    want = jmv.maecho_v_update_factored_stacked(W, V, U, s, frac=frac, norm=norm, bo=out_d,
                                                bi=in_d, bk=k)
    Wt, Vt, Ut, st = to_port((W, V, U, s))
    B = tmg.compressed_residual(Wt, Vt, Ut, st)
    got = _emulated_v_update_left(B, Ut.transpose(-1, -2), Wt, Vt, frac, norm)
    _close(got, want, **APPLY_TOL)


class _UnitCursor:
    """maecho_v_update_factored_stacked.cu's UnitCursor: the units b, b +
    C, ... of U in (layer, out tile, in tile, client) order, clients
    fastest, nk stages each."""

    def __init__(self, u, N, tiles, ct):
        self.set(u, N, tiles, ct)

    def set(self, u, N, tiles, ct):
        self.u = u
        q, self.client = divmod(u, N)
        self.l, self.tile = divmod(q, tiles)
        self.step = 0
        by, bx = divmod(self.tile, ct)
        self.o0, self.c0 = 128 * by, 128 * bx

    def next(self, C, U, N, nk, tiles, ct):
        self.step += 1
        if self.step < nk:
            return
        if self.u + C < U:
            self.set(self.u + C, N, tiles, ct)

    def at(self):
        return self.l, self.o0, self.c0, self.client, self.step


def test_v_update_left_walks_every_unit_once():
    """Over a grid of leaves and CTA counts: each CTA of B17's persistent
    grid, set at unit b and stepped stage by stage through its G =
    ((U - 1 - b) / C + 1)·nk stages, visits the (layer, o0, c0, client,
    depth step) stages of exactly the units b, b + C, ... in order, so
    the CTAs together cover every stage once and the N units of one
    (layer, tile) run on neighbouring CTAs at once."""
    for L, N, out_d, in_d, k in ((1, 1, 33, 65, 7), (3, 2, 200, 300, 89), (2, 5, 130, 257, 40),
                                 (24, 2, 4864, 896, 89)):
        ct, nk = -(-in_d // 128), -(-k // 32)
        tiles = -(-out_d // 128) * ct
        U = L * tiles * N
        units = [(l, 128 * (t // ct), 128 * (t % ct), i) for l in range(L)
                 for t in range(tiles) for i in range(N)]
        for C in sorted({1, 3, 7, 132, min(U, 132)}):
            if C > U:
                continue
            seen = set()
            for b in range(C):
                cur = _UnitCursor(b, N, tiles, ct)
                got = []
                for _ in range(((U - 1 - b) // C + 1) * nk):
                    got.append(cur.at())
                    cur.next(C, U, N, nk, tiles, ct)
                want = [units[u] + (step,) for u in range(b, U, C) for step in range(nk)]
                assert got == want, (L, N, out_d, in_d, k, C, b)
                seen.update(got)
            assert len(seen) == U * nk


def test_gram_left_plan_gives_whole_units_in_one_wave():
    """B2's plan: while the (tile, client) units fit one wave each CTA
    holds one whole unit and the share kernel parks nothing (so the
    workspace has no slots); past one wave the stages are cut into
    shares of at least kMinShare stages over every SM."""
    for out_d, in_d, k, N in ((400, 784, 78, 4), (200, 400, 78, 4), (256, 1024, 78, 4),
                              (33, 65, 7, 1), (400, 784, 78, 64), (200, 300, 130, 9)):
        T, C, nk, _ = _left_plan(N, out_d, in_d, k, 132)
        parked, whole = _kernel_slots(T, C, nk)
        if T // nk <= 132:
            assert C == T // nk and not parked and whole == set(range(C))
        else:
            assert C == 132 and T // C >= MIN_SHARE
