"""The schemes of B1 (Eq. 6 Gram) and B4 (Eq. 7) on 3xTF32 ``wgmma``
with the depth split across the card (``csrc/maecho_splitk.cuh``),
emulated in torch on the CPU: the (tile, client, depth step) stages of
an unstacked leaf cut into C equal shares, each share's stages summed
into a fresh running sum (small products first, a fresh accumulator a
32-deep stage: B13's FMA times -2 alpha_i for B4, B10's fp32 add for
B1), a unit (B4: a tile; B1: a (tile, client) pair) that one share
holds stored whole, a split one summed from its shares in CTA order; B1
then contracts the residual stack in fp64, rounding once (up to 8
clients each tile's fix-up and pair sums in one kernel, above 8 B19's
contraction, ``csrc/maecho_cross.cuh``, both in fp64).  Each is held
against the reference's Pallas ``maecho_gram`` / ``maecho_update`` in
interpret mode at the fp32 tolerances (Gram atol 1e-2 / rtol 1e-4,
Eq. 7 1e-4), at the split a 132-SM card gives and at a coarse one.  The
slot bookkeeping of the share kernel and the fix-up is checked exactly
over a grid of splits.  The kernels themselves run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import pytest
import torch

from repro.kernels import maecho_gram as jmg
from repro.kernels import maecho_update as jmu
from test_torch_stacked import _close, _fma, _stacked_leaf, _stage_parts, to_port

GRAM_TOL = dict(atol=1e-2, rtol=1e-4)
APPLY_TOL = dict(atol=1e-4, rtol=1e-4)
MIN_SHARE = 4           # maecho_splitk.cuh's kMinShare


def _split(N, out_d, in_d, gram, sms):
    """maecho_splitk.cuh's splitk_plan: (stages T, CTAs C, stages a unit
    K, depth steps nk, in tiles ct)."""
    nk, ct = -(-in_d // 32), -(-in_d // 128)
    T = -(-out_d // 128) * ct * N * nk
    C = min(sms, max(1, T // MIN_SHARE))
    return T, C, (nk if gram else N * nk), nk, ct


def _share_begin(c, T, C):
    return c * T // C


def _cta_of(x, T, C):
    return ((x + 1) * C - 1) // T


def _unit_segments(u, T, C, K):
    """The stages of unit u each share holds, in CTA order: [(first,
    end)], as splitk_fixup_kernel sums them (one entry: stored whole)."""
    x0 = u * K
    return [(max(_share_begin(c, T, C), x0), min(_share_begin(c + 1, T, C), x0 + K))
            for c in range(_cta_of(x0, T, C), _cta_of(x0 + K - 1, T, C) + 1)]


def _emulated_splitk(W, V, P, gram, sms, alpha=None, eta=1.0):
    """B4's output (gram=False) or B1's residual stack R (N, out, in)
    (gram=True) as the share kernel and the fix-up form them."""
    N, out_d, in_d = V.shape
    parts = list(_stage_parts(W[None] - V, P, small_first=True))    # nk x (N, out, in)
    T, C, K, nk, ct = _split(N, out_d, in_d, gram, sms)
    out = torch.zeros(V.shape if gram else W.shape)
    for u in range(T // K):
        tile, i = divmod(u, N) if gram else (u, 0)
        rows = slice(128 * (tile // ct), 128 * (tile // ct) + 128)
        cols = slice(128 * (tile % ct), 128 * (tile % ct) + 128)
        total = None
        for first, end in _unit_segments(u, T, C, K):
            acc = torch.zeros(W[rows, cols].shape)
            for g in range(first, end):
                k = g - u * K
                if gram:
                    acc = acc + parts[k][i][rows, cols]
                else:
                    c, s = divmod(k, nk)
                    acc = _fma(-2.0 * alpha[c], parts[s][c][rows, cols], acc)
            total = acc if total is None else total + acc
        if gram:
            out[i, rows, cols] = total
        else:
            out[rows, cols] = _fma(torch.tensor(eta), total, W[rows, cols])
    return out


def _dense_leaf(seed, n, out_d, in_d):
    """W (out, in), V (N, out, in), rank-in/2 projectors P (N, in, in),
    alpha (N,) on the simplex: layer 0 of the stacked tests' leaf."""
    W, V, P, a = _stacked_leaf(seed, n, 1, out_d, in_d, "full")
    return W[0], V[:, 0], P[:, 0], a[0]


# (out, in, N): a multiple of the 128-tile, ragged out / in / depth
# (in % 32 != 0), and past the 54 clients of the SIMT Gram's CTA
SHAPES = ((128, 256, 3), (200, 300, 5), (33, 65, 55))
SMS = (132, 7)          # an H100's SMs (shares of 4 stages here), and long shares


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: "x".join(map(str, s)))
def test_update_splitk_scheme_matches_reference_kernel(shape, sms):
    """B4's scheme against the reference's ``maecho_update`` in interpret
    mode (one block a leaf, so ragged leaves need no padding) at 1e-4."""
    out_d, in_d, n = shape
    W, V, P, a = _dense_leaf(61 + out_d, n, out_d, in_d)
    want = jmu.maecho_update(W, V, P, a, eta=0.5, bo=out_d, bi=in_d, bk=in_d)
    got = _emulated_splitk(*to_port((W, V, P)), False, sms, to_port(a), 0.5)
    _close(got, want, **APPLY_TOL)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gram_splitk_scheme_matches_reference_kernel(shape, sms):
    """B1's scheme (the split residual stack, then the fp64 contraction
    of its flat rows) against the reference's ``maecho_gram`` in
    interpret mode at the Gram tolerance, and exactly symmetric."""
    out_d, in_d, n = shape
    W, V, P, _ = _dense_leaf(71 + out_d, n, out_d, in_d)
    want = jmg.maecho_gram(W, V, P, bo=out_d, bi=in_d, bk=in_d)
    R = _emulated_splitk(*to_port((W, V, P)), True, sms).reshape(n, -1).double()
    got = (R @ R.T).float()
    assert torch.equal(got, got.T)
    _close(got, want, **GRAM_TOL)


def _kernel_slots(T, C, K):
    """What splitk_tf32_kernel stores, walking each share stage by stage
    as its epilogue does: {unit: [(cta, slot)]} for the segments it parks
    (slot 0 a share's first, 1 its last) and the set of units it stores
    whole."""
    parked, whole = {}, set()
    for c in range(C):
        b0, b1 = _share_begin(c, T, C), _share_begin(c + 1, T, C)
        from_start, seg = b0 % K == 0, 0
        for g in range(b0, b1):
            unit_end = g % K == K - 1
            if unit_end or g == b1 - 1:
                if from_start and unit_end:
                    whole.add(g // K)
                else:
                    parked.setdefault(g // K, []).append((c, int(seg > 0)))
                seg, from_start = seg + 1, True
    return parked, whole


def test_fixup_reads_the_slots_the_share_kernel_parks():
    """Over a grid of (units, stages a unit, CTAs): every unit is stored
    whole by exactly one share or split, and then splitk_fixup_kernel's
    rule (slot 1 of the first share unless it starts at the unit, slot 0
    of the others, CTA order) names exactly the slots the share kernel
    parked it in; no CTA parks more than two; the segments tile the unit."""
    for units in (1, 2, 3, 7, 28):
        for K in (1, 3, 4, 25, 100):
            T = units * K
            for C in sorted({1, 2, 3, 5, 7, 13, 132, max(1, T // MIN_SHARE)} - {0}):
                if C > T:
                    continue
                parked, whole = _kernel_slots(T, C, K)
                per_cta = {}
                for u in range(units):
                    x0 = u * K
                    lo, hi = _cta_of(x0, T, C), _cta_of(x0 + K - 1, T, C)
                    segs = _unit_segments(u, T, C, K)
                    assert segs[0][0] == x0 and segs[-1][1] == x0 + K
                    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
                    if lo == hi:
                        assert u in whole and u not in parked, (units, K, C, u)
                        continue
                    want = [(lo, 0 if _share_begin(lo, T, C) == x0 else 1)]
                    want += [(c, 0) for c in range(lo + 1, hi + 1)]
                    assert parked[u] == want and u not in whole, (units, K, C, u)
                    for c, slot in want:
                        per_cta.setdefault(c, set()).add(slot)
                assert all(len(s) <= 2 for s in per_cta.values())
