"""The CUDA kernels B1/B4/B7, B2/B5/B8, B3/B6/B9, the stacked B10/B13/B16,
B11/B14/B17 and B12/B15/B18, the chunk-pair cross-Gram B19, the
block-RLS downdate B20 and the serving path's flash attention B21 and
decode attention B22 against their plain versions on the card (the
3xTF32 kernels B1, B4, B10, B13, B16, B2 and B17 also against float64)
(``PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py``
on a machine with an NVIDIA Hopper GPU and ``nvcc``; ``--noconftest``
because ``tests/conftest.py`` imports jax, which such a machine need not
have).  Without a card every test here skips;
``chip_smoke.py`` runs the same comparison at the main path's shapes.
"""
import pytest
import torch

from repro_torch.core.maecho import MAEchoConfig, maecho_aggregate
from repro_torch.core.projections import block_update
from repro_torch.kernels import ops, ref
from repro_torch.kernels.maecho_gram import (compressed_residual, maecho_gram,
                                             maecho_gram_cross, maecho_gram_diag,
                                             maecho_gram_diag_stacked,
                                             maecho_gram_left,
                                             maecho_gram_left_stacked,
                                             maecho_gram_stacked)
from repro_torch.kernels.maecho_update import (maecho_update, maecho_update_diag,
                                               maecho_update_diag_stacked,
                                               maecho_update_left,
                                               maecho_update_left_stacked,
                                               maecho_update_stacked)
from repro_torch.kernels.maecho_v_update import (maecho_v_update,
                                                 maecho_v_update_diag,
                                                 maecho_v_update_diag_stacked,
                                                 maecho_v_update_factored,
                                                 maecho_v_update_factored_stacked,
                                                 maecho_v_update_left,
                                                 maecho_v_update_left_stacked,
                                                 maecho_v_update_stacked)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rank_update import block_rls_update, rank_downdate

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape", ((400, 784, 4), (200, 400, 4), (33, 65, 1),
                                   (1000, 1100, 8), (64, 96, 54)))
def test_kernels_match_plain(card, shape):
    out_d, in_d, N = shape
    W = torch.randn(out_d, in_d, device="cuda", generator=card)
    V = W + 0.1 * torch.randn(N, out_d, in_d, device="cuda", generator=card)
    U = torch.linalg.qr(torch.randn(N, in_d, in_d // 2, device="cuda",
                                    generator=card))[0]
    P = (U @ U.transpose(1, 2)).contiguous()
    a = torch.softmax(torch.randn(N, device="cuda", generator=card), 0)
    G, Gr = maecho_gram(W, V, P), ref.maecho_gram_ref(W, V, P)
    assert (G - Gr).abs().max() <= 1e-5 * Gr.abs().max()
    Wn = maecho_update(W, V, P, a, 0.5)
    torch.testing.assert_close(Wn, ref.maecho_update_ref_any(W, V, P, a, 0.5),
                               atol=1e-4, rtol=0)
    for norm in (False, True):
        torch.testing.assert_close(maecho_v_update(Wn, V, P, 0.9, norm),
                                   ref.maecho_v_update_ref(Wn, V, P, 0.9, norm),
                                   atol=1e-4, rtol=0)


def test_wrappers_reject_bad_operands(card):
    W = torch.zeros(8, 8, device="cuda")
    V = torch.zeros(2, 8, 8, device="cuda")
    P = torch.zeros(2, 8, 8, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        maecho_gram(W, V, P.double())
    with pytest.raises(ValueError, match="contiguous"):
        maecho_update(W, V, P.transpose(1, 2), torch.ones(2, device="cuda"))
    with pytest.raises(ValueError, match="shapes"):
        maecho_v_update(W, V, P[:, :4].contiguous(), 0.5)
    with pytest.raises(ValueError, match="clients"):
        maecho_gram(W, torch.zeros(0, 8, 8, device="cuda"),
                    torch.zeros(0, 8, 8, device="cuda"))


def _factored(gen, out_d, in_d, k, N):
    W = torch.randn(out_d, in_d, device="cuda", generator=gen)
    V = W + 0.1 * torch.randn(N, out_d, in_d, device="cuda", generator=gen)
    U = torch.linalg.qr(torch.randn(N, in_d, k, device="cuda", generator=gen))[0]
    s = torch.rand(N, k, device="cuda", generator=gen) * 0.9 + 0.1
    a = torch.softmax(torch.randn(N, device="cuda", generator=gen), 0)
    return W, V, U.contiguous(), s, a


# (out, in, rank, N): the MLP's W0/W1 at table6_svd's ranks, ragged
# out/in/rank, one client, and the shared-memory cap of 54 clients
@pytest.mark.parametrize("shape", ((400, 784, 78, 4), (200, 400, 196, 4),
                                   (33, 65, 7, 1), (1000, 1100, 150, 8),
                                   (64, 96, 40, 54)))
def test_factored_kernels_match_plain(card, shape):
    out_d, in_d, k, N = shape
    W, V, U, s, a = _factored(card, out_d, in_d, k, N)
    A = compressed_residual(W, V, U, s)
    UT = U.transpose(1, 2).contiguous()
    G, Gr = maecho_gram_left(A, UT), ref.maecho_gram_left_ref(A, UT)
    assert (G - Gr).abs().max() <= 1e-5 * Gr.abs().max()
    Wn = maecho_update_left(W, A, UT, a, 0.5)
    torch.testing.assert_close(Wn, ref.maecho_update_left_ref(W, A, UT, a, 0.5),
                               atol=1e-4, rtol=0)
    B = compressed_residual(Wn, V, U, s)
    for norm in (False, True):
        torch.testing.assert_close(
            maecho_v_update_factored(Wn, V, U, s, 0.9, norm),
            ref.maecho_v_update_factored_ref(Wn, V, U, s, 0.9, norm),
            atol=1e-4, rtol=0)
        torch.testing.assert_close(
            maecho_v_update_left(B, UT, Wn, V, 0.9, norm),
            ref.maecho_v_update_left_ref(B, UT, Wn, V, 0.9, norm),
            atol=1e-4, rtol=0)


def test_factored_wrappers_reject_bad_operands(card):
    A = torch.zeros(2, 8, 3, device="cuda")
    UT = torch.zeros(2, 3, 8, device="cuda")
    with pytest.raises(ValueError, match="shapes"):
        maecho_gram_left(A, UT[:, :2].contiguous())
    with pytest.raises(ValueError, match="clients"):
        maecho_gram_left(torch.zeros(0, 8, 3, device="cuda"),
                         torch.zeros(0, 3, 8, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        maecho_update_left(torch.zeros(8, 8, device="cuda"), A,
                           A.transpose(1, 2), torch.ones(2, device="cuda"))
    with pytest.raises(ValueError, match="shapes"):
        maecho_v_update_factored(torch.zeros(8, 8, device="cuda"),
                                 torch.zeros(2, 8, 8, device="cuda"),
                                 torch.zeros(2, 8, 3, device="cuda"),
                                 torch.zeros(2, 4, device="cuda"), 0.5)
    with pytest.raises(ValueError, match="shapes"):
        maecho_v_update_left(A, UT[:, :2].contiguous(), torch.zeros(8, 8, device="cuda"),
                             torch.zeros(2, 8, 8, device="cuda"), 0.5)


def _aggregate_launches(clients, projs, cfg, kernels):
    """Launches of ``kernels`` in one kernel aggregate, and that
    aggregate against the oracle's (1e-3)."""
    before = [k.launches for k in kernels]
    got = maecho_aggregate(clients, projs, cfg, backend="kernel")
    torch.cuda.synchronize()
    launches = [k.launches - b for k, b in zip(kernels, before)]
    want = maecho_aggregate(clients, projs, cfg, backend="oracle")
    torch.testing.assert_close(got["W"], want["W"], atol=1e-3, rtol=0)
    return launches


DIAG = (maecho_gram_diag, maecho_update_diag, maecho_v_update_diag)
OTHERS = (maecho_gram, maecho_update, maecho_v_update, maecho_gram_left,
          maecho_update_left, maecho_v_update_factored)


def test_factored_aggregate_launches_left_kernels(card):
    """A factored kernel aggregate runs B2/B5/B8 on the card, τ times
    each for its one kernel leaf, and no other kernel."""
    N, out_d, in_d, k = 3, 160, 200, 30
    clients = [{"W": torch.randn(out_d, in_d, device="cuda", generator=card)}
               for _ in range(N)]
    U = [torch.linalg.qr(torch.randn(in_d, k, device="cuda", generator=card))[0]
         for _ in range(N)]
    projs = [{"W": {"U": u.contiguous(), "s": torch.ones(k, device="cuda")}}
             for u in U]
    cfg = MAEchoConfig(tau=2, eta=0.5, mu=20.0)
    launches = _aggregate_launches(clients, projs, cfg, OTHERS + DIAG)
    assert launches == [0, 0, 0, 2, 2, 2, 0, 0, 0]


@pytest.mark.parametrize("norm", (False, True))
def test_scalar_and_diag_aggregates_launch_diag_kernels(card, norm):
    """The default scalar projectors (``projections=None``, broadcast to
    diagonals) and diagonal projectors run B3/B6/B9 on the card, τ times
    each for the one kernel leaf, and no other kernel; the 1-D bias
    runs the oracle."""
    N, out_d, in_d = 3, 160, 200
    clients = [{"W": torch.randn(out_d, in_d, device="cuda", generator=card),
                "b": torch.randn(out_d, device="cuda", generator=card)}
               for _ in range(N)]
    diag = [{"W": torch.rand(in_d, device="cuda", generator=card),
             "b": torch.ones((), device="cuda")} for _ in range(N)]
    cfg = MAEchoConfig(tau=3, eta=0.5, mu=20.0, norm=norm)
    for projs in (None, diag):
        launches = _aggregate_launches(clients, projs, cfg, DIAG + OTHERS)
        assert launches == [3, 3, 3] + [0] * 6


# (out, in, N): the MLP's W0/W1, ragged out/in with one client, a
# multi-tile ragged leaf, and the shared-memory cap of 54 clients
@pytest.mark.parametrize("shape", ((400, 784, 4), (200, 400, 4), (33, 65, 1),
                                   (1000, 1100, 8), (64, 96, 54)))
def test_diag_kernels_match_plain(card, shape):
    out_d, in_d, N = shape
    W = torch.randn(out_d, in_d, device="cuda", generator=card)
    V = W + 0.1 * torch.randn(N, out_d, in_d, device="cuda", generator=card)
    p = torch.rand(N, in_d, device="cuda", generator=card)
    a = torch.softmax(torch.randn(N, device="cuda", generator=card), 0)
    G, Gr = maecho_gram_diag(W, V, p), ref.maecho_gram_diag_ref(W, V, p)
    assert (G - Gr).abs().max() <= 1e-5 * Gr.abs().max()
    assert torch.equal(G, maecho_gram_diag(W, V, p))     # fixed-order reduction
    Wn = maecho_update_diag(W, V, p, a, 0.5)
    torch.testing.assert_close(Wn, ref.maecho_update_diag_ref(W, V, p, a, 0.5),
                               atol=1e-4, rtol=0)
    for norm in (False, True):
        torch.testing.assert_close(maecho_v_update_diag(Wn, V, p, 0.9, norm),
                                   ref.maecho_v_update_diag_ref(Wn, V, p, 0.9, norm),
                                   atol=1e-4, rtol=0)


def test_diag_wrappers_reject_bad_operands(card):
    W = torch.zeros(8, 8, device="cuda")
    V = torch.zeros(2, 8, 8, device="cuda")
    p = torch.zeros(2, 8, device="cuda")
    a = torch.ones(2, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        maecho_gram_diag(W, V, p.double())
    with pytest.raises(ValueError, match="contiguous"):
        maecho_update_diag(W, V, torch.zeros(8, 2, device="cuda").T, a)
    with pytest.raises(ValueError, match="shapes"):
        maecho_v_update_diag(W, V, p[:, :4].contiguous(), 0.5)
    with pytest.raises(ValueError, match="shapes"):
        maecho_update_diag(W, V, p, a[:1].contiguous())
    with pytest.raises(ValueError, match="clients"):
        maecho_gram_diag(W, torch.zeros(0, 8, 8, device="cuda"),
                         torch.zeros(0, 8, device="cuda"))
    for fn, args in ((maecho_update_diag, (a[:0],)), (maecho_v_update_diag, (0.5,))):
        with pytest.raises(ValueError, match="clients"):
            fn(W, torch.zeros(0, 8, 8, device="cuda"), torch.zeros(0, 8, device="cuda"),
               *args)


STACKED_FULL = (maecho_gram_stacked, maecho_update_stacked, maecho_v_update_stacked)
STACKED_DIAG = (maecho_gram_diag_stacked, maecho_update_diag_stacked,
                maecho_v_update_diag_stacked)


def _stacked_inputs(gen, L, out_d, in_d, N):
    W = torch.randn(L, out_d, in_d, device="cuda", generator=gen)
    V = W + 0.1 * torch.randn(N, L, out_d, in_d, device="cuda", generator=gen)
    U = torch.linalg.qr(torch.randn(N, L, in_d, max(1, in_d // 2), device="cuda",
                                    generator=gen))[0]
    P = (U @ U.transpose(-1, -2)).contiguous()
    p = torch.rand(N, L, in_d, device="cuda", generator=gen)
    a = torch.softmax(torch.randn(L, N, device="cuda", generator=gen), -1).contiguous()
    return W, V, P, p, a


# (L, out, in, N): ragged out/in with one client, a multi-tile ragged
# leaf, one layer, and the shared-memory cap of 54 clients
@pytest.mark.parametrize("shape", ((3, 33, 65, 1), (3, 200, 300, 5), (1, 128, 256, 3),
                                   (2, 64, 96, 54)))
def test_stacked_kernels_match_plain(card, shape):
    """B10/B13/B16 (dense) and B12/B15/B18 (diagonal) against their plain
    versions, both Grams bitwise reproducible, and B10's layer l equal
    to an L = 1 launch on that layer's slices."""
    W, V, P, p, a = _stacked_inputs(card, *shape)
    for (gram, update, v_update), (g_ref, u_ref, v_ref), Pk in (
            (STACKED_FULL, (ref.maecho_gram_stacked_ref, ref.maecho_update_stacked_ref,
                            ref.maecho_v_update_stacked_ref), P),
            (STACKED_DIAG, (ref.maecho_gram_diag_stacked_ref,
                            ref.maecho_update_diag_stacked_ref,
                            ref.maecho_v_update_diag_stacked_ref), p)):
        G, Gr = gram(W, V, Pk), g_ref(W, V, Pk)
        assert G.shape == (shape[0], shape[3], shape[3])
        assert (G - Gr).abs().max() <= 1e-5 * Gr.abs().max()
        assert torch.equal(G, gram(W, V, Pk))
        Wn = update(W, V, Pk, a, 0.5)
        torch.testing.assert_close(Wn, u_ref(W, V, Pk, a, 0.5), atol=1e-4, rtol=0)
        for norm in (False, True):
            torch.testing.assert_close(v_update(Wn, V, Pk, 0.9, norm),
                                       v_ref(Wn, V, Pk, 0.9, norm), atol=1e-4, rtol=0)
    l = shape[0] - 1
    assert torch.equal(maecho_gram_stacked(W, V, P)[l],
                       maecho_gram_stacked(W[l:l + 1].contiguous(),
                                           V[:, l:l + 1].contiguous(),
                                           P[:, l:l + 1].contiguous())[0])


def _kernel_names(fn, sessions=3):
    """Names of the CUDA kernels ``fn()`` launches, from torch.profiler.
    A session that records no device event at all is taken again, up to
    ``sessions`` times: the profiler has come back blind now and then on
    the card (once for a B2 call whose kernels ran, as its launch count,
    output and reproducibility showed), and every caller launches at
    least one kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


def _v_update_f64(W, V, P, frac, norm, eps=1e-12):
    """Eq. 11 in float64: the witness both fp32 versions are held to."""
    d = (W[None] - V).double()
    u = d - frac * (d @ P.double())
    if norm:
        u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True).clamp_min(eps)
    return V.double() + u


# (L, out, in, N): ragged out/in/depth (in % 4 != 0 takes the 4-byte
# copies), a multi-tile ragged leaf, 64 x 96, and Qwen2-0.5B's wq
@pytest.mark.parametrize("norm", (False, True))
@pytest.mark.parametrize("shape", ((3, 33, 65, 1), (3, 200, 300, 5), (2, 64, 96, 3),
                                   (24, 896, 896, 2)), ids=lambda s: "x".join(map(str, s)))
def test_v_update_stacked_3xtf32(card, shape, norm):
    """B16 on the tensor cores (3xTF32): one launch of its tf32 kernel
    (plus the norm pass), bitwise reproducible, and on inputs scaled
    x1e3 within 4x the plain fp32 version's error against float64, plus
    1e-7 max|V'| (the output's own rounding)."""
    L, out_d, in_d, N = shape
    W, V, P, _, _ = _stacked_inputs(card, *shape)
    W, V = W * 1e3, V * 1e3
    frac = 20.0 / 21.0
    before = maecho_v_update_stacked.launches
    got = maecho_v_update_stacked(W, V, P, frac, norm)
    assert maecho_v_update_stacked.launches - before == 1
    assert torch.equal(got, maecho_v_update_stacked(W, V, P, frac, norm))
    want = _v_update_f64(W, V, P, frac, norm)
    err = (got.double() - want).abs().max().item()
    err_plain = (ref.maecho_v_update_stacked_ref(W, V, P, frac, norm).double()
                 - want).abs().max().item()
    assert err <= 4 * err_plain + 1e-7 * want.abs().max().item(), (err, err_plain)
    names = _kernel_names(lambda: maecho_v_update_stacked(W, V, P, frac, norm))
    assert sum("v_update_tf32_kernel" in n for n in names) == 1, names
    assert sum("v_norm_kernel" in n for n in names) == norm, names
    assert all(any(k in n for k in ("v_update_tf32_kernel", "p_split_kernel", "v_norm_kernel"))
               for n in names), names


def _stacked_witness(W, V, P, alpha=None, eta=0.5):
    """Float64 witnesses of B10 (the (L, N, N) Grams) or, given alpha,
    of B13 (W + eta·(-2 Σ_i alpha_i R_i))."""
    R = (W[None] - V).double() @ P.double()
    if alpha is None:
        return torch.einsum("iloc,jloc->lij", R, R)
    return W.double() + eta * (-2.0 * torch.einsum("ln,nloi->loi", alpha.double(), R))


# (L, out, in, N): ragged out/in/depth (in % 4 != 0 takes the 4-byte
# copies), a multi-tile ragged leaf, 64 x 96, and Qwen2-0.5B's wq
TF32_SHAPES = ((3, 33, 65, 1), (3, 200, 300, 5), (2, 64, 96, 3), (24, 896, 896, 2))


@pytest.mark.parametrize("shape", TF32_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_update_stacked_3xtf32(card, shape):
    """B13 on the tensor cores (3xTF32): one launch of its tf32 kernel,
    bitwise reproducible, and on inputs scaled x1e3 within 4x the plain
    fp32 version's error against float64, plus 1e-7 max|W'|."""
    W, V, P, _, a = _stacked_inputs(card, *shape)
    W, V = W * 1e3, V * 1e3
    before = maecho_update_stacked.launches
    got = maecho_update_stacked(W, V, P, a, 0.5)
    assert maecho_update_stacked.launches - before == 1
    assert torch.equal(got, maecho_update_stacked(W, V, P, a, 0.5))
    want = _stacked_witness(W, V, P, a)
    err = (got.double() - want).abs().max().item()
    err_plain = (ref.maecho_update_stacked_ref(W, V, P, a, 0.5).double()
                 - want).abs().max().item()
    assert err <= 4 * err_plain + 1e-7 * want.abs().max().item(), (err, err_plain)
    names = _kernel_names(lambda: maecho_update_stacked(W, V, P, a, 0.5))
    assert len(names) == 1 and "update_tf32_kernel" in names[0], names


@pytest.mark.parametrize("shape", TF32_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gram_stacked_3xtf32(card, shape):
    """B10 on the tensor cores (3xTF32 residuals, fixed-order fp32 pair
    sums): its tf32 kernel and the fp64 tile-order reduce, bitwise
    reproducible, symmetric, and on inputs scaled x1e3 within 4x the plain
    fp32 version's error against float64, plus 1e-7 max|G|."""
    W, V, P, _, _ = _stacked_inputs(card, *shape)
    W, V = W * 1e3, V * 1e3
    before = maecho_gram_stacked.launches
    got = maecho_gram_stacked(W, V, P)
    assert maecho_gram_stacked.launches - before == 1
    assert torch.equal(got, maecho_gram_stacked(W, V, P))
    assert torch.equal(got, got.transpose(1, 2))
    want = _stacked_witness(W, V, P)
    err = (got.double() - want).abs().max().item()
    err_plain = (ref.maecho_gram_stacked_ref(W, V, P).double() - want).abs().max().item()
    assert err <= 4 * err_plain + 1e-7 * want.abs().max().item(), (err, err_plain)
    names = _kernel_names(lambda: maecho_gram_stacked(W, V, P))
    assert len(names) == 2, names
    assert "gram_tf32_kernel" in names[0] and "gram_reduce_f64_kernel" in names[1], names


@pytest.mark.parametrize("N", (54, 55))
def test_gram_stacked_routes_by_clients(card, N):
    """B10 takes its tf32 kernel up to 54 clients and the SIMT blocked
    launch past them, both against the plain version at 1e-5 max|G|."""
    W, V, P, _, _ = _stacked_inputs(card, 2, 64, 96, N)
    G, Gr = maecho_gram_stacked(W, V, P), ref.maecho_gram_stacked_ref(W, V, P)
    assert (G - Gr).abs().max() <= 1e-5 * Gr.abs().max()
    assert torch.equal(G, maecho_gram_stacked(W, V, P))
    names = _kernel_names(lambda: maecho_gram_stacked(W, V, P))
    want = "gram_tf32_kernel" if N <= 54 else "gram_blocked_partial_kernel"
    assert any(want in n for n in names) and len(names) == 2, names


def _dense_witness(W, V, P, alpha=None, eta=0.5):
    """Float64 witnesses of B1 (the (N, N) Gram) or, given alpha, of B4
    (W + eta·(-2 Σ_i alpha_i R_i))."""
    R = (W[None] - V).double() @ P.double()
    if alpha is None:
        Rf = R.reshape(R.shape[0], -1)
        return Rf @ Rf.T
    return W.double() + eta * (-2.0 * torch.einsum("n,noi->oi", alpha.double(), R))


# B1's kernels: up to 8 clients the share kernel, then each tile's fix-up
# and pair sums in one pass; above, the fix-up and B19's contraction
B1_FUSED = ("splitk_tf32_kernel", "gram_tile_pairs_kernel", "gram_pairs_reduce_kernel")
B1_CROSS = ("splitk_tf32_kernel", "splitk_fixup_kernel", "gram_cross_partial_kernel",
            "gram_cross_reduce_kernel")
B4_NAMES = B1_CROSS[:2]


# (out, in, N): ragged out/in/depth (in % 4 != 0 takes the 4-byte
# copies), a multi-tile ragged leaf, 64 x 96, the paper MLP's W0 and W1,
# the CNN's fc0 and the ragged 1000 x 1100 of chip_smoke.py
DENSE_TF32_SHAPES = ((33, 65, 1), (200, 300, 5), (64, 96, 3), (400, 784, 4), (200, 400, 4),
                     (256, 1024, 4), (1000, 1100, 8))


@pytest.mark.parametrize("shape", DENSE_TF32_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gram_and_update_3xtf32(card, shape):
    """B1 and B4 on the tensor cores (3xTF32, the depth split across the
    card): each one wrapper launch, bitwise reproducible (B1's Gram
    exactly symmetric), and on inputs scaled x1e3 within 4x the plain
    fp32 version's error against float64, plus 1e-7 max|out|; B4's
    kernels the share kernel and the fix-up, B1's (N <= 8) the share
    kernel and the fused fix-up and pair sums."""
    W, V, P, _, a = _stacked_inputs(card, 1, *shape)
    W, V, P, a = W[0] * 1e3, V[:, 0] * 1e3, P[:, 0].contiguous(), a[0].contiguous()
    for fn, plain, args, names in (
            (maecho_gram, ref.maecho_gram_ref, (W, V, P), B1_FUSED),
            (maecho_update, ref.maecho_update_ref_any, (W, V, P, a, 0.5), B4_NAMES)):
        before = fn.launches
        got = fn(*args)
        assert fn.launches - before == 1
        assert torch.equal(got, fn(*args))
        if fn is maecho_gram:
            assert torch.equal(got, got.T)
        want = _dense_witness(W, V, P, *args[3:])
        err = (got.double() - want).abs().max().item()
        err_plain = (plain(*args).double() - want).abs().max().item()
        assert err <= 4 * err_plain + 1e-7 * want.abs().max().item(), (fn.__name__, err,
                                                                       err_plain)
        got_names = _kernel_names(lambda: fn(*args))
        assert len(got_names) == len(names), got_names
        assert all(n in g for n, g in zip(names, got_names)), got_names


@pytest.mark.parametrize("N", (2, 54, 55, 64, 128))
def test_gram_routes_by_clients(card, N):
    """B1 has no client cap: up to 8 clients the fused fix-up and pair
    sums, above them the fix-up and B19's contraction, each against the
    plain version at 1e-5 max|G| and bitwise reproducible."""
    W = torch.randn(200, 300, device="cuda", generator=card)
    V = W + 0.1 * torch.randn(N, 200, 300, device="cuda", generator=card)
    U = torch.linalg.qr(torch.randn(N, 300, 150, device="cuda", generator=card))[0]
    P = (U @ U.transpose(1, 2)).contiguous()
    G, Gr = maecho_gram(W, V, P), ref.maecho_gram_ref(W, V, P)
    assert (G - Gr).abs().max() <= 1e-5 * Gr.abs().max()
    assert torch.equal(G, maecho_gram(W, V, P))
    names = _kernel_names(lambda: maecho_gram(W, V, P))
    want = B1_FUSED if N <= 8 else B1_CROSS
    assert len(names) == len(want) and all(n in g for n, g in zip(want, names)), names


def _b7_digest():
    """sha256 of B7's output (row norm off and on) on inputs drawn with
    numpy from a fixed seed at the paper MLP's W1 (200 x 400, N = 4)."""
    import hashlib

    import numpy as np

    r = np.random.RandomState(7)
    W = r.randn(200, 400).astype(np.float32)
    V = (W + 0.1 * r.randn(4, 200, 400)).astype(np.float32)
    U = np.linalg.qr(r.randn(4, 400, 200))[0]
    P = (U @ U.transpose(0, 2, 1)).astype(np.float32)
    W, V, P = (torch.from_numpy(x).cuda() for x in (W, V, P))
    h = hashlib.sha256()
    for norm in (False, True):
        h.update(maecho_v_update(W, V, P, 20 / 21, norm).cpu().numpy().tobytes())
    return h.hexdigest()


# B7's digest on the tree before B1 and B4 left the SIMT templates it
# shares with them (an NVIDIA H100 80GB HBM3; torch 2.11.0+cu128)
B7_DIGEST = "9bbe8be6b34b020fdb5d2265d7524d4518079a9dd961fe4d7b2667bc44233746"


def test_v_update_output_unchanged(card):
    """B7 still runs maecho_tile.cuh's SIMT templates: its output is
    bitwise what it was."""
    assert _b7_digest() == B7_DIGEST


def _left_inputs(gen, out_d, in_d, k, N, L=None, scale=1e3):
    """W, V (scaled x``scale``), orthonormal U (N[, L], in, k), s in
    [0.1, 1], and the compressed residual of W with Uᵀ: the factored
    kernels' operands, unstacked (L None) or stacked."""
    lead = (N,) if L is None else (N, L)
    W = torch.randn(*lead[1:], out_d, in_d, device="cuda", generator=gen) * scale
    V = W + 0.1 * scale * torch.randn(*lead, out_d, in_d, device="cuda", generator=gen)
    U = torch.linalg.qr(torch.randn(*lead, in_d, k, device="cuda", generator=gen))[0]
    s = torch.rand(*lead, k, device="cuda", generator=gen) * 0.9 + 0.1
    A = compressed_residual(W, V, U.contiguous(), s)
    return W, V, U.contiguous(), s, A, U.transpose(-1, -2).contiguous()


# (out, in, k, N): ragged out/in/rank with k % 4 != 0 and in % 4 != 0 (the
# 4-byte copies), k % 4 == 0 (16-byte A copies), the paper MLP's W0 at
# table6_svd's rank, a rank past three stages (k = 130) above 8 clients
# (B19's contraction), the ragged multi-tile 1000 x 1100, and 64 clients
# at W0 (past 54, and past one wave of units: the stages cut into shares)
LEFT_TF32_SHAPES = ((33, 65, 7, 1), (200, 300, 40, 4), (400, 784, 78, 4), (200, 300, 130, 9),
                    (1000, 1100, 150, 8), (400, 784, 78, 64))
SIMT_GRAMS = ("gram_partial_kernel", "gram_blocked_partial_kernel", "gram_reduce_kernel")


@pytest.mark.parametrize("shape", LEFT_TF32_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gram_left_3xtf32(card, shape):
    """B2 on the tensor cores (3xTF32 residuals A_i UT_i, B1's fp64 pair
    sums): one wrapper launch, bitwise reproducible, exactly symmetric,
    and on inputs scaled x1e3 within 4x the plain fp32 version's error
    against float64, plus 1e-7 max|G|; its kernels B1's (the fused pass up
    to 8 clients, B19's contraction above), none of the SIMT Gram's."""
    out_d, in_d, k, N = shape
    _, _, _, _, A, UT = _left_inputs(card, out_d, in_d, k, N)
    before = maecho_gram_left.launches
    got = maecho_gram_left(A, UT)
    assert maecho_gram_left.launches - before == 1
    assert torch.equal(got, maecho_gram_left(A, UT))
    assert torch.equal(got, got.T)
    R = (A.double() @ UT.double()).reshape(N, -1)
    want = R @ R.T
    err = (got.double() - want).abs().max().item()
    err_plain = (ref.maecho_gram_left_ref(A, UT).double() - want).abs().max().item()
    assert err <= 4 * err_plain + 1e-7 * want.abs().max().item(), (err, err_plain)
    names = _kernel_names(lambda: maecho_gram_left(A, UT))
    route = B1_FUSED if N <= 8 else B1_CROSS
    assert len(names) == len(route) and all(n in g for n, g in zip(route, names)), names
    assert not any(k in n for n in names for k in SIMT_GRAMS), names


def test_left_kernels_take_unaligned_operands(card):
    """B2 and B17 on operands whose data start 4 bytes past a 16-byte
    boundary (views one float into a larger tensor: every operand then
    takes the 4-byte copies, V' the single stores) give bitwise the
    outputs of the aligned operands."""
    def shifted(t):
        buf = torch.empty(t.numel() + 1, device="cuda")
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4
        return view

    _, _, _, _, A, UT = _left_inputs(card, 200, 300, 78, 4)
    assert torch.equal(maecho_gram_left(shifted(A), shifted(UT)), maecho_gram_left(A, UT))
    W, V, _, _, B, UTs = _left_inputs(card, 200, 300, 89, 2, 3)
    for norm in (False, True):
        want = maecho_v_update_left_stacked(B, UTs, W, V, 0.9, norm)
        got = maecho_v_update_left_stacked(shifted(B), shifted(UTs), shifted(W), shifted(V),
                                           0.9, norm)
        assert torch.equal(got, want), norm


def _v_update_left_f64(B, UT, W, V, frac, norm, eps=1e-12):
    """Eq. 11 from compressed residuals in float64, stacked: V + Norm((W -
    V) - frac B UT)."""
    u = (W[None] - V).double() - frac * (B.double() @ UT.double())
    if norm:
        u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True).clamp_min(eps)
    return V.double() + u


# (L, out, in, k, N): a ragged multi-tile leaf, in % 4 != 0 and k % 4 != 0
# (every copy 4 bytes, single stores), and Qwen2-0.5B's wq at k = 89
@pytest.mark.parametrize("norm", (False, True))
@pytest.mark.parametrize("shape", ((3, 200, 300, 40, 5), (2, 130, 301, 37, 3),
                                   (24, 896, 896, 89, 2)), ids=lambda s: "x".join(map(str, s)))
def test_v_update_left_stacked_3xtf32(card, shape, norm):
    """B17 on the tensor cores (3xTF32, a persistent grid over the (layer,
    tile, client) units): one launch of its tf32 kernel (plus the norm
    pass), none of the SIMT v_update_kernel, bitwise reproducible, and on
    inputs scaled x1e3 within 4x the plain fp32 version's error against
    float64, plus 1e-7 max|V'|."""
    L, out_d, in_d, k, N = shape
    W, V, _, _, B, UT = _left_inputs(card, out_d, in_d, k, N, L)
    frac = 20.0 / 21.0
    before = maecho_v_update_factored_stacked.launches
    got = maecho_v_update_left_stacked(B, UT, W, V, frac, norm)
    assert maecho_v_update_factored_stacked.launches - before == 1
    assert torch.equal(got, maecho_v_update_left_stacked(B, UT, W, V, frac, norm))
    want = _v_update_left_f64(B, UT, W, V, frac, norm)
    err = (got.double() - want).abs().max().item()
    err_plain = (ref.maecho_v_update_left_stacked_ref(B, UT, W, V, frac, norm).double()
                 - want).abs().max().item()
    assert err <= 4 * err_plain + 1e-7 * want.abs().max().item(), (err, err_plain)
    names = _kernel_names(lambda: maecho_v_update_left_stacked(B, UT, W, V, frac, norm))
    assert sum("v_update_left_tf32_kernel" in n for n in names) == 1, names
    assert sum("v_norm_kernel" in n for n in names) == norm, names
    assert len(names) == 1 + norm, names


def test_stacked_wrappers_reject_bad_operands(card):
    W = torch.zeros(2, 8, 8, device="cuda")
    V = torch.zeros(3, 2, 8, 8, device="cuda")
    P = torch.zeros(3, 2, 8, 8, device="cuda")
    p = torch.zeros(3, 2, 8, device="cuda")
    a = torch.ones(2, 3, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        maecho_gram_stacked(W, V, P.double())
    with pytest.raises(ValueError, match="contiguous"):
        maecho_update_stacked(W, V, P.transpose(-1, -2), a)
    with pytest.raises(ValueError, match="shapes"):
        maecho_v_update_stacked(W, V, P[:, :1].contiguous(), 0.5)
    with pytest.raises(ValueError, match="shapes"):
        maecho_update_diag_stacked(W, V, p, a.T.contiguous())
    with pytest.raises(ValueError, match="V must be"):
        maecho_gram_diag_stacked(W, V[0], p)
    with pytest.raises(ValueError, match="clients"):
        maecho_gram_diag_stacked(W, torch.zeros(0, 2, 8, 8, device="cuda"),
                                 torch.zeros(0, 2, 8, device="cuda"))
    with pytest.raises(ValueError, match="several devices"):
        maecho_v_update_diag_stacked(W, V, p.cpu(), 0.5)


@pytest.mark.parametrize("L", (1, 3, 8))
def test_stacked_aggregate_launches_once_per_leaf_and_iteration(card, L):
    """A kernel aggregate with stacked leaves launches each stacked kernel
    once per leaf and outer iteration, whatever L is — B10/B13/B16 for
    the dense leaf, B12/B15/B18 for the scalar one — and no unstacked
    kernel; it matches the oracle aggregate to 1e-3."""
    N, tau = 3, 2
    clients = [{"q": torch.randn(L, 160, 200, device="cuda", generator=card),
                "o": torch.randn(L, 200, 144, device="cuda", generator=card),
                "b": torch.randn(L, 200, device="cuda", generator=card)}
               for _ in range(N)]
    U = torch.linalg.qr(torch.randn(N, L, 160, 40, device="cuda", generator=card))[0]
    projs = [{"q": (U[i] @ U[i].transpose(-1, -2)).contiguous(),
              "o": torch.ones(L, device="cuda"), "b": torch.ones(L, device="cuda")}
             for i in range(N)]
    cfg = MAEchoConfig(tau=tau, eta=0.5, mu=20.0)
    kernels = STACKED_FULL + STACKED_DIAG + OTHERS + DIAG
    before = [k.launches for k in kernels]
    got = maecho_aggregate(clients, projs, cfg, convention="io",
                           stack_levels={"q": 1, "o": 1, "b": 1}, backend="kernel")
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [tau] * 6 + [0] * 9
    want = maecho_aggregate(clients, projs, cfg, convention="io",
                            stack_levels={"q": 1, "o": 1, "b": 1}, backend="oracle")
    for k in ("q", "o", "b"):
        torch.testing.assert_close(got[k], want[k], atol=1e-3, rtol=0)


STACKED_LEFT = (maecho_gram_left_stacked, maecho_update_left_stacked,
                maecho_v_update_factored_stacked)


def _stacked_factored(gen, L, out_d, in_d, k, N):
    W = torch.randn(L, out_d, in_d, device="cuda", generator=gen)
    V = W + 0.1 * torch.randn(N, L, out_d, in_d, device="cuda", generator=gen)
    U = torch.linalg.qr(torch.randn(N, L, in_d, k, device="cuda", generator=gen))[0]
    s = torch.rand(N, L, k, device="cuda", generator=gen) * 0.9 + 0.1
    a = torch.softmax(torch.randn(L, N, device="cuda", generator=gen), -1).contiguous()
    return W, V, U.contiguous(), s, a


# (L, out, in, rank, N): ragged out/in/rank with one client, a multi-tile
# ragged leaf, one layer, 54 clients (one block) and 64 (client blocks)
@pytest.mark.parametrize("shape", ((3, 33, 65, 7, 1), (3, 200, 300, 40, 5),
                                   (1, 128, 256, 16, 3), (2, 64, 96, 40, 54),
                                   (2, 64, 96, 40, 64)))
def test_stacked_factored_kernels_match_plain(card, shape):
    """B11/B14/B17 against their plain versions, B11 bitwise reproducible
    and its last layer equal to a launch on that layer alone."""
    L, out_d, in_d, k, N = shape
    W, V, U, s, a = _stacked_factored(card, L, out_d, in_d, k, N)
    A = compressed_residual(W, V, U, s)
    UT = U.transpose(-1, -2).contiguous()
    G, Gr = maecho_gram_left_stacked(A, UT), ref.maecho_gram_left_stacked_ref(A, UT)
    assert G.shape == (L, N, N)
    assert (G - Gr).abs().max() <= 1e-5 * Gr.abs().max()
    assert torch.equal(G, maecho_gram_left_stacked(A, UT))
    assert torch.equal(G[L - 1], maecho_gram_left_stacked(A[:, L - 1:].contiguous(),
                                                          UT[:, L - 1:].contiguous())[0])
    Wn = maecho_update_left_stacked(W, A, UT, a, 0.5)
    torch.testing.assert_close(Wn, ref.maecho_update_left_stacked_ref(W, A, UT, a, 0.5),
                               atol=1e-4, rtol=0)
    B = compressed_residual(Wn, V, U, s)
    for norm in (False, True):
        want = ref.maecho_v_update_factored_stacked_ref(Wn, V, U, s, 0.9, norm)
        torch.testing.assert_close(maecho_v_update_factored_stacked(Wn, V, U, s, 0.9, norm),
                                   want, atol=1e-4, rtol=0)
        torch.testing.assert_close(maecho_v_update_left_stacked(B, UT, Wn, V, 0.9, norm),
                                   want, atol=1e-4, rtol=0)


def test_stacked_factored_wrappers_reject_bad_operands(card):
    A = torch.zeros(3, 2, 8, 4, device="cuda")
    UT = torch.zeros(3, 2, 4, 8, device="cuda")
    W = torch.zeros(2, 8, 8, device="cuda")
    V = torch.zeros(3, 2, 8, 8, device="cuda")
    a = torch.ones(2, 3, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        maecho_gram_left_stacked(A, UT.double())
    with pytest.raises(ValueError, match="shapes"):
        maecho_gram_left_stacked(A, UT[:, :, :3].contiguous())
    with pytest.raises(ValueError, match="must be"):
        maecho_gram_left_stacked(A[0], UT)
    with pytest.raises(ValueError, match="contiguous"):
        maecho_update_left_stacked(W, A, UT, a.T)
    with pytest.raises(ValueError, match="shapes"):
        maecho_update_left_stacked(W, A, UT, a.T.contiguous())
    with pytest.raises(ValueError, match="shapes"):
        maecho_v_update_factored_stacked(W, V, torch.zeros(3, 2, 8, 4, device="cuda"),
                                         torch.zeros(3, 2, 5, device="cuda"), 0.5)
    with pytest.raises(ValueError, match="shapes"):
        maecho_v_update_left_stacked(A, UT, W, V[:, :1].contiguous(), 0.5)
    with pytest.raises(ValueError, match="several devices"):
        maecho_v_update_left_stacked(A, UT, W, V.cpu(), 0.5)


@pytest.mark.parametrize("L", (1, 3))
def test_stacked_factored_aggregate_launches_once_per_leaf_and_iteration(card, L):
    """A kernel aggregate with a factored stacked leaf launches B11/B14/B17
    once per leaf and outer iteration, whatever L is (B12/B15/B18 for
    the scalar one), and no other kernel; it matches the oracle
    aggregate to 1e-3, "io" layout."""
    N, tau, k = 3, 2, 24
    clients = [{"q": torch.randn(L, 160, 200, device="cuda", generator=card),
                "o": torch.randn(L, 200, 144, device="cuda", generator=card)}
               for _ in range(N)]
    U = torch.linalg.qr(torch.randn(N, L, 160, k, device="cuda", generator=card))[0]
    projs = [{"q": {"U": U[i].contiguous(),
                    "s": torch.rand(L, k, device="cuda", generator=card)},
              "o": torch.ones(L, device="cuda")} for i in range(N)]
    cfg = MAEchoConfig(tau=tau, eta=0.5, mu=20.0)
    kernels = STACKED_LEFT + STACKED_DIAG + STACKED_FULL + OTHERS + DIAG
    before = [k.launches for k in kernels]
    got = maecho_aggregate(clients, projs, cfg, convention="io",
                           stack_levels={"q": 1, "o": 1}, backend="kernel")
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [tau] * 6 + [0] * 12
    want = maecho_aggregate(clients, projs, cfg, convention="io",
                            stack_levels={"q": 1, "o": 1}, backend="oracle")
    for key in ("q", "o"):
        torch.testing.assert_close(got[key], want[key], atol=1e-3, rtol=0)


# Every Gram kernel past the 54 clients one CTA can park: 55 (three
# blocks of 19/19/17) and 64 (22/22/20), on ragged multi-tile leaves
@pytest.mark.parametrize("N", (55, 64))
def test_gram_kernels_beyond_54_clients(card, N):
    """B1, B2, B3, B10, B11 and B12 against their plain versions and a
    float64 Gram, each bitwise reproducible, and a dense kernel aggregate
    against the oracle's."""
    out_d, in_d, k, L = 200, 300, 40, 2
    W = torch.randn(out_d, in_d, device="cuda", generator=card)
    V = W + 0.1 * torch.randn(N, out_d, in_d, device="cuda", generator=card)
    Uf = torch.linalg.qr(torch.randn(N, in_d, k, device="cuda", generator=card))[0]
    P = (Uf @ Uf.transpose(1, 2)).contiguous()
    s = torch.rand(N, k, device="cuda", generator=card) + 0.1
    p = torch.rand(N, in_d, device="cuda", generator=card)
    A = compressed_residual(W, V, Uf, s)
    UT = Uf.transpose(1, 2).contiguous()
    Ws, Vs, Us, ss, _ = _stacked_factored(card, L, out_d, in_d, k, N)
    Ps = (Us @ Us.transpose(-1, -2)).contiguous()
    ps = torch.rand(N, L, in_d, device="cuda", generator=card)
    As = compressed_residual(Ws, Vs, Us, ss)
    UTs = Us.transpose(-1, -2).contiguous()
    d, ds = (W[None] - V).double(), (Ws[None] - Vs).double()
    for fn, plain, args, R64 in (
            (maecho_gram, ref.maecho_gram_ref, (W, V, P), d @ P.double()),
            (maecho_gram_left, ref.maecho_gram_left_ref, (A, UT), A.double() @ UT.double()),
            (maecho_gram_diag, ref.maecho_gram_diag_ref, (W, V, p),
             d * p.double()[:, None, :]),
            (maecho_gram_stacked, ref.maecho_gram_stacked_ref, (Ws, Vs, Ps),
             ds @ Ps.double()),
            (maecho_gram_left_stacked, ref.maecho_gram_left_stacked_ref, (As, UTs),
             As.double() @ UTs.double()),
            (maecho_gram_diag_stacked, ref.maecho_gram_diag_stacked_ref, (Ws, Vs, ps),
             ds * ps.double()[:, :, None, :])):
        G, Gr = fn(*args), plain(*args)
        assert G.shape == Gr.shape and G.shape[-2:] == (N, N), fn.__name__
        assert (G - Gr).abs().max() <= 1e-5 * Gr.abs().max(), fn.__name__
        Rf = R64.reshape(N, -1, out_d * in_d).transpose(0, 1)      # (L or 1, N, out·in)
        G64 = (Rf @ Rf.transpose(-1, -2)).reshape(G.shape)
        assert (G.double() - G64).abs().max() <= 1e-5 * G64.abs().max(), fn.__name__
        assert torch.equal(G, fn(*args)), fn.__name__
    clients = [{"W": W.clone()}] + [{"W": V[i] + 0.0} for i in range(1, N)]
    projs = [{"W": P[i]} for i in range(N)]
    cfg = MAEchoConfig(tau=2, eta=0.5, mu=20.0)
    assert _aggregate_launches(clients, projs, cfg, OTHERS[:3]) == [2, 2, 2]


# B19 at ragged client counts and a D no multiple of a k-step; Ra is Rb
# for a diagonal block.  Every tile (64, 16, 1-4 on either axis; tiny
# pairs) and both load widths (float4 where D % 4 == 0, scalar otherwise)
@pytest.mark.parametrize("shape", ((1, 7, 513), (37, 64, 60001), (65, 130, 4097),
                                   (64, 64, 313600), (1, 1, 2 ** 20 + 3), (1, 64, 313600),
                                   (3, 5, 4097), (16, 16, 60001), (64, 16, 313600),
                                   (2, 3, 2 ** 20)))
def test_gram_cross_matches_plain(card, shape):
    """B19 against its plain version and a float64 product, bitwise
    reproducible, and exactly symmetric on a diagonal block."""
    ca, cb, D = shape
    Ra = torch.randn(ca, D, device="cuda", generator=card)
    Rb = torch.randn(cb, D, device="cuda", generator=card)
    before = maecho_gram_cross.launches
    for a, b in ((Ra, Rb), (Rb, Rb)):
        G, Gr = maecho_gram_cross(a, b), ref.maecho_gram_cross_ref(a, b)
        G64 = a.double() @ b.double().T
        assert G.shape == (a.shape[0], b.shape[0])
        assert (G - Gr).abs().max() <= 1e-5 * Gr.abs().max()
        assert (G.double() - G64).abs().max() <= 1e-5 * G64.abs().max()
        assert torch.equal(G, maecho_gram_cross(a, b))
    assert torch.equal(G, G.T)
    assert maecho_gram_cross.launches - before == 4


def test_gram_cross_rejects_bad_operands(card):
    Ra = torch.zeros(3, 8, device="cuda")
    with pytest.raises(ValueError, match="shapes"):
        maecho_gram_cross(Ra, torch.zeros(3, 9, device="cuda"))
    with pytest.raises(ValueError, match="float32"):
        maecho_gram_cross(Ra.double(), Ra.double())
    with pytest.raises(ValueError, match="contiguous"):
        maecho_gram_cross(Ra, torch.zeros(8, 3, device="cuda").T)


@pytest.mark.parametrize("d,b", ((512, 64), (784, 128), (896, 128), (100, 7), (70, 200)))
def test_rank_downdate_matches_plain(card, d, b):
    """B20 against Q − U A Uᵀ in fp32 and float64 (1e-3), ragged d and b
    included, and the block-RLS step around it against
    core.projections.block_update."""
    Q0 = torch.randn(d, d, device="cuda", generator=card)
    Q = Q0 @ Q0.T / d + torch.eye(d, device="cuda")
    U = torch.randn(d, b, device="cuda", generator=card) / b ** 0.5
    A0 = torch.randn(b, b, device="cuda", generator=card) / b ** 0.5
    A = (0.5 * (A0 + A0.T)).contiguous()
    before = rank_downdate.launches
    got = rank_downdate(Q, U, A)
    torch.testing.assert_close(got, ref.rank_downdate_ref(Q, U, A), atol=1e-3, rtol=1e-3)
    want64 = Q.double() - U.double() @ A.double() @ U.double().T
    torch.testing.assert_close(got.double(), want64, atol=1e-3, rtol=1e-3)
    Xb = torch.randn(b, d, device="cuda", generator=card)
    torch.testing.assert_close(block_rls_update(Q, Xb, 1.0),
                               block_update(Q, Xb, 1.0), atol=1e-3, rtol=1e-3)
    assert rank_downdate.launches - before == 2


def test_chunked_kernel_aggregate_matches_oracle(card):
    """A kernel aggregate at client_chunk 3 over N = 7 (chunks 3/3/1)
    contracts its one kernel leaf's chunk pairs with B19, 6 a step, and
    launches no other kernel; it agrees with the unchunked oracle."""
    N, out_d, in_d, k = 7, 160, 200, 30
    clients = [{"W": torch.randn(out_d, in_d, device="cuda", generator=card)}
               for _ in range(N)]
    projs = [{"W": {"U": torch.linalg.qr(torch.randn(in_d, k, device="cuda",
                                                     generator=card))[0].contiguous(),
                    "s": torch.rand(k, device="cuda", generator=card) + 0.1}}
             for _ in range(N)]
    cfg = MAEchoConfig(tau=2, eta=0.5, mu=20.0, client_chunk=3)
    before = maecho_gram_cross.launches
    assert _aggregate_launches(clients, projs, cfg, OTHERS + DIAG) == [0] * 9
    assert maecho_gram_cross.launches - before == 2 * 6
    want = maecho_aggregate(clients, projs, MAEchoConfig(tau=2, eta=0.5, mu=20.0),
                            backend="oracle")
    got = maecho_aggregate(clients, projs, cfg, backend="kernel")
    torch.testing.assert_close(got["W"], want["W"], atol=1e-3, rtol=0)
    assert ops.maecho_gram_cross is maecho_gram_cross


# --------------------------------------------------------------------------
# serving: B21 (flash attention) and B22 (decode attention)
# --------------------------------------------------------------------------
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}   # bf16: one output rounding


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", ((8, 512, 512, 14, 2, 64, True), (2, 200, 200, 14, 2, 64, True),
                                   (2, 200, 200, 14, 2, 64, False), (1, 130, 130, 4, 1, 96, True),
                                   (1, 70, 300, 2, 2, 128, False), (2, 40, 40, 4, 2, 32, True),
                                   (2, 64, 64, 4, 2, 64, False), (2, 64, 64, 4, 2, 64, True),
                                   (1, 100, 100, 4, 2, 40, True), (1, 100, 100, 4, 2, 80, False),
                                   (1, 100, 100, 4, 2, 36, True), (3, 1, 1, 4, 2, 64, True)),
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_matches_plain(card, shape, dtype):
    """B21 against its plain version, causal and not, GQA/MQA/MHA, D 32 to
    128 (36, 40, 80 and 96 zero-filled to 64 or 128; at D = 36 the bf16
    rows are not 16-byte aligned and are copied element by element), one
    kv tile (S = 64), Sq = Sk = 1, ragged S; one launch per call, bitwise
    reproducible."""
    B, Sq, Sk, Hq, Hkv, D, causal = shape
    q = torch.randn(B, Sq, Hq, D, device="cuda", generator=card).to(dtype)
    k = torch.randn(B, Sk, Hkv, D, device="cuda", generator=card).to(dtype)
    v = torch.randn(B, Sk, Hkv, D, device="cuda", generator=card).to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches - before == 1 and got.dtype == dtype
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v, causal=causal).float(),
                               atol=tol, rtol=tol)
    assert torch.equal(got, flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
def test_flash_attention_reads_strided_inputs(card, dtype):
    """q, k, v sliced out of one fused (B, S, H, D) buffer are read in place."""
    qkv = torch.randn(2, 96, 10, 64, device="cuda", generator=card).to(dtype)
    q, k, v = qkv[:, :, :6], qkv[:, :, 6:8], qkv[:, :, 8:]
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(flash_attention(q, k, v).float(),
                               ref.flash_attention_ref(q, k, v).float(), atol=tol, rtol=tol)


def _decode_inputs(card, B, W, Hkv, group, D, fill, dtype):
    q = torch.randn(B, 1, Hkv * group, D, device="cuda", generator=card).to(dtype)
    kc = torch.randn(B, W, Hkv, D, device="cuda", generator=card).to(dtype)
    vc = torch.randn(B, W, Hkv, D, device="cuda", generator=card).to(dtype)
    pos = fill - 1
    idx = torch.arange(W, device="cuda")
    last = pos - torch.remainder(pos - idx, W)
    valid = ((last >= 0) & (last > pos - W)).expand(B, W).clone()
    return q, kc, vc, valid


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("case", ((8, 640, 2, 7, 64, 576), (8, 640, 2, 7, 64, 700),
                                  (2, 200, 2, 4, 64, 150), (3, 256, 1, 16, 128, 30),
                                  (1, 128, 4, 1, 32, 128), (8, 4096, 2, 7, 64, 4000),
                                  (2, 512, 1, 64, 64, 300), (2, 300, 1, 64, 128, 250),
                                  (2, 4096, 2, 7, 128, 5000), (3, 5, 2, 3, 40, 4)),
                         ids=lambda c: "x".join(map(str, c)))
def test_decode_attention_matches_plain(card, case, dtype):
    """B22 against its plain version: Qwen2-0.5B's serving shape filled to
    576 and wrapped, a ragged W, MQA with a group of 16, MHA, W = 4096
    (more sub-blocks than a cluster has CTAs), groups of 64 (at D = 128
    the largest shared-memory footprint), a window of 5 slots; row 0 with
    no valid slot gives zeros; one launch per call."""
    B, W, Hkv, group, D, fill = case
    q, kc, vc, valid = _decode_inputs(card, B, W, Hkv, group, D, fill, dtype)
    valid[0] = False
    before = decode_attention.launches
    got = decode_attention(q, kc, vc, valid)
    assert decode_attention.launches - before == 1 and got.dtype == dtype
    assert bool((got[0] == 0).all())
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.decode_attention_ref(q, kc, vc, valid).float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(decode_attention(q, kc, vc, valid), got, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
def test_decode_attention_per_row_fills(card, dtype):
    """Each batch row at its own position, as continuous batching makes
    them (slots admitted at different steps, one wrapped, one empty):
    B22 against its plain version, bitwise reproducible."""
    B, W, Hkv, group, D = 8, 640, 2, 7, 64
    q, kc, vc, _ = _decode_inputs(card, B, W, Hkv, group, D, 1, dtype)
    pos = torch.tensor([0, 3, 63, 64, 200, 575, 700, -1], device="cuda")[:, None]
    idx = torch.arange(W, device="cuda")[None]
    last = pos - torch.remainder(pos - idx, W)
    valid = (last >= 0) & (last > pos - W)
    got = decode_attention(q, kc, vc, valid)
    assert bool((got[7] == 0).all())
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.decode_attention_ref(q, kc, vc, valid).float(),
                               atol=tol, rtol=tol)
    assert torch.equal(got, decode_attention(q, kc, vc, valid))


_ONE_KERNEL = """
import json, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.decode_attention import decode_attention
g = torch.Generator(device="cuda").manual_seed(0)
q = torch.randn(8, 1, 14, 64, device="cuda", generator=g).bfloat16()
kc, vc = (torch.randn(8, 640, 2, 64, device="cuda", generator=g).bfloat16() for _ in range(2))
valid = (torch.arange(640, device="cuda") < 576).expand(8, 640)
decode_attention(q, kc, vc, valid)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    decode_attention(q, kc, vc, valid)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events() if e.device_type == DeviceType.CUDA]))
"""


def test_decode_attention_is_one_kernel(card):
    """One call is one kernel launch (no combine kernel) and allocates
    only its output (no workspace).  The launch count is read by
    torch.profiler in a process of its own: late in this file's run the
    profiler reported no device events at all (calls 20i-20k, PERF.md
    §6), while the same check passed alone and in chip_smoke.py."""
    import json
    import subprocess
    import sys

    run = subprocess.run([sys.executable, "-c", _ONE_KERNEL], capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    names = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(names) == 1 and "decode_attention_kernel" in names[0], names
    q, kc, vc, valid = _decode_inputs(card, 8, 640, 2, 7, 64, 576, torch.bfloat16)
    decode_attention(q, kc, vc, valid)
    torch.cuda.synchronize()
    n0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = decode_attention(q, kc, vc, valid)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - n0 == 1
    assert out.shape == (8, 1, 14, 64)


def test_decode_attention_reads_a_w_live_view(card):
    """The serving crop hands B22 a view of the cache (batch stride
    W·Hkv·D) and of an expanded mask (batch stride 0), with no copy."""
    q, kc, vc, valid = _decode_inputs(card, 4, 1024, 2, 7, 64, 200, torch.bfloat16)
    mask = valid[:1].expand(4, 1024)
    seen = []
    orig = ops.decode_attention

    def spy(q_, k_, v_, m_):
        seen.append((k_.stride(0), k_.data_ptr() == kc.data_ptr(), m_.stride(0)))
        return orig(q_, k_, v_, m_)

    ops.decode_attention = spy
    try:
        got = ops.decode_attention_auto(q, kc, vc, mask, w_live=200)
    finally:
        ops.decode_attention = orig
    assert seen == [(1024 * 2 * 64, True, 0)]
    torch.testing.assert_close(got.float(), ref.decode_attention_ref(q, kc, vc, mask).float(),
                               atol=1e-2, rtol=1e-2)


def test_flash_attention_backward_raises(card):
    q = torch.randn(1, 64, 2, 32, device="cuda", generator=card, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_attention(q, q.detach(), q.detach()).sum().backward()


def test_kernel_backend_raises_on_inexpressible_shapes(card):
    from repro_torch.models import layers as L

    q = torch.randn(1, 32, 2, 32, device="cuda", generator=card)
    k = torch.randn(1, 100, 2, 32, device="cuda", generator=card)
    with pytest.raises(ValueError, match="not expressible"):
        L.prefill_attention(q, q, q, q_offset=4, backend="kernel")
    with pytest.raises(ValueError, match="not expressible"):
        L.prefill_attention(q, k, k, causal=False, backend="kernel")
    with pytest.raises(ValueError, match="128-multiple"):
        L.decode_attention(q[:, :1], k, k, torch.ones(1, 100, dtype=torch.bool, device="cuda"),
                           backend="kernel")
    with pytest.raises(ValueError, match="not expressible"):
        ops.flash_attention_auto(q, k, k, causal=True)
    # "auto" keeps the reference's rule: an ineligible shape runs the plain path
    torch.testing.assert_close(L.prefill_attention(q, q, q, q_offset=4, backend="auto"),
                               L.prefill_attention(q, q, q, q_offset=4, backend="oracle"))


def test_auto_backend_launches_flash_at_noncausal_block_multiple(card):
    """Non-causal Sk = 384 (a 128- but not 256-multiple) is eligible under
    the reference's rule: ``"auto"`` launches B21 once and agrees with the
    plain version."""
    from repro_torch.models import layers as L

    q = torch.randn(2, 40, 14, 64, device="cuda", generator=card)
    k, v = (torch.randn(2, 384, 2, 64, device="cuda", generator=card) for _ in range(2))
    before = flash_attention.launches
    got = L.prefill_attention(q, k, v, causal=False, backend="auto")
    assert flash_attention.launches - before == 1
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, causal=False),
                               atol=2e-5, rtol=0)


def test_attention_wrappers_reject_bad_operands(card):
    q = torch.randn(1, 16, 2, 32, device="cuda", generator=card)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="mixed dtypes"):
        flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="several devices"):
        flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError, match="contiguous last axis"):
        flash_attention(q, q.transpose(1, 3).contiguous().transpose(1, 3), q)
    with pytest.raises(ValueError, match="D <= 128"):
        big = torch.zeros(1, 4, 1, 160, device="cuda")
        flash_attention(big, big, big)
    mask = torch.ones(1, 16, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="valid_mask"):
        decode_attention(q[:, :1], q, q, mask.cpu())
    with pytest.raises(ValueError, match="valid_mask"):
        decode_attention(q[:, :1], q, q, mask.int())
    with pytest.raises(ValueError, match="one token"):
        decode_attention(q[:, :2], q, q, mask)


def test_serving_kernel_tokens_match_oracle(card):
    """The smoke Qwen2-0.5B served at a 256-slot window: the kernel
    backend launches B21 once per prefill layer and B22 once per decode
    layer and step, and emits the oracle backend's tokens."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import run_fixed
    from repro_torch.models.zoo import get_model

    cfg = get_smoke_config("qwen2-0.5b")
    params = get_model(cfg).init_params(0, device="cuda")
    prompts = torch.randint(0, cfg.vocab, (3, 250), device="cuda", generator=card,
                            dtype=torch.int32)
    toks = {}
    for backend in ("kernel", "oracle"):
        c = cfg.replace(attn_backend=backend)
        before = (flash_attention.launches, decode_attention.launches)
        toks[backend], stats = run_fixed(c, get_model(c), params, prompts, 6)
        counts = (flash_attention.launches - before[0], decode_attention.launches - before[1])
        assert stats["window"] == 256
        assert counts == ((cfg.n_layers, cfg.n_layers * 5) if backend == "kernel" else (0, 0))
    assert torch.equal(toks["kernel"], toks["oracle"])
