"""The CUDA kernels B1/B4/B7 against their plain versions on the card
(``PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py``
on a machine with an NVIDIA Hopper GPU and ``nvcc``; ``--noconftest``
because ``tests/conftest.py`` imports jax, which such a machine need not
have).  Without a card every test here skips;
``chip_smoke.py`` runs the same comparison at the main path's shapes.
"""
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.maecho_gram import maecho_gram
from repro_torch.kernels.maecho_update import maecho_update
from repro_torch.kernels.maecho_v_update import maecho_v_update

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
        maecho_gram(W, torch.zeros(55, 8, 8, device="cuda"),
                    torch.zeros(55, 8, 8, device="cuda"))
