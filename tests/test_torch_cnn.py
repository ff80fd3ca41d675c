"""Port parity on the paper CNN (CIFAR-10 shaped, three stride-2 3×3
convs and three fc layers) and the rest of the client data side: the
CIFAR-like data and the label-shard partition bit-identical, the conv
with XLA's "SAME" padding and the (1, 1)-padded im2col as the reference
computes them, the forward (logits and features), local training,
projector estimation and the one-shot aggregate (conv flattening
included), each from the reference's own start.

Inputs come from fixed numpy seeds.  Tolerances: forward and features
1e-5 (fp32 round-off of one conv stack), training and projectors 1e-4,
aggregate 1e-3 (the reference's aggregate tolerance).
"""
import jax
import numpy as np
import pytest

from repro.core.maecho import MAEchoConfig as JCfg
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.fl import client as jc
from repro.fl import models as jpm
from repro.fl.server import one_shot_aggregate as j_aggregate
from repro_torch import interop
from repro_torch.core.maecho import MAEchoConfig as TCfg
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.fl import client as tc
from repro_torch.fl import models as tpm
from repro_torch.fl.server import one_shot_aggregate as t_aggregate
from repro_torch.kernels.maecho_gram import maecho_gram

# the smoke CNN, and a wider one whose fc0 (128 x 128) takes the kernel route
SPECS = {"smoke": dict(in_shape=(8, 8, 3), conv_channels=(8, 8, 8), fc_hidden=(16, 16)),
         "wide": dict(in_shape=(8, 8, 3), conv_channels=(8, 8, 128),
                      fc_hidden=(128, 16))}


def jspec(name):
    return jpm.PaperModelSpec(name, "cnn", **SPECS[name])


def tspec(name):
    return tpm.PaperModelSpec(name, "cnn", **SPECS[name])


def to_port(tree):
    return interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _close(got, want, atol):
    g = jax.tree_util.tree_leaves(interop.params_to_numpy(got))
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == np.shape(b)
        np.testing.assert_allclose(a, np.asarray(b), atol=atol)


def _images(seed, n, shape=(8, 8, 3)):
    """Synthetic images (n, *shape) and labels from the reference's
    generator (the lift has prod(shape) pixels)."""
    d = jsyn.generate(jsyn.DatasetSpec("img", n_train=n, n_test=n // 2, latent=8,
                                       out_dim=int(np.prod(shape)), seed=seed))
    return (d["train_x"].reshape((n,) + shape), d["train_y"],
            d["test_x"].reshape((n // 2,) + shape), d["test_y"])


@pytest.fixture(scope="module", params=sorted(SPECS))
def trained(request):
    """Three reference-trained clients of one CNN spec with their
    reference projectors, on a Dirichlet(0.3) split."""
    name = request.param
    x, y, tx, ty = _images(3, 240)
    parts = jpart.dirichlet_partition(y, 3, 0.3, seed=1)
    cfg = jc.LocalTrainConfig(epochs=2, max_steps=8, batch_size=16, seed=5)
    clients, projs = [], []
    for k, ix in enumerate(parts):
        p, _ = jc.train_classifier(jspec(name), jpm.init(jspec(name), jax.random.PRNGKey(k)),
                                   x[ix], y[ix], cfg)
        clients.append(p)
        projs.append(jc.compute_projections(jspec(name), p, x[ix], batch=64))
    return name, (x, y, tx, ty), parts, clients, projs


def test_cifar_like_bit_identical():
    assert tsyn.CIFAR_LIKE == tsyn.DatasetSpec(**{
        f: getattr(jsyn.CIFAR_LIKE, f) for f in jsyn.CIFAR_LIKE.__dataclass_fields__})
    a = jsyn.generate(jsyn.CIFAR_LIKE)
    b = tsyn.generate(tsyn.CIFAR_LIKE)
    assert b["train_x"].shape == (10_000, 32, 32, 3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


@pytest.mark.parametrize("n_clients,n_labels,seed", ((4, 2, 0), (10, 2, 3), (5, 3, 7)))
def test_label_shard_partition_bit_identical(n_clients, n_labels, seed):
    y = np.random.RandomState(seed).randint(0, 10, size=600)
    a = jpart.label_shard_partition(y, n_clients, n_labels, seed=seed)
    b = tpart.label_shard_partition(y, n_clients, n_labels, seed=seed)
    assert len(a) == len(b) == n_clients
    for x, z in zip(a, b):
        np.testing.assert_array_equal(x, z)
        assert x.dtype == z.dtype


@pytest.mark.parametrize("hw", ((8, 8), (7, 7), (6, 9)))
def test_conv2d_matches_reference(hw):
    """XLA "SAME" padding at stride 2: (0, 1) on an even axis, (1, 1) on
    an odd one — torch's symmetric ``padding=1`` would be wrong."""
    r = np.random.RandomState(sum(hw))
    x = r.randn(2, *hw, 5).astype(np.float32)
    W = r.randn(4, 5, 3, 3).astype(np.float32)
    b = r.randn(4).astype(np.float32)
    want = jpm._conv2d(x, W, b)
    got = tpm._conv2d(*to_port((x, W, b)))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_im2col_and_forward_match_reference(name):
    """Logits and every layer's features (im2col patches for the convs,
    in the reference's ``c·9 + di·3 + dj`` column order, and the
    (H, W, C)-order flatten before fc0) from the reference's init."""
    params = jpm.init(jspec(name), jax.random.PRNGKey(0))
    x = _images(1, 6)[0]
    np.testing.assert_allclose(tpm._im2col(to_port(x), 3).numpy(),
                               np.asarray(jpm._im2col(x, 3)), atol=0)
    want, wfeats = jpm.cnn_forward(params, x, return_features=True)
    got, gfeats = tpm.forward(tspec(name), to_port(params), to_port(x),
                              return_features=True)
    _close([got] + gfeats, [want] + list(wfeats), 1e-5)
    model = tpm.CNN(tspec(name), to_port(params), device="cpu")
    _close(model(to_port(x)), want, 1e-5)
    assert [tuple(lay["W"].shape) for lay in tpm.init(tspec(name), device="cpu")] == \
        [lay["W"].shape for lay in params]


def test_train_evaluate_and_projections_match_reference(trained):
    """A few SGD steps from the reference's init, the test accuracy, and
    the projectors (conv ones (C_in·9, C_in·9)) of the trained client."""
    name, (x, y, tx, ty), parts, clients, projs = trained
    cfg = jc.LocalTrainConfig(epochs=2, max_steps=8, batch_size=16, seed=5)
    tcfg = tc.LocalTrainConfig(epochs=2, max_steps=8, batch_size=16, seed=5)
    ix = parts[0]
    init = jpm.init(jspec(name), jax.random.PRNGKey(0))
    want, wloss = jc.train_classifier(jspec(name), init, x[ix], y[ix], cfg)
    got, gloss = tc.train_classifier(tspec(name), to_port(init), x[ix], y[ix], tcfg,
                                     device="cpu")
    _close(got, want, 1e-4)
    assert abs(gloss - wloss) < 1e-4
    assert tc.evaluate_classifier(tspec(name), to_port(clients[0]), tx, ty,
                                  batch=32, device="cpu") == \
        jc.evaluate_classifier(jspec(name), clients[0], tx, ty, batch=32)
    got_p = tc.compute_projections(tspec(name), to_port(clients[1]), x[parts[1]],
                                   batch=64, device="cpu")
    _close(got_p, projs[1], 1e-4)
    assert got_p[0]["W"].shape == (27, 27)


@pytest.mark.parametrize("method", ("fedavg", "maecho"))
def test_one_shot_aggregate_matches_reference(trained, method):
    """The aggregate of the reference's trained clients, conv leaves
    flattened to (C_out, C_in·9) and back; MA-Echo on the kernel
    backend (on the wide CNN fc0 runs the B1/B4/B7 wrappers' plain
    versions) against the reference's oracle."""
    name, _, _, clients, projs = trained
    jcfg = JCfg(tau=2, eta=0.5, mu=20.0, qp_iters=60)
    tcfg = TCfg(tau=2, eta=0.5, mu=20.0, qp_iters=60)
    args = (projs, method, jcfg) if method == "maecho" else (None, method)
    want = j_aggregate(jspec(name), clients, *args)
    kw = dict(backend="kernel") if method == "maecho" else {}
    targs = ((to_port(projs), method, tcfg) if method == "maecho"
             else (None, method))
    before = maecho_gram.launches
    got = t_aggregate(tspec(name), to_port(clients), *targs, device="cpu", **kw)
    assert maecho_gram.launches == before       # CPU: plain versions only
    assert [tuple(lay["W"].shape) for lay in got] == [lay["W"].shape for lay in want]
    _close(got, want, 1e-3)
