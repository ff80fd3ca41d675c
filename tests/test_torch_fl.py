"""Port parity on the client/server side: data and partitions
bit-identical, local training and projector estimation from the same
start (1e-4), the one-shot aggregate of the same clients (1e-3), and
the numpy interop round trip."""
import jax
import numpy as np
import pytest

from repro.core import projections as jproj
from repro.core.maecho import MAEchoConfig as JCfg
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.fl import client as jc
from repro.fl import models as jpm
from repro.fl.server import one_shot_aggregate as j_aggregate
from repro.utils import trees as jtrees
from repro_torch import interop
from repro_torch.core import projections as tproj
from repro_torch.core.maecho import MAEchoConfig as TCfg
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.fl import client as tc
from repro_torch.fl import models as tpm
from repro_torch.fl.server import one_shot_aggregate as t_aggregate
from repro_torch.utils import trees as ttrees

# a narrow MLP whose first layer (128 x 160) still takes the kernel route
JSPEC = jpm.PaperModelSpec("narrow", "mlp", (160,), hidden=(128, 16))
TSPEC = tpm.PaperModelSpec("narrow", "mlp", (160,), hidden=(128, 16))
DATA = dict(n_train=600, n_test=200, latent=8, out_dim=160, seed=2)


def to_port(tree):
    return interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _close(got, want, atol):
    g, w = jax.tree_util.tree_leaves(interop.params_to_numpy(got)), \
        jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol)


@pytest.fixture(scope="module")
def setup():
    data = jsyn.generate(jsyn.DatasetSpec("narrow", **DATA))
    parts = jpart.dirichlet_partition(data["train_y"], 3, 0.1, seed=1)
    cfg = jc.LocalTrainConfig(epochs=2, max_steps=20, seed=5)
    clients, projs = [], []
    for k, ix in enumerate(parts):
        p, _ = jc.train_classifier(JSPEC, jpm.init(JSPEC, jax.random.PRNGKey(k)),
                                   data["train_x"][ix], data["train_y"][ix], cfg)
        clients.append(p)
        projs.append(jc.compute_projections(JSPEC, p, data["train_x"][ix]))
    return data, parts, clients, projs


@pytest.mark.parametrize("spec", (dict(DATA), dict(n_train=50, n_test=20,
                                                   out_dim=3072, seed=1)))
def test_generate_bit_identical(spec):
    a = jsyn.generate(jsyn.DatasetSpec("x", **spec))
    b = tsyn.generate(tsyn.DatasetSpec("x", **spec))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


@pytest.mark.parametrize("beta", (0.05, 0.5, 100.0))
def test_dirichlet_partition_bit_identical(beta):
    y = np.random.RandomState(0).randint(0, 10, size=500)
    a = jpart.dirichlet_partition(y, 4, beta, seed=3)
    b = tpart.dirichlet_partition(y, 4, beta, seed=3)
    for x, z in zip(a, b):
        np.testing.assert_array_equal(x, z)
    assert jpart.partition_stats(y, a) == tpart.partition_stats(y, b)


def test_train_classifier_matches_reference(setup):
    data, parts, _, _ = setup
    init = jpm.init(JSPEC, jax.random.PRNGKey(7))
    ix = parts[0]
    jcfg = jc.LocalTrainConfig(epochs=3, max_steps=20, seed=4)
    tcfg = tc.LocalTrainConfig(epochs=3, max_steps=20, seed=4)
    want, wl = jc.train_classifier(JSPEC, init, data["train_x"][ix],
                                   data["train_y"][ix], jcfg)
    got, gl = tc.train_classifier(TSPEC, to_port(init), data["train_x"][ix],
                                  data["train_y"][ix], tcfg, device="cpu")
    _close(got, want, 1e-4)
    assert abs(gl - wl) < 1e-4
    assert tc.evaluate_classifier(TSPEC, got, data["test_x"], data["test_y"],
                                  batch=64, device="cpu") == \
        jc.evaluate_classifier(JSPEC, want, data["test_x"], data["test_y"],
                               batch=64)


def test_compute_projections_matches_reference(setup):
    data, parts, clients, projs = setup
    for p, ix, want in zip(clients, parts, projs):
        got = tc.compute_projections(TSPEC, to_port(p), data["train_x"][ix],
                                     device="cpu")
        _close(got, want, 1e-4)


@pytest.mark.parametrize("method", ("fedavg", "maecho"))
def test_one_shot_aggregate_matches_reference(setup, method):
    """The slice end to end from the same clients and projectors: the
    port's kernel backend (plain versions on CPU) against the
    reference's kernel backend (Pallas in interpret mode)."""
    _, _, clients, projs = setup
    kw = {}
    if method == "maecho":
        kw = {"cfg": JCfg(tau=3, eta=0.5, mu=20.0), "backend": "kernel"}
    want = j_aggregate(JSPEC, clients, projs, method, **kw)
    if method == "maecho":
        kw["cfg"] = TCfg(tau=3, eta=0.5, mu=20.0)
    got = t_aggregate(TSPEC, to_port(clients), to_port(projs), method,
                      device="cpu", **kw)
    _close(got, want, 1e-3)


def test_interop_round_trip(setup):
    _, _, clients, projs = setup
    tree = {"params": clients[0], "proj": projs[0],
            "factored": {"U": np.ones((3, 2), np.float32), "s": np.ones(2)},
            "ints": np.arange(4)}
    host = jax.tree_util.tree_map(np.asarray, tree)
    back = interop.params_to_numpy(interop.params_from_numpy(host, device="cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(host)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(host)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("method", ("ot", "maecho+ot"))
def test_unported_methods_raise(setup, method):
    _, _, clients, projs = setup
    with pytest.raises(NotImplementedError, match="A6"):
        t_aggregate(TSPEC, to_port(clients), to_port(projs), method,
                    device="cpu")


def test_fedprox_local_training_raises():
    with pytest.raises(NotImplementedError, match="A6"):
        tc.train_classifier(
            tpm.MLP_SPEC, tpm.init(tpm.MLP_SPEC, device="cpu"),
            np.zeros((4, 784), np.float32), np.zeros(4, np.int32),
            tc.LocalTrainConfig(fedprox_mu=0.1), device="cpu")


def test_unported_model_kinds_raise():
    for spec in (tpm.PaperModelSpec("c", "cnn", (32, 32, 3)),
                 tpm.PaperModelSpec("v", "cvae", (794,))):
        with pytest.raises(NotImplementedError, match="A5"):
            tpm.init(spec, device="cpu")


def test_tree_utils_match_reference(setup):
    """Flatten order and dotted paths line up with JAX's on the same
    structure (dict keys sorted), and the leaf arithmetic agrees."""
    _, _, clients, projs = setup
    tree = {"z": clients[0], "a": [projs[0][0], (np.ones(2, np.float32),)]}
    want = jtrees.tree_paths(tree)
    got = ttrees.tree_paths(to_port(tree))
    assert [p for p, _ in got] == [p for p, _ in want]
    a, b = to_port(clients[0]), to_port(clients[1])
    for fn, args in ((ttrees.tree_add, (a, b)), (ttrees.tree_sub, (a, b)),
                     (ttrees.tree_scale, (a, 0.25))):
        jfn = getattr(jtrees, fn.__name__)
        jargs = tuple(clients[:2]) if fn is not ttrees.tree_scale \
            else (clients[0], 0.25)
        _close(fn(*args), jfn(*jargs), 1e-7)
    leaves, treedef = ttrees.tree_flatten(a)
    assert ttrees.tree_unflatten(treedef, leaves) == a


def test_projection_algebra_matches_reference():
    r = np.random.RandomState(0)
    X = r.randn(40, 24).astype(np.float32)
    Q0 = np.eye(24, dtype=np.float32)
    Xt = to_port(X)
    _close(tproj.projection_direct(Xt[:10]), jproj.projection_direct(X[:10]), 1e-4)
    _close(tproj.block_update(to_port(Q0), Xt[:8], 0.5),
           jproj.block_update(Q0, X[:8], 0.5), 1e-5)
    want = jproj.null_projector_from_features_continue(Q0, X, 1.0, block=16)
    got = tproj.null_projector_from_features_continue(
        tproj.null_projector_init(24), Xt, 1.0, block=16)
    _close(got, want, 1e-5)
    _close(tproj.symmetrize(got), jproj.symmetrize(want), 1e-5)
